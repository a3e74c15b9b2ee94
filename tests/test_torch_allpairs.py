"""allpairs_global in the PyTorch port against the JAX package.

K2m, the row-scan forward with the match plane (vsearch_tpu_torch.ops.
nw_rowscan, with_matches=True), is compared cell for cell with the Pallas
kernel (nw_pallas2.build_forward2(..., with_matches=True)) in interpret
mode; K5, the stats walk (vsearch_tpu_torch.ops.allpairs_dev.stats_walk),
with the JAX build_allpairs_stats on the same planes.  Then the whole
command: the port runs in a subprocess on its CPU device, where its device
stats pipeline takes the kernels' plain versions, and its process is shown
to load neither jax nor vsearch_tpu; the JAX package runs in process, where
off the TPU it takes its generic path and aligns every pair.  Every
comparison is exact, and outputs must be byte-equal.
"""

import json
import random
import zlib

import numpy as np
import pytest
import torch

from vsearch_tpu.ops.allpairs_dev import build_allpairs_stats
from vsearch_tpu.ops.nw_pallas2 import build_forward2
from vsearch_tpu_torch.ops import allpairs_dev, cuda_lib, nw_batch, nw_rowscan

from .conftest import run_ours
from .test_allpairs_fast import CASES, pairs_fasta  # noqa: F401 (fixture)
from .test_torch_nw import _pairs, _schemes, _wire, random_seq
from .test_torch_search import run_port
from .torch_helpers import (ACCEPT_TERMS, COVERAGE_TRAPS, accept_options,
                            accept_rows)

SCHEMES = ["default", "iupac", "n_mismatch", "overflow"]
M = N = 16
B = 128


def _inputs(case):
    key, alphabet = _schemes()[case]
    qs, ts = _pairs(random.Random(zlib.crc32(case.encode())), B, M, N,
                    alphabet)
    qmT, amT, qlen, t4T, tlen = _wire(key, qs, ts, M, N)
    rqT = np.ascontiguousarray(nw_batch.encode_padded(qs, B, M).T)
    return key, (qmT, amT, rqT, qlen, t4T, tlen)


def _forward(case):
    key, wire = _inputs(case)
    out = nw_rowscan.build_forward(key, with_matches=True)(
        *(torch.from_numpy(a) for a in wire))
    return key, wire, out


@pytest.mark.parametrize("case", SCHEMES)
def test_forward_with_matches_matches_pallas(case):
    import jax.numpy as jnp
    cuda_lib.reset_launches()
    key, (qmT, amT, rqT, qlen, t4T, tlen), (s_t, o_t, d_t, m_t) = \
        _forward(case)
    assert cuda_lib.PLAIN_CALLS["nw_rowscan_mr"] == 1
    assert cuda_lib.PLAIN_CALLS["nw_rowscan"] == 0
    s_j, o_j, d_j, m_j = build_forward2(
        key, M, N, B, interpret=True, with_matches=True)(
        jnp.asarray(qmT), jnp.asarray(amT.astype(np.int8)),
        jnp.asarray(rqT), jnp.asarray(qlen), jnp.asarray(t4T),
        jnp.asarray(tlen))
    assert d_t.dtype == torch.uint16 and m_t.dtype == torch.uint8
    assert tuple(m_t.shape) == (M, N, B)
    assert np.array_equal(np.asarray(s_j), s_t.numpy())
    assert np.array_equal(np.asarray(o_j), o_t.numpy())
    assert np.array_equal(np.asarray(d_j), d_t.numpy())
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    # the plane counts matches: some cells count several
    assert int(m_t.max()) > 1
    # K2m's score, overflow and dirs are K2's
    for a, b in zip(nw_rowscan.build_forward(key)(
            *(torch.from_numpy(x) for x in (qmT, amT, qlen, t4T, tlen))),
            (s_t, o_t, d_t)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.uint16
                           else a,
                           b.view(torch.int16) if b.dtype == torch.uint16
                           else b)
    if case == "overflow":
        assert o_t.any() and not o_t.all()


def _hard_pairs(case, rng):
    """(pairs, W, lengths the walk takes or None) of a stats-walk case
    whose paths reach the walk's edge cases, on a W x W plane."""
    if case == "gap_chains":
        # one gap of every length 1-40 in a pair, a deletion (D moves) or
        # an insertion (I moves): chains of every length
        qs, ts = [], []
        for g in range(1, 41):
            q = random_seq(rng, 60)
            qs.append(q)
            ts.append(q[:10] + q[10 + g:])
            q = random_seq(rng, 24)
            qs.append(q)
            ts.append(q[:10] + random_seq(rng, g) + q[10:])
        return qs, ts, 64, None
    if case == "drains":
        # lengths past the 32 x 32 plane (reads clamp to its last row or
        # column, the walk cut at S = 64 entries), 0 (the whole walk is
        # drains) and 4200 (drains capped at 4095, two entries of one run)
        qs = [random_seq(rng, rng.randint(5, 32)) for _ in range(8)]
        ts = [random_seq(rng, rng.randint(5, 32)) for _ in range(8)]
        lens = ([0, 4200, 0, 12, 4200, 40, 0, 31],
                [4200, 0, 0, 4200, 4200, 20, 9, 70])
        return qs, ts, 32, lens
    if case == "len1":
        # one sequence of each pair a single nucleotide
        qs, ts = [], []
        for k in range(32):
            a, b = random_seq(rng, 1), random_seq(rng, rng.randint(1, 64))
            qs.append(a if k % 2 else b)
            ts.append(b if k % 2 else a)
        return qs, ts, 64, None
    # identity: ~300 nt copies, some with a substitution: diagonal runs
    # past RLCAP restart with their match counts
    qs, ts = [], []
    for k in range(6):
        q = random_seq(rng, 300 - 2 * k)
        t = bytearray(q)
        if k % 2:
            t[rng.randrange(len(t))] = ord(rng.choice("ACGT"))
        qs.append(q)
        ts.append(bytes(t))
    return qs, ts, 304, None


def _stats_inputs(case):
    """(dirs, mr, qlen, tlen) as tensors on the CPU: the planes from K2m's
    plain version (16 x 16 x 128 for the schemes; a square plane per hard
    case), the lengths the walk takes."""
    if case in SCHEMES:
        _, (_, _, _, qlen, _, tlen), (_, _, dirs, mr) = _forward(case)
        return dirs, mr, torch.from_numpy(qlen), torch.from_numpy(tlen)
    key = _schemes()["default"][0]
    qs, ts, W, lens = _hard_pairs(case, random.Random(case))
    qmT, amT, qlen, t4T, tlen = _wire(key, qs, ts, W, W)
    rqT = np.ascontiguousarray(nw_batch.encode_padded(qs, len(qs), W).T)
    _, _, dirs, mr = nw_rowscan.build_forward(key, with_matches=True)(
        *(torch.from_numpy(a) for a in (qmT, amT, rqT, qlen, t4T, tlen)))
    if lens is not None:
        qlen, tlen = (np.array(v, dtype=np.int32) for v in lens)
    return dirs, mr, torch.from_numpy(qlen), torch.from_numpy(tlen)


@pytest.mark.parametrize("case", SCHEMES + ["gap_chains", "drains", "len1",
                                            "identity"])
def test_stats_walk_matches_jax(case):
    """K5's plain version against the JAX build_allpairs_stats on the same
    planes: the four schemes, and the walk's edge cases that the card tests
    hold the kernel to (tests/test_torch_kernels.py)."""
    import jax.numpy as jnp
    dirs, mr, qlen, tlen = _stats_inputs(case)
    W, _, Bc = dirs.shape
    cuda_lib.reset_launches()
    got = allpairs_dev.stats_walk(dirs, mr, qlen, tlen)
    assert cuda_lib.PLAIN_CALLS["nw_stats"] == 1
    ref = build_allpairs_stats(W, 1, Bc)(
        (jnp.asarray(dirs.view(torch.int16).numpy().view(np.uint16)),),
        (jnp.asarray(mr.numpy()),), (jnp.asarray(qlen.numpy()),),
        (jnp.asarray(tlen.numpy()),))
    assert got.dtype == torch.int32 and tuple(got.shape) == (Bc, 8)
    assert np.array_equal(np.asarray(ref), got.numpy())
    ops = nw_batch.backtrack_rle_plain(dirs, qlen, tlen)
    op, cnt = ops & 3, ops >> 2
    if case in SCHEMES:
        # the walks meet gaps and matches, and end on gaps and on matches
        assert (got[:, 3] > 0).any() and (got[:, 1] > 0).any()
        assert {1, 2, 3} <= set(got[:, 4].tolist())
    elif case == "gap_chains":
        # gap chains of 20 moves and more
        run = torch.zeros(Bc, dtype=torch.int64)
        longest = 0
        for row in op:
            gap = (row == 2) | (row == 3)
            run = torch.where(gap, run + 1, 0)
            longest = max(longest, int(run.max()))
        assert longest >= 20
    elif case == "drains":
        # capped drains, whole-drain lanes, a lane with no entry
        assert int((cnt == 4095).sum()) >= 3
        assert got[2].tolist() == [0] * 8
        assert got[0].tolist() == [4200, 0, 4200, 1, 3, 4200, 3, 4200]
    elif case == "len1":
        # one diagonal column at most, the rest gaps
        assert ((got[:, 0] - got[:, 2]) <= 1).all()
        assert (got[:, 0] >= torch.maximum(qlen, tlen)).all()
    else:
        # RLCAP-split runs: a 255-match chunk, merged into one first run
        assert int((mr == nw_rowscan.RLCAP).sum()) > 0
        assert int((got[:, 5] >= 256).sum()) > 0


# the issue's cases plus a mismatch score outside int8, which the JAX
# device wire (int8 am) could not carry and the port's int16 wire does
PORT_CASES = CASES + [
    ("mismatch_m200", ["--id", "0.3", "--mismatch", "-200", "--blast6out",
                       "{o}.b6", "--uc", "{o}.uc"]),
    ("basic_batch96", CASES[0][1]),
    # a match score that takes the near-identical pairs' scores past the
    # 16-bit forward's range (the overflow path) and leaves the random
    # pairs' inside it
    ("match_overflow", ["--id", "0.5", "--match", "220", "--userout",
                        "{o}.user", "--userfields", "query+target+id+raw"]),
    # the unaligned gate (a length ratio) filters the triangle's pairs
    ("minsl_gate", ["--id", "0.4", "--minsl", "0.8", "--blast6out",
                    "{o}.b6", "--uc", "{o}.uc"]),
]
# the triangle in chunks of 2 batches of 96 (CHUNKS2): 6 chunks, with
# queries straddling their boundaries
PORT_CASES += [
    ("basic_chunks", ["--id", "0.5", "--blast6out", "{o}.b6", "--uc",
                      "{o}.uc", "--output_no_hits", "--matched", "{o}.m",
                      "--notmatched", "{o}.nm"]),
    # overflow pairs in several chunks
    ("match_overflow_chunks", dict(PORT_CASES)["match_overflow"]),
    # a filtered triangle, with queries that have no pairs
    ("minsl_gate_chunks", dict(PORT_CASES)["minsl_gate"]),
]
# the port's process computes on one CPU thread: the suite runs its files
# in parallel workers, where torch's intra-op threads would oversubscribe
# the cores
ONE_THREAD = "import torch\ntorch.set_num_threads(1)\n"
# the same workload in batches of 96 pairs (12 batches and a tail of 24)
BATCH96 = ("from vsearch_tpu_torch.ops.allpairs_dev import AllPairsDevice\n"
           "AllPairsDevice.PAIR_BATCH = 96\n")
# chunks of 2 batches, and the program's counters written to tally.json
CHUNKS2 = BATCH96 + (
    "AllPairsDevice.CHUNK_BATCHES = 2\n"
    "import atexit, json\n"
    "from vsearch_tpu_torch.utils import phasetimer\n"
    "phasetimer.ENABLED = True\n"
    "atexit.register(lambda: open('tally.json', 'w').write(\n"
    "    json.dumps(dict(phasetimer.tally))))\n")


def _setup(name: str) -> str:
    if name.endswith("_chunks"):
        return ONE_THREAD + CHUNKS2
    return ONE_THREAD + (BATCH96 if name == "basic_batch96" else "")


@pytest.mark.parametrize("name,opts", PORT_CASES,
                         ids=[c[0] for c in PORT_CASES])
def test_allpairs_matches_jax(pairs_fasta, tmp_path, name,  # noqa: F811
                              opts):
    def expand(tag):
        return [x.replace("{o}", str(tmp_path / tag)) for x in opts]

    base = ["--allpairs_global", str(pairs_fasta), "--minseqlength", "1"]
    run_ours(base + expand("jax"), tmp_path)
    rep = run_port(base + expand("port") + ["--threads", "1", "--quiet"],
                   tmp_path, setup=_setup(name))
    assert rep["rc"] == 0
    outs = [x for x in opts if x.startswith("{o}")]
    assert outs
    for tpl in outs:
        jax_b = (tmp_path / tpl.replace("{o}", "jax")).read_bytes()
        port_b = (tmp_path / tpl.replace("{o}", "port")).read_bytes()
        if tpl.endswith(".aln"):
            # program banner differs in the first two lines
            jax_b = b"\n".join(jax_b.split(b"\n")[2:])
            port_b = b"\n".join(port_b.split(b"\n")[2:])
        assert port_b == jax_b, "%s: %s differs" % (name, tpl)
    if name.startswith("match_overflow"):
        rows = [ln.split(b"\t")
                for ln in (tmp_path / "port.user").read_bytes().splitlines()]
        raws = [int(r[3]) for r in rows]
        assert max(raws) > 32767
        if name.endswith("_chunks"):
            # the overflowing pairs written lie in several chunks
            n = 48
            chunks = set()
            for r, raw in zip(rows, raws):
                q, t = (int(x.split(b";")[0][1:]) for x in r[:2])
                if raw > 32767:
                    chunks.add((q * (n - 1) - q * (q - 1) // 2 + t - q - 1)
                               // (2 * 96))
            assert len(chunks) > 2, chunks
    if name.endswith("_chunks"):
        tally = json.loads((tmp_path / "tally.json").read_text())
        assert tally["allpairs.chunks"] == -(-tally["allpairs.batches"]
                                             // 2) > 1, tally
    calls = rep["plain_calls"]
    if name == "acceptall":
        # the generic path: every pair through the batched aligner
        assert calls["nw_rowscan_mr"] == 0 and calls["nw_stats"] == 0
    else:
        # the device stats pipeline: one K2m and one K5 call per batch,
        # and with no unaligned gate the whole triangle of 1128 pairs
        assert calls["nw_rowscan_mr"] == calls["nw_stats"] > 0, calls
        if name.startswith("basic"):
            assert calls["nw_rowscan_mr"] == (1 if name == "basic" else 12)
    assert not any(rep["launches"].values())
    loaded = rep["modules"]
    assert "vsearch_tpu_torch.commands.allpairs" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


@pytest.mark.parametrize("iddef", range(5))
def test_accept_mask_matches_jax(iddef):
    """The port's accept cascade over CPU tensors against the JAX
    package's numpy one, mask for mask: every term on, then each term
    alone, on rows at the terms' thresholds and at the zero
    denominators."""
    from vsearch_tpu.commands.allpairs import _accept_mask
    from vsearch_tpu.params import Parameters as JaxParameters
    from vsearch_tpu_torch.commands.allpairs import accept_mask
    from vsearch_tpu_torch.params import Parameters
    n = 4096
    stats, qlen, tlen = accept_rows(2100 + iddef, n)
    tensors = [torch.from_numpy(a) for a in (stats, qlen, tlen)]
    sets = [("all", ACCEPT_TERMS)] + [(k, {k: v})
                                      for k, v in ACCEPT_TERMS.items()]
    for name, opts in sets:
        got = accept_mask(accept_options(Parameters, iddef, **opts),
                          *tensors)
        want = _accept_mask(accept_options(JaxParameters, iddef, **opts),
                            stats, qlen, tlen)
        assert got.dtype == torch.bool and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), name
        if name != "all":
            # the term alone rejects some drawn rows and passes others
            assert 0 < int(want[-n:].sum()) < n, name
        if name in ("all", "opt_id"):
            # one count under 100 x --id, on it, and one over
            assert got[:3].tolist() == [False, True, True], name
    # the coverage traps: float32 would decide them the other way
    for k, (key, cov, length, cols) in enumerate(COVERAGE_TRAPS):
        f32 = float((torch.tensor([length]) * cov)[0])
        assert (cols >= cov * length) != (cols >= f32)
        row = len(stats) - n - len(COVERAGE_TRAPS) + k
        got = accept_mask(accept_options(Parameters, iddef, **{key: cov}),
                          *(t[row:row + 1] for t in tensors))
        assert got.tolist() == [cols >= cov * length], key


def _key_of(**opts) -> tuple:
    """The scheme key the CLI's fixups give for these Parameters options."""
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    from vsearch_tpu_torch.params import Parameters
    p = Parameters()
    p.apply_defaults_fixups()
    for k, v in opts.items():
        setattr(p, k, v)
    s = ScoreScheme.from_params(p)
    return (s.match, s.mismatch, s.go_q_left, s.go_t_left, s.go_q_int,
            s.go_t_int, s.go_q_right, s.go_t_right, s.ge_q_left,
            s.ge_t_left, s.ge_q_int, s.ge_t_int, s.ge_q_right, s.ge_t_right,
            s.n_mismatch)


def test_rowscan16_route_default_and_match_220():
    """The allpairs cell (the default scheme at 400 x 400) takes K2m's
    16-bit body; --match 220, whose scores pass 16 bits, does not."""
    assert nw_rowscan.rowscan16(_key_of(), 400, 400)
    assert not nw_rowscan.rowscan16(_key_of(opt_match=220), 400, 400)
    # gap rewards and substitution scores past the V table's seven bits
    # are refused whatever the shape
    assert not nw_rowscan.rowscan16(_key_of(opt_mismatch=-65), 16, 16)
    assert not nw_rowscan.rowscan16((2, -4, -1) + _key_of()[3:], 16, 16)


def _box_extremes(key, q, t, qlen, tlen):
    """(min, max) over the whole M x N box, boundaries included, of H, E,
    F, htemp, htemp2 and the intermediates E - R_q, F - R_t, h - QR_t and
    htemp2 - QR_q of the row-scan forward's recurrences, for pairs of
    4-bit codes q (B, M) and t (B, N) padded with code 0, in int64.  A
    row's E is its max-plus prefix: E(j) = max(E0 - jR, max over k < j of
    htemp2(k) - QR - (j - 1 - k)R)."""
    (match, mismatch, go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r,
     ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r, n_mismatch) = key
    B, M = q.shape
    N = t.shape[1]
    single = np.zeros(16, dtype=bool)
    single[[1, 2, 4, 8]] = True
    qq, tt = q[:, :, None], t[:, None, :]
    V = np.where(qq == tt, match, mismatch)
    V = np.where(~single[qq] | ~single[tt], 0, V)
    if n_mismatch:
        V = np.where((qq == 15) | (tt == 15), mismatch, V)
    V = V.astype(np.int64)                                  # (B, M, N)
    j = np.arange(N, dtype=np.int64)
    right = j[None, :] == (tlen[:, None] - 1)               # (B, N)
    QR_t = np.where(right, go_t_r + ge_t_r, go_t_i + ge_t_i)
    R_t = np.where(right, ge_t_r, ge_t_i)
    H = np.broadcast_to(-(go_q_l + (j + 1) * ge_q_l), (B, N)).copy()
    F = H - QR_t
    lo, hi = min(H.min(), F.min()), max(H.max(), F.max())
    for i in range(M):
        last = (qlen == i + 1)[:, None]
        QR_q = np.where(last, go_q_r + ge_q_r, go_q_i + ge_q_i)
        R_q = np.where(last, ge_q_r, ge_q_i)
        left = 0 if i == 0 else -(go_t_l + i * ge_t_l)
        diag = np.concatenate((np.full((B, 1), left), H[:, :-1]), axis=1)
        htemp = diag + V[:, i]
        htemp2 = np.maximum(htemp, F)
        E0 = -(go_t_l + (i + 1) * ge_t_l) - QR_q
        P = np.maximum.accumulate(htemp2 + j * R_q, axis=1)
        Ps = np.concatenate((np.full((B, 1), -(1 << 40)), P[:, :-1]), axis=1)
        E = np.maximum(E0 - j * R_q, Ps - (QR_q - R_q) - j * R_q)
        h = np.maximum(E, htemp2)
        Fx = F - R_t
        F = np.maximum(Fx, h - QR_t)
        for v in (E0, left, htemp, htemp2, E, h, F, E - R_q, Fx, h - QR_t,
                  htemp2 - QR_q):
            lo, hi = min(lo, np.min(v)), max(hi, np.max(v))
        H = h
    return int(lo), int(hi)


def _adversarial_pairs(rng, M, N):
    """Pairs of 4-bit codes that push the box's scores to its extremes: all
    matches, all mismatches, all N, one long gap each way, a random pair;
    at full and at partial lengths."""
    A, C, Nc = 1, 2, 15
    rows = []
    for full in (True, False):
        ql = M if full else rng.randint(1, M)
        tl = N if full else rng.randint(1, N)
        kinds = [([A] * ql, [A] * tl), ([A] * ql, [C] * tl),
                 ([Nc] * ql, [Nc] * tl), ([A] * ql, [A] * max(1, tl // 5)),
                 ([A] * max(1, ql // 5), [A] * tl),
                 ([rng.choice((1, 2, 4, 8)) for _ in range(ql)],
                  [rng.choice((1, 2, 4, 8)) for _ in range(tl)])]
        rows += kinds
    q = np.zeros((len(rows), M), dtype=np.int64)
    t = np.zeros((len(rows), N), dtype=np.int64)
    for k, (a, b) in enumerate(rows):
        q[k, :len(a)] = a
        t[k, :len(b)] = b
    qlen = np.array([len(a) for a, _ in rows], dtype=np.int64)
    tlen = np.array([len(b) for _, b in rows], dtype=np.int64)
    return q, t, qlen, tlen


@pytest.mark.parametrize("seed", range(6))
def test_rowscan16_envelope_holds(seed):
    """Wherever K2m's route picks its 16-bit body, every value of the box
    fits int16: seeded schemes (large scores, so that the envelope's edge
    lies below 1024 nt; gap classes that differ, zero gap opens,
    n_mismatch) at the largest square plane the route takes and two
    rectangles of it, with adversarial pairs (_box_extremes)."""
    rng = random.Random(seed)
    gos = [rng.choice((0, rng.randint(1, 300))) for _ in range(6)]
    ges = [rng.randint(4, 30) for _ in range(6)]
    key = ((rng.randint(20, 63), rng.randint(-64, -24)) + tuple(gos)
           + tuple(ges) + (bool(seed % 2),))
    W = 8
    while W < 1024 and nw_rowscan.rowscan16(key, W + 8, W + 8):
        W += 8
    assert nw_rowscan.rowscan16(key, W, W)
    for M, N in ((W, W), (W, W // 2), (W // 3, W)):
        assert nw_rowscan.rowscan16(key, M, N)
        q, t, qlen, tlen = _adversarial_pairs(rng, M, N)
        lo, hi = _box_extremes(key, q, t, qlen, tlen)
        assert -32768 <= lo and hi <= 32767, (key, M, N, lo, hi)
        if M == N:
            # the plane is at the route's edge, and its scores use a
            # good part of the range
            assert W < 1024 and not nw_rowscan.rowscan16(key, W + 8, W + 8)
            assert min(lo, -hi) < -8192, (key, W, lo, hi)
