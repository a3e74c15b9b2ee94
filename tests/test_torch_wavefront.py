"""The wavefront route of the PyTorch port against the JAX package.

Under a mismatch score outside int8 the JAX package aligns with the
anti-diagonal wavefront (nw_pallas.build_forward) and the flat backtrack
(nw_jax.py:266-318), and so does the port (ops/nw_wavefront.py, K6, and
nw_batch.backtrack_flat, K7).  The port's plain versions are compared with
the Pallas kernel, run in interpret mode (nw_pallas.pl.pallas_call is
wrapped for the test only), and with its XLA twin,
nw_jax._build_kernels(key, M, N, Bp=-1): score, overflow and the direction
plane exactly, then the backtrack's ops on the same plane.  Then the CLI:
usearch_global and cluster_fast under --mismatch -200, the port in a
subprocess on its CPU device, byte-equal to the JAX package, with K6's and
K7's plain versions run and K2's and K3's not.
"""

import functools

import numpy as np
import pytest
import torch

from vsearch_tpu.ops import nw_jax, nw_pallas
from vsearch_tpu.ops import nw as jax_nw
from vsearch_tpu.params import Parameters
from vsearch_tpu_torch.ops import cuda_lib, nw_batch, nw_wavefront

from .conftest import run_ours
from .test_device_search_parity import _write_workload
from .test_torch_cluster import SETUP, families  # noqa: F401 (fixture)
from .test_torch_search import run_port
from .torch_helpers import longest_gap_run


def _default_key():
    p = Parameters()
    p.apply_defaults_fixups()
    s = jax_nw.ScoreScheme.from_params(p)
    return (s.match, s.mismatch, s.go_q_left, s.go_t_left, s.go_q_int,
            s.go_t_int, s.go_q_right, s.go_t_right, s.ge_q_left,
            s.ge_t_left, s.ge_q_int, s.ge_t_int, s.ge_q_right, s.ge_t_right,
            s.n_mismatch)


def _schemes():
    base = _default_key()
    return {
        "default": base,
        "mismatch_200": base[:1] + (-200,) + base[2:],
        "n_mismatch": base[:1] + (-200,) + base[2:14] + (True,),
        # every end-gap class its own open and extension penalty
        "asym_ends": base[:2] + (3, 7) + base[4:6] + (5, 11, 1, 2)
                     + base[10:12] + (3, 1, False),
        # a match score that passes SHRT_MAX within 14 matches
        "overflow": (2500,) + base[1:],
    }


def _inputs(seed, B, M, N, zero_lanes=False):
    """int8 codes with 0 (padding and ambiguous), 5 (ambiguous) and 15 (N)
    mixed in, ragged lengths including 1, half the targets near copies of
    their query; zero_lanes gives pair 3 qlen 0 and pair 1 tlen 0."""
    rng = np.random.default_rng(seed)
    alphabet = np.array([1, 2, 4, 8, 1, 2, 4, 8, 5, 15, 0], dtype=np.int8)
    qlen = rng.integers(1, M + 1, size=B).astype(np.int32)
    tlen = rng.integers(1, N + 1, size=B).astype(np.int32)
    qlen[0], tlen[1] = 1, 1
    q4 = alphabet[rng.integers(0, alphabet.size, size=(B, M))]
    t4 = alphabet[rng.integers(0, alphabet.size, size=(B, N))]
    for b in range(0, B, 2):
        n = min(M, N)
        t4[b, :n] = q4[b, :n]
        tlen[b] = min(qlen[b] + int(rng.integers(0, 3)), N)
        flip = rng.integers(0, n, size=2)
        t4[b, flip] = 8
    # pair 2: a full-length exact copy over ACGT (it overflows at match
    # 2500)
    q4[2] = alphabet[rng.integers(0, 4, size=M)]
    qlen[2] = tlen[2] = min(M, N)
    t4[2, :min(M, N)] = q4[2, :min(M, N)]
    if zero_lanes:
        qlen[3], tlen[1] = 0, 0
    q4[np.arange(M)[None, :] >= qlen[:, None]] = 0
    t4[np.arange(N)[None, :] >= tlen[:, None]] = 0
    return q4, qlen, t4, tlen


@pytest.fixture
def pallas_interpret(monkeypatch):
    """nw_pallas.build_forward with its pallas_call in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(nw_pallas.pl, "pallas_call", functools.partial(
        nw_pallas.pl.pallas_call, interpret=pltpu.InterpretParams()))
    return nw_pallas.build_forward


@pytest.mark.parametrize("case,M,N,B,zero_lanes", [
    ("default", 20, 28, 8, False), ("mismatch_200", 20, 28, 8, False),
    ("n_mismatch", 20, 28, 8, False), ("asym_ends", 20, 28, 8, False),
    ("overflow", 20, 28, 8, False), ("mismatch_200", 64, 64, 16, False),
    ("n_mismatch", 33, 40, 8, True), ("mismatch_200", 1, 20, 4, True),
    ("asym_ends", 20, 1, 4, True)])
def test_wavefront_matches_pallas_and_xla(pallas_interpret, case, M, N, B,
                                          zero_lanes):
    """Band edges of the card kernel (33 rows: a second band of one row;
    one row; one column), each with a lane of qlen 0 and one of tlen 0.
    The tlen-0 lane's score is h at (qlen - 1, -1), left of column 0: 0
    unless a query N under n_mismatch makes it negative (-5 at 33 x 40)."""
    import jax.numpy as jnp
    key = _schemes()[case]
    q4, qlen, t4, tlen = _inputs(M * 7 + N + len(case), B, M, N, zero_lanes)
    cuda_lib.reset_launches()
    s_t, o_t, d_t = nw_wavefront.build_forward(key)(
        *(torch.from_numpy(a) for a in (q4, qlen, t4, tlen)))
    assert cuda_lib.PLAIN_CALLS["nw_wavefront"] == 1
    Ms = nw_wavefront.lane_stride(M)
    assert d_t.dtype == torch.uint8 and tuple(d_t.shape) == \
        (M + N - 1, B, Ms)
    assert not d_t[:, :, M:].any()

    jargs = [jnp.asarray(a) for a in (q4.astype(np.int32), qlen,
                                      t4.astype(np.int32), tlen)]
    s_p, o_p, d_p = pallas_interpret(key, M, N, B)(*jargs)
    assert np.array_equal(np.asarray(s_p), s_t.numpy())
    assert np.array_equal(np.asarray(o_p), o_t.numpy())
    assert np.asarray(d_p).shape == tuple(d_t.shape)
    assert np.array_equal(np.asarray(d_p), d_t.numpy())

    fwd_x, bt_x = nw_jax._build_kernels(key, M, N, Bp=-1)
    s_x, o_x, d_x = fwd_x(*jargs)
    assert np.array_equal(np.asarray(s_x), s_t.numpy())
    assert np.array_equal(np.asarray(o_x), o_t.numpy())
    assert np.array_equal(np.asarray(d_x), d_t[:, :, :M].numpy())
    if case == "overflow":
        assert o_t.any() and not o_t.all()
    if zero_lanes:
        assert not d_t[:, 3].any() and not d_t[:, 1].any()
        assert s_t[3] == 0 and not o_t[3] and not o_t[1]

    # K7's plain version against the flat backtrack, on either plane
    ops_t = nw_batch.backtrack_flat(d_t, torch.from_numpy(qlen),
                                    torch.from_numpy(tlen))
    assert cuda_lib.PLAIN_CALLS["nw_backtrack_flat"] == 1
    assert ops_t.dtype == torch.int16 and tuple(ops_t.shape) == (M + N, B)
    for d in (d_x, d_p):
        ops_x = bt_x(d, jnp.asarray(qlen), jnp.asarray(tlen))
        assert np.array_equal(np.asarray(ops_x), ops_t.numpy())
    assert cuda_lib.PLAIN_CALLS["nw_rowscan"] == 0
    assert not any(cuda_lib.LAUNCHES.values())


def _walk_case(case, rng):
    """(q4, t4 int8 codes, the pairs' lengths, the lengths the flat
    backtrack walks) of an adversarial pair set at CPU sizes: reject-like
    random pairs, one gap of 1..40 a pair (chains of one gap op longer
    than the 32 diagonals K7 walks in a window before it fetches the
    next), drains (short against long, lanes of length 0), single-
    nucleotide pairs, and lengths past the plane."""
    acgt = np.array([1, 2, 4, 8], dtype=np.int8)

    def seq(n):
        return acgt[rng.integers(0, 4, size=n)]
    qs, ts, walk = [], [], None
    if case == "reject":
        qs = [seq(int(rng.integers(140, 161))) for _ in range(8)]
        ts = [seq(int(rng.integers(140, 161))) for _ in range(8)]
        M = N = 160
    elif case == "gap_chains":
        for g in range(1, 41, 3):
            q = seq(100)
            at = int(rng.integers(20, 60))
            qs += [q, q]
            ts += [np.concatenate([q[:at], q[at + g:]]),
                   np.concatenate([q[:at], seq(g), q[at:]])]
        M, N = 100, 140
    elif case == "drains":
        qs = [seq(12), seq(150), seq(1), seq(1), seq(90), seq(9)]
        ts = [seq(150), seq(20), seq(1), seq(1), seq(80), seq(120)]
        M = N = 150
        walk = ([12, 150, 0, 150, 90, 9], [150, 20, 150, 0, 80, 0])
    elif case == "len1":
        for k in range(16):
            a, b = seq(1), seq(int(rng.integers(1, 41)))
            qs.append(a if k % 2 else b)
            ts.append(b if k % 2 else a)
        M = N = 40
    else:
        # past_plane: lengths above M and N (one of them above the lane
        # stride, 128); the walks start past the plane's last diagonal
        for _ in range(6):
            q = seq(100)
            qs.append(q)
            ts.append(np.concatenate([q[:50], seq(40)]))
        M, N = 100, 90
        walk = ([103, 140, 600, 110, 5, 100], [95, 91, 500, 20, 300, 89])
    B = len(qs)
    q4 = np.zeros((B, M), dtype=np.int8)
    t4 = np.zeros((B, N), dtype=np.int8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        q4[b, :q.size] = q
        t4[b, :t.size] = t
    qlen = np.array([q.size for q in qs], dtype=np.int32)
    tlen = np.array([t.size for t in ts], dtype=np.int32)
    if walk is None:
        walk = (qlen, tlen)
    return q4, t4, qlen, tlen, tuple(np.asarray(w, dtype=np.int32)
                                     for w in walk)


@pytest.mark.parametrize("case", ["reject", "gap_chains", "drains", "len1",
                                  "past_plane"])
def test_flat_backtrack_plain_matches_xla(case):
    """The oracle K7 is held to on the card, backtrack_flat_plain, against
    the XLA twin's flat backtrack on the twin's own plane (lane stride M)
    and on that plane padded to K6's lane stride, under --mismatch -200,
    on the adversarial pair sets of the card tests at CPU sizes."""
    import jax.numpy as jnp
    key = _schemes()["mismatch_200"]
    q4, t4, qlen, tlen, (wq, wt) = _walk_case(
        case, np.random.default_rng(len(case)))
    M, N = q4.shape[1], t4.shape[1]
    fwd_x, bt_x = nw_jax._build_kernels(key, M, N, Bp=-1)
    d_x = np.array(fwd_x(*(jnp.asarray(a) for a in (
        q4.astype(np.int32), qlen, t4.astype(np.int32), tlen)))[2])
    Ms = nw_wavefront.lane_stride(M)
    padded = np.zeros(d_x.shape[:2] + (Ms,), dtype=np.uint8)
    padded[:, :, :M] = d_x
    for d in (d_x, padded):
        ops = nw_batch.backtrack_flat_plain(
            torch.from_numpy(d), torch.from_numpy(wq), torch.from_numpy(wt))
        ops_x = bt_x(jnp.asarray(d), jnp.asarray(wq), jnp.asarray(wt))
        assert np.array_equal(np.asarray(ops_x), ops.numpy())
    moves = (ops != 0).sum(dim=0)
    if case == "reject":
        assert int(moves.max()) > 200
    if case == "gap_chains":
        assert longest_gap_run(ops) > 32
    if case == "drains":
        assert int(moves[2]) == 150 and int(moves[3]) == 150
    if case == "past_plane":
        assert bool((ops[-1] != 0).any())


def test_aligner_codes_wire_matches_oracle(monkeypatch):
    """BatchAligner under --mismatch -200 takes the codes wire (K6 + K7)
    for every device batch; its results equal the scalar oracle's."""
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    key = _schemes()["n_mismatch"]
    jax_scheme = jax_nw.ScoreScheme(*key)
    ba = nw_batch.BatchAligner(ScoreScheme(*key), torch.device("cpu"))
    assert not ba.row_wire
    assert nw_batch.BatchAligner(ScoreScheme(*_schemes()["default"]),
                                 torch.device("cpu")).row_wire
    monkeypatch.setattr(nw_batch.BatchAligner, "NATIVE_CELLS_LIMIT", 0)
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGTN", dtype=np.uint8)
    qs, ts = [], []
    for _ in range(12):
        q = acgt[rng.integers(0, 5, size=int(rng.integers(1, 70)))]
        t = q.copy()
        t[rng.integers(0, t.size, size=3)] = acgt[rng.integers(0, 4, 3)]
        if rng.random() < 0.5:
            t = np.delete(t, rng.integers(0, t.size))
        qs.append(q.tobytes())
        ts.append((t if t.size else q).tobytes())
    cuda_lib.reset_launches()
    got = ba.align_pairs(qs, ts)
    assert cuda_lib.PLAIN_CALLS["nw_wavefront"] == 1
    assert cuda_lib.PLAIN_CALLS["nw_backtrack_flat"] == 1
    assert cuda_lib.PLAIN_CALLS["nw_rowscan"] == 0
    assert cuda_lib.PLAIN_CALLS["nw_backtrack"] == 0
    for q, t, r in zip(qs, ts, got):
        h = jax_nw.align_pair_host(jax_scheme, q, t)
        assert (h.score, h.cigar, h.aligned, h.matches, h.mismatches,
                h.gaps) == (r.score, r.cigar, r.aligned, r.matches,
                            r.mismatches, r.gaps), (q, t)
    with pytest.raises(ValueError, match="row wire"):
        ba.dispatch_compact([b"ACGT"], 1, None, None, np.zeros(1), 1, 1,
                            None, None, 64, 1)


def _assert_wavefront_route(rep):
    assert rep["rc"] == 0
    plain = rep["plain_calls"]
    assert plain["nw_wavefront"] > 0 and plain["nw_backtrack_flat"] > 0, rep
    assert plain["nw_rowscan"] == 0 and plain["nw_backtrack"] == 0, rep
    assert not any(rep["launches"].values())
    loaded = rep["modules"]
    assert "vsearch_tpu_torch.ops.nw_wavefront" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


@pytest.mark.parametrize("extra", [
    ["--id", "0.8", "--maxaccepts", "1", "--maxrejects", "32"],
    ["--id", "0.9", "--maxaccepts", "4", "--maxrejects", "8",
     "--output_no_hits"],
    ["--id", "0.8", "--strand", "both"],
], ids=["ma1", "ma4_nohits", "both"])
def test_usearch_global_mismatch_200_matches_jax(tmp_path, extra):
    db, q = _write_workload(tmp_path)
    args = ["--usearch_global", str(q), "--db", str(db),
            "--mismatch", "-200"] + extra
    run_ours(args + ["--blast6out", "jax.b6", "--uc", "jax.uc"], tmp_path)
    rep = run_port(args + ["--blast6out", "port.b6", "--uc", "port.uc",
                           "--threads", "1", "--quiet"], tmp_path)
    _assert_wavefront_route(rep)
    assert rep["plain_calls"]["score_dense"] > 0
    for name in ("uc", "b6"):
        assert (tmp_path / ("jax." + name)).read_bytes() == \
            (tmp_path / ("port." + name)).read_bytes(), name
    assert (tmp_path / "port.uc").read_bytes().count(b"\n") == 64


def test_cluster_fast_mismatch_200_matches_jax(families, tmp_path):  # noqa: F811
    args = ["--cluster_fast", str(families), "--id", "0.97",
            "--mismatch", "-200"]
    outs = ("uc", "centroids")

    def out_args(side):
        return [x for o in outs for x in ("--" + o, "%s.%s" % (side, o))]

    run_ours(args + out_args("jax"), tmp_path)
    rep = run_port(args + out_args("port") + ["--threads", "1", "--quiet"],
                   tmp_path, setup=SETUP)
    _assert_wavefront_route(rep)
    assert rep["plain_calls"]["score_ranked"] > 0
    for o in outs:
        jax_out = (tmp_path / ("jax." + o)).read_bytes()
        assert jax_out, o
        assert jax_out == (tmp_path / ("port." + o)).read_bytes(), o
