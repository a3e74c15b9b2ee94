"""allpairs_global past the 640 bucket, and the pair batch sized from the
card's memory.

AllPairsDevice.batch_size: on a card the planes of a batch take at most
half of what the card can give, so full-length 16S pairs (W = 1456) keep
the 4096-pair batch on an 80 GB card; on the CPU PLANE_BUDGET caps them.
Then a set of related 720 nt sequences through the port's fast path, in
batches of 32 pairs: its blast6 and userout rows byte-equal to the JAX
package's and, for every pair of the triangle, to the benchmark's plain
reference (benchmark/reference/allpairs.py).  Last, K2m's counters: the
cells as W * W a pair and the plane buffers' bytes; and the triangle in
chunks of batches, counted, with outputs byte-equal to one chunk's.
"""

import numpy as np
import pytest
import torch

from benchmark.gen import seqgen
from benchmark.reference import allpairs as ref_allpairs
from vsearch_tpu_torch.ops.allpairs_dev import AllPairsDevice

from .conftest import run_ours
from .test_torch_search import run_port

GB = 10 ** 9


@pytest.mark.parametrize("W,available,batch", [
    # an 80 GB card: full-length 16S and V3-V4 both keep 4096 pairs
    (1456, 80 * GB, 4096),
    (400, 80 * GB, 4096),
    (1456, 79 * GB, 4096),
    # little memory: a multiple of 32, at least 32
    (1456, 2 * GB, 128),
    (1456, 10 ** 6, 32),
    (400, 0, 32),
    # the CPU: PLANE_BUDGET caps the planes (4 GB: 608 pairs at 1456)
    (1456, None, 608),
    (400, None, 4096),
], ids=["fl16s_80g", "v34_80g", "fl16s_79g", "fl16s_2g", "fl16s_1m",
        "v34_0", "fl16s_cpu", "v34_cpu"])
def test_batch_size_rule(W, available, batch):
    got = AllPairsDevice.batch_size(W, available)
    assert got == batch
    assert got % 32 == 0 and 32 <= got <= AllPairsDevice.PAIR_BATCH
    if available is not None and got > 32:
        assert 3 * W * W * got <= available // 2


def _scheme():
    """The default scheme, as the CLI's fixups give it."""
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    return ScoreScheme.from_params(cli.parse_args(
        ["--allpairs_global", "x.fa", "--id", "0.5", "--blast6out", "o"]))


def test_batch_size_on_the_cpu_device():
    """A run on the CPU takes PLANE_BUDGET's rule."""
    seqs = [b"ACGT" * 364] * 2
    dev = AllPairsDevice(_scheme(), seqs, torch.device("cpu"))
    assert dev.W == 1456 and dev.batch == 608


# 24 related sequences of 720 nt: 2 x 2 x 2 x 3 leaves, substitutions
# a branch set so that the pairs of a clade lie about 97-99.5 %
LONG = dict(branching=[2, 2, 2, 3], subs=[30, 20, 8, 3],
            indels=[1, 1, 1, 0], length=720)
LONG_ID = 0.96
SCHEME = {"match": 2, "mismatch": -4, "open_int": 20, "ext_int": 2,
          "open_end": 2, "ext_end": 1}
BATCH32 = ("import torch\ntorch.set_num_threads(1)\n"
           "from vsearch_tpu_torch.ops.allpairs_dev import AllPairsDevice\n"
           "AllPairsDevice.PAIR_BATCH = 32\n")


def test_long_pairs_match_jax_and_reference(tmp_path):
    codes, _ = seqgen.taxon_tree(seqgen.rng_for(1450, 1, 0),
                                 LONG["branching"], LONG["subs"],
                                 LONG["indels"], LONG["length"])
    n = codes.shape[0]
    fa = tmp_path / "long.fa"
    seqgen.write_fasta(fa, "s", codes)
    argv = ["--allpairs_global", str(fa), "--id", str(LONG_ID),
            "--userfields", "query+target+raw"]

    def outs(tag):
        return ["--blast6out", str(tmp_path / (tag + ".b6")),
                "--userout", str(tmp_path / (tag + ".user"))]

    run_ours(argv + outs("jax"), tmp_path)
    rep = run_port(argv + outs("port") + ["--threads", "1", "--quiet"],
                   tmp_path, setup=BATCH32)
    assert rep["rc"] == 0
    # the fast path, batch by batch: 276 pairs in 9 batches of 32
    pairs = n * (n - 1) // 2
    assert rep["plain_calls"]["nw_rowscan_mr"] == -(-pairs // 32) == 9
    assert rep["plain_calls"]["nw_stats"] == 9
    port = {}
    for ext in ("b6", "user"):
        got = (tmp_path / ("port." + ext)).read_bytes()
        assert got == (tmp_path / ("jax." + ext)).read_bytes(), ext
        port[ext] = got.decode().splitlines()
    # every pair of the triangle against the plain reference: reported
    # or not, and both rows
    rows = {}
    for b6, user in zip(port["b6"], port["user"]):
        q, t = b6.split("\t")[:2]
        assert user.split("\t")[:2] == [q, t]
        rows[(int(q[1:]), int(t[1:]))] = (b6, user)
    assert len(rows) == len(port["b6"])
    labels = ["s%d" % i for i in range(n)]
    tri = [(q, t) for q in range(n) for t in range(q + 1, n)]
    # one intra-op thread: beside the suite's other workers a thread team
    # an op oversubscribes the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = ref_allpairs.rows({"id": LONG_ID, "scheme": SCHEME}, codes,
                                 labels, tri, "cpu")
    finally:
        torch.set_num_threads(threads)
    reported = [qt for qt in tri if want[qt] is not None]
    # both sides of the threshold are present
    assert 20 <= len(reported) <= pairs - 20
    for qt in tri:
        assert rows.get(qt) == want[qt], qt


@pytest.fixture
def timer():
    from vsearch_tpu_torch.utils import phasetimer
    enabled = phasetimer.ENABLED
    phasetimer.reset()
    phasetimer.ENABLED = True
    try:
        yield phasetimer
    finally:
        phasetimer.ENABLED = enabled
        phasetimer.reset()


@pytest.mark.parametrize("lengths,copies,batch", [
    ((101, 60, 77, 90), 4, 32), ((700, 650, 512), 4, 32)],
    ids=["w104", "w704"])
def test_cells_and_plane_bytes_counted(timer, monkeypatch, lengths, copies,
                                       batch):
    monkeypatch.setattr(AllPairsDevice, "PAIR_BATCH", batch)
    rng = np.random.default_rng(len(lengths))
    seqs = [bytes(seqgen.ALPHABET[rng.integers(0, 4, k)]) for k in lengths]
    seqs = seqs * copies
    q, t = np.triu_indices(len(seqs), 1)
    # a triangle of several batches, and one of less than one
    assert q.size > 2 * batch
    for P in (q.size, 5):
        dev = AllPairsDevice(_scheme(), seqs, torch.device("cpu"))
        W = dev.W
        assert W == {101: 104, 700: 704}[max(lengths)]
        timer.reset()
        over, stats = dev.run(torch.from_numpy(q[:P]),
                              torch.from_numpy(t[:P]))
        assert stats.shape == (P, 8)
        B = min(batch, P)
        assert timer.tally["allpairs.cells"] == P * W * W
        # one uint16 direction plane and one uint8 match plane of B pairs
        assert timer.tally["allpairs.plane_bytes"] == 3 * W * W * B
        assert timer.tally["allpairs.batches"] == -(-P // B)
        # the planes' allocation, inside dispatch
        assert 0 < timer.acc["planes"] <= timer.acc["dispatch"]
        # a later run of the same set (the next chunk) reuses the planes
        dev.run(torch.from_numpy(q[:P]), torch.from_numpy(t[:P]))
        assert timer.tally["allpairs.plane_bytes"] == 3 * W * W * B
        assert timer.tally["allpairs.cells"] == 2 * P * W * W


# 40 related 160 nt sequences (4 x 2 x 5 leaves, pairs of a clade about
# 96-99 %) and the --id that cuts between them: 780 pairs in 25 batches
CHUNKED = dict(branching=[4, 2, 5], subs=[30, 4, 2], indels=[1, 1, 0],
               length=160)


@pytest.mark.parametrize("chunk_batches", [3, 7])
def test_chunks_counted_and_rows_unchanged(timer, tmp_path, monkeypatch,
                                           chunk_batches):
    """The triangle in chunks of chunk_batches batches of 32: the counter
    allpairs.chunks reads ceil(batches / chunk_batches), and every output
    file is byte-equal to the run of the whole triangle as one chunk
    (chunks 1), with --uc, --output_no_hits, --matched and --notmatched,
    queries written in the chunk that completes them."""
    from vsearch_tpu_torch import cli
    codes, _ = seqgen.taxon_tree(seqgen.rng_for(780, 2, 0),
                                 CHUNKED["branching"], CHUNKED["subs"],
                                 CHUNKED["indels"], CHUNKED["length"])
    fa = tmp_path / "set.fa"
    seqgen.write_fasta(fa, "s", codes)
    monkeypatch.setattr(AllPairsDevice, "PAIR_BATCH", 32)
    files = ("b6", "uc", "m", "nm")

    def run(tag, chunk):
        monkeypatch.setattr(AllPairsDevice, "CHUNK_BATCHES", chunk)
        timer.reset()
        argv = ["--allpairs_global", str(fa), "--id", "0.97",
                "--output_no_hits", "--threads", "1", "--quiet"]
        for ext, opt in zip(files, ("--blast6out", "--uc", "--matched",
                                    "--notmatched")):
            argv += [opt, str(tmp_path / ("%s.%s" % (tag, ext)))]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            assert cli.main(argv, device="cpu") == 0
        finally:
            torch.set_num_threads(threads)
        return dict(timer.tally)

    one = run("one", 64)
    assert one["allpairs.batches"] == -(-780 // 32) == 25
    assert one["allpairs.chunks"] == 1
    got = run("chunked", chunk_batches)
    assert got["allpairs.chunks"] == -(-25 // chunk_batches) > 1
    for name in ("allpairs.pairs", "allpairs.batches", "allpairs.cells",
                 "allpairs.accepted", "allpairs.rows"):
        assert got[name] == one[name], name
    # some pairs reported and some queries not matched
    assert 0 < one["allpairs.rows"] < 780
    assert (tmp_path / "one.nm").stat().st_size > 0
    for ext in files:
        assert ((tmp_path / ("chunked." + ext)).read_bytes()
                == (tmp_path / ("one." + ext)).read_bytes()), ext
