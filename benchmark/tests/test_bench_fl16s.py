"""The full-length 16S cell, allpairs_fl16s.species: at a tiny size on the
CPU it is correct against the plain reference and its 8-bit control is
not; its two readers read what they should; its tree gives Yarza et al.'s
identities by rank at 1450 nt."""

import numpy as np
import pytest

from benchmark import control, run
from benchmark.gen import seqgen
from benchmark.harness import loader, trace
from vsearch_tpu_torch.utils import phasetimer

from .tiny import run_cell

CELL = "allpairs_fl16s.species"
# the tree cut to 16 leaves of 150 nt, a genus of 4 (near_level 4 finds
# mates); the judge reads every row and a sample of pairs
TINY = {
    "config": {"generator": {"length": 150,
                             "branching": [2, 1, 1, 1, 2, 2, 2],
                             "subs": [8, 4, 4, 6, 3, 1, 0.5],
                             "indels": [1, 0, 0, 1, 0, 0, 0]},
               "judge": {"sample_rows": 400, "sample_pairs": 600}},
    "cell": {"traffic": {"pool": 2}}}
# 300 nt, so that an alignment's score passes 8 bits
CONTROL = {"config": {"generator": dict(TINY["config"]["generator"],
                                        length=300),
                      "judge": {"sample_rows": 64, "sample_pairs": 120}},
           "cell": TINY["cell"]}


def _metric(name):
    return loader.metric(name)


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_cell_correct_against_the_reference(capsys, seed):
    rc, res = run_cell(capsys, CELL, seed, overrides=TINY)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"wrong_rows", "wrong_pairs",
                                  "order_faults"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"pairs_per_s", "setup_s"}


def test_traced_run_reports_the_host_reader(capsys):
    """On the CPU nothing runs on a card: the device readers, the two new
    ones among them, report nothing and the host phase reader speaks."""
    rc, res = run_cell(capsys, CELL, 8, trace=1, overrides=TINY)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"host_ms_per_mpair.allpairs"}


def test_control_fails_and_reference_holds():
    r = control.reading(CELL, 13, "cpu", jobs=3, overrides=CONTROL)
    assert r["exact"]["correct"], r
    assert set(r["exact"]["checks"].values()) == {0}
    assert not r["control"]["correct"], r


def _ctx(cfg, work=523_776, jobs=2, busy_s=2.0, kernel_s=None):
    length = int(cfg["generator"]["length"])
    return run.Context(cell={}, config=cfg, work=work, jobs=jobs,
                       dp_cells=work * length * length,
                       trace=trace.Summary(busy_s, 4.0, kernel_s or {}, {}),
                       phases={}, sms=132, clock_hz=1.98e9)


def test_roofline_envelope_at_full_length():
    """16 bits at 1450 nt under the default scheme, where nw_roofline.
    allpairs's step rule says 32; 32 under a match score that passes
    them."""
    reader = _metric("nw_roofline.allpairs_fl16s")
    old = _metric("nw_roofline.allpairs")
    cfg = loader.config("allpairs_fl16s")
    assert reader.envelope(cfg["reference"]["scheme"], 1450, 1450) == (
        -8740, 2900)
    assert reader.fits16(cfg) and not old.fits16(cfg)
    wide = dict(cfg, reference=dict(cfg["reference"], scheme=dict(
        cfg["reference"]["scheme"], match=30)))
    assert reader.envelope(wide["reference"]["scheme"], 1450, 1450)[1] \
        == 43500
    assert not reader.fits16(wide)
    # two operations a lane halve the least time
    ctx, ctx_wide = _ctx(cfg), _ctx(wide)
    share = reader.read(ctx)
    assert share == pytest.approx(reader.read(ctx_wide) / 2)
    ops = ctx.dp_cells * 16
    rate = 2 * 128 * 132 * 1.98e9
    assert share == pytest.approx(100.0 * ops / rate / 2.0)
    assert reader.read(_ctx(cfg, busy_s=0.0)) is None


@pytest.fixture
def timer():
    phasetimer.reset()
    try:
        yield phasetimer
    finally:
        phasetimer.reset()


def test_k2m_ps_per_cell(timer):
    reader = _metric("k2m_ps_per_cell.allpairs_fl16s")
    cfg = loader.config("allpairs_fl16s")
    kernels = {"void nw_rowscan_mr16_kernel<16>": 36.0,
               "void nw_rowscan_kernel<false, 8>": 0.2,
               "nw_stats_kernel": 1.0}
    # no counter: nothing to read
    assert reader.read(_ctx(cfg, kernel_s=kernels)) is None
    cells = 2 * 523_776 * 1456 * 1456
    timer.tally["allpairs.cells"] = cells
    got = reader.read(_ctx(cfg, kernel_s=kernels))
    assert got == pytest.approx(1e12 * 36.2 / cells)
    # no nw_rowscan kernel in the window: nothing to read
    assert reader.read(_ctx(cfg, kernel_s={"nw_stats_kernel": 1.0})) is None


def test_k2m_ps_per_cell_on_a_program_without_the_counter(timer,
                                                          monkeypatch):
    """A program whose phasetimer has no tally: nothing read, nothing
    raised."""
    monkeypatch.delattr(phasetimer, "tally")
    reader = _metric("k2m_ps_per_cell.allpairs_fl16s")
    cfg = loader.config("allpairs_fl16s")
    assert reader.read(_ctx(cfg, kernel_s={"nw_rowscan_mr16": 1.0})) is None


def test_taxon_tree_identities_by_rank_at_full_length():
    """The config's tree: two leaves whose last common ancestor sits at a
    rank align at Yarza et al.'s identity threshold of the rank below,
    within 0.5 % at every rank, 12 pairs a rank in each of the pool's 4
    sets (one tree's own branch draws move its phylum-rank mean by about
    0.5 %, so the mean is taken over the sets of one job's pool)."""
    import torch
    from benchmark.reference import nwalign
    torch.set_num_threads(2)
    gen = loader.config("allpairs_fl16s")["generator"]
    pool = loader.cell(CELL)["traffic"]["pool"]
    rng = np.random.default_rng(1)
    qs, ts, level = [], [], []
    for k in range(pool):
        codes, clades = seqgen.taxon_tree(seqgen.rng_for(777, 1, k),
                                          gen["branching"], gen["subs"],
                                          gen["indels"], gen["length"])
        assert codes.shape == (1024, 1450)
        n = codes.shape[0]
        for lv in range(len(gen["branching"])):
            got = 0
            while got < 12:
                a, b = rng.integers(0, n, 2)
                if a != b and (clades[a] == clades[b]).sum() == lv:
                    qs.append(codes[a])
                    ts.append(codes[b])
                    level.append(lv)
                    got += 1
    ids = np.array([nwalign.hit_fields(x).identity for x in
                    nwalign.align_codes(nwalign.Scheme(), qs, ts, "cpu")])
    level = np.array(level)
    want = [75.0, 78.5, 82.0, 86.5, 94.5, 98.65, 99.5]
    for lv, w in enumerate(want):
        assert abs(ids[level == lv].mean() - w) < 0.5, (lv, ids[level == lv])
