"""The plain reference agrees with the program on the CPU: pair by pair
(alignment, DUST) and, at a tiny size of each cell, on every answer the
judge samples from the program's own run."""

import numpy as np
import pytest
import torch

from benchmark.reference import dust, nwalign

from benchmark.harness import loader

from .tiny import run_cell, with_search_metrics


@pytest.fixture
def spec_with_search(monkeypatch):
    spec = with_search_metrics(loader.benchmark_json())
    monkeypatch.setattr(loader, "benchmark_json", lambda: spec)

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _pairs(seed, n=240):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(n):
        q = rng.integers(0, 4, int(rng.integers(1, 70))).astype(np.uint8)
        if k % 3 == 0:
            t = rng.integers(0, 4, int(rng.integers(1, 70))).astype(np.uint8)
        else:
            t = q.copy()
            for _ in range(int(rng.integers(0, 7))):
                p = int(rng.integers(0, len(t)))
                r = rng.random()
                if r < 0.33 and len(t) > 1:
                    t = np.delete(t, p)
                elif r < 0.66:
                    t = np.insert(t, p, rng.integers(0, 4))
                else:
                    t[p] = (t[p] + 1) % 4
            if k % 3 == 2:
                t = np.concatenate([
                    rng.integers(0, 4, int(rng.integers(0, 9))), t,
                    rng.integers(0, 4, int(rng.integers(0, 9)))]).astype(
                        np.uint8)
        qs.append(q)
        ts.append(t)
    return qs, ts


@pytest.mark.parametrize("seed", [1, 2])
def test_alignment_matches_the_program_pair_by_pair(seed):
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops.nw import ScoreScheme, align_pair_host
    scheme = ScoreScheme.from_params(cli.parse_args(
        ["--allpairs_global", "x.fa", "--id", "0.5", "--blast6out", "o"]))
    qs, ts = _pairs(seed)
    alns = nwalign.align_codes(nwalign.Scheme(), qs, ts, "cpu", batch=96)
    for q, t, a in zip(qs, ts, alns):
        r = align_pair_host(scheme, ACGT[q].tobytes(), ACGT[t].tobytes())
        f = nwalign.hit_fields(a)
        assert (a.score, a.cigar, f.aligned, f.matches, f.mismatches,
                f.gaps) == (r.score, r.cigar, r.aligned, r.matches,
                            r.mismatches, r.gaps)


def test_dust_matches_the_program():
    from vsearch_tpu_torch.core import mask
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (150, 300)).astype(np.uint8)
    for s in range(150):
        for _ in range(int(rng.integers(0, 4))):
            p, n = int(rng.integers(0, 270)), int(rng.integers(4, 30))
            unit = rng.integers(0, 4, int(rng.integers(1, 4)))
            codes[s, p:p + n] = np.tile(unit, n)[:n]
    got = dust.mask(torch.from_numpy(codes), chunk=64).numpy()
    masked = 0
    for s in range(150):
        out = mask.dust_mask(ACGT[codes[s]].tobytes(), False)
        want = np.frombuffer(out, np.uint8) >= ord("a")
        masked += int(want.any())
        assert np.array_equal(got[s], want), s
    assert masked > 50


def test_saturating_control_differs():
    """Scores in saturating 8-bit lanes change the alignment of 400 nt
    pairs: the control cannot pass for the reference."""
    rng = np.random.default_rng(9)
    q = [rng.integers(0, 4, 400).astype(np.uint8) for _ in range(8)]
    t = [x.copy() for x in q]
    exact = nwalign.align_codes(nwalign.Scheme(), q, t, "cpu")
    low = nwalign.align_codes(nwalign.Scheme(), q, t, "cpu",
                              saturate=(-128, 127))
    assert all(a.score == 800 for a in exact)
    assert all(b.score != a.score for a, b in zip(exact, low))


@pytest.mark.parametrize("workload,seed", [
    ("allpairs_v34.related", 5), ("allpairs_v34.related", 2 ** 33 + 1),
    ("search_otutab.novel50", 5), ("search_otutab.novel50", 2 ** 33 + 1)])
def test_cell_correct_against_the_reference(capsys, spec_with_search,
                                            workload, seed):
    rc, res = run_cell(capsys, workload, seed)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    rate = {"allpairs_v34.related": "pairs_per_s",
            "search_otutab.novel50": "queries_per_s"}[workload]
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", ["allpairs_v34.related",
                                      "search_otutab.novel50"])
def test_traced_run_reports_per_layer_metrics(capsys, spec_with_search,
                                              workload):
    rc, res = run_cell(capsys, workload, 8, trace=1)
    assert rc == 0 and res["correct"]
    assert "breakdown" in res and "window_s" in res["device"]
    # on the CPU nothing runs on a card: only the host phase readers speak
    host = {"allpairs_v34.related": {"host_ms_per_mpair.allpairs"},
            "search_otutab.novel50": {"walk_ms_per_kread.search",
                                      "front_ms_per_kread.search"}}
    assert set(res["metrics"]) == host[workload]
