"""A run whose timed path is broken underneath reports correct false:
the harness's look for a card is skipped (CPU, tiny sizes), the rest of a
run is driven as it is, and the program is broken where it produces its
answers."""

import numpy as np
import pytest

from .tiny import run_cell

CELLS = ["allpairs_v34.related", "search_otutab.novel50"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(capsys, workload):
    rc, res = run_cell(capsys, workload, 21)
    assert rc == 0 and res["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_is_caught(capsys, monkeypatch, workload):
    """Every identity written is 0.1 off."""
    from vsearch_tpu_torch.core import results
    orig = results._fmt1
    monkeypatch.setattr(results, "_fmt1", lambda x: orig(x + 0.1))
    rc, res = run_cell(capsys, workload, 21)
    assert rc == 0 and res["correct"] is False


def test_half_the_pairs_left_out_is_caught(capsys, monkeypatch):
    """The allpairs pipeline aligns the first half of its pairs and
    returns the second half's stats as zeros (never reported)."""
    from vsearch_tpu_torch.ops.allpairs_dev import AllPairsDevice
    orig = AllPairsDevice.run

    def half(self, qpos, tpos):
        h = len(qpos) // 2
        over, stats = orig(self, qpos[:h], tpos[:h])
        rest = len(qpos) - h
        return (np.concatenate([over, np.zeros(rest, bool)]),
                np.concatenate([stats, np.zeros((rest, 8), stats.dtype)]))

    monkeypatch.setattr(AllPairsDevice, "run", half)
    rc, res = run_cell(capsys, "allpairs_v34.related", 21)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["wrong_pairs"]["value"] > 0


def test_half_the_reads_left_out_is_caught(capsys, monkeypatch):
    """The search walks the first half of each batch of reads and leaves
    the other half without hits."""
    from vsearch_tpu_torch.core.search import SearchContext
    orig = SearchContext._run_walks

    def half(self, units, cand_lists, prefetched):
        h = len(units) // 2
        cand_lists = list(cand_lists[:h]) + [[] for _ in cand_lists[h:]]
        return orig(self, units, cand_lists, prefetched)

    monkeypatch.setattr(SearchContext, "_run_walks", half)
    rc, res = run_cell(capsys, "search_otutab.novel50", 21)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["wrong_lines"]["value"] > 0


def test_failed_job_is_not_correct(capsys, monkeypatch):
    """A job that fails in the window makes the run not correct."""
    from vsearch_tpu_torch import cli
    orig = cli.main
    calls = []

    def flaky(argv, device=None):
        calls.append(1)
        return 1 if len(calls) == 2 else orig(argv, device=device)

    monkeypatch.setattr(cli, "main", flaky)
    rc, res = run_cell(capsys, "allpairs_v34.related", 21)
    assert rc == 0 and res["correct"] is False and res["failed"] == 1
