"""The readers of the program's spans and counters: self times and counters
of a reset-and-filled phasetimer, on a hand-built Context."""

import pytest

from benchmark import run
from benchmark.harness import loader, trace
from vsearch_tpu_torch.utils import phasetimer

READERS = ("prep_ms_per_mpair.allpairs", "realign_us_per_pair.allpairs",
           "emit_us_per_row.allpairs", "untimed_ms_per_mpair.allpairs")


def _ctx(work):
    return run.Context(cell={}, config={}, work=work, jobs=2, dp_cells=None,
                       trace=trace.Summary(1.0, 4.0, {}, {}), phases={},
                       sms=132, clock_hz=1.98e9)


@pytest.fixture
def timer():
    phasetimer.reset()
    try:
        yield phasetimer
    finally:
        phasetimer.reset()


def test_readers_read_self_time_and_counters(timer):
    timer.self_acc.update({"cli": 0.02, "read": 0.01, "mask": 0.002,
                           "context": 0.003, "upload": 0.05,
                           "triangle": 0.015, "align": 0.6, "align_wait": 0.2,
                           "emit": 0.5, "dispatch": 1.3})
    timer.acc.update({"align": 0.8, "emit": 0.5})
    timer.tally.update({"allpairs.realigned": 30000, "allpairs.rows": 25000,
                        "allpairs.pairs": 4_000_000})
    ctx = _ctx(4_000_000)
    got = {name: loader.metric(name).read(ctx) for name in READERS}
    assert got["prep_ms_per_mpair.allpairs"] == pytest.approx(
        1e3 * 0.08 / 4)
    # align's self time, its wait for K2 + K3 left out
    assert got["realign_us_per_pair.allpairs"] == pytest.approx(
        1e6 * 0.6 / 30000)
    assert got["emit_us_per_row.allpairs"] == pytest.approx(1e6 * 0.5 / 25000)
    assert got["untimed_ms_per_mpair.allpairs"] == pytest.approx(
        1e3 * 0.02 / 4)


def test_readers_give_none_without_their_spans_or_counters(timer):
    ctx = _ctx(4_000_000)
    for name in READERS:
        assert loader.metric(name).read(ctx) is None, name
    # spans without their counters, and counters without their spans
    timer.self_acc.update({"align": 0.6, "emit": 0.5})
    assert loader.metric("realign_us_per_pair.allpairs").read(ctx) is None
    assert loader.metric("emit_us_per_row.allpairs").read(ctx) is None
    timer.reset()
    timer.tally.update({"allpairs.realigned": 10, "allpairs.rows": 10})
    assert loader.metric("realign_us_per_pair.allpairs").read(ctx) is None
    assert loader.metric("emit_us_per_row.allpairs").read(ctx) is None
    # spans of another command, and a window without work
    timer.self_acc.update({"walk": 1.0, "load": 2.0})
    for name in ("prep_ms_per_mpair.allpairs",
                 "untimed_ms_per_mpair.allpairs"):
        assert loader.metric(name).read(ctx) is None, name
    timer.self_acc.update({"cli": 0.1, "read": 0.1})
    for name in ("prep_ms_per_mpair.allpairs",
                 "untimed_ms_per_mpair.allpairs"):
        assert loader.metric(name).read(_ctx(0)) is None, name


def test_readers_give_none_on_a_program_without_them(timer, monkeypatch):
    """A program whose phasetimer has no self_acc or tally (the parent
    of these readers): nothing to read, nothing raised."""
    monkeypatch.delattr(phasetimer, "self_acc")
    monkeypatch.delattr(phasetimer, "tally")
    ctx = _ctx(4_000_000)
    for name in READERS:
        assert loader.metric(name).read(ctx) is None, name
