"""The port's phase spans and counters (vsearch_tpu_torch/utils/phasetimer).

Self time is a span's time less its children's, while ``acc`` stays
inclusive; disabled, nothing is recorded; under torch.profiler each span is
a ``vs.*`` host range nested in the range that holds it, which the
benchmark's trace summary then names as the label of an idle gap; and an
allpairs run on the CPU counts its pairs, batches, overflow, accepted and
realigned pairs and rows where the work happens.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import trace
from vsearch_tpu_torch import cli
from vsearch_tpu_torch.ops.allpairs_dev import AllPairsDevice
from vsearch_tpu_torch.utils import phasetimer


@pytest.fixture
def timer():
    saved = phasetimer.ENABLED
    phasetimer.reset()
    phasetimer.ENABLED = True
    try:
        yield phasetimer
    finally:
        phasetimer.ENABLED = saved
        phasetimer.reset()


def test_self_time_is_inclusive_time_less_children(timer):
    with timer.phase("outer"):
        time.sleep(0.02)
        with timer.phase("inner"):
            time.sleep(0.03)
        with timer.phase("inner"):
            with timer.phase("leaf"):
                time.sleep(0.01)
    acc, own = timer.acc, timer.self_acc
    assert acc["outer"] >= 0.06
    assert acc["inner"] >= 0.04 and acc["leaf"] >= 0.01
    # acc is inclusive: outer holds both inner spans, inner holds leaf
    assert acc["outer"] > acc["inner"] > acc["leaf"]
    assert own["leaf"] == pytest.approx(acc["leaf"])
    assert own["inner"] == pytest.approx(acc["inner"] - acc["leaf"])
    assert own["outer"] == pytest.approx(acc["outer"] - acc["inner"])
    assert own["outer"] >= 0.02
    # a span closed by an exception still counts, and leaves no open span
    with pytest.raises(KeyError):
        with timer.phase("raises"):
            raise KeyError("x")
    with timer.phase("after"):
        pass
    assert own["after"] == pytest.approx(acc["after"])
    assert "raises" in acc and own["outer"] == pytest.approx(
        acc["outer"] - acc["inner"])


def test_disabled_records_nothing(timer):
    timer.ENABLED = False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("cli"):
            timer.add("allpairs.pairs", 5)
    assert not timer.acc and not timer.self_acc and not timer.tally
    assert not any(e.name().startswith("vs.")
                   for e in prof.profiler.kineto_results.events())
    timer.ENABLED = True
    timer.add("allpairs.pairs", 5)
    timer.add("allpairs.pairs", 2)
    assert timer.tally == {"allpairs.pairs": 7}
    timer.reset()
    assert not timer.tally


def test_spans_label_idle_gaps_under_the_profiler(timer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_RANGE):
            with record_function("bench.job"):
                with timer.phase("cli"):
                    time.sleep(0.005)
                    with timer.phase("accept"):
                        time.sleep(0.02)
                    time.sleep(0.005)
    spans = {e.name(): (e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()}
    w0, w1 = spans[trace.WINDOW_RANGE]
    job, cli_span, accept = (spans[n] for n in ("bench.job", "vs.cli",
                                                "vs.accept"))
    # nested: window > job > cli > accept
    for outer, inner in ((spans[trace.WINDOW_RANGE], job), (job, cli_span),
                         (cli_span, accept)):
        assert outer[0] <= inner[0] and inner[1] <= outer[1]
    host = [(s, e, n) for n, (s, e) in spans.items()
            if n != trace.WINDOW_RANGE]
    # the card busy up to accept and after it: the one idle gap is accept's
    device = [(w0, accept[0], "k1"), (accept[1], w1, "k2")]
    out = trace.summarize(device, host, (w0, w1))
    assert set(out.idle_by_label) == {"vs.accept"}
    assert out.idle_by_label["vs.accept"] == pytest.approx(
        (accept[1] - accept[0]) / 1e9)
    # the card busy through accept: the gaps lie in cli's own time
    device = [(accept[0], accept[1], "k1")]
    out = trace.summarize(device, host, (w0, w1))
    assert "bench.job" not in out.idle_by_label
    assert out.idle_by_label["vs.cli"] >= 0.008


def _related_fasta(path, n=20):
    """n sequences: half copies of one 180 nt base with a few
    substitutions, half random, so that some pairs are accepted."""
    rng = np.random.default_rng(41)
    base = rng.choice(list("ACGT"), size=180)
    with open(path, "w") as fh:
        for i in range(n):
            if i % 2 == 0:
                s = base.copy()
                idx = rng.integers(0, 180, size=int(rng.integers(3, 12)))
                s[idx] = rng.choice(list("ACGT"), size=idx.size)
            else:
                s = rng.choice(list("ACGT"), size=int(rng.integers(150, 200)))
            fh.write(">s%d\n%s\n" % (i, "".join(s)))
    return n


@pytest.mark.parametrize("scheme", [[], ["--match", "220"]],
                         ids=["default", "match_220"])
def test_allpairs_counters(timer, tmp_path, monkeypatch, scheme):
    fa = tmp_path / "set.fa"
    n = _related_fasta(fa)
    out = tmp_path / "out.b6"
    monkeypatch.setattr(AllPairsDevice, "PAIR_BATCH", 32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = cli.main(["--allpairs_global", str(fa), "--id", "0.8",
                       "--blast6out", str(out), "--userout",
                       str(tmp_path / "out.user"), "--userfields",
                       "query+target+raw", "--threads", "1", "--quiet"]
                      + scheme, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    tally = timer.tally
    pairs = n * (n - 1) // 2
    assert tally["allpairs.pairs"] == pairs
    assert tally["allpairs.batches"] == -(-pairs // 32)
    rows = len(out.read_bytes().splitlines())
    assert rows > 0 and tally["allpairs.rows"] == rows
    assert tally["allpairs.realigned"] == (tally["allpairs.accepted"]
                                           + tally["allpairs.overflow"])
    if scheme:
        # the related pairs' scores pass 16 bits
        assert tally["allpairs.overflow"] > 0
    else:
        assert tally["allpairs.overflow"] == 0
        assert tally["allpairs.accepted"] == rows
    # every span of the job ran, each inside cli
    for name in ("cli", "read", "mask", "context", "upload", "triangle",
                 "dispatch", "stats_fetch", "accept", "collect", "align",
                 "emit", "close"):
        assert timer.acc[name] > 0, name
        assert 0 <= timer.self_acc[name] <= timer.acc[name] + 1e-9, name
    assert timer.acc["cli"] >= max(v for k, v in timer.acc.items()
                                   if k != "cli")
    assert sum(timer.self_acc.values()) == pytest.approx(timer.acc["cli"])
