"""The idle-share, gap and roofline arithmetic on synthetic traces."""

import types

import pytest

from benchmark.harness import loader, peaks, trace


def _ctx(**kw):
    base = dict(cell={}, config={}, work=0, jobs=0, dp_cells=None,
                trace=trace.Summary(0.0, 1.0, {}, {}), phases={}, sms=132,
                clock_hz=1.98e9)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_union_idle_and_kernel_times():
    s = 1_000_000_000
    device = [(0, s // 10, "k1(int)"), (s // 20, s // 5, "k2"),
              (s // 2, s // 2 + s // 10, "k1(int)"), (2 * s, 3 * s, "late")]
    host = [(0, s, "bench.job"), (s // 5, s // 2, "aten::copy_"),
            (s // 4, s // 3, "aten::item")]
    out = trace.summarize(device, host, (0, s))
    # busy: [0, 0.2] and [0.5, 0.6]; the late op lies outside the window
    assert out.busy_s == pytest.approx(0.3)
    assert out.window_s == pytest.approx(1.0)
    assert out.kernel_s == {"k1": pytest.approx(0.2), "k2": pytest.approx(0.15)}
    # gap [0.2, 0.5]: midpoint 0.35 lies in aten::copy_ (aten::item ends at
    # 0.333); gap [0.6, 1.0] only in bench.job
    assert out.idle_by_label == {"aten::copy_": pytest.approx(0.3),
                                 "bench.job": pytest.approx(0.4)}
    b = out.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(0.2)]
    assert [g[0] for g in b["idle_gaps"]] == ["bench.job", "aten::copy_"]


def test_idle_share_reader():
    reader = loader.metric("device_idle_share.allpairs")
    assert reader.read(_ctx(trace=trace.Summary(0.25, 1.0, {}, {}))) == \
        pytest.approx(0.75)
    # nothing ran on the card: nothing to read
    assert reader.read(_ctx(trace=trace.Summary(0.0, 1.0, {}, {}))) is None


def test_roofline_counts_the_function():
    reader = loader.metric("nw_roofline.allpairs")
    cfg = loader.config("allpairs_v34")
    n, L = 2048, 400
    pairs = n * (n - 1) // 2
    ctx = _ctx(config=cfg, work=2 * pairs, jobs=2,
               dp_cells=2 * pairs * L * L,
               trace=trace.Summary(2.0, 4.0, {}, {}))
    rate = peaks.INT_LANES_PER_SM * 132 * 1.98e9 * 2      # fits 16 bits
    least = max(2 * pairs * L * L * 16 / rate,
                (2 * n * L + 2 * pairs * 36) / peaks.HBM_BPS)
    assert reader.fits16(cfg)
    assert reader.read(ctx) == pytest.approx(100.0 * least / 2.0)
    # no clock read from the card, or no busy time: no reading, never 0
    assert reader.read(_ctx(config=cfg, work=1, dp_cells=1,
                            clock_hz=None)) is None
    assert reader.read(_ctx(config=cfg, work=pairs, dp_cells=pairs * L * L,
                            trace=trace.Summary(0.0, 1.0, {}, {}))) is None


def test_per_read_and_per_pair_readers():
    walk = loader.metric("walk_ms_per_kread.search")
    front = loader.metric("front_ms_per_kread.search")
    dev = loader.metric("device_ms_per_kread.search")
    host = loader.metric("host_ms_per_mpair.allpairs")
    ctx = _ctx(work=20000, phases={"walk": 4.0, "prep": 0.5, "emit": 0.5,
                                   "dispatch": 0.25, "topk_fetch": 0.25},
               trace=trace.Summary(1.0, 8.0, {}, {}))
    assert walk.read(ctx) == pytest.approx(200.0)
    assert front.read(ctx) == pytest.approx(75.0)
    assert dev.read(ctx) == pytest.approx(50.0)
    ap = _ctx(work=2_000_000, phases={"accept": 0.5, "stats_fetch": 0.1,
                                      "dispatch": 0.7})
    assert host.read(ap) == pytest.approx(300.0)
    assert walk.read(_ctx(work=100)) is None


def test_trace_of_a_cpu_profile_finds_its_window():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_RANGE):
            torch.ones(64).sum()
    out = trace.from_profiler(prof)
    assert out.busy_s == 0.0 and out.window_s > 0
    assert sum(out.idle_by_label.values()) == pytest.approx(out.window_s)
