"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up: load the cell's files by name, generate its inputs from the seed
into a new directory under $TMPDIR, and run one warm job (it builds the
kernels on a checkout's first run).  ``setup_s`` runs from the start of
this script to the end of that job.  The window: jobs back to back, each
a call of ``vsearch_tpu_torch.cli.main`` on the card, until ``--seconds``
have passed; the window ends with the job that crosses it.  The rate is
the work of all the window's jobs over the window.  With ``--trace 1`` the
window runs under torch.profiler with the program's phase timers on, and
the cell's per-layer metrics are printed instead of its end-to-end ones;
with the phase timers on (``--trace 1``, or VSEARCH_TPU_PHASES=1 in the
environment) each job's phase times go to stderr.
Then the judge compares what the window's jobs wrote with the plain
reference, prints each number compared beside its limit on stderr, and
the last line of stdout is the result as JSON.

Without a card (or fewer than the cell asks for) the run fails and prints
no result; it never falls back to the CPU.  The kernels build into
``build/`` of the checkout, so later runs there reuse them.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import importcheck, loader  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""
    cell: dict
    config: dict
    work: int                      # units of the window's jobs
    jobs: int                      # the window's completed jobs
    dp_cells: Optional[int]        # DP cells the window's jobs need
    trace: object                  # harness.trace.Summary
    phases: Dict[str, float]       # the program's phase timers, seconds
    sms: int
    clock_hz: Optional[float]


def _env(cfg: dict) -> None:
    """Threads and the caches of every compiler, fixed inside the
    checkout, before torch or the program load.  torch's host thread pool
    takes the config's ``--threads``."""
    argv = list(cfg["argv"])
    os.environ["OMP_NUM_THREADS"] = argv[argv.index("--threads") + 1]
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def _parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, device: Optional[str] = None,
         overrides: Optional[dict] = None) -> int:
    """Run a cell.  ``device="cpu"`` (tests only) skips the look for a card
    and runs the program's plain versions; ``overrides`` merges into the
    cell and config (tests run tiny sizes)."""
    args = _parse(argv)
    spec = loader.benchmark_json() or {}
    cell, cfg = loader.resolve(args.workload, overrides)
    chips = next((int(w.get("chips", 1)) for w in spec.get("workloads", [])
                  if w.get("name") == args.workload), 1)
    _env(cfg)

    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark measures the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print("the cell needs %d cards, found %d"
                  % (chips, torch.cuda.device_count()), file=sys.stderr)
            return 2
        device = "cuda"
    on_card = device == "cuda"

    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib
    from vsearch_tpu_torch.utils import phasetimer

    entry_mod = loader.entry(cfg["entry"])
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="vsbench-"))
    try:
        return _run(args, cell, cfg, spec, entry_mod, workdir, device,
                    on_card, chips, torch, cli, cuda_lib, phasetimer)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _sync(torch, on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def _run(args, cell, cfg, spec, entry_mod, workdir, device, on_card, chips,
         torch, cli, cuda_lib, phasetimer) -> int:
    from torch.profiler import ProfilerActivity, profile, record_function
    entry = entry_mod.Entry(cfg, cell, args.seed, workdir)

    def job(k: int) -> Tuple[int, pathlib.Path]:
        out = workdir / ("job%d.out" % k)
        with record_function("bench.job"):
            rc = cli.main(entry.argv(k, out), device=device)
            _sync(torch, on_card)
        return rc, out

    rc, _ = job(0)
    if rc != 0:
        print("the warm job failed (rc %d)" % rc, file=sys.stderr)
        return 1
    setup_s = time.time() - T_START

    outputs: Dict[int, pathlib.Path] = {}
    job_s: List[float] = []
    job_phases: List[Dict[str, float]] = []
    attempted = failed = 0
    cuda_lib.reset_launches()
    phases_env = phasetimer.ENABLED
    phasetimer.reset()
    if args.trace:
        phasetimer.ENABLED = True
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof_cm = profile(activities=acts)
    else:
        prof_cm = contextlib.nullcontext()
    k = 1
    with prof_cm as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                attempted += 1
                tj = time.perf_counter()
                try:
                    rc, out = job(k)
                except Exception as exc:     # a job that raises ends the run
                    print("job %d raised %r" % (k, exc), file=sys.stderr)
                    failed += 1
                    break
                job_s.append(time.perf_counter() - tj)
                if phasetimer.ENABLED:
                    job_phases.append(dict(phasetimer.acc))
                if rc != 0:
                    failed += 1
                else:
                    outputs[k] = out
                k += 1
                if time.perf_counter() - t0 >= args.seconds:
                    break
            window_s = time.perf_counter() - t0
    phasetimer.ENABLED = phases_env
    work = sum(entry.work(j) for j in outputs)
    plain_calls = sum(cuda_lib.PLAIN_CALLS.values())
    memory_peak = (torch.cuda.max_memory_allocated() if on_card else 0)

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": chips if on_card else 0,
                   "memory_peak_bytes": memory_peak}
    breakdown = None
    t_read = time.perf_counter()
    if args.trace:
        from benchmark.harness import peaks, trace
        summary = (trace.from_profiler(prof) if on_card else
                   trace.Summary(0.0, window_s, {}, {}))
        props = torch.cuda.get_device_properties(0) if on_card else None
        ctx = Context(cell, cfg, work, len(outputs),
                      sum(entry.dp_cells(j) for j in outputs)
                      if hasattr(entry, "dp_cells") else None,
                      summary, dict(phasetimer.acc),
                      props.multi_processor_count if props else 0,
                      peaks.max_sm_clock_hz() if on_card else None)
        for name, m in loader.per_layer(args.workload, spec).items():
            try:
                reader = loader.metric(name)
            except KeyError:
                continue
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        breakdown = summary.breakdown()
        del prof
    else:
        e2e = loader.end_to_end(args.workload, spec)
        rate_name = cfg["rate_metric"]
        if rate_name in e2e:
            metrics[rate_name] = {"value": work / window_s,
                                  "unit": e2e[rate_name]["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # the judge, once the window's numbers are read and its state freed
    import gc
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = entry.judge(outputs, args.seed, device)
    print("timing: setup %.3f s, window %.3f s of %d jobs, trace read "
          "%.3f s, judge %.3f s" % (setup_s, window_s, attempted,
                                   t_judge - t_read,
                                   time.perf_counter() - t_judge),
          file=sys.stderr)
    print("jobs: %s s" % " ".join("%.3f" % x for x in job_s), file=sys.stderr)
    before: Dict[str, float] = {}
    for n, acc in enumerate(job_phases, 1):
        print("job %d phases: %s" % (n, " ".join(
            "%s %.3f" % (p, acc[p] - before.get(p, 0.0)) for p in sorted(acc))),
            file=sys.stderr)
        before = acc
    if on_card:
        checks.append(("plain_calls", plain_calls, 0))
    correct = (bool(outputs) and failed == 0
               and all(v <= lim for _, v, lim in checks))

    bad = importcheck.loaded()
    if bad:
        print("forbidden modules loaded: %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print("check %s: %s (limit %s)" % (name, value, limit),
              file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
