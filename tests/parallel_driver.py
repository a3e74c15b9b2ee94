"""One rank of a multi-process run of the port, started by torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        tests/parallel_driver.py SPEC.json

SPEC is a JSON object: "backend" and "device" for
parallel.distributed.maybe_initialize (null: from the environment),
"setup" (Python run once after the group is up, with ``rank`` and
``world`` defined), "runs" (each {"name", "cwd", "setup" (Python run
first), and "argv" for the CLI or "code", Python that sets ``result``,
and "trace": true to run it under torch.profiler on a card}) and
"report", a path prefix: each rank writes
<report>.rank<r>.json with, for each run, its rc or result, its launches
and plain calls by kernel, its collectives, the device index classes it
built, its device and seconds (with "trace" also its device's busy ms and
idle share), and whether jax or vsearch_tpu was loaded.

tests/test_torch_parallel.py runs it on the CPU (gloo) and chip_smoke.py
on one card shared by two ranks (gloo on cuda:0).  Imports nothing of jax
or vsearch_tpu.
"""

import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def count_builds():
    """Count the device indexes built, by exact class."""
    from vsearch_tpu_torch.ops.score import DeviceKmerIndex
    from vsearch_tpu_torch.ops.score_grow import (GrowingDeviceKmerIndex,
                                                  ShardedGrowingKmerIndex)
    from vsearch_tpu_torch.parallel.sharded_index import ShardedKmerIndex
    built = collections.Counter()
    for cls in (DeviceKmerIndex, ShardedKmerIndex, GrowingDeviceKmerIndex,
                ShardedGrowingKmerIndex):
        def init(self, *a, _orig=cls.__init__, _cls=cls, **k):
            if type(self) is _cls:
                built[_cls.__name__] += 1
            _orig(self, *a, **k)
        cls.__init__ = init
    return built


def traced(run):
    """run() under torch.profiler: (its result, the device's busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = run()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end_us = 0.0, float("-inf")
    for start, stop in spans:
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    return result, busy_us / 1e3


def main() -> int:
    with open(sys.argv[1]) as fh:
        spec = json.load(fh)
    from vsearch_tpu_torch.parallel import distributed
    distributed.maybe_initialize(spec.get("backend"), spec.get("device"))
    # every rank's failures show: ranks other than 0 report to the null
    # device
    sys.stderr = sys.__stderr__
    import torch
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch import device as device_mod
    from vsearch_tpu_torch.ops import cuda_lib
    from vsearch_tpu_torch.parallel import mesh
    rank = distributed.process_index()
    world = mesh.active_mesh().size if mesh.active_mesh() else 1
    built = count_builds()
    ns = {"rank": rank, "world": world}
    exec(spec.get("setup", ""), ns)
    reports = []
    for run in spec["runs"]:
        cuda_lib.reset_launches()
        mesh.reset_collectives()
        built.clear()
        os.chdir(run.get("cwd", REPO))
        exec(run.get("setup", ""), ns)

        def call(run=run):
            t0 = time.perf_counter()
            if "argv" in run:
                result = cli.main(run["argv"])
            else:
                exec(run["code"], ns)
                result = ns.get("result")
            if device_mod.current().type == "cuda":
                torch.cuda.synchronize()
            return result, time.perf_counter() - t0

        rep = {"name": run["name"]}
        if run.get("trace") and device_mod.current().type == "cuda":
            (result, seconds), busy_ms = traced(call)
            rep.update(device_busy_ms=busy_ms,
                       device_idle_share=1.0 - busy_ms / 1e3 / seconds)
        else:
            result, seconds = call()
        rep.update(result=result, seconds=seconds,
                   launches=dict(cuda_lib.LAUNCHES),
                   plain_calls=dict(cuda_lib.PLAIN_CALLS),
                   collectives=dict(mesh.COLLECTIVES), built=dict(built),
                   device=str(device_mod.current()))
        reports.append(rep)
    loaded = [m for m in sys.modules
              if m in ("jax", "vsearch_tpu")
              or m.startswith(("jax.", "vsearch_tpu."))]
    with open("%s.rank%d.json" % (spec["report"], rank), "w") as fh:
        json.dump({"rank": rank, "world": world, "runs": reports,
                   "foreign_modules": loaded}, fh)
    # the group's teardown, which exit would run, here where its failure
    # shows
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
