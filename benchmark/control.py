"""The control of a cell's comparison: the plain reference in the program's
place, computed in the precision below the one the configuration states.

vsearch's aligner keeps its scores in 16-bit lanes with overflow detection
(a pair that would overflow is aligned again in full width), so the scores
are exact; the control keeps them in saturating 8-bit lanes.  For each
seed it builds the cell's inputs at the cell's own size, has the cell's
entry write the output files of ``--jobs`` window jobs as the reference
would write them in the program's place (``Entry.control_outputs``),
and hands them to the entry's own ``judge``, as a run hands it the jobs'
files.  It prints the judge's numbers and ``correct`` for the control
(which must come out false) and for the exact reference (true).  The
benchmark's runs never run it:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--jobs n]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import loader  # noqa: E402

INT8 = (-128, 127)


def reading(workload: str, seed: int, device, jobs: int = 16,
            overrides=None) -> dict:
    """The judge's numbers, and whether they pass, for the exact
    reference and for the control, on one seed."""
    cell, cfg = loader.resolve(workload, overrides)
    out = {"seed": seed, "workload": workload, "jobs": jobs}
    with tempfile.TemporaryDirectory(prefix="vsbench-control-") as tmp:
        tmp = pathlib.Path(tmp)
        entry = loader.entry(cfg["entry"]).Entry(cfg, cell, seed, tmp)
        for name, saturate in (("exact", None), ("control", INT8)):
            outputs = entry.control_outputs(list(range(1, jobs + 1)), seed,
                                            tmp / name, device, saturate)
            checks = entry.judge(outputs, seed, device)
            out[name] = {"correct": all(v <= lim for _, v, lim in checks),
                         "checks": {n: v for n, v, _ in checks}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--jobs", type=int, default=16,
                    help="jobs of a window whose outputs are judged")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(reading(args.workload, seed, "cuda", args.jobs)))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
