#!/usr/bin/env python3
"""The port's sharded path across the cards of one node, over nccl.

    python3 tools/multicard.py [--ranks 4]

chip_smoke.py's sharded phase runs two ranks on one card over gloo, which
shows function, not scaling.  This runs chip_smoke.py's full-width search
(after a warm-up), chimera and clustering cells first in one process on
cuda:0, each under torch.profiler, then through the same sharded phase
(chip_smoke.phase_sharded) at --ranks ranks with nothing named, so that
each rank takes cuda:LOCAL_RANK and nccl.  That phase holds every rank's
outputs byte-equal to the single process's and requires the path's
kernels and collectives in every rank.  Prints each run's seconds,
launches, collectives and idle share, by rank, with the cards' names and
power limits.  Needs --ranks cards.
"""

import argparse
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

# chip_smoke.sharded_runs's full-width cells
CELLS = ("sharded_usearch_global", "sharded_uchime3_denovo",
         "sharded_cluster_size")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < args.ranks:
        print("multicard: %d CUDA devices, %d ranks asked"
              % (torch.cuda.device_count(), args.ranks), file=sys.stderr)
        return 1
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    cuda_lib.build()
    cs.WORK.mkdir(parents=True, exist_ok=True)
    db_path, q_path = cs.generate(cs.WORK)
    runs = cs.sharded_runs(
        db_path, q_path, cs.generate_amp(cs.WORK / "amp100k.fasta"),
        cs.generate_amp(cs.WORK / "amp50k.fasta",
                        families=cs.CHIM_FAMILIES), *[None] * 4)
    runs = {name: runs[name] for name in CELLS}
    cs.emit({"phase": "setup", "seconds": time.perf_counter() - t0,
             "cards": cards})
    for name, (argv, outs, _, _, _) in runs.items():
        # the single process writes the outputs the ranks are held to
        single = [str(outs.get(pathlib.Path(a), a)) for a in argv]

        def run(single=single):
            t = time.perf_counter()
            rc = cli.main(single, device="cuda:0")
            torch.cuda.synchronize()
            cs.require(rc == 0, "the single-process run failed")
            return time.perf_counter() - t

        if name in cs.SHARDED_WARM:
            run()
        cs.emit(dict({"phase": "single", "run": name}, **cs.trace(run),
                     cards=cards))
    cs.phase_sharded(cards, runs, ranks=args.ranks, shared_card=False)
    cs.emit({"phase": "total", "seconds": time.perf_counter() - t0,
             "cards": cards})
    return 0


if __name__ == "__main__":
    sys.exit(main())
