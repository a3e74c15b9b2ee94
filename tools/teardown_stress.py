"""Launch many short multi-rank gloo runs of the port and count the
launches that fail, to show a fault of the process group's start or
teardown that strikes one run in several.

Each launch is ``torch.distributed.run --standalone`` of a rank program
that forms the group through ``parallel.distributed.maybe_initialize``,
all-gathers through the port's mesh ``--gathers`` times and exits; rank 0
waits 50 ms first, so the ranks leave at different moments.  Launches
run ``--parallel`` at a time, on the CPU:

    python3 tools/teardown_stress.py [--repo DIR] [--launches 96]
        [--ranks 4] [--parallel 4]

``--repo`` names the checkout whose ``vsearch_tpu_torch`` the ranks
import (another commit unpacked with ``git archive``, to compare two).
Prints one JSON line: launches, failures, and each failed launch's rank
exit codes and whether a rank printed "terminate called".  Exits 1 when
a launch failed.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent.parent

RANK = """
import sys, time
sys.path.insert(0, %r)
import torch
from vsearch_tpu_torch.parallel import distributed, mesh
distributed.maybe_initialize()
m = mesh.active_mesh()
for _ in range(%d):
    m.all_gather(torch.arange(4, dtype=torch.int32) + m.rank)
if m.rank == 0:
    time.sleep(0.05)
"""


def launch(script: str, ranks: int, cwd: str) -> dict:
    env = dict(os.environ, VSEARCH_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(ranks), script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)
    codes = [int(line.split("exitcode")[1].split(":")[1].split()[0])
             for line in proc.stderr.splitlines()
             if line.strip().startswith("exitcode")]
    return {"rc": proc.returncode, "rank_exit_codes": codes,
            "terminate": "terminate called" in proc.stderr}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO))
    ap.add_argument("--launches", type=int, default=96)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--gathers", type=int, default=20)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "rank.py")
        with open(script, "w") as fh:
            fh.write(RANK % (os.path.abspath(args.repo), args.gathers))
        with ThreadPoolExecutor(args.parallel) as pool:
            results = list(pool.map(
                lambda _: launch(script, args.ranks, d),
                range(args.launches)))
    failed = [r for r in results if r["rc"] != 0]
    print(json.dumps({"repo": os.path.abspath(args.repo),
                      "launches": len(results), "ranks": args.ranks,
                      "parallel": args.parallel, "failures": len(failed),
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
