#!/usr/bin/env python3
"""K2m's 16-bit body: its SASS, and the allpairs cell's pair batch.

    python3 tools/tune_rowscan16.py [--skip-cell] [--sass-out FILE]

Needs one CUDA device and nvcc; imports nothing of jax.  What
chip_smoke.py does not do: builds vsearch_tpu_torch/csrc/nw_rowscan.cu
as shipped and prints ptxas's registers and spills for K2m's 16-bit body
(nw_rowscan_mr16_kernel) and an opcode count of its SASS (cuobjdump):
which instructions the 16x2 DPX forms became.  Then, on chip_smoke.py's
allpairs inputs (the triangle's first pairs of the allpairs_2000 cell,
M=N=400), the 16-bit body at a batch of 4096 and of 8192 pairs, each
equal to the 32-bit body there, timed in turns (4096, 8192, 8192, 4096);
and, unless --skip-cell, the whole cell through the CLI, after a warm-up
run, with AllPairsDevice.PAIR_BATCH at 4096 and at 8192, in turns, with
K2m's launches and every blast6 byte-equal.  The last line of the output
is one JSON object with the card and every number.
"""

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

BATCHES = (4096, 8192)


def sass_counts(so: pathlib.Path, out_path=None) -> dict:
    """Opcode counts of each nw_rowscan_mr16_kernel instantiation in a
    built library; with out_path, its SASS is written there too."""
    from vsearch_tpu_torch.ops import cuda_lib
    cuobjdump = pathlib.Path(cuda_lib._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out, name, lines = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1) if "mr16" in m.group(1) else None
            if name:
                out[name] = collections.Counter()
        if name:
            lines.append(line)
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                     r"(\.[A-Z0-9_.x]+)?", line)
        if name and m and m.group(2) != "NOP":
            out[name][m.group(2) + (m.group(3) or "")] += 1
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text("\n".join(lines) + "\n")
    return {k: dict(v.most_common()) for k, v in out.items()}


def main() -> int:
    import numpy as np
    import torch
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import allpairs_dev, cuda_lib, nw_batch
    from vsearch_tpu_torch.ops import nw_rowscan
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-cell", action="store_true")
    parser.add_argument("--sass-out", type=pathlib.Path, default=None,
                        help="also write the 16-bit body's SASS here")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_rowscan16: no CUDA device", file=sys.stderr)
        return 1
    gpu = chip_smoke.card()
    record = {"card": gpu}
    built = cuda_lib.build(["nw_rowscan_mr16"], force=True)
    ptxas, fn = {}, None
    for line in built["nw_rowscan"]["ptxas"].splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "mr16" in fn and ("registers" in line or "spill" in line):
            ptxas.setdefault(fn, []).append(line.strip())
    record["ptxas"] = ptxas
    record["sass"] = sass_counts(cuda_lib.so_path("nw_rowscan"),
                                 opts.sass_out)
    for k, v in record["sass"].items():
        print("sass", k, json.dumps(v), flush=True)

    chip_smoke.WORK.mkdir(parents=True, exist_ok=True)
    ap_path = chip_smoke.generate_ap(chip_smoke.WORK / "ap2000.fasta")
    ap, scheme, _ = chip_smoke.allpairs_first_batch(ap_path)
    key = tuple(int(v) for v in nw_batch.BatchAligner(scheme, ap.device)._key)
    W = ap.W
    qpos, tpos = np.triu_indices(chip_smoke.AP_SEQS, 1)
    calls = {}
    for B in BATCHES:
        a = ap.batch_wire(torch.from_numpy(qpos[:B]).to(ap.device),
                          torch.from_numpy(tpos[:B]).to(ap.device))
        planes = (torch.empty((W, W, B), dtype=torch.uint16,
                              device=ap.device),
                  torch.empty((W, W, B), dtype=torch.uint8, device=ap.device))

        def call(body, a=a, planes=planes):
            return nw_rowscan._forward(key, a[0], a[1], a[3], a[4], a[5],
                                       a[2], planes, _body=body)
        got = [t.clone() for t in call("nw_rowscan_mr16")]
        ref = call("nw_rowscan_mr")
        torch.cuda.synchronize()
        chip_smoke.require(all(chip_smoke.max_abs_err(x, y) == 0
                               for x, y in zip(got, ref)),
                           "K2m's bodies differ at B=%d" % B)
        del got, ref
        calls[B] = call
    turns = {B: [] for B in BATCHES}
    for B in BATCHES + BATCHES[::-1]:
        turns[B].append(chip_smoke.timed(
            lambda: calls[B]("nw_rowscan_mr16"), 3))
    record["mr16"] = {B: {"ms": sum(t) / len(t), "ms_turns": t,
                          "us_per_pair": 1e3 * sum(t) / len(t) / B}
                      for B, t in turns.items()}
    print(json.dumps({"mr16": record["mr16"], "card": gpu}), flush=True)
    del calls
    torch.cuda.empty_cache()

    if not opts.skip_cell:
        cell, first = {}, None
        for n, B in enumerate(BATCHES[:1] + BATCHES + BATCHES[::-1]):
            allpairs_dev.AllPairsDevice.PAIR_BATCH = B
            cuda_lib.reset_launches()
            out = chip_smoke.WORK / ("tune_ap_%d.b6" % B)
            t0 = time.perf_counter()
            rc = cli.main(["--allpairs_global", str(ap_path), "--blast6out",
                           str(out)] + chip_smoke.AP_ARGS, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            chip_smoke.require(rc == 0, "allpairs_global failed")
            blast6 = out.read_bytes()
            first = blast6 if first is None else first
            chip_smoke.require(blast6 == first, "blast6 differs at %d" % B)
            if n == 0:
                # the warm-up: the process's first run of the cell
                cell["warm_up_seconds"] = seconds
                continue
            cell.setdefault(B, []).append(
                {"seconds": seconds,
                 "launches": {k: cuda_lib.LAUNCHES[k]
                              for k in chip_smoke.K2M_BODIES
                              + ("nw_stats",)}})
            print(json.dumps({"pair_batch": B, **cell[B][-1], "card": gpu}),
                  flush=True)
        allpairs_dev.AllPairsDevice.PAIR_BATCH = BATCHES[0]
        record["cell"] = cell
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
