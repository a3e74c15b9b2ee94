#!/usr/bin/env python3
"""Time variants of the K6 kernel source against the shipped build.

    python3 tools/tune_wavefront.py [--baseline OTHER/nw_wavefront.cu ...]

Needs one CUDA device and nvcc; imports nothing of jax.  Each variant is
vsearch_tpu_torch/csrc/nw_wavefront.cu with one edit (VARIANTS below: the
warps a pair and the steps between two block barriers); each --baseline
adds another nw_wavefront.cu with the same C interface (for example a
parent commit's, unpacked with git archive), named by its directory.  All
are built by nvcc with the port's flags into the git-ignored
build/vsearch_tpu_torch/tune_wavefront/ by tools/tune_backtrack.py's
build_all.  The inputs are chip_smoke.py's, under
--mismatch -200: the search prefetch's top-1 pairs (B=512, M=N=640), a
walk round's (the first 128 of them) and the cluster round's top-1 pairs
(B=512, M=N=512).  Every build's score, overflow and whole plane must
equal the plain version's, on a plane filled with 0xAB before the launch
so that a byte left unwritten shows.  Each is timed in the order shipped,
variants, variants reversed, shipped: warm (repeated on one set of
inputs) and cold (after 256 MB of writes have flushed L2).  Beside them, a
clocked build of the shipped source says where a pair's cycles went: its
block's cycles, its first warp's cycles waiting at the block barriers, the
super-steps and the chunks that warp computed.  The last line of the
output is one JSON object with the card, ptxas's register counts and
every number.
"""

import argparse
import ctypes
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tune_backtrack import (build_all, clock_summary, cold_ms,  # noqa: E402
                            variant_sources)

WARPS = "#define K6_WARPS 8"
CHUNK = "#define K6_CHUNK 32"
# name -> (what it changes, [(old, new), ...])
VARIANTS = {
    "warps4": ("4 warps a pair", [(WARPS, "#define K6_WARPS 4")]),
    "warps16": ("16 warps a pair", [(WARPS, "#define K6_WARPS 16")]),
    "chunk16": ("a block barrier every 16 steps, bands 3 chunks apart",
                [(CHUNK, "#define K6_CHUNK 16")]),
    "chunk64": ("a block barrier every 64 steps, bands 2 chunks apart",
                [(CHUNK, "#define K6_CHUNK 64")]),
}

# the shipped kernel with per-pair clocks: the block's cycles, warp 0's
# cycles at the block barriers, the super-steps, warp 0's chunks, the
# block's start and end on the global timer (ns) and the SM; read back by
# k6_probe_read
CLOCK_EDITS = [
    ("__global__ void __launch_bounds__(LANES * W, 32 / W)\n"
     "nw_wavefront_kernel(",
     "__device__ long long k6_probe[8 * 8192];\n"
     "__global__ void __launch_bounds__(LANES * W, 32 / W)\n"
     "nw_wavefront_kernel("),
    ("    const int lane = threadIdx.x % LANES;\n",
     "    const int lane = threadIdx.x % LANES;\n"
     "    const long long k6_c0 = clock64();\n"
     "    unsigned long long k6_g0;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k6_g0));\n"
     "    long long k6_wait = 0;\n"
     "    int k6_chunks = 0;\n"),
    ("            // lane 0's row above and every lane's target codes, one "
     "chunk\n",
     "            ++k6_chunks;\n"
     "            // lane 0's row above and every lane's target codes, one "
     "chunk\n"),
    ("        __syncthreads();\n    }\n\n    for (int off = 16",
     "        const long long k6_b0 = clock64();\n"
     "        __syncthreads();\n"
     "        k6_wait += clock64() - k6_b0;\n    }\n\n    for (int off = 16"),
    ("        over_out[b] = hmin <= sc.score_min || hmax >= SHRT_MAX_;\n",
     "        over_out[b] = hmin <= sc.score_min || hmax >= SHRT_MAX_;\n"
     "        unsigned long long k6_g1;\n"
     "        asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k6_g1));\n"
     "        unsigned k6_sm;\n"
     "        asm(\"mov.u32 %0, %%smid;\" : \"=r\"(k6_sm));\n"
     "        if (b < 8192) {\n"
     "            long long* q = k6_probe + 8 * b;\n"
     "            q[0] = 0;\n"
     "            q[1] = clock64() - k6_c0;\n"
     "            q[2] = k6_wait;\n"
     "            q[3] = T;\n"
     "            q[4] = k6_chunks;\n"
     "            q[5] = (long long)k6_g0;\n"
     "            q[6] = (long long)k6_g1;\n"
     "            q[7] = k6_sm;\n"
     "        }\n"),
]
CLOCK_READ = """
extern "C" int k6_probe_read(void* dst, int n)
{
    return (int)cudaMemcpyFromSymbol(dst, k6_probe,
                                     (size_t)n * 8 * sizeof(long long));
}
"""
# clock_summary's K3 field names, as this probe fills them
CLOCK_NAMES = {"walk": "pair", "fetch": "wait", "rounds": "supersteps",
               "entries": "chunks", "entry": "chunk"}


def shapes():
    """{tag: (scheme key, K6's inputs (q4, qlen, t4, tlen))} at
    chip_smoke.py's three K6 shapes, under --mismatch -200."""
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import nw_batch
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    cs = chip_smoke
    dev = device.select("cuda")
    cs.WORK.mkdir(parents=True, exist_ok=True)
    db_path, q_path = cs.generate(cs.WORK)
    ctx, qseqs, _, Kbits = cs.search_chunk(db_path, q_path)
    args, p = cs.search_prefetch_args(ctx, qseqs, Kbits)
    codes = cs.search_codes_args(ctx, qseqs, args, p)
    key = cs.mismatch_200_key(ctx.aligner._key)
    walk_b = nw_batch.BatchAligner.PAIR_BUCKETS[0]
    out = {"search": (key, codes),
           "walk": (key, tuple(a[:walk_b].contiguous() for a in codes))}
    amp = cs.generate_amp(cs.WORK / "amp100k.fasta")
    params, g, qseqs, klists, Kbits = cs.cluster_round(amp)
    _, _, idx, (qmT, _, qlen) = cs.cluster_prefetch_args(
        params, g, qseqs, klists, Kbits)
    key = nw_batch.BatchAligner(ScoreScheme.from_params(params), dev)._key
    out["cluster"] = (cs.mismatch_200_key(key), cs.cluster_codes_args(
        g, qseqs, idx, qlen, qmT.shape[0]))
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, action="append",
                    default=[],
                    help="another nw_wavefront.cu to time beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_wavefront: no CUDA device", file=sys.stderr)
        return 1
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import cuda_lib, nw_wavefront
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    cs = chip_smoke
    gpu = cs.card()
    src = (cuda_lib.CSRC / "nw_wavefront.cu").read_text()
    sources = variant_sources(src, VARIANTS, CLOCK_EDITS, CLOCK_READ)
    for path in opts.baseline:
        sources[path.resolve().parent.name] = path.read_text()
    built = build_all(sources, cuda_lib.BUILD_DIR / "tune_wavefront")
    clocks = built.pop("clocks")[0]
    libs = {name: lib for name, (lib, _) in built.items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in list(libs.values()) + [clocks]:
        lib.nw_wavefront_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p,
                                            p, p, p]
    dev = device.select("cuda")
    stream = cuda_lib.stream_ptr(dev)
    result = {"card": gpu,
              "registers": {n: r for n, (_, r) in built.items()},
              "variants": {k: v[0] for k, v in VARIANTS.items()}}

    for tag, (key, args) in shapes().items():
        q4, qlen, t4, tlen = args
        B, M = q4.shape
        N = t4.shape[1]
        Ms = nw_wavefront.lane_stride(M)
        score_min = ScoreScheme(*key[:14], bool(key[14])).score_min()
        ref = nw_wavefront.forward_plain(key, score_min, *args)
        score = torch.empty(B, dtype=torch.int32, device=dev)
        over = torch.empty(B, dtype=torch.bool, device=dev)
        dirs = torch.empty((M + N - 1, B, Ms), dtype=torch.uint8, device=dev)
        params = (ctypes.c_int * 16)(*key, score_min)

        def k6(lib):
            # at these shapes every build keeps its rows in shared memory
            cs.require(lib.nw_wavefront_launch(
                q4.data_ptr(), qlen.data_ptr(), t4.data_ptr(),
                tlen.data_ptr(), M, N, B, Ms, params, score.data_ptr(),
                over.data_ptr(), dirs.data_ptr(), None, stream) == 0,
                "K6 launch")

        def check(lib, name):
            dirs.fill_(0xAB)
            k6(lib)
            cs.require(all(torch.equal(a, b) for a, b in
                           zip((score, over, dirs), ref)),
                       "%s differs from the plain version (%s)"
                       % (name, tag))

        times = {}
        order = list(libs) + list(reversed(list(libs)))
        for name in order:
            lib = libs[name]
            check(lib, name)
            t = times.setdefault(name, {"warm": [], "cold": []})
            t["warm"].append(cs.timed(lambda: k6(lib), 10))
            t["cold"].append(cold_ms(lambda: k6(lib), dev, 5))
        check(clocks, "clocks")
        torch.cuda.synchronize()
        summary = clock_summary(clocks, B, "k6", CLOCK_NAMES)
        result[tag + "_clocks"] = summary
        print(json.dumps({tag + "_clocks": summary}), flush=True)
        valid = int((qlen.clamp(0, M).to(torch.int64)
                     * tlen.clamp(0, N).to(torch.int64)).sum())
        result[tag] = {"B": B, "M": M, "N": N, "cells": valid,
                       "plane_bytes": dirs.numel(), "ms": times}
        print(json.dumps({tag: result[tag]}), flush=True)
        del dirs, ref
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
