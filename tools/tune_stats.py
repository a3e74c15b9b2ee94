#!/usr/bin/env python3
"""Time variants of the K5 kernel source against the shipped build.

    python3 tools/tune_stats.py [--baseline OTHER/nw_stats.cu ...]

Needs one CUDA device and nvcc; imports nothing of jax.  Each variant is
vsearch_tpu_torch/csrc/nw_stats.cu with one edit (VARIANTS below); each
--baseline adds another nw_stats.cu with the same C interface (for
example a parent commit's, unpacked with git archive), named by its
directory.  All are built by nvcc with the port's flags into the
git-ignored build/vsearch_tpu_torch/tune_stats/.  The input is
chip_smoke.py's: K2m's planes of the allpairs cell's first batch
(B=4096, M=N=400), and of its tail (the last 152 pairs of the triangle).
Every build's stats must equal the plain version's.  Each is timed three
ways, in the order shipped, variants, variants reversed, shipped: warm
(repeated on one pair of planes, its walked cells staying in L2), right
after a fresh K2m launch wrote the planes (as the pipeline runs it), and
cold (after 256 MB of writes have flushed L2).  Beside them: the entries
a lane (max, mean), the windows a lane fetches at each variant's span,
and a clocked build of the shipped source that says where the slowest
pair's cycles went (window fetches, walk) right after K2m.  The last line
of the output is one JSON object with the card, ptxas's register counts
and every number.
"""

import argparse
import ctypes
import json
import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tune_backtrack import (build_all, clock_summary, cold_ms,  # noqa: E402
                            variant_sources)

SPAN = "#define K5_SPAN 7"
PAIRS = "#define K5_PAIRS 4"
# design (a) of the match count: mr of every window cell loaded in the
# same round as dirs and kept beside the transition word (a uint2 slot),
# added on the walk's diagonal entries; nothing deferred
MR_TABLE = [
    ("__shared__ uint32_t tab[", "__shared__ uint2 tab["),
    ("uint32_t* my = tab[w];", "uint2* my = tab[w];"),
    ("                v[u] = __ldcs(dirs + idx);\n",
     "                v[u] = __ldcs(dirs + idx), m[u] = __ldcs(mr + idx);\n"),
    ("my[st * K5_CELLS + k] = word;",
     "my[st * K5_CELLS + k] = make_uint2(word, op == OP_M ? m[u] : 0);"),
    ("        for (int u = 0; u < K5_PER_LANE; ++u) lane_matches += m[u];\n",
     ""),
    ("            e = my[slot];\n"
     "            if ((e & 3) == OP_M) {\n"
     "                const int k = slot % K5_CELLS;\n"
     "                if ((k & 31) == lane) owed |= 1u << (k >> 5);\n"
     "            }\n",
     "            const uint2 both = my[slot];\n"
     "            e = both.x;\n"
     "            s.matches += both.y;\n"),
    ("    s.matches = __reduce_add_sync(0xffffffffu, lane_matches);\n", ""),
]
# name -> (what it changes, [(old, new), ...])
VARIANTS = {
    "span5": ("5-row triangle, 15 cells", [(SPAN, "#define K5_SPAN 5")]),
    "span6": ("6-row triangle, 21 cells", [(SPAN, "#define K5_SPAN 6")]),
    "span8": ("8-row triangle, 36 cells, 2 loads a lane",
              [(SPAN, "#define K5_SPAN 8")]),
    "span10": ("10-row triangle, 55 cells, 2 loads a lane",
               [(SPAN, "#define K5_SPAN 10")]),
    "mr_table": ("design (a): mr of every window cell loaded with dirs, "
                 "kept in the table", MR_TABLE),
    "pairs1": ("1 pair (warp) a block", [(PAIRS, "#define K5_PAIRS 1")]),
    "pairs8": ("8 pairs (warps) a block", [(PAIRS, "#define K5_PAIRS 8")]),
    "ldg": ("loads through the read-only path (ld.global.nc)",
            [("__ldcs(", "__ldg(")]),
    "ldcg": ("loads cached in L2 only (ld.global.cg)",
             [("__ldcs(", "__ldcg(")]),
}

# the shipped kernel with per-pair clocks: cycles of the walk and of its
# window fetches (loads, decode and table), the windows and entries, the
# walk's start and end on the global timer (ns) and the SM; read back by
# k5_probe_read
CLOCK_EDITS = [
    ("__global__ void __launch_bounds__(32 * K5_PAIRS)\nnw_stats_kernel(",
     "__device__ long long k5_probe[8 * 8192];\n"
     "__global__ void __launch_bounds__(32 * K5_PAIRS)\nnw_stats_kernel("),
    ("    if (b >= B) return;\n    // this lane's cells",
     "    if (b >= B) return;\n"
     "    const long long k5_c1 = clock64();\n"
     "    unsigned long long k5_g0;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k5_g0));\n"
     "    long long k5_fetch = 0;\n"
     "    int k5_rounds = 0;\n"
     "    // this lane's cells"),
    ("        uint16_t v[K5_PER_LANE];",
     "        const long long k5_f0 = clock64();\n"
     "        ++k5_rounds;\n"
     "        uint16_t v[K5_PER_LANE];"),
    ("        // walk the window from its anchor, cell 0",
     "        k5_fetch += clock64() - k5_f0;\n"
     "        // walk the window from its anchor, cell 0"),
    ("    if (lane == 0) {\n        int32_t* row",
     "    unsigned long long k5_g1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k5_g1));\n"
     "    unsigned k5_sm;\n"
     "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(k5_sm));\n"
     "    if (lane == 0 && b < 8192) {\n"
     "        long long* q = k5_probe + 8 * b;\n"
     "        q[0] = 0;\n"
     "        q[1] = clock64() - k5_c1;\n"
     "        q[2] = k5_fetch;\n"
     "        q[3] = k5_rounds;\n"
     "        q[4] = s.t;\n"
     "        q[5] = (long long)k5_g0;\n"
     "        q[6] = (long long)k5_g1;\n"
     "        q[7] = k5_sm;\n"
     "    }\n"
     "    if (lane == 0) {\n        int32_t* row"),
]
CLOCK_READ = """
extern "C" int k5_probe_read(void* dst, int n)
{
    return (int)cudaMemcpyFromSymbol(dst, k5_probe,
                                     (size_t)n * 8 * sizeof(long long));
}
"""


def span_of(text: str) -> int:
    m = re.search(r"#define K5_SPAN (\d+)", text)
    return int(m.group(1)) if m else 0


def batches(ap_path):
    """{tag: (K2m forward, its args, planes)}: the allpairs cell's first
    batch and its tail batch (the triangle's last 152 pairs)."""
    import numpy as np
    import torch
    cs = chip_smoke
    ap, _, args = cs.allpairs_first_batch(ap_path)
    qpos, tpos = np.triu_indices(cs.AP_SEQS, 1)
    tail = len(qpos) % ap.batch
    dev = args[0].device
    tail_args = ap.batch_wire(torch.from_numpy(qpos[-tail:]).to(dev),
                              torch.from_numpy(tpos[-tail:]).to(dev))
    out = {}
    for tag, a in (("first", args), ("tail", tail_args)):
        W, B = ap.W, a[3].shape[0]
        planes = (torch.empty((W, W, B), dtype=torch.uint16, device=dev),
                  torch.empty((W, W, B), dtype=torch.uint8, device=dev))
        out[tag] = (ap.forward, a, planes)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, action="append",
                    default=[], help="another nw_stats.cu to time beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_stats: no CUDA device", file=sys.stderr)
        return 1
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import allpairs_dev, cuda_lib, nw_batch
    cs = chip_smoke
    gpu = cs.card()
    src = (cuda_lib.CSRC / "nw_stats.cu").read_text()
    sources = variant_sources(src, VARIANTS, CLOCK_EDITS, CLOCK_READ)
    for path in opts.baseline:
        sources[path.resolve().parent.name] = path.read_text()
    built = build_all(sources, cuda_lib.BUILD_DIR / "tune_stats")
    clocks = built.pop("clocks")[0]
    libs = {name: lib for name, (lib, _) in built.items()}
    for lib in list(libs.values()) + [clocks]:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nw_stats_launch.argtypes = [p, p, p, p, i, i, i, i, p, p]
    dev = device.select("cuda")
    stream = cuda_lib.stream_ptr(dev)
    result = {"card": gpu,
              "registers": {n: r for n, (_, r) in built.items()},
              "variants": {k: v[0] for k, v in VARIANTS.items()},
              "spans": {n: span_of(t) for n, t in sources.items()
                        if n != "clocks"}}
    cs.WORK.mkdir(parents=True, exist_ok=True)
    ap_path = cs.generate_ap(cs.WORK / "ap2000.fasta")

    for tag, (fwd, args, planes) in batches(ap_path).items():
        qlen, tlen = args[3], args[5]
        _, _, dirs, mr = fwd(*args, out=planes)
        M, N, B = dirs.shape
        ref = allpairs_dev.stats_walk_plain(dirs, mr, qlen, tlen)
        ops = nw_batch.backtrack_rle_plain(dirs, qlen, tlen)
        lane_steps = (ops != 0).sum(dim=0)
        ops_np, ql, tl = (t.cpu().numpy() for t in (ops, qlen, tlen))
        del ops
        rounds = {}
        for span in sorted({s for s in result["spans"].values() if s}):
            r = cs.window_rounds(ops_np, ql, tl, span)
            rounds[span] = {"max": int(r.max()), "mean": float(r.mean())}
        stats = torch.empty((B, 8), dtype=torch.int32, device=dev)

        def k5(lib, d, m):
            cs.require(lib.nw_stats_launch(
                d.data_ptr(), m.data_ptr(), qlen.data_ptr(),
                tlen.data_ptr(), M, N, B, M + N, stats.data_ptr(),
                stream) == 0, "K5 launch")
            return stats

        def fresh():
            return fwd(*args, out=planes)

        def check(lib, name):
            stats.fill_(-1)
            cs.require(torch.equal(k5(lib, dirs, mr), ref),
                       "%s differs from the plain version (%s)"
                       % (name, tag))

        times = {}
        order = list(libs) + list(reversed(list(libs)))
        for name in order:
            lib = libs[name]
            check(lib, name)
            t = times.setdefault(name, {"warm": [], "after_k2m": [],
                                        "cold": []})
            t["warm"].append(cs.timed(lambda: k5(lib, dirs, mr), 20))
            t["after_k2m"].append(cs.timed_after(
                fresh, lambda g: k5(lib, g[2], g[3]), 5))
            t["cold"].append(cold_ms(lambda: k5(lib, dirs, mr), dev, 5))
        check(clocks, "clocks")
        g = fresh()
        k5(clocks, g[2], g[3])
        torch.cuda.synchronize()
        result[tag + "_clocks_after_k2m"] = clock_summary(clocks, B, "k5")
        print(json.dumps({tag + "_clocks_after_k2m":
                          result[tag + "_clocks_after_k2m"]}), flush=True)
        result[tag] = {"B": B, "M": M, "N": N,
                       "max_steps": int(lane_steps.max()),
                       "mean_steps": float(lane_steps.float().mean()),
                       "window_rounds": rounds, "ms": times}
        print(json.dumps({tag: result[tag]}), flush=True)
        del dirs, mr, ref, stats, planes
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
