#!/usr/bin/env python3
"""Time variants of the K3 kernel source against the shipped build.

    python3 tools/tune_backtrack.py [--baseline OTHER/nw_backtrack.cu ...]

Needs one CUDA device and nvcc; imports nothing of jax.  Each variant is
vsearch_tpu_torch/csrc/nw_backtrack.cu with one edit (VARIANTS below);
each --baseline adds another nw_backtrack.cu with the same C interface
(for example a parent commit's, unpacked with git archive), named by its
directory.  All are built by nvcc with the port's flags into the
git-ignored build/vsearch_tpu_torch/tune_backtrack/.  The inputs are
chip_smoke.py's: the K2 planes of the search prefetch (B=512, M=N=640),
of a walk round (its first 128 pairs) and of the cluster prefetch
(B=2048, M=N=512).  Every build's ops must equal the plain version's.
Each is timed three ways, in the order shipped, variants, variants
reversed, shipped: warm (repeated on one plane, its walked cells staying
in L2), right after a fresh K2 launch wrote the plane (as the pipeline
runs it), and cold (after 256 MB of writes have flushed L2).  Beside
them: each shape's entries a lane (max, mean), the windows a lane
fetches at each variant's span, a clocked build of the shipped source
that says where the slowest pair's cycles went (window fetches, walk)
right after K2, and a one-thread pointer chase that times one dependent
load hitting L2 or DRAM, within one 2 MiB page or a new page every hop.
The last line of the output is one JSON object with the card, ptxas's
register counts and every number.
"""

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

SPAN = "#define K3_SPAN 7"
PAIRS = "#define K3_PAIRS 4"
# name -> (what it changes, [(old, new), ...])
VARIANTS = {
    "span5": ("5-row triangle, 15 cells", [(SPAN, "#define K3_SPAN 5")]),
    "span6": ("6-row triangle, 21 cells", [(SPAN, "#define K3_SPAN 6")]),
    "span8": ("8-row triangle, 36 cells, 2 loads a lane",
              [(SPAN, "#define K3_SPAN 8")]),
    "span10": ("10-row triangle, 55 cells, 2 loads a lane",
               [(SPAN, "#define K3_SPAN 10")]),
    "span13": ("13-row triangle, 91 cells, 3 loads a lane",
               [(SPAN, "#define K3_SPAN 13")]),
    "pairs1": ("1 pair (warp) a block", [(PAIRS, "#define K3_PAIRS 1")]),
    "pairs8": ("8 pairs (warps) a block", [(PAIRS, "#define K3_PAIRS 8")]),
    "ldg": ("window loads through the read-only path (ld.global.nc)",
            [("__ldcs(dirs", "__ldg(dirs")]),
    "ldcg": ("window loads cached in L2 only (ld.global.cg)",
             [("__ldcs(dirs", "__ldcg(dirs")]),
}

# the shipped kernel with per-pair clocks: cycles of the walk and of its
# window fetches (loads and table), the windows and entries, the walk's
# start and end on the global timer (ns) and the SM; read back by
# k3_probe_read
CLOCK_EDITS = [
    ("__global__ void __launch_bounds__(32 * K3_PAIRS)\nnw_backtrack_kernel(",
     "__device__ long long k3_probe[8 * 8192];\n"
     "__global__ void __launch_bounds__(32 * K3_PAIRS)\nnw_backtrack_kernel("),
    ("    if (b >= B) return;\n    // this lane's cells",
     "    if (b >= B) return;\n"
     "    const long long k3_c1 = clock64();\n"
     "    unsigned long long k3_g0;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k3_g0));\n"
     "    long long k3_fetch = 0;\n"
     "    int k3_rounds = 0;\n"
     "    // this lane's cells"),
    ("        uint16_t v[K3_PER_LANE];",
     "        const long long k3_f0 = clock64();\n"
     "        ++k3_rounds;\n"
     "        uint16_t v[K3_PER_LANE];"),
    ("        // walk the window from its anchor, cell 0",
     "        k3_fetch += clock64() - k3_f0;\n"
     "        // walk the window from its anchor, cell 0"),
    ("        prev = op;\n    }\n}",
     "        prev = op;\n    }\n"
     "    unsigned long long k3_g1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k3_g1));\n"
     "    unsigned k3_sm;\n"
     "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(k3_sm));\n"
     "    if (lane == 0 && b < 8192) {\n"
     "        long long* q = k3_probe + 8 * b;\n"
     "        q[0] = 0;\n"
     "        q[1] = clock64() - k3_c1;\n"
     "        q[2] = k3_fetch;\n"
     "        q[3] = k3_rounds;\n"
     "        q[4] = t;\n"
     "        q[5] = (long long)k3_g0;\n"
     "        q[6] = (long long)k3_g1;\n"
     "        q[7] = k3_sm;\n"
     "    }\n}"),
]
CLOCK_READ = """
extern "C" int k3_probe_read(void* dst, int n)
{
    return (int)cudaMemcpyFromSymbol(dst, k3_probe,
                                     (size_t)n * 8 * sizeof(long long));
}
"""

# a one-thread chase of dependent loads through L2 (ld.global.cg)
PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void chase_kernel(const int32_t* __restrict__ next,
                             long long start, int hops, int32_t* out)
{
    long long k = start;
    for (int h = 0; h < hops; ++h) k = __ldcg(next + k);
    out[0] = (int32_t)k;
}
extern "C" int chase_launch(const void* next, long long start, int hops,
                            void* out, void* stream)
{
    chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const int32_t*)next, start, hops, (int32_t*)out);
    return (int)cudaGetLastError();
}
"""
PAGE = 1 << 21
HOPS = 4096


def span_of(text: str) -> int:
    m = re.search(r"#define K3_SPAN (\d+)", text)
    return int(m.group(1)) if m else 0


def build_all(sources: dict, out_dir: pathlib.Path) -> dict:
    """Compile {name: source text}, all nvcc processes started together;
    returns {name: (ctypes library, ptxas register lines)}."""
    from vsearch_tpu_torch.ops import cuda_lib
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / (name + ".cu")
        cu.write_text(text)
        so = out_dir / ("lib%s.so" % name)
        procs[name] = (subprocess.Popen(
            [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-o", str(so),
                                                        str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        regs = sorted({ln.split(":", 1)[1].strip()
                       for ln in log.splitlines() if "registers" in ln})
        libs[name] = (ctypes.CDLL(str(so)), regs)
    return libs


def variant_sources(src: str, variants=VARIANTS, clock_edits=CLOCK_EDITS,
                    clock_read=CLOCK_READ) -> dict:
    """{name: source}: the shipped source, each variant's edits of it and
    the clocked build ("clocks"); every edit's old text must be there."""
    def edited(what, edits):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError("%s: %r not in the source" % (what, old))
            text = text.replace(old, new)
        return text
    out = {"shipped": src}
    for name, (_, edits) in variants.items():
        out[name] = edited("variant " + name, edits)
    out["clocks"] = edited("clocks", clock_edits) + clock_read
    return out


def clock_summary(lib, B: int, probe: str = "k3", names: dict = None) -> dict:
    """Where the time of the clocked build's last launch went: the pair
    whose walk took longest, and means over the pairs.  The build keeps 8
    int64 a pair in <probe>_probe, read back by <probe>_probe_read.  names
    renames the fields for another kernel's probe (for example {"walk":
    "pair"}) in every key of the result."""
    import numpy as np
    buf = np.zeros((B, 8), dtype=np.int64)
    read = getattr(lib, probe + "_probe_read")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    chip_smoke.require(read(buf.ctypes.data, B) == 0, probe + "_probe_read")
    _, walk, fetch, rounds, entries, g0, g1, _ = buf.T
    k = int(np.argmax(walk))
    ns = max(int(g1[k] - g0[k]), 1)
    many = entries > 20
    out = {
        "slowest": {"walk_cycles": int(walk[k]),
                    "fetch_cycles": int(fetch[k]), "rounds": int(rounds[k]),
                    "entries": int(entries[k]), "walk_ns": ns,
                    "start_ns": int(g0[k] - g0.min())},
        "ghz": float(walk[k]) / ns,
        "mean": {"walk_cycles": float(walk.mean()),
                 "fetch_cycles": float(fetch.mean()),
                 "rounds": float(rounds.mean()),
                 "entries": float(entries.mean())},
        "cycles_a_fetch": float(fetch.sum() / max(rounds.sum(), 1)),
        "walk_cycles_an_entry": (float(((walk - fetch)[many]).sum()
                                       / max(entries[many].sum(), 1))),
        "start_spread_ns": int(g0.max() - g0.min()),
        "span_ns": int(g1.max() - g0.min()),
        "sms": int(len(np.unique(buf[:, 7])))}

    def renamed(key):
        for old, new in (names or {}).items():
            key = key.replace(old, new)
        return key
    return {renamed(k): ({renamed(f): x for f, x in v.items()}
                         if isinstance(v, dict) else v)
            for k, v in out.items()}


def flush_l2(dev):
    import torch
    torch.empty(64 << 20, dtype=torch.int32, device=dev).fill_(1)


def cold_ms(run, dev, reps: int) -> float:
    """Mean ms of run() launched right after 256 MB of writes flushed L2."""
    import torch
    total = 0.0
    for _ in range(reps):
        flush_l2(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def latency_probe(lib, dev, stream) -> dict:
    """ns a dependent load, one thread: L2 hits (the chain read once
    before) and DRAM (after an L2 flush), within one 2 MiB page and a new
    page every hop over 1 GiB (the cluster plane's size) and 4 GiB."""
    import numpy as np
    import torch
    cs = chip_smoke
    lib.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    rng = np.random.default_rng(7)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    res = {}
    for tag, gib in (("one_page", 0), ("page_a_hop_1gib", 1),
                     ("page_a_hop_4gib", 4)):
        n = max(gib, 1) << 28
        buf = torch.empty(n, dtype=torch.int32, device=dev)
        slots = PAGE // 64
        if gib == 0:
            pos = rng.choice(slots, size=HOPS, replace=False) * 16
        else:
            pages = gib * 512
            order = np.concatenate([rng.permutation(pages)
                                    for _ in range(-(-HOPS // pages))])
            pos = (order[:HOPS] * (PAGE // 4)
                   + rng.integers(0, slots, size=HOPS) * 16)
        pos_t = torch.from_numpy(pos.astype(np.int64)).to(dev)
        buf[pos_t] = torch.roll(pos_t, -1).to(torch.int32)

        def chase():
            cs.require(lib.chase_launch(buf.data_ptr(), int(pos[0]), HOPS,
                                        out.data_ptr(), stream) == 0,
                       "chase launch")
        chase()
        res["l2_" + tag] = cs.timed(chase, 3) * 1e6 / HOPS
        res["dram_" + tag] = cold_ms(chase, dev, 3) * 1e6 / HOPS
        del buf, pos_t
        torch.cuda.empty_cache()
    return res


def shapes():
    """{tag: (K2 forward, its args)} at chip_smoke.py's three K3 shapes."""
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import nw_batch, nw_rowscan
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    cs = chip_smoke
    dev = device.select("cuda")
    cs.WORK.mkdir(parents=True, exist_ok=True)
    db_path, q_path = cs.generate(cs.WORK)
    ctx, qseqs, _, Kbits = cs.search_chunk(db_path, q_path)
    args, _ = cs.search_prefetch_args(ctx, qseqs, Kbits)
    fwd = nw_rowscan.build_forward(tuple(int(v) for v in ctx.aligner._key))
    walk_b = nw_batch.BatchAligner.PAIR_BUCKETS[0]
    out = {"search": (fwd, args),
           "walk": (fwd, tuple(a[..., :walk_b].contiguous() for a in args))}
    amp = cs.generate_amp(cs.WORK / "amp100k.fasta")
    params, g, qseqs, klists, Kbits = cs.cluster_round(amp)
    args = cs.cluster_prefetch_args(params, g, qseqs, klists, Kbits)[0]
    key = nw_batch.BatchAligner(ScoreScheme.from_params(params), dev)._key
    out["cluster"] = (nw_rowscan.build_forward(tuple(int(v) for v in key)),
                      args)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, action="append",
                    default=[],
                    help="another nw_backtrack.cu to time beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_backtrack: no CUDA device", file=sys.stderr)
        return 1
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch
    cs = chip_smoke
    gpu = cs.card()
    src = (cuda_lib.CSRC / "nw_backtrack.cu").read_text()
    sources = variant_sources(src)
    for path in opts.baseline:
        sources[path.resolve().parent.name] = path.read_text()
    sources["probe"] = PROBE_CU
    built = build_all(sources, cuda_lib.BUILD_DIR / "tune_backtrack")
    probe = built.pop("probe")[0]
    clocks = built.pop("clocks")[0]
    libs = {name: lib for name, (lib, _) in built.items()}
    for lib in list(libs.values()) + [clocks]:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nw_backtrack_launch.argtypes = [p, p, p, i, i, i, i, p, p]
    dev = device.select("cuda")
    stream = cuda_lib.stream_ptr(dev)
    result = {"card": gpu,
              "registers": {n: r for n, (_, r) in built.items()},
              "variants": {k: v[0] for k, v in VARIANTS.items()},
              "spans": {n: span_of(t) for n, t in sources.items()
                        if n not in ("probe", "clocks")}}
    result["latency_ns"] = latency_probe(probe, dev, stream)
    print(json.dumps({"latency_ns": result["latency_ns"]}), flush=True)

    for tag, (fwd, args) in shapes().items():
        qlen, tlen = args[2], args[4]
        dirs = fwd(*args)[2]
        M, N, B = dirs.shape
        S = M + N
        ref = nw_batch.backtrack_rle_plain(dirs, qlen, tlen)
        ref_np = ref.cpu().numpy()
        lane_steps = (ref != 0).sum(dim=0)
        ql, tl = qlen.cpu().numpy(), tlen.cpu().numpy()
        rounds = {}
        for span in sorted({s for s in result["spans"].values() if s}):
            r = cs.window_rounds(ref_np, ql, tl, span)
            rounds[span] = {"max": int(r.max()), "mean": float(r.mean())}
        ops = torch.empty((S, B), dtype=torch.int16, device=dev)

        def k3(lib, d):
            # as the wrapper runs it: ops zeroed, then the launch
            ops.zero_()
            cs.require(lib.nw_backtrack_launch(
                d.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), M, N, B, S,
                ops.data_ptr(), stream) == 0, "K3 launch")
            return ops

        times = {}
        order = list(libs) + list(reversed(list(libs)))
        for name in order:
            lib = libs[name]
            cs.require(torch.equal(k3(lib, dirs), ref),
                       "%s differs from the plain version (%s)"
                       % (name, tag))
            t = times.setdefault(name, {"warm": [], "after_k2": [],
                                        "cold": []})
            t["warm"].append(cs.timed(lambda: k3(lib, dirs), 20))
            t["after_k2"].append(cs.timed_after(
                lambda: fwd(*args)[2], lambda d: k3(lib, d), 5))
            k3(lib, dirs)
            t["cold"].append(cold_ms(lambda: k3(lib, dirs), dev, 5))
        cs.require(torch.equal(k3(clocks, dirs), ref),
                   "clocks differs from the plain version (%s)" % tag)
        k3(clocks, fwd(*args)[2])
        torch.cuda.synchronize()
        result[tag + "_clocks_after_k2"] = clock_summary(clocks, B)
        print(json.dumps({tag + "_clocks_after_k2":
                          result[tag + "_clocks_after_k2"]}), flush=True)
        result[tag] = {"B": B, "M": M, "N": N,
                       "max_steps": int(lane_steps.max()),
                       "mean_steps": float(lane_steps.float().mean()),
                       "window_rounds": rounds, "ms": times}
        print(json.dumps({tag: result[tag]}), flush=True)
        del dirs, ops, ref
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
