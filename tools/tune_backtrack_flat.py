#!/usr/bin/env python3
"""Time variants of the K7 kernel source against the shipped build.

    python3 tools/tune_backtrack_flat.py [--baseline OTHER/nw_backtrack.cu ...]

Needs one CUDA device and nvcc; imports nothing of jax.  Each variant is
vsearch_tpu_torch/csrc/nw_backtrack.cu with edits (VARIANTS below: the
window's span and lookahead, pairs a block, the load path, a transition
table walked instead of the raw bytes, the move's branches, no ballot
over runs of M moves, ops zeroed by the caller instead of the kernel, and
this design's first body); each --baseline adds another nw_backtrack.cu with the same C
interface (for example a parent commit's, unpacked with git archive),
named by its directory.  All are built by nvcc with the port's flags into
the git-ignored build/vsearch_tpu_torch/tune_backtrack_flat/ by
tools/tune_backtrack.py's build_all.  The inputs are
tools/tune_wavefront.py's, under --mismatch -200: K6's planes of the
search prefetch's top-1 pairs (B=512, M=N=640), of a walk round's (the
first 128 of them) and of the cluster round's top-1 pairs (B=512,
M=N=512).  Every build's ops must equal the plain version's, on ops
filled with 0x5555 before the launch so that an entry left unwritten
shows (zeroed first for the variant whose caller zeroes).  Each is timed
three ways, in the order shipped, variants, variants reversed, shipped:
warm (repeated on one plane), right after a fresh K6 launch wrote the
plane (as the pipeline runs it) and cold (after 256 MB of writes have
flushed L2).  Beside them: each shape's moves a lane (max, mean) and cells
read (the moves before a drain), and a clocked build of the shipped source
that counts each pair's walk steps and windows (max, mean) and says where
the slowest pair's cycles went (window fetches, walk) right after K6.
The last line of the output is one JSON object with the card, ptxas's
register counts and every number.
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
from tune_wavefront import shapes  # noqa: E402

SPAN = "#define K7_SPAN 64"
AHEAD = "#define K7_AHEAD 32"
PAIRS = "#define K7_PAIRS 4"
# the move as the plain version writes it: branches on the previous op and
# the direction bits
BRANCHY = [("        const int op = (lut >> (2 * (my[a] & 15))) & 3;\n",
            """        const int w = my[a];
        const int prev = lut == lut_i ? OP_I : (lut == lut_d ? OP_D : OP_M);
        int op;
        if (prev == OP_I && (w & DIR_EXTLEFT)) op = OP_I;
        else if (prev == OP_D && (w & DIR_EXTUP)) op = OP_D;
        else if (w & DIR_LEFT) op = OP_I;
        else if (w & DIR_UP) op = OP_D;
        else op = OP_M;
""")]
# every move taken one at a time, no ballot over a run of M moves
JUMP = """            if (lut == lut_m) {
                bool m = false;
                if (k + 2 * lane < lim && lane <= min(i, j))
                    m = (my[a + lane * (2 * K7_WIDTH - 1)] & 3) == 0;
                const int n = __clz(__brev(~__ballot_sync(~0u, m)));
                if (lane < n) ring[(t + lane) & 127] = OP_M;
                t += n;
                k += 2 * n;
                a += n * (2 * K7_WIDTH - 1);
                i -= n;
                j -= n;
                if (k >= lim || (i | j) < 0) break;
            }
"""
NOJUMP = [(JUMP, "")]
WALK = """        for (;;) {
            walk(min(K7_AHEAD, kmax));
            // K7_AHEAD diagonals on: fetch the window anchored here while
            // the walk finishes this one, then go on in it
            const int ni = i, nj = j, nk = k, nt = t;
            const bool ahead = k < kmax && (i | j) >= 0 && aligned
                               && i + j < D && i < Ms;
            if (ahead) load(ni, nj);
            walk(kmax);
            flush();
            if (!ahead || (i | j) < 0 || t >= S) break;
            K7_COUNT(++fetched;)
            __syncwarp();
            store(ni, nj);
            __syncwarp();
            k -= nk;
            a = k * K7_WIDTH + i - k7_base(ni);
            kmax = min(K7_SPAN, S - nt);
        }
"""
# the transition table of K3 on K7's window (32 diagonals): each lane
# decodes its cells of the window's triangle (cell k (k + 1) / 2 + r at
# diagonal offset k, row offset r) for the three states the previous op
# leaves into op | next slot << 2, and the walk is one shared load a move
TABLE = [
    (SPAN, "#define K7_SPAN 32\n"
     "#define K7_CELLS (K7_SPAN * (K7_SPAN + 1) / 2)\n"
     "#define K7_EXIT 0x3FFF"),
    ("    uint8_t* my = win[w];\n",
     "    uint8_t* my = win[w];\n"
     "    __shared__ uint16_t tabs[K7_PAIRS][3 * K7_CELLS];\n"
     "    uint16_t* tab = tabs[w];\n"),
    (WALK, """        {
            const uint32_t luts[3] = {lut_m, lut_i, lut_d};
            int k = 0;
            for (int c = lane; c < K7_CELLS; c += 32) {
                while ((k + 1) * (k + 2) / 2 <= c) ++k;
                const int r = c - k * (k + 1) / 2;
                const int cell = my[k * K7_WIDTH + i - r - base] & 15;
#pragma unroll
                for (int st = 0; st < 3; ++st) {
                    const int op = (luts[st] >> (2 * cell)) & 3;
                    const int nk = k + (op == OP_M ? 2 : 1);
                    const int nr = r + (op != OP_I);
                    const int next = (nk < K7_SPAN && i - nr >= 0
                                      && j - (nk - nr) >= 0)
                        ? k3_state(op) * K7_CELLS + nk * (nk + 1) / 2 + nr
                        : K7_EXIT;
                    tab[st * K7_CELLS + c] = (uint16_t)(op | next << 2);
                }
            }
        }
        __syncwarp();
        int slot = (lut == lut_i ? 1 : (lut == lut_d ? 2 : 0)) * K7_CELLS;
        int op;
        do {
            const int e = tab[slot];
            op = e & 3;
            ring[t++ & 127] = (uint8_t)op;
            if (op != OP_I) --i;
            if (op != OP_D) --j;
            slot = e >> 2;
        } while (slot != K7_EXIT && t < S);
        lut = op == OP_I ? lut_i : (op == OP_D ? lut_d : lut_m);
        flush();
"""),
]
# the window's chunks copied by cp.async straight into a second shared
# buffer, the two swapped when the walk moves into the new window: no
# registers hold a window in flight
LOADSTORE = """    uint4 v[K7_LOADS][K7_CHUNKS];
    auto load = [&](int ai, int aj) {
        const int d = ai + aj;
#pragma unroll
        for (int u = 0; u < K7_LOADS; ++u) {
            const int k = lane + 32 * u;
            const uint8_t* row =
                dirs + ((size_t)max(d - k, 0) * B + b) * Ms + k7_base(ai);
#pragma unroll
            for (int c = 0; c < K7_CHUNKS; ++c)
                if (k7_chunk(k, c, ai, d))
                    v[u][c] = __ldcs((const uint4*)(row + 16 * c));
        }
    };
    auto store = [&](int ai, int aj) {
        const int d = ai + aj;
#pragma unroll
        for (int u = 0; u < K7_LOADS; ++u) {
            const int k = lane + 32 * u;
#pragma unroll
            for (int c = 0; c < K7_CHUNKS; ++c)
                if (k7_chunk(k, c, ai, d))
                    *(uint4*)(my + k * K7_WIDTH + 16 * c) = v[u][c];
        }
    };
"""
CPASYNC = [
    ("// the first row a window anchored at row i keeps",
     "__device__ __forceinline__ void k7_cp16(uint8_t* dst, "
     "const uint8_t* src)\n{\n"
     "    asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\"\n"
     "                 :: \"r\"((unsigned)__cvta_generic_to_shared(dst)), "
     "\"l\"(src));\n}\n\n"
     "// the first row a window anchored at row i keeps"),
    ("    __shared__ __align__(16) uint8_t win[K7_PAIRS][K7_SPAN * K7_WIDTH];",
     "    __shared__ __align__(16) uint8_t win[K7_PAIRS][2]"
     "[K7_SPAN * K7_WIDTH];"),
    ("    uint8_t* my = win[w];\n",
     "    uint8_t* my = win[w][0];\n    uint8_t* nxt = win[w][1];\n"),
    (LOADSTORE, """    auto load = [&](int ai, int aj) {
        const int d = ai + aj;
#pragma unroll
        for (int u = 0; u < K7_LOADS; ++u) {
            const int k = lane + 32 * u;
            const uint8_t* row =
                dirs + ((size_t)max(d - k, 0) * B + b) * Ms + k7_base(ai);
#pragma unroll
            for (int c = 0; c < K7_CHUNKS; ++c)
                if (k7_chunk(k, c, ai, d))
                    k7_cp16(nxt + k * K7_WIDTH + 16 * c, row + 16 * c);
        }
        asm volatile("cp.async.commit_group;\\n" ::);
    };
    auto store = [&](int, int) {
        asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
        uint8_t* const was = my;
        my = nxt;
        nxt = was;
    };
"""),
]
CPASYNC.append(("    // the rest of the column, 32 entries a round",
                "    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
                "    // the rest of the column, 32 entries a round"))
# the kernel stores only the walk's moves and the drain; the caller
# zeroes ops first (a fill kernel before each launch)
CALLER_ZEROES = [("u < S; u += 32)", "u < min(tend, S); u += 32)")]
# name -> (what it changes, [(old, new), ...])
VARIANTS = {
    "first": ("this design's first body: 32 diagonals a window fetched once "
              "the walk leaves the last, every move alone, decided by "
              "branches", [(SPAN, "#define K7_SPAN 32"),
                           (AHEAD, "#define K7_AHEAD 32")]
             + NOJUMP + BRANCHY),
    "span16": ("16 diagonals a window, fetched once the walk leaves the "
               "last", [(SPAN, "#define K7_SPAN 16"),
                        (AHEAD, "#define K7_AHEAD 16")]),
    "span24": ("24 diagonals a window, fetched once the walk leaves the "
               "last", [(SPAN, "#define K7_SPAN 24"),
                        (AHEAD, "#define K7_AHEAD 24")]),
    "span32": ("32 diagonals a window, one a lane, fetched once the walk "
               "leaves the last", [(SPAN, "#define K7_SPAN 32"),
                                   (AHEAD, "#define K7_AHEAD 32")]),
    "span64": ("64 diagonals a window, fetched once the walk leaves the "
               "last", [(AHEAD, "#define K7_AHEAD 64")]),
    "span48_ahead24": ("48 diagonals a window, the next fetched 24 in",
                       [(SPAN, "#define K7_SPAN 48"),
                        (AHEAD, "#define K7_AHEAD 24")]),
    "pairs2": ("2 pairs (warps) a block", [(PAIRS, "#define K7_PAIRS 2")]),
    "pairs8": ("8 pairs (warps) a block", [(PAIRS, "#define K7_PAIRS 8")]),
    "ldg": ("window loads through the read-only path (ld.global.nc)",
            [("__ldcs((const uint4*)", "__ldg((const uint4*)")]),
    "ldcg": ("window loads cached in L2 only (ld.global.cg)",
             [("__ldcs((const uint4*)", "__ldcg((const uint4*)")]),
    "cpasync": ("windows copied by cp.async into a second shared buffer",
                CPASYNC),
    "table": ("32 diagonals a window, decoded into a transition table of "
              "its triangle, walked one shared load a move", TABLE),
    "branchy": ("the move decided by branches on the previous op and the "
                "direction bits", BRANCHY),
    "nojump": ("every move taken alone, no ballot over a run of M moves",
               NOJUMP),
    "caller_zeroes": ("ops zeroed by the caller (ops.zero_() before each "
                      "launch), the kernel storing moves and drains only",
                      CALLER_ZEROES),
}

# the shipped kernel with per-pair clocks: the walk's steps (a ballot over
# a run of M moves and the move after it, or one move), cycles of the
# whole pair and of its window fetches (the waits for loads into shared
# memory), the windows, the moves walked through windows, the pair's
# start and end on the global timer (ns) and the SM; read back by
# k7_probe_read
CLOCK_EDITS = [
    ("__global__ void __launch_bounds__(32 * K7_PAIRS)\n"
     "nw_backtrack_flat_kernel(",
     "__device__ long long k7_probe[8 * 8192];\n"
     "__global__ void __launch_bounds__(32 * K7_PAIRS)\n"
     "nw_backtrack_flat_kernel("),
    ("    uint8_t* my = win[w];\n",
     "    uint8_t* my = win[w];\n"
     "    const long long k7_c1 = clock64();\n"
     "    unsigned long long k7_g0;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k7_g0));\n"
     "    long long k7_fetch = 0;\n"
     "    int k7_rounds = 0;\n"
     "    int k7_steps = 0;\n"),
    ("        while (k < lim && (i | j) >= 0) {\n",
     "        while (k < lim && (i | j) >= 0) {\n"
     "            ++k7_steps;\n"),
    ("        const int base = k7_base(i);\n",
     "        const long long k7_f0 = clock64();\n"
     "        ++k7_rounds;\n"
     "        const int base = k7_base(i);\n"),
    ("        // walk it: a move takes",
     "        k7_fetch += clock64() - k7_f0;\n"
     "        // walk it: a move takes"),
    ("            __syncwarp();\n            store(ni, nj);\n"
     "            __syncwarp();\n",
     "            const long long k7_f1 = clock64();\n"
     "            ++k7_rounds;\n"
     "            __syncwarp();\n            store(ni, nj);\n"
     "            __syncwarp();\n"
     "            k7_fetch += clock64() - k7_f1;\n"),
    ("    const int drain = i >= 0 ? OP_D : OP_I;\n",
     "    const int k7_walked = t;\n"
     "    const int drain = i >= 0 ? OP_D : OP_I;\n"),
    ("(int16_t)(u < t ? ring[u & 127] : (u < tend ? drain : 0));\n}",
     "(int16_t)(u < t ? ring[u & 127] : (u < tend ? drain : 0));\n"
     "    unsigned long long k7_g1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k7_g1));\n"
     "    unsigned k7_sm;\n"
     "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(k7_sm));\n"
     "    if (lane == 0 && b < 8192) {\n"
     "        long long* q = k7_probe + 8 * b;\n"
     "        q[0] = k7_steps;\n"
     "        q[1] = clock64() - k7_c1;\n"
     "        q[2] = k7_fetch;\n"
     "        q[3] = k7_rounds;\n"
     "        q[4] = k7_walked;\n"
     "        q[5] = (long long)k7_g0;\n"
     "        q[6] = (long long)k7_g1;\n"
     "        q[7] = k7_sm;\n"
     "    }\n}"),
]
CLOCK_READ = """
extern "C" int k7_probe_read(void* dst, int n)
{
    return (int)cudaMemcpyFromSymbol(dst, k7_probe,
                                     (size_t)n * 8 * sizeof(long long));
}
"""
# clock_summary's K3 field names, as this probe fills them
CLOCK_NAMES = {"walk": "pair", "entries": "moves", "an_entry": "a_move"}


def steps_of(lib, B: int, summary: dict) -> dict:
    """The clocked build's walk steps and windows a pair (max, mean) and
    the pair's cycles outside window fetches a step, beside
    clock_summary's."""
    import numpy as np
    buf = np.zeros((B, 8), dtype=np.int64)
    lib.k7_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    chip_smoke.require(lib.k7_probe_read(buf.ctypes.data, B) == 0,
                       "k7_probe_read")
    steps, pair, fetch, windows = buf[:, 0], buf[:, 1], buf[:, 2], buf[:, 3]
    return dict(summary, steps={"max": int(steps.max()),
                                "mean": float(steps.mean())},
                windows={"max": int(windows.max()),
                         "mean": float(windows.mean())},
                pair_cycles_a_step=float((pair - fetch).sum()
                                         / max(int(steps.sum()), 1)))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, action="append",
                    default=[],
                    help="another nw_backtrack.cu to time beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_backtrack_flat: no CUDA device", file=sys.stderr)
        return 1
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch, nw_wavefront
    cs = chip_smoke
    gpu = cs.card()
    src = (cuda_lib.CSRC / "nw_backtrack.cu").read_text()
    sources = variant_sources(src, VARIANTS, CLOCK_EDITS, CLOCK_READ)
    for path in opts.baseline:
        sources[path.resolve().parent.name] = path.read_text()
    built = build_all(sources, cuda_lib.BUILD_DIR / "tune_backtrack_flat")
    clocks = built.pop("clocks")[0]
    libs = {name: lib for name, (lib, _) in built.items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in list(libs.values()) + [clocks]:
        lib.nw_backtrack_flat_launch.argtypes = [p, p, p, i, i, i, p, p]
    dev = device.select("cuda")
    stream = cuda_lib.stream_ptr(dev)
    result = {"card": gpu,
              "registers": {n: r for n, (_, r) in built.items()},
              "variants": {k: v[0] for k, v in VARIANTS.items()}}

    for tag, (key, args) in shapes().items():
        fwd = nw_wavefront.build_forward(key)
        qlen, tlen = args[1], args[3]
        dirs = fwd(*args)[2]
        D, B, Ms = dirs.shape
        ref = nw_batch.backtrack_flat_plain(dirs, qlen, tlen)
        lane_moves = (ref != 0).sum(dim=0)
        reads = cs.flat_cells_read(ref, qlen, tlen)
        ops = torch.empty((D + 1, B), dtype=torch.int16, device=dev)

        def k7(name, d):
            if name == "caller_zeroes":
                ops.zero_()
            cs.require(libs[name].nw_backtrack_flat_launch(
                d.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), D, B, Ms,
                ops.data_ptr(), stream) == 0, "K7 launch")
            return ops

        times = {}
        order = list(libs) + list(reversed(list(libs)))
        for name in order:
            ops.fill_(0x5555)
            cs.require(torch.equal(k7(name, dirs), ref),
                       "%s differs from the plain version (%s)"
                       % (name, tag))
            t = times.setdefault(name, {"warm": [], "after_k6": [],
                                        "cold": []})
            t["warm"].append(cs.timed(lambda: k7(name, dirs), 20))
            t["after_k6"].append(cs.timed_after(
                lambda: fwd(*args)[2], lambda d: k7(name, d), 5))
            k7(name, dirs)
            t["cold"].append(cold_ms(lambda: k7(name, dirs), dev, 5))
        ops.fill_(0x5555)
        cs.require(clocks.nw_backtrack_flat_launch(
            dirs.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), D, B, Ms,
            ops.data_ptr(), stream) == 0 and torch.equal(ops, ref),
            "clocks differs from the plain version (%s)" % tag)
        d = fwd(*args)[2]
        cs.require(clocks.nw_backtrack_flat_launch(
            d.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), D, B, Ms,
            ops.data_ptr(), stream) == 0, "clocks launch")
        torch.cuda.synchronize()
        summary = steps_of(clocks, B,
                           clock_summary(clocks, B, "k7", CLOCK_NAMES))
        result[tag + "_clocks_after_k6"] = summary
        print(json.dumps({tag + "_clocks_after_k6": summary}), flush=True)
        result[tag] = {"B": B, "D": D, "Ms": Ms,
                       "max_moves": int(lane_moves.max()),
                       "mean_moves": float(lane_moves.float().mean()),
                       "cells_read": reads, "ms": times}
        print(json.dumps({tag: result[tag]}), flush=True)
        del dirs, d, ops, ref
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
