#!/usr/bin/env python3
"""Measure the integer issue rates of the card, one operation at a time.

    python3 tools/int_rate.py

Needs one CUDA device and nvcc; imports nothing of jax.  Builds a probe
(a kernel an operation, each thread running 8 independent chains of it)
with nvcc for sm_90a into the git-ignored build/vsearch_tpu_torch/
int_rate/, times each kernel with CUDA events on 4 blocks of 512 threads
an SM, and prints the operations a warp an SM completes a clock (at the
card's maximum SM clock, cudaDevAttrClockRate: a floor on the rate at
the clock it ran at) and the lane operations an SM a clock, 32 times
that.  Beside each stand the opcodes its kernel compiled to (cuobjdump
-sass): ptxas fuses two chained adds into one three-input IADD3 and two
maxes into one VIMNMX3, so those operations complete at twice the rate
of their instructions.  chip_smoke.py's integer bound (INT_LANES_PER_SM)
is the rate the add and min/max reach here.  The last line is one JSON
object with the card and every number.
"""

import collections
import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

ITER = 4096
# {kernel: (what it issues, a statement on the chain x and the operand y)}
OPS = {name: (ptx, 'asm volatile("%s" : "+r"(x) : "r"(y))' % body)
       for name, ptx, body in (
           ("iadd", "add.u32", "add.u32 %0, %0, %1;"),
           ("imad", "mad.lo.u32", "mad.lo.u32 %0, %0, %1, 7;"),
           ("lop3", "lop3.b32", "lop3.b32 %0, %0, %1, 0x5555, 0xe8;"),
           ("prmt", "prmt.b32", "prmt.b32 %0, %0, %1, 0x3021;"),
           ("shr", "shr.u32", "shr.u32 %0, %0, %1;"),
           ("shfl", "shfl.sync.idx.b32",
            "shfl.sync.idx.b32 %0, %0, %1, 0x1f, 0xffffffff;"),
           ("max16x2", "max.u16x2", "max.u16x2 %0, %0, %1;"),
           ("add16x2", "add.u16x2", "add.u16x2 %0, %0, %1;"))}
OPS["addmax16x2"] = ("__viaddmax_u16x2", "x = __viaddmax_u16x2(x, y, y)")
PROBE_HEAD = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
#define ITER %d
#define CHAINS(OP) \
    uint32_t a0 = seed ^ threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, \
        a3 = a0 + 3, a4 = a0 + 4, a5 = a0 + 5, a6 = a0 + 6, a7 = a0 + 7; \
    const uint32_t y = (threadIdx.x + 1) & 31; \
    for (int i = 0; i < ITER; ++i) { OP(a0); OP(a1); OP(a2); OP(a3); \
        OP(a4); OP(a5); OP(a6); OP(a7); } \
    out[blockIdx.x * blockDim.x + threadIdx.x] = \
        a0 ^ a1 ^ a2 ^ a3 ^ a4 ^ a5 ^ a6 ^ a7;
"""
PROBE_KERNEL = r"""
#define OP_%(name)s(x) %(stmt)s
__global__ void k_%(name)s(uint32_t* out, uint32_t seed) { CHAINS(OP_%(name)s) }
"""
PROBE_MAIN = r"""
typedef void (*kern)(uint32_t*, uint32_t);
int main() {
    int sms, khz;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
    const int blocks = sms * 4, threads = 512;
    uint32_t* out;
    if (cudaMalloc(&out, sizeof(uint32_t) * blocks * threads)) return 1;
    kern ks[] = {%(kernels)s};
    const char* names[] = {%(names)s};
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    for (int k = 0; k < %(n)d; ++k) {
        ks[k]<<<blocks, threads>>>(out, 1);
        float best = 1e30f;
        for (int rep = 0; rep < 3; ++rep) {
            cudaEventRecord(e0);
            ks[k]<<<blocks, threads>>>(out, 2 + rep);
            cudaEventRecord(e1);
            cudaEventSynchronize(e1);
            float ms;
            cudaEventElapsedTime(&ms, e0, e1);
            if (ms < best) best = ms;
        }
        const double warp_ops = (double)blocks * threads / 32 * ITER * 8;
        printf("%%s %%.6f %%.6f %%d %%d\n", names[k], best,
               warp_ops / sms / (best * 1e-3 * khz * 1e3), sms, khz);
    }
    return (int)cudaGetLastError();
}
"""


def probe_source() -> str:
    src = PROBE_HEAD % ITER
    for name, (_, stmt) in OPS.items():
        src += PROBE_KERNEL % {"name": name, "stmt": stmt}
    src += PROBE_MAIN % {
        "kernels": ", ".join("k_" + n for n in OPS),
        "names": ", ".join('"%s"' % n for n in OPS), "n": len(OPS)}
    return src


def sass_opcodes(exe: pathlib.Path, cuobjdump: str) -> dict:
    """{kernel: {opcode: count}} of the probe's kernels, its loop body's
    opcodes (no branches, moves or the store)."""
    text = subprocess.run([cuobjdump, "-sass", str(exe)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : _Z\d+k_(\w+?)Pjj", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                     r"(\.[A-Z0-9_.x]+)?", line)
        if name and m and m.group(2) not in (
                "NOP", "BRA", "EXIT", "MOV", "S2R", "STG", "ULDC", "ISETP",
                "LDC", "S2UR"):
            out[name][m.group(2) + (m.group(3) or "")] += 1
    return {k: dict(v.most_common(4)) for k, v in out.items()}


def main() -> int:
    from vsearch_tpu_torch.ops import cuda_lib
    nvcc = cuda_lib._nvcc()
    gpu = chip_smoke.card()
    out_dir = cuda_lib.BUILD_DIR / "int_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, exe = out_dir / "int_rate.cu", out_dir / "int_rate"
    cu.write_text(probe_source())
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(cu)], check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    if run.returncode:
        print("int_rate: the probe failed (%d)\n%s" % (run.returncode,
                                                        run.stderr),
              file=sys.stderr)
        return 1
    sass = sass_opcodes(exe, str(pathlib.Path(nvcc).with_name("cuobjdump")))
    rates = {}
    for line in run.stdout.split("\n"):
        if not line.strip():
            continue
        name, ms, per_clk, sms, khz = line.split()
        rates[name] = {"issues": OPS[name][0], "ms": float(ms),
                       "warp_ops_per_clk_per_sm": float(per_clk),
                       "lanes_per_clk_per_sm": 32 * float(per_clk),
                       "sass": sass.get(name, {})}
        print(json.dumps({name: rates[name], "card": gpu}), flush=True)
    print(json.dumps({"card": gpu, "sms": int(sms),
                      "max_sm_clock_mhz": int(khz) / 1e3,
                      "iterations": ITER, "chains": 8, "rates": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
