// K3: run-length backtrack over the row-scan forward's direction plane.
//
// Replaces: vsearch_tpu/ops/nw_jax.py backtrack_rle (nw_jax.py:320-377),
// an XLA while_loop on the TPU (not a Pallas kernel).  Same function: from
// (qlen-1, tlen-1) each step consumes a whole diagonal run (count =
// max(run length, 1)), one I/D move (the extension bits win when the
// previous op was the same gap), or a whole boundary drain (count capped at
// 4095), and writes int16 op | count << 2 end-to-front into ops (S, B);
// entries after the walk ends are 0.  This is the wire that the native
// tier's assemble_batch reads.
//
// What bounds it on the H100: latency.  The bytes it must move are the
// dirs it reads on the path (~#runs gathers of 2 bytes per pair) and the
// (S, B) int16 ops written once, a few MB; but each step's read depends on
// the previous step's position.  Design: one thread per pair, a dependent
// chain of L2/HBM reads per run; lanes of a warp walk different paths, so
// the reads are scattered.  As a torch loop the same walk would cost ~M+N
// steps of ~15 launches each with a host sync per step; here it is one
// launch.
//
// K7, below: the flat backtrack over the wavefront forward's diagonal-major
// plane (K6, csrc/nw_wavefront.cu).  Replaces: vsearch_tpu/ops/nw_jax.py
// backtrack with row_layout=False (nw_jax.py:266-318), an XLA scan on the
// TPU.  Same function: from (qlen-1, tlen-1), one move a step, reading
// dirs (D, B, Ms) uint8 at [i + j, b, i] (the lane stride Ms taken from the
// plane's shape, i + j clipped to D - 1 and i to Ms - 1), the extension bits
// winning when the previous op was the same gap, one D or I a step once i
// or j is spent, and plain op codes 1-3 written as int16 into ops (S, B),
// S = D + 1, end-to-front, 0 after the walk ends (the assembler reads a
// plain code as a count of 1).  Bound and design as K3's: one thread per
// pair, a dependent chain of byte reads, one per move.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define OP_NONE 0
#define OP_M 1
#define OP_D 2
#define OP_I 3
#define DIR_UP 1
#define DIR_LEFT 2
#define DIR_EXTUP 4
#define DIR_EXTLEFT 8

__global__ void __launch_bounds__(THREADS)
nw_backtrack_kernel(const uint16_t* __restrict__ dirs,
                    const int32_t* __restrict__ qlen,
                    const int32_t* __restrict__ tlen,
                    int M, int N, int B, int S,
                    int16_t* __restrict__ ops)
{
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    int i = qlen[b] - 1;
    int j = tlen[b] - 1;
    int prev = OP_NONE;
    int t = 0;
    while (t < S && (i >= 0 || j >= 0)) {
        int op, cnt;
        if (i >= 0 && j >= 0) {
            const int ci = min(i, M - 1);
            const int cj = min(j, N - 1);
            const int d = dirs[((size_t)ci * N + cj) * B + b];
            const int rl = (d >> 4) & 0xFFF;
            if (prev == OP_I && (d & DIR_EXTLEFT)) op = OP_I;
            else if (prev == OP_D && (d & DIR_EXTUP)) op = OP_D;
            else if (d & DIR_LEFT) op = OP_I;
            else if (d & DIR_UP) op = OP_D;
            else op = OP_M;
            cnt = (op == OP_M) ? max(rl, 1) : 1;
        } else {
            op = (i >= 0) ? OP_D : OP_I;
            cnt = min(((i >= 0) ? i : j) + 1, 4095);
        }
        ops[(size_t)t * B + b] = (int16_t)(op | (cnt << 2));
        if (op == OP_D || op == OP_M) i -= cnt;
        if (op == OP_I || op == OP_M) j -= cnt;
        prev = op;
        ++t;
    }
    for (; t < S; ++t) ops[(size_t)t * B + b] = 0;
}

extern "C" int nw_backtrack_launch(const void* dirs, const void* qlen,
                                   const void* tlen, int M, int N, int B,
                                   int S, void* ops, void* stream)
{
    dim3 grid((B + THREADS - 1) / THREADS);
    nw_backtrack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)dirs, (const int32_t*)qlen, (const int32_t*)tlen,
        M, N, B, S, (int16_t*)ops);
    return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
nw_backtrack_flat_kernel(const uint8_t* __restrict__ dirs,
                         const int32_t* __restrict__ qlen,
                         const int32_t* __restrict__ tlen,
                         int D, int B, int Ms,
                         int16_t* __restrict__ ops)
{
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    const int S = D + 1;
    int i = qlen[b] - 1;
    int j = tlen[b] - 1;
    int prev = OP_NONE;
    int t = 0;
    for (; t < S && (i >= 0 || j >= 0); ++t) {
        int op;
        if (i >= 0 && j >= 0) {
            const int d = min(i + j, D - 1);
            const int w = dirs[((size_t)d * B + b) * Ms + min(i, Ms - 1)];
            if (prev == OP_I && (w & DIR_EXTLEFT)) op = OP_I;
            else if (prev == OP_D && (w & DIR_EXTUP)) op = OP_D;
            else if (w & DIR_LEFT) op = OP_I;
            else if (w & DIR_UP) op = OP_D;
            else op = OP_M;
        } else {
            op = (i >= 0) ? OP_D : OP_I;
        }
        ops[(size_t)t * B + b] = (int16_t)op;
        if (op == OP_D || op == OP_M) --i;
        if (op == OP_I || op == OP_M) --j;
        prev = op;
    }
    for (; t < S; ++t) ops[(size_t)t * B + b] = 0;
}

extern "C" int nw_backtrack_flat_launch(const void* dirs, const void* qlen,
                                        const void* tlen, int D, int B,
                                        int Ms, void* ops, void* stream)
{
    dim3 grid((B + THREADS - 1) / THREADS);
    nw_backtrack_flat_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)dirs, (const int32_t*)qlen, (const int32_t*)tlen,
        D, B, Ms, (int16_t*)ops);
    return (int)cudaGetLastError();
}
