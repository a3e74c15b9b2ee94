// K5: the allpairs stats walk over K2m's direction and match planes.
//
// Replaces: vsearch_tpu/ops/allpairs_dev.py build_allpairs_stats
// (allpairs_dev.py:79-177), an XLA while_loop on the TPU (not a Pallas
// kernel).  Same function: the run-length walk of K3 (csrc/nw_backtrack.cu)
// from (qlen-1, tlen-1), consuming a whole diagonal run chunk, one I/D move
// (the extension bits win when the previous op was the same gap) or a whole
// boundary drain (count capped at 4095) per step, but instead of writing
// the ops it accumulates per pair, as int32 stats (B, 8) in the JAX
// column order:
//     aligned, matches, indels, gap_opens, first_op, first_len, last_op,
//     last_len
// matches adds the chunk's count from the match plane mr (M, N, B) uint8 at
// the cell the step reads, on diagonal steps only (drains add none);
// gap_opens counts gap steps whose op differs from the previous one (prev
// starts at OP_NONE); the first run merges consecutive steps of the same op
// (RLCAP-split chunks included) and is whatever run is current when the
// walk ends; the last run is set at the first step, extended while the op
// stays the same and frozen at the first change.  The steps are bounded by
// S = 2W.
//
// What bounds it on the H100: latency, as for K3.  The bytes it must move
// are the dirs and mr cells on the walked path (3 bytes a step) and 32
// bytes of stats a pair, but each step's read depends on the previous
// step's position.  Design: one thread per pair, a dependent chain of
// reads per run; every accumulator is a register.  The TPU's walk grouped
// four forward batches per loop because its per-step gather cost grew far
// slower than its lane count; a thread's step has no such cost, so K5 runs
// once per forward batch.
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
nw_stats_kernel(const uint16_t* __restrict__ dirs,
                const uint8_t* __restrict__ mr,
                const int32_t* __restrict__ qlen,
                const int32_t* __restrict__ tlen,
                int M, int N, int B, int S,
                int32_t* __restrict__ stats)
{
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    int i = qlen[b] - 1;
    int j = tlen[b] - 1;
    int prev = OP_NONE;
    int aligned = 0, matches = 0, indels = 0, gap_opens = 0;
    int cur_op = OP_NONE, cur_len = 0, last_op = OP_NONE, last_len = 0;
    bool last_still = true;
    for (int t = 0; t < S && (i >= 0 || j >= 0); ++t) {
        int op, cnt;
        if (i >= 0 && j >= 0) {
            const size_t idx = ((size_t)min(i, M - 1) * N + min(j, N - 1))
                               * B + b;
            const int d = dirs[idx];
            const int rl = (d >> 4) & 0xFFF;
            if (prev == OP_I && (d & DIR_EXTLEFT)) op = OP_I;
            else if (prev == OP_D && (d & DIR_EXTUP)) op = OP_D;
            else if (d & DIR_LEFT) op = OP_I;
            else if (d & DIR_UP) op = OP_D;
            else op = OP_M;
            cnt = (op == OP_M) ? max(rl, 1) : 1;
            if (op == OP_M) matches += mr[idx];
        } else {
            op = (i >= 0) ? OP_D : OP_I;
            cnt = min(((i >= 0) ? i : j) + 1, 4095);
        }
        aligned += cnt;
        if (op == OP_D || op == OP_I) {
            indels += cnt;
            if (op != prev) ++gap_opens;
        }
        cur_len = (op == cur_op) ? cur_len + cnt : cnt;
        cur_op = op;
        if (t == 0) last_op = op;
        last_still = last_still && op == last_op;
        if (last_still) last_len += cnt;
        if (op == OP_D || op == OP_M) i -= cnt;
        if (op == OP_I || op == OP_M) j -= cnt;
        prev = op;
    }
    int32_t* row = stats + (size_t)b * 8;
    row[0] = aligned;
    row[1] = matches;
    row[2] = indels;
    row[3] = gap_opens;
    row[4] = cur_op;
    row[5] = cur_len;
    row[6] = last_op;
    row[7] = last_len;
}

extern "C" int nw_stats_launch(const void* dirs, const void* mr,
                               const void* qlen, const void* tlen, int M,
                               int N, int B, int S, void* stats, void* stream)
{
    dim3 grid((B + THREADS - 1) / THREADS);
    nw_stats_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)dirs, (const uint8_t*)mr, (const int32_t*)qlen,
        (const int32_t*)tlen, M, N, B, S, (int32_t*)stats);
    return (int)cudaGetLastError();
}
