// K3: run-length backtrack over the row-scan forward's direction plane.
//
// Replaces: vsearch_tpu/ops/nw_jax.py backtrack_rle (nw_jax.py:320-377),
// an XLA while_loop on the TPU (not a Pallas kernel).  Same function: from
// (qlen-1, tlen-1) each step consumes a whole diagonal run (count =
// max(run length, 1)), one I/D move (the extension bits win when the
// previous op was the same gap), or a whole boundary drain (count capped at
// 4095), and writes int16 op | count << 2 end-to-front into ops (S, B);
// entries after the walk ends are 0.  This is the wire that the native
// tier's assemble_batch reads.  Cell (i, j) is read at
// [min(i, M-1), min(j, N-1), b] of the (M, N, B) uint16 plane.
//
// What bounds it on the H100: latency and scattered sectors.  The bytes it
// must move are the cells its paths read (~#runs of 2 bytes a pair) and
// the (S, B) int16 ops written once, a few MB; but each step's read
// depends on the previous step's position, and with the pair index
// fastest in the plane every cell of one pair is its own 32-byte sector,
// 2B bytes from its neighbour along j and 2BN bytes along i (a 2 MiB row
// at B=2048, N=512).  The first design, one thread a pair, paid one
// dependent round trip a run (a reject-like pair walks 100-300 runs) on
// B/128 SMs.
//
// Design: one warp a pair, walking windows of the plane.  A window is the
// triangle up-left of its anchor cell (ai, aj): the cells (ai - r, aj - c)
// with r, c >= 0 and r + c < K3_SPAN, every cell the path can reach in
// fewer than K3_SPAN rows and columns (28 cells at span 7, one load a
// lane).  Its cells are loaded in one round of independent loads.  Each
// lane then decodes its cells for the three states the previous op leaves
// (M or none, I, D) into transition words in the warp's slice of shared
// memory: the entry op | count << 2, the table slot of the cell and state
// the path goes to next (K3_EXIT when it leaves the window or reaches the
// plane's edge), and the cell's offset from the anchor.  The walk is then
// one shared load an entry (~120 cycles an entry; decoding each cell on
// the walk's chain cost ~415).  Only when the path leaves the triangle is
// the window at its next cell fetched.  prev (the extension-bit state)
// lives in registers across windows.  Every lane stores each entry to the
// same address (one request, no divergent branch); the wrapper zeroes ops
// first, so the walk stores only its entries.
//
// What bounds it now, measured at the cluster prefetch's shape (B=2048,
// M=N=512; tools/tune_backtrack.py on an H100 80GB HBM3): the rounds of
// the longest path, 43 at span 7, ~0.9 us each under the load of every
// warp's fetches (0.36 us for one dependent DRAM load on an idle card),
// and the windows' sectors, each cell its own 32-byte sector: 0.93
// million at span 7, 2.1 million at span 13, which needs 26 rounds but
// is slower.  The window loads are marked evict-first (ld.global.cs): each
// cell is read about once, and leaving L2 to the rest took that shape
// from 0.065 to 0.057 ms right after K2.
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
// plain code as a count of 1).  Bound and design as K3's first: one
// thread per pair, a dependent chain of byte reads, one per move.
#include <cuda_runtime.h>
#include <stdint.h>

#define OP_NONE 0
#define OP_M 1
#define OP_D 2
#define OP_I 3
#define DIR_UP 1
#define DIR_LEFT 2
#define DIR_EXTUP 4
#define DIR_EXTLEFT 8

// K3's window: the triangle's span in rows and columns (at most 16: a
// transition word keeps the offset in 4 bits each), and pairs (warps) a
// block (tools/tune_backtrack.py times other values)
#define K3_SPAN 7
#define K3_PAIRS 4
#define K3_CELLS (K3_SPAN * (K3_SPAN + 1) / 2)
#define K3_PER_LANE ((K3_CELLS + 31) / 32)
// a transition word's next slot when the path leaves the window
#define K3_EXIT 511
static_assert(K3_SPAN <= 16 && 3 * K3_CELLS < K3_EXIT, "K3_SPAN too large");

// the table of transitions a previous op selects: 0 after M (or at the
// walk's start), 1 after I, 2 after D
__device__ __forceinline__ int k3_state(int op)
{
    return op == OP_I ? 1 : (op == OP_D ? 2 : 0);
}

__global__ void __launch_bounds__(32 * K3_PAIRS)
nw_backtrack_kernel(const uint16_t* __restrict__ dirs,
                    const int32_t* __restrict__ qlen,
                    const int32_t* __restrict__ tlen,
                    int M, int N, int B, int S,
                    int16_t* __restrict__ ops)
{
    // per warp, 3 tables of K3_CELLS transition words: bits 0-13 the
    // entry, 14-22 the next slot, 23-26 and 27-30 the cell's (r, c)
    __shared__ uint32_t tab[K3_PAIRS][3 * K3_CELLS];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x * K3_PAIRS + w;
    if (b >= B) return;
    // this lane's cells of a window: cell lane + 32u of the triangle, row
    // by row, at offset (r, c) from the anchor; r = -1 past the last cell
    int cell_r[K3_PER_LANE], cell_c[K3_PER_LANE];
#pragma unroll
    for (int u = 0; u < K3_PER_LANE; ++u) {
        int k = lane + 32 * u, r = 0;
        while (r < K3_SPAN && k >= K3_SPAN - r) {
            k -= K3_SPAN - r;
            ++r;
        }
        cell_r[u] = r < K3_SPAN ? r : -1;
        cell_c[u] = k;
    }
    uint32_t* my = tab[w];
    int16_t* out = ops + b;
    int i = qlen[b] - 1;
    int j = tlen[b] - 1;
    int prev = OP_NONE;
    int t = 0;
    while (t < S && (i >= 0 || j >= 0)) {
        if (i < 0 || j < 0) {
            // a boundary drain
            const int op = (i >= 0) ? OP_D : OP_I;
            const int cnt = min(((i >= 0) ? i : j) + 1, 4095);
            out[(size_t)t * B] = (int16_t)(op | (cnt << 2));
            if (op == OP_D) i -= cnt;
            else j -= cnt;
            prev = op;
            ++t;
            continue;
        }
        // fetch the window anchored at (i, j): the loads first, all in
        // flight together
        uint16_t v[K3_PER_LANE];
#pragma unroll
        for (int u = 0; u < K3_PER_LANE; ++u) {
            const int ci = i - cell_r[u], cj = j - cell_c[u];
            v[u] = 0;
            if (cell_r[u] >= 0 && ci >= 0 && cj >= 0)
                v[u] = __ldcs(dirs + ((size_t)min(ci, M - 1) * N
                                     + min(cj, N - 1)) * B + b);
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < K3_PER_LANE; ++u) {
            const int r = cell_r[u], c = cell_c[u], d = v[u];
            if (r < 0) continue;
            const int rl = max((d >> 4) & 0xFFF, 1);
            const int k = lane + 32 * u;
#pragma unroll
            for (int st = 0; st < 3; ++st) {
                int op;
                if (st == 1 && (d & DIR_EXTLEFT)) op = OP_I;
                else if (st == 2 && (d & DIR_EXTUP)) op = OP_D;
                else if (d & DIR_LEFT) op = OP_I;
                else if (d & DIR_UP) op = OP_D;
                else op = OP_M;
                const int cnt = (op == OP_M) ? rl : 1;
                const int nr = r + (op != OP_I ? cnt : 0);
                const int nc = c + (op != OP_D ? cnt : 0);
                const int next = (nr + nc < K3_SPAN && nr <= i && nc <= j)
                    ? k3_state(op) * K3_CELLS
                          + nr * (2 * K3_SPAN + 1 - nr) / 2 + nc
                    : K3_EXIT;
                my[st * K3_CELLS + k] = (uint32_t)(op | (cnt << 2))
                    | ((uint32_t)next << 14) | ((uint32_t)r << 23)
                    | ((uint32_t)c << 27);
            }
        }
        __syncwarp();
        // walk the window from its anchor, cell 0
        int slot = k3_state(prev) * K3_CELLS;
        uint32_t e;
        do {
            e = my[slot];
            out[(size_t)t * B] = (int16_t)(e & 0x3FFF);
            ++t;
            slot = (e >> 14) & K3_EXIT;
        } while (slot != K3_EXIT && t < S);
        // leave from the last entry's cell by its move
        const int op = e & 3, cnt = (e >> 2) & 0xFFF;
        i -= ((e >> 23) & 15) + (op != OP_I ? cnt : 0);
        j -= ((e >> 27) & 15) + (op != OP_D ? cnt : 0);
        prev = op;
    }
}

extern "C" int nw_backtrack_launch(const void* dirs, const void* qlen,
                                   const void* tlen, int M, int N, int B,
                                   int S, void* ops, void* stream)
{
    // ops arrives zeroed (the wrapper's torch.zeros)
    dim3 grid((B + K3_PAIRS - 1) / K3_PAIRS);
    nw_backtrack_kernel<<<grid, 32 * K3_PAIRS, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)dirs, (const int32_t*)qlen, (const int32_t*)tlen,
        M, N, B, S, (int16_t*)ops);
    return (int)cudaGetLastError();
}

// K7's threads a block (one thread a pair)
#define THREADS 128

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
