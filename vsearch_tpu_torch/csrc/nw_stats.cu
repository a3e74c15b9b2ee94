// K5: the allpairs stats walk over K2m's direction and match planes.
//
// Replaces: vsearch_tpu/ops/allpairs_dev.py build_allpairs_stats
// (allpairs_dev.py:79-177), an XLA while_loop on the TPU (not a Pallas
// kernel).  Same function: the run-length walk of K3 (csrc/nw_backtrack.cu)
// from (qlen-1, tlen-1), each entry consuming a whole diagonal run chunk
// (count max(run length, 1)), one I/D move (the extension bits win when
// the previous op was the same gap) or a whole boundary drain (count
// capped at 4095), but instead of writing the ops it accumulates per pair,
// as int32 stats (B, 8) in the JAX column order:
//     aligned, matches, indels, gap_opens, first_op, first_len, last_op,
//     last_len
// matches adds the match plane mr (M, N, B) uint8 at the cell the entry
// reads, on diagonal entries only (drains add none); gap_opens counts gap
// entries whose op differs from the previous one (prev starts at OP_NONE);
// the first run merges consecutive entries of the same op (RLCAP-split
// chunks and capped drains included) and is whatever run is current when
// the walk ends; the last run is set at the first entry, extended while
// the op stays the same and frozen at the first change.  At most S = M + N
// entries.  Cell (i, j) is read at [min(i, M-1), min(j, N-1), b].
//
// What bounds it on the H100: latency and scattered sectors, as K3.  The
// bytes it must move are the dirs and mr cells on the walked path (3
// bytes an entry) and 32 bytes of stats a pair, but each entry's read
// depends on the previous entry's position, and with the pair index
// fastest in the planes every cell of one pair is its own 32-byte sector.
// The first design, one thread a pair on B/128 SMs, paid two dependent
// round trips a diagonal entry (dirs, then mr behind the decoded op).
//
// Design: K3's, one warp a pair walking triangle windows.  A window is
// the cells (ai - r, aj - c), r, c >= 0, r + c < K5_SPAN, up-left of its
// anchor: every cell the path can reach in fewer than K5_SPAN rows and
// columns (28 at span 7, one a lane), loaded in one round of independent
// evict-first loads.  Each lane decodes its cells for the three states
// the previous op leaves (M or none, I, D) into transition words in the
// warp's slice of shared memory (the entry op | count << 2, the table
// slot the path goes to next or K5_EXIT when it leaves the window or
// reaches the plane's edge, the cell's offset from the anchor), and the
// walk is one shared load an entry until the path leaves the triangle.
// Every accumulator, prev and the last run's state live in registers,
// the same in every lane; lane 0 writes the 32-byte row at the end.
//
// The match count: the walk reads the window from dirs alone, each lane
// noting the diagonal entries at its own cells, and loads their mr in the
// next window's round (one more round after the last window), summed
// across the warp at the end: sectors only for the path's diagonal cells.
//
// What bounds it now, measured on the allpairs cell's first batch (B=4096,
// M=N=400; tools/tune_stats.py on an H100 80GB HBM3): the windows'
// sectors.  Its pairs walk 112 entries in 20 windows on average (340 and
// 49 at most); the 4096 warps fetch 2.3 million window cells, each its
// own 32-byte sector, in one wave, and under that load a round takes
// ~3100 cycles.  The slowest pair spends 103 000 of its 161 000 cycles in
// its 49 fetches and 58 000 walking.  At B=4096 a smaller span fetches
// fewer sectors in more rounds and spans 6-7 are best; mr of every window
// cell in the table costs 1.4-1.5x; loads through the read-only or
// L2-only path cost 5 % right after K2m.  The cell's tail batch (B=152 on
// 38 SMs, ~990 cycles a round, 1 launch of the cell's 489) ranks them
// otherwise: there mr in the table and 1 pair a block are faster, and the
// read-only and L2-only loads are faster warm.
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

// the window's span in rows and columns (at most 16: a transition word
// keeps the offset in 4 bits each) and pairs (warps) a block
// (tools/tune_stats.py times other values)
#define K5_SPAN 7
#define K5_PAIRS 4
#define K5_CELLS (K5_SPAN * (K5_SPAN + 1) / 2)
#define K5_PER_LANE ((K5_CELLS + 31) / 32)
// a transition word's next slot when the path leaves the window
#define K5_EXIT 511
static_assert(K5_SPAN <= 16 && 3 * K5_CELLS < K5_EXIT, "K5_SPAN too large");

// the table of transitions a previous op selects: 0 after M (or at the
// walk's start), 1 after I, 2 after D
__device__ __forceinline__ int k5_state(int op)
{
    return op == OP_I ? 1 : (op == OP_D ? 2 : 0);
}

// the stats of one pair's walk so far, the same in every lane
struct k5_stats {
    int aligned = 0, matches = 0, indels = 0, gap_opens = 0;
    int cur_op = OP_NONE, cur_len = 0, last_op = OP_NONE, last_len = 0;
    int prev = OP_NONE, t = 0;
    bool last_still = true;

    // one entry of the walk: op (D, I or M) over cnt cells
    __device__ __forceinline__ void entry(int op, int cnt)
    {
        aligned += cnt;
        if (op != OP_M) {
            indels += cnt;
            gap_opens += op != prev;
        }
        cur_len = (op == cur_op) ? cur_len + cnt : cnt;
        cur_op = op;
        if (t == 0) last_op = op;
        last_still = last_still && op == last_op;
        if (last_still) last_len += cnt;
        prev = op;
        ++t;
    }
};

__global__ void __launch_bounds__(32 * K5_PAIRS)
nw_stats_kernel(const uint16_t* __restrict__ dirs,
                const uint8_t* __restrict__ mr,
                const int32_t* __restrict__ qlen,
                const int32_t* __restrict__ tlen,
                int M, int N, int B, int S,
                int32_t* __restrict__ stats)
{
    // per warp, 3 tables of K5_CELLS transition words: bits 0-13 the
    // entry, 14-22 the next slot, 23-26 and 27-30 the cell's (r, c)
    __shared__ uint32_t tab[K5_PAIRS][3 * K5_CELLS];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x * K5_PAIRS + w;
    if (b >= B) return;
    // this lane's cells of a window: cell lane + 32u of the triangle, row
    // by row, at offset (r, c) from the anchor; r = -1 past the last cell
    int cell_r[K5_PER_LANE], cell_c[K5_PER_LANE];
#pragma unroll
    for (int u = 0; u < K5_PER_LANE; ++u) {
        int k = lane + 32 * u, r = 0;
        while (r < K5_SPAN && k >= K5_SPAN - r) {
            k -= K5_SPAN - r;
            ++r;
        }
        cell_r[u] = r < K5_SPAN ? r : -1;
        cell_c[u] = k;
    }
    uint32_t* my = tab[w];
    k5_stats s;
    // this lane's share of the match count, and the cells of the last
    // window whose mr the walk owes it (bit u: cell lane + 32u, at[u])
    int lane_matches = 0;
    unsigned owed = 0;
    size_t at[K5_PER_LANE];
    int i = qlen[b] - 1;
    int j = tlen[b] - 1;
    while (s.t < S && (i >= 0 || j >= 0)) {
        if (i < 0 || j < 0) {
            // a boundary drain
            const int op = (i >= 0) ? OP_D : OP_I;
            const int cnt = min(((i >= 0) ? i : j) + 1, 4095);
            s.entry(op, cnt);
            if (op == OP_D) i -= cnt;
            else j -= cnt;
            continue;
        }
        // fetch the window anchored at (i, j): the loads first, all in
        // flight together
        uint16_t v[K5_PER_LANE];
        uint8_t m[K5_PER_LANE];
#pragma unroll
        for (int u = 0; u < K5_PER_LANE; ++u) {
            m[u] = 0;
            if (owed >> u & 1) m[u] = __ldcs(mr + at[u]);
        }
#pragma unroll
        for (int u = 0; u < K5_PER_LANE; ++u) {
            const int ci = i - cell_r[u], cj = j - cell_c[u];
            const size_t idx = ((size_t)min(ci, M - 1) * N + min(cj, N - 1))
                               * B + b;
            v[u] = 0;
            if (cell_r[u] >= 0 && ci >= 0 && cj >= 0)
                v[u] = __ldcs(dirs + idx);
            at[u] = idx;
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < K5_PER_LANE; ++u) {
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
                const int next = (nr + nc < K5_SPAN && nr <= i && nc <= j)
                    ? k5_state(op) * K5_CELLS
                          + nr * (2 * K5_SPAN + 1 - nr) / 2 + nc
                    : K5_EXIT;
                const uint32_t word = (uint32_t)(op | (cnt << 2))
                    | ((uint32_t)next << 14) | ((uint32_t)r << 23)
                    | ((uint32_t)c << 27);
                my[st * K5_CELLS + k] = word;
            }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < K5_PER_LANE; ++u) lane_matches += m[u];
        owed = 0;
        // walk the window from its anchor, cell 0
        int slot = k5_state(s.prev) * K5_CELLS;
        uint32_t e;
        do {
            e = my[slot];
            if ((e & 3) == OP_M) {
                const int k = slot % K5_CELLS;
                if ((k & 31) == lane) owed |= 1u << (k >> 5);
            }
            s.entry(e & 3, (e >> 2) & 0xFFF);
            slot = (e >> 14) & K5_EXIT;
        } while (slot != K5_EXIT && s.t < S);
        // leave from the last entry's cell by its move
        const int op = e & 3, cnt = (e >> 2) & 0xFFF;
        i -= ((e >> 23) & 15) + (op != OP_I ? cnt : 0);
        j -= ((e >> 27) & 15) + (op != OP_D ? cnt : 0);
    }
    // the last window's diagonal cells, then the warp's sum
#pragma unroll
    for (int u = 0; u < K5_PER_LANE; ++u)
        if (owed >> u & 1) lane_matches += __ldcs(mr + at[u]);
    s.matches = __reduce_add_sync(0xffffffffu, lane_matches);
    if (lane == 0) {
        int32_t* row = stats + (size_t)b * 8;
        row[0] = s.aligned;
        row[1] = s.matches;
        row[2] = s.indels;
        row[3] = s.gap_opens;
        row[4] = s.cur_op;
        row[5] = s.cur_len;
        row[6] = s.last_op;
        row[7] = s.last_len;
    }
}

extern "C" int nw_stats_launch(const void* dirs, const void* mr,
                               const void* qlen, const void* tlen, int M,
                               int N, int B, int S, void* stats, void* stream)
{
    dim3 grid((B + K5_PAIRS - 1) / K5_PAIRS);
    nw_stats_kernel<<<grid, 32 * K5_PAIRS, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)dirs, (const uint8_t*)mr, (const int32_t*)qlen,
        (const int32_t*)tlen, M, N, B, S, (int32_t*)stats);
    return (int)cudaGetLastError();
}
