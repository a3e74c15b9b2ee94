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
// plain code as a count of 1).
//
// What bounds it on the H100: latency.  The bytes it must move are one
// byte a cell the path reads and the (S, B) int16 ops written once, about
// 1.6 MB at B=512, M=N=640 (0.5 us at the HBM rate); but each move's read
// depends on the move before.  The first design, one thread a pair, paid
// one dependent round trip a move (~629 a pair at ~95 % identity) on
// B/128 SMs: 0.41 ms at that shape.
//
// Design: one warp a pair, walking windows of K7_SPAN diagonals, K3's
// design carried over to K6's plane.  From anchor (i, j), d = i + j, the
// cells the path can reach within k diagonals, (i - r, j - (k - r)) for r
// = 0..k, lie at [d - k, b, i - k .. i]: k + 1 consecutive bytes of one
// row of the plane, whose rows start 128-byte aligned.  Lane l loads
// diagonals d - l and d - l - 32 as at most five aligned 16-byte chunks
// each (ld.global.cs: each cell is read about once), all in flight
// together, into the warp's slice of shared memory.  Every lane then
// walks the same path through the window.  A move is one shared byte
// load and one shift of a 32-bit table the previous op selects (k7_lut).
// After an M the extension bits play no part, and the path takes M at
// every cell without LEFT or UP: lane l tests the cell l M moves on, and
// one ballot takes the whole run of M moves, so a pair at high identity
// walks in about a fifth as many steps as moves.  K7_AHEAD diagonals into
// a window the loads of the window anchored at the walk's cell go out,
// and the walk finishes the current window while they are in flight.
// A window that reaches past the plane (a qlen above M or a tlen above
// N), or a plane whose rows are not 16-byte aligned, is loaded a byte a
// cell at the plain version's clamped addresses.  The ops go through a
// 128-entry ring in shared memory and are stored 32 a round whenever the
// walk pauses; once i or j is spent the rest of the column (the drain's
// codes, then zeros to S) is known and stored the same way, so the
// wrapper's torch.empty needs no fill.
//
// What bounds it now, measured at the search prefetch's shape (B=512,
// M=N=640, right after K6; tools/tune_backtrack_flat.py on an H100 80GB
// HBM3): the walk's dependent steps, 118 a pair (629 moves, 37 windows)
// at ~450 cycles a step (about 70 instructions, one warp a scheduler),
// two thirds of a pair's ~83 000 cycles, and the window fetches the walk
// does not cover, the other third (~800 cycles each).  Windows of 32
// diagonals, no lookahead, every move alone or decided by branches, a
// transition table of the window, and windows copied by cp.async are all
// slower.
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

// K7's window: the diagonals it spans (one or two a lane, at most 64),
// the diagonal offset from its anchor at which the walk starts fetching the
// next window (K7_SPAN: only once it has left this one), and pairs (warps)
// a block (tools/tune_backtrack_flat.py times other values)
#define K7_SPAN 64
#define K7_AHEAD 32
#define K7_PAIRS 4
// 16-byte chunks of a diagonal's row that a window keeps: rows i - K7_SPAN
// + 1 .. i of its anchor row i lie within the K7_CHUNKS chunks that end
// with the chunk of row i
#define K7_CHUNKS (1 + (K7_SPAN + 14) / 16)
#define K7_WIDTH (16 * K7_CHUNKS)
#define K7_LOADS ((K7_SPAN + 31) / 32)
static_assert(K7_SPAN >= 2 && K7_SPAN <= 64, "K7_SPAN out of range");
static_assert(K7_AHEAD >= 2 && K7_AHEAD <= K7_SPAN, "K7_AHEAD out of range");

// a build with -DK7_COUNT_WINDOWS=n also counts the windows each of the
// first n pairs fetches, read back by nw_backtrack_flat_windows
// (chip_smoke.py reports them); the shipped build compiles none of it
#ifdef K7_COUNT_WINDOWS
__device__ int k7_windows[K7_COUNT_WINDOWS];
#define K7_COUNT(...) __VA_ARGS__
#else
#define K7_COUNT(...)
#endif

// the plain version's move at a cell with direction bits w, after a
// previous op prev (M, D, I or none), as bits 2w..2w+1 of k7_lut(prev): a
// move is one shift of a register, with no branch
__host__ __device__ constexpr uint32_t k7_lut(int prev)
{
    uint32_t lut = 0;
    for (int w = 0; w < 16; ++w) {
        int op = OP_M;
        if (prev == OP_I && (w & DIR_EXTLEFT)) op = OP_I;
        else if (prev == OP_D && (w & DIR_EXTUP)) op = OP_D;
        else if (w & DIR_LEFT) op = OP_I;
        else if (w & DIR_UP) op = OP_D;
        lut |= (uint32_t)op << (2 * w);
    }
    return lut;
}

// the first row a window anchored at row i keeps
__device__ __forceinline__ int k7_base(int i)
{
    return (i & ~15) - 16 * (K7_CHUNKS - 1);
}

// does lane k's chunk c hold a row the path can reach on diagonal d - k
// from anchor (i, d - i): rows i - k .. i at columns >= 0
__device__ __forceinline__ bool k7_chunk(int k, int c, int i, int d)
{
    const int r0 = k7_base(i) + 16 * c;
    return k < K7_SPAN && r0 + 15 >= max(i - k, 0) && r0 <= min(i, d - k);
}

__global__ void __launch_bounds__(32 * K7_PAIRS)
nw_backtrack_flat_kernel(const uint8_t* __restrict__ dirs,
                         const int32_t* __restrict__ qlen,
                         const int32_t* __restrict__ tlen,
                         int D, int B, int Ms,
                         int16_t* __restrict__ ops)
{
    // per warp, the window: diagonal d - k of anchor (i, j), d = i + j, at
    // win[w][k * K7_WIDTH + row - k7_base(i)]
    __shared__ __align__(16) uint8_t win[K7_PAIRS][K7_SPAN * K7_WIDTH];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x * K7_PAIRS + w;
    if (b >= B) return;
    uint8_t* my = win[w];
    // rows of 16-byte multiples at a 16-byte aligned plane take 16-byte
    // loads; any other plane is read a byte a cell
    const bool aligned = (((uintptr_t)dirs | (uintptr_t)Ms) & 15) == 0;
    const int S = D + 1;
    int16_t* out = ops + b;
    int i = qlen[b] - 1;
    int j = tlen[b] - 1;
    constexpr uint32_t lut_m = k7_lut(OP_M), lut_d = k7_lut(OP_D),
                       lut_i = k7_lut(OP_I);
    uint32_t lut = lut_m;   // the previous op's table
    int t = 0;
    // the ops of the moves walked, end to front, in a ring of 128 in
    // shared memory; the warp stores them to ops 32 a round (flushed: the
    // moves stored so far) each time the walk pauses
    __shared__ uint8_t rings[K7_PAIRS][128];
    uint8_t* ring = rings[w];
    int flushed = 0;
    K7_COUNT(int fetched = 0;)
    auto flush = [&]() {
        __syncwarp();
        for (; flushed + 32 <= t; flushed += 32)
            out[(size_t)(flushed + lane) * B] = ring[(flushed + lane) & 127];
    };
    // a window's 16-byte chunks on their way to shared memory: every
    // cell the path can reach in fewer than K7_SPAN diagonals from anchor
    // (ai, aj), (ai - r, aj - (k - r)) for 0 <= r <= k < K7_SPAN, is in
    // the run [d - k, b, ai - k .. ai] of the plane, d = ai + aj; lane l
    // takes diagonals d - l and d - l - 32.  The loads go out all
    // together and evict first (ld.global.cs): each cell is read about
    // once.  A window inside the plane (d < D, ai < Ms) takes runs
    uint4 v[K7_LOADS][K7_CHUNKS];
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
    // one move from cell my[a], a = k * K7_WIDTH + row - base at diagonal
    // offset k; every lane walks the same path
    int k, a;
    auto move = [&]() {
        const int op = (lut >> (2 * (my[a] & 15))) & 3;
        lut = op == OP_I ? lut_i : (op == OP_D ? lut_d : lut_m);
        ring[t++ & 127] = (uint8_t)op;
        k += op == OP_M ? 2 : 1;
        a += op == OP_M ? 2 * K7_WIDTH - 1
                        : (op == OP_D ? K7_WIDTH - 1 : K7_WIDTH);
        if (op != OP_I) --i;
        if (op != OP_D) --j;
    };
    // the moves while the walk stays within lim diagonals of the anchor.
    // After an M (or at the start) the extension bits play no part, and
    // the path takes M at every cell without the LEFT and UP bits: lane l
    // tests the cell l M moves on, and one ballot gives the whole run of M
    // moves (most of a path at high identity), then one move leaves it
    auto walk = [&](int lim) {
        while (k < lim && (i | j) >= 0) {
            if (lut == lut_m) {
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
            move();
        }
    };
    while (i >= 0 && j >= 0 && t < S) {
        // fetch the window anchored at (i, j) and wait for it.  One that
        // reaches past the plane's last diagonal or row (a qlen above M or
        // a tlen above N), or a plane that takes no 16-byte loads, is
        // read a byte a cell at the plain version's clamped addresses
        const int base = k7_base(i);
        K7_COUNT(++fetched;)
        __syncwarp();
        if (aligned && i + j < D && i < Ms) {
            load(i, j);
            store(i, j);
        } else {
            for (int u = 0; u < K7_LOADS; ++u) {
                const int kk = lane + 32 * u, dk = i + j - kk;
                if (kk >= K7_SPAN || dk < 0) break;
                const uint8_t* row =
                    dirs + ((size_t)min(dk, D - 1) * B + b) * Ms;
                for (int r = max(i - kk, 0); r <= min(i, dk); ++r)
                    my[kk * K7_WIDTH + r - base] = row[min(r, Ms - 1)];
            }
        }
        __syncwarp();
        // walk it: a move takes at least one diagonal, so t stays below S
        // within kmax diagonals of the anchor
        k = 0;
        a = i - base;
        int kmax = min(K7_SPAN, S - t);
        for (;;) {
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
    }
    K7_COUNT(if (lane == 0 && b < K7_COUNT_WINDOWS) k7_windows[b] = fetched;)
    // the rest of the column, 32 entries a round: the moves not yet
    // stored, a drain of i + 1 D or j + 1 I moves once j or i is spent,
    // then zeros to S
    const int drain = i >= 0 ? OP_D : OP_I;
    const int tend = t + max(max(i, j) + 1, 0);
    for (int u = (t & ~31) + lane; u < S; u += 32)
        out[(size_t)u * B] =
            (int16_t)(u < t ? ring[u & 127] : (u < tend ? drain : 0));
}

extern "C" int nw_backtrack_flat_launch(const void* dirs, const void* qlen,
                                        const void* tlen, int D, int B,
                                        int Ms, void* ops, void* stream)
{
    dim3 grid((B + K7_PAIRS - 1) / K7_PAIRS);
    nw_backtrack_flat_kernel<<<grid, 32 * K7_PAIRS, 0,
                               (cudaStream_t)stream>>>(
        (const uint8_t*)dirs, (const int32_t*)qlen, (const int32_t*)tlen,
        D, B, Ms, (int16_t*)ops);
    return (int)cudaGetLastError();
}

#ifdef K7_COUNT_WINDOWS
extern "C" int nw_backtrack_flat_windows(void* dst, int n)
{
    return (int)cudaMemcpyFromSymbol(dst, k7_windows,
                                     (size_t)n * sizeof(int));
}
#endif
