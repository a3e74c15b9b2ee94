// K1 and K4: shared-k-mer counts of a query chunk against a packed-bit
// index block, with the top-k key folded in the epilogue.
//
// K1 replaces vsearch_tpu/ops/score_mxu.py `_kernel` (the pl.pallas_call
// in dense_topk_kernel, score_mxu.py:130); K4 replaces `_kernel_ranked`
// (the pl.pallas_call in dense_topk_ranked_kernel, score_mxu.py:266), the
// growing index of clustering.  Same counts, three epilogues:
//
//     counts(q, pos) = sum over the k-mer ids set in Kbits[q] of
//                      bit (pos % 32) of bits[id, pos / 32]
//     K1 pack:  out = pos < n_real ? count << 17 | (2^17 - 1 - pos) : -1
//     K1:       out = count
//     K4:       out = rank[pos] < RANK_MAX
//                     ? count << 20 | (RANK_MAX - rank[pos]) : -1
//
// with columns in POSITION order (the TPU kernels' bit-interleaved column
// order, and K4's rank permutation into it, were artifacts of its unpack
// and are not reproduced).  rank is the reference min-heap rank of each
// position (ops/score_grow.py), RANK_MAX where the position is empty.
// bits is read through a row stride `ld` >= words, so a caller may scan a
// column prefix of a wider matrix (the growing index scans its filled
// positions only).
//
// What bounds it on the H100.  The TPU kernel runs the dense one-hot
// product, V * n_cols MACs per query.  Listing each query's own ~L k-mer
// ids instead makes the work L * words word-reads per query, and the floor
// is the bit matrix read once from HBM (839 MB at V=65536, 3200 words:
// 0.25 ms at 3.35 TB/s) plus the (qp, 32 * words) int32 output (0.06 ms at
// qp=512).  Three things kept the first design (byte-wide SWAR counters,
// one thread a word, tiles fastest in the grid) at 5x that floor:
//
// 1. Integer issue.  Adding a word into 8 SWAR byte counters took 24
//    integer instructions per (id, word), which issue at 64 lanes an SM a
//    clock: 1.6e10 instructions, ~1 ms, at qp=512, L~390, 3200 words.
//    Here each thread keeps its 32 positions' counts as PLANES bit planes
//    (plane j holds bit j of every count) and adds GROUP=16 ids' words at
//    a time with a Harley-Seal tree of carry-save adders: sum = a^b^c and
//    carry = majority(a, b, c) are one LOP3 each, 15 adders fold the 16
//    words into planes 0-3 and one carry word of weight 16, which ripples
//    into planes 4 and up (2 instructions a plane).  About 5 instructions
//    per (id, word) with the loads and their addresses.  The planes are
//    unpacked to counts once, into the padded shared stage, through
//    16-bit lanes (2 instructions per plane and lane pair).
// 2. L2 reuse.  With tiles fastest in the grid, the ~1000 resident blocks
//    were ~30 queries x every tile, so each query's rows came from HBM
//    (2.6 GB a launch).  Here queries vary fastest (blockIdx.x) within a
//    tile (blockIdx.y): the resident blocks gather rows of one or two
//    tiles of THREADS words (V * THREADS * 4 bytes, 33.5 MB at V=65536),
//    which stay in the 50 MB L2 while every query of the chunk reads them.
// 3. Loads in flight.  A group's 16 row loads are independent and issued
//    before the adder tree uses them; its 16 ids are 4 int4 reads from
//    shared memory (a broadcast: every thread of the block reads the same
//    ids).
//
// What bounds it now (H100 80GB HBM3 at 700 W; chip_smoke.py phase 2 and
// tools/tune_score_dense.py): K4 takes 0.729-0.734 ms at qp=512,
// V=65536, 3200 words, 2.3x its HBM bound, 0.211-0.214 ms on the 896-word
// prefix, and K1 1.000-1.009 ms at the search block (3200 words).  The
// rows a launch gathers are qp * L * words * 4 bytes from L2 (2.57 GB for
// K4, 3.87 GB for K1: 3.5-3.9 TB/s), and the queries of a chunk share few
// rows (~390 of 65536 k-mers each).  What moves it is how many word
// columns are in flight at once (resident threads / qp), which decides
// whether a tile's rows stay in L2: tiles fastest in the grid take K4 to
// 1.004 ms; fewer planes (9, windows of 496 ids: 40 registers, more
// blocks resident) to 0.812 ms; 64-word tiles (72 registers) help at 3200
// words (K4 0.707, K1 0.860 ms) and lose on the prefix (0.228 ms), which
// is what clustering launches.
//
// A count must fit the planes: ids are listed into shared memory and
// counted in windows of at most ID_CAP = 2048, so a window's count is at
// most 2048 < 2^PLANES; each window's planes are added into the stage, so
// K1's counts-only path stays exact for a query of any size (up to V ids)
// and K4's queries (at most MAX_COUNT = 2047 ids, ops/score_dense.py) take
// one window.  A window's ragged last group is padded with row 0 and its
// words masked to 0.
//
// The block lists its query's ids once: each thread popcounts the Kbits
// words tid, tid + THREADS, ... (cut to V), a warp scan and one shared
// atomic per warp reserve its slots (the order of ids in the list is
// free: the counts are sums), and the thread writes the ids that fall in
// the current window.  The epilogue writes the block's 32 * THREADS
// outputs from the padded stage so the stores are coalesced, and folds the
// key there (consecutive threads, consecutive positions: K4's rank reads
// coalesce too).
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define POS_BITS 17
#define RANK_BITS 20
#define RANK_MAX ((1 << RANK_BITS) - 1)
// ids counted between two flushes of the planes; a multiple of GROUP
#define ID_CAP 2048
#define GROUP 16
// bit planes of a window's counts: 2^PLANES > ID_CAP
#define PLANES 12

// epilogues
#define EPI_COUNTS 0
#define EPI_POS_KEY 1
#define EPI_RANK_KEY 2

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c)
{
    uint32_t d;
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

__device__ __forceinline__ uint32_t maj3(uint32_t a, uint32_t b, uint32_t c)
{
    uint32_t d;
    asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// carry-save adder: a + b + c = 2 * hi + lo, bitwise
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                    uint32_t b, uint32_t c)
{
    hi = maj3(a, b, c);
    lo = xor3(a, b, c);
}

// Kbits word kw of a query row, cut to ids below V (the one-hot operand
// has V columns)
__device__ __forceinline__ uint32_t kbits_word(const uint32_t* krow, int kw,
                                               int V)
{
    uint32_t word = krow[kw];
    const int keep = V - kw * 32;
    if (keep < 32)
        word = keep <= 0 ? 0u : (word & ((1u << keep) - 1u));
    return word;
}

// Add the words of GROUP ids (the last r of a TAIL group masked to 0) at
// this thread's column into the planes p: p[0..3] are the Harley-Seal
// accumulators of weight 1, 2, 4, 8; the group's weight-16 carry ripples
// into p[4..].
template <bool TAIL>
__device__ __forceinline__ void add_group(uint32_t (&p)[PLANES],
                                          const int* ids,
                                          const uint32_t* bcol, unsigned ld,
                                          int r)
{
    uint32_t x[GROUP];
    const int4* ids4 = reinterpret_cast<const int4*>(ids);
#pragma unroll
    for (int k = 0; k < GROUP / 4; ++k) {
        const int4 v = ids4[k];
        x[4 * k + 0] = __ldg(bcol + (size_t)(unsigned)v.x * ld);
        x[4 * k + 1] = __ldg(bcol + (size_t)(unsigned)v.y * ld);
        x[4 * k + 2] = __ldg(bcol + (size_t)(unsigned)v.z * ld);
        x[4 * k + 3] = __ldg(bcol + (size_t)(unsigned)v.w * ld);
    }
    if (TAIL) {
#pragma unroll
        for (int k = 1; k < GROUP; ++k)
            if (k >= r) x[k] = 0u;
    }
    uint32_t twosA, twosB, foursA, foursB, eightsA, eightsB, sixteens;
    csa(twosA, p[0], p[0], x[0], x[1]);
    csa(twosB, p[0], p[0], x[2], x[3]);
    csa(foursA, p[1], p[1], twosA, twosB);
    csa(twosA, p[0], p[0], x[4], x[5]);
    csa(twosB, p[0], p[0], x[6], x[7]);
    csa(foursB, p[1], p[1], twosA, twosB);
    csa(eightsA, p[2], p[2], foursA, foursB);
    csa(twosA, p[0], p[0], x[8], x[9]);
    csa(twosB, p[0], p[0], x[10], x[11]);
    csa(foursA, p[1], p[1], twosA, twosB);
    csa(twosA, p[0], p[0], x[12], x[13]);
    csa(twosB, p[0], p[0], x[14], x[15]);
    csa(foursB, p[1], p[1], twosA, twosB);
    csa(eightsB, p[2], p[2], foursA, foursB);
    csa(sixteens, p[3], p[3], eightsA, eightsB);
    uint32_t c = sixteens;
#pragma unroll
    for (int j = 4; j < PLANES; ++j) {
        const uint32_t t = p[j] & c;
        p[j] ^= c;
        c = t;
    }
}

// Unpack the planes to the thread's 32 counts and add them into its stage
// row (srow[b] counts bit b of its word).  Lane pairs: bits k and k + 16 of
// every plane gather into the low and high halves of one word.
__device__ __forceinline__ void flush(const uint32_t (&p)[PLANES],
                                      int* srow, bool first)
{
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        uint32_t w = 0u;
#pragma unroll
        for (int j = 0; j < PLANES; ++j) {
            const uint32_t s = k >= j ? p[j] >> (k - j) : p[j] << (j - k);
            w |= s & (0x00010001u << j);
        }
        const int lo = (int)(w & 0xFFFFu);
        const int hi = (int)(w >> 16);
        srow[k] = first ? lo : srow[k] + lo;
        srow[k + 16] = first ? hi : srow[k + 16] + hi;
    }
}

// grid: (qp, tiles) -- queries fastest, so the resident blocks share tiles
template <int EPI>
__global__ void __launch_bounds__(THREADS)
score_kernel(const uint32_t* __restrict__ kbits, int qw,
             const uint32_t* __restrict__ bits, int V, int words,
             unsigned ld, int n_real, const int32_t* __restrict__ rank,
             int32_t* __restrict__ out)
{
    __shared__ __align__(16) int ids[ID_CAP];
    __shared__ int stage[THREADS * 33];
    __shared__ int n_total;

    const int q = blockIdx.x;
    const int w0 = blockIdx.y * THREADS;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int w = w0 + tid;
    const bool live = w < words;
    const uint32_t* krow = kbits + (size_t)q * qw;
    const uint32_t* bcol = bits + (live ? w : 0);

    // reserve this thread's slots in the id list
    if (tid == 0) n_total = 0;
    __syncthreads();
    int mine = 0;
    for (int kw = tid; kw < qw; kw += THREADS)
        mine += __popc(kbits_word(krow, kw, V));
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += v;
    }
    int wbase = 0;
    if (lane == 31) wbase = atomicAdd(&n_total, incl);
    const int off = __shfl_sync(0xFFFFFFFFu, wbase, 31) + incl - mine;
    __syncthreads();
    const int total = n_total;

    int base = 0;
    do {
        const int end = base + ID_CAP;
        const int n = min(ID_CAP, total - base);
        if (mine && off < end && off + mine > base) {
            int i = off;
            for (int kw = tid; kw < qw && i < end; kw += THREADS) {
                uint32_t word = kbits_word(krow, kw, V);
                while (word && i < end) {
                    const int b = __ffs(word) - 1;
                    word &= word - 1u;
                    if (i >= base) ids[i - base] = kw * 32 + b;
                    ++i;
                }
            }
        }
        // pad the window to whole groups with row 0
        const int pad = ((n + GROUP - 1) & ~(GROUP - 1)) - n;
        if (tid < pad) ids[n + tid] = 0;
        __syncthreads();
        if (live) {
            uint32_t p[PLANES];
#pragma unroll
            for (int j = 0; j < PLANES; ++j) p[j] = 0u;
            const int full = n / GROUP;
#pragma unroll 2
            for (int g = 0; g < full; ++g)
                add_group<false>(p, ids + g * GROUP, bcol, ld, GROUP);
            if (n % GROUP)
                add_group<true>(p, ids + full * GROUP, bcol, ld, n % GROUP);
            flush(p, stage + tid * 33, base == 0);
        }
        base = end;
        __syncthreads();
    } while (base < total);

    const int ncols = min(THREADS, words - w0) * 32;
    int32_t* orow = out + (size_t)q * words * 32 + (size_t)w0 * 32;
    for (int idx = tid; idx < ncols; idx += THREADS) {
        const int pos = w0 * 32 + idx;
        int v = stage[(idx >> 5) * 33 + (idx & 31)];
        if (EPI == EPI_POS_KEY) {
            v = (pos < n_real)
                ? (v << POS_BITS) | ((1 << POS_BITS) - 1 - pos) : -1;
        } else if (EPI == EPI_RANK_KEY) {
            const int r = __ldg(rank + pos);
            v = (r < RANK_MAX) ? (v << RANK_BITS) | (RANK_MAX - r) : -1;
        }
        orow[idx] = v;
    }
}

static dim3 grid_of(int qp, int words)
{
    return dim3(qp, (words + THREADS - 1) / THREADS);
}

// bits: V rows of `words` packed words, row stride ld words
extern "C" int score_dense_launch(const void* kbits, int qp, int qw,
                                  const void* bits, int V, int words, int ld,
                                  int n_real, int pack, void* out,
                                  void* stream)
{
    if (pack)
        score_kernel<EPI_POS_KEY>
            <<<grid_of(qp, words), THREADS, 0, (cudaStream_t)stream>>>(
                (const uint32_t*)kbits, qw, (const uint32_t*)bits, V, words,
                (unsigned)ld, n_real, nullptr, (int32_t*)out);
    else
        score_kernel<EPI_COUNTS>
            <<<grid_of(qp, words), THREADS, 0, (cudaStream_t)stream>>>(
                (const uint32_t*)kbits, qw, (const uint32_t*)bits, V, words,
                (unsigned)ld, n_real, nullptr, (int32_t*)out);
    return (int)cudaGetLastError();
}

// K4: rank is (32 * words,) int32 in position order
extern "C" int score_ranked_launch(const void* kbits, int qp, int qw,
                                   const void* bits, int V, int words,
                                   int ld, const void* rank, void* out,
                                   void* stream)
{
    score_kernel<EPI_RANK_KEY>
        <<<grid_of(qp, words), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)kbits, qw, (const uint32_t*)bits, V, words,
            (unsigned)ld, words * 32, (const int32_t*)rank, (int32_t*)out);
    return (int)cudaGetLastError();
}
