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
//
// What bounds it on the H100: bytes.  The TPU kernel runs the dense
// one-hot product, V * n_cols MACs per query (6.9e12 int8 ops at the bench
// shape qp=512, V=65536, n_cols=102400: >= 3.5 ms at 1979 TOPS).  Listing
// each query's own ~L k-mer ids instead reads L * words * 4 bytes per query
// (<= 3.9 GB at L~590, words=3200: ~1.2 ms at 3.35 TB/s with no L2 reuse;
// the 839 MB bit matrix read once is the floor, ~0.25 ms).  K4's rank
// vector adds n_cols * 4 bytes (0.4 MB at 102400 positions).
//
// Design: one block per (query, tile of THREADS packed words).  The block
// lists the query's k-mer ids from its Kbits row into shared memory, one
// tile of THREADS Kbits words at a time (a block-wide prefix sum of
// popcounts places each id).  Each thread owns one 32-bit word of the bit
// matrix -- 32 positions -- and for every id reads bits[id, w] (a warp reads
// 128 contiguous bytes) and adds its 32 bits into byte-wide SWAR counters
// (8 accumulators x 4 bytes; flushed into 32 int32 counters every 255 ids
// so no byte overflows).  The epilogue writes the block's 32 * THREADS
// outputs through a padded shared-memory transpose so the stores are
// coalesced, and folds the key there: consecutive threads handle
// consecutive positions, so K4's rank reads are coalesced too.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define POS_BITS 17
#define RANK_BITS 20
#define RANK_MAX ((1 << RANK_BITS) - 1)
#define ID_TILE (THREADS * 32)

// epilogues
#define EPI_COUNTS 0
#define EPI_POS_KEY 1
#define EPI_RANK_KEY 2

template <int EPI>
__global__ void __launch_bounds__(THREADS)
score_kernel(const uint32_t* __restrict__ kbits, int qw,
             const uint32_t* __restrict__ bits, int V, int words,
             int n_real, const int32_t* __restrict__ rank,
             int32_t* __restrict__ out)
{
    __shared__ int ids[ID_TILE];
    __shared__ int warp_sums[THREADS / 32];
    __shared__ int stage[THREADS * 33];

    const int q = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int w = blockIdx.x * THREADS + tid;
    const bool live = w < words;
    const uint32_t* krow = kbits + (size_t)q * qw;
    const uint32_t* bcol = bits + (live ? w : 0);

    int cnt[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] = 0;

    for (int base = 0; base < qw; base += THREADS) {
        const int kw = base + tid;
        uint32_t word = (kw < qw) ? krow[kw] : 0u;
        // ids at or beyond V are not k-mers (the one-hot operand is cut
        // to V columns)
        if (kw * 32 + 32 > V) {
            const int keep = V - kw * 32;
            word = keep <= 0 ? 0u : (word & ((keep >= 32) ? 0xFFFFFFFFu
                                              : ((1u << keep) - 1u)));
        }
        const int n = __popc(word);
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
            if (lane >= o) incl += v;
        }
        if (lane == 31) warp_sums[warp] = incl;
        __syncthreads();
        int off = incl - n;
        int total = 0;
#pragma unroll
        for (int i = 0; i < THREADS / 32; ++i) {
            const int s = warp_sums[i];
            if (i < warp) off += s;
            total += s;
        }
        while (word) {
            const int b = __ffs(word) - 1;
            word &= word - 1u;
            ids[off++] = kw * 32 + b;
        }
        __syncthreads();

        if (live) {
            for (int i0 = 0; i0 < total; i0 += 255) {
                const int i1 = min(total, i0 + 255);
                uint32_t acc[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) acc[k] = 0u;
                for (int i = i0; i < i1; ++i) {
                    const uint32_t x = __ldg(bcol + (size_t)ids[i] * words);
#pragma unroll
                    for (int k = 0; k < 8; ++k)
                        acc[k] += (x >> k) & 0x01010101u;
                }
                // byte j of acc[k] counts bit 8*j + k
#pragma unroll
                for (int k = 0; k < 8; ++k) {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        cnt[k + 8 * j] += (int)((acc[k] >> (8 * j)) & 0xFFu);
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int b = 0; b < 32; ++b) stage[tid * 33 + b] = cnt[b];
    __syncthreads();
    const int w0 = blockIdx.x * THREADS;
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

extern "C" int score_dense_launch(const void* kbits, int qp, int qw,
                                  const void* bits, int V, int words,
                                  int n_real, int pack, void* out,
                                  void* stream)
{
    dim3 grid((words + THREADS - 1) / THREADS, qp);
    if (pack)
        score_kernel<EPI_POS_KEY><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)kbits, qw, (const uint32_t*)bits, V, words,
            n_real, nullptr, (int32_t*)out);
    else
        score_kernel<EPI_COUNTS><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)kbits, qw, (const uint32_t*)bits, V, words,
            n_real, nullptr, (int32_t*)out);
    return (int)cudaGetLastError();
}

// K4: rank is (32 * words,) int32 in position order
extern "C" int score_ranked_launch(const void* kbits, int qp, int qw,
                                   const void* bits, int V, int words,
                                   const void* rank, void* out,
                                   void* stream)
{
    dim3 grid((words + THREADS - 1) / THREADS, qp);
    score_kernel<EPI_RANK_KEY><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)kbits, qw, (const uint32_t*)bits, V, words,
        words * 32, (const int32_t*)rank, (int32_t*)out);
    return (int)cudaGetLastError();
}
