// K6: anti-diagonal wavefront global-alignment (Needleman-Wunsch) forward
// with the diagonal-major uint8 direction plane.
//
// Replaces: vsearch_tpu/ops/nw_pallas.py build_forward's kernel (the
// pl.pallas_call at nw_pallas.py:208; kernel body :58-195), the forward the
// JAX package runs when the row-scan kernel's preconditions fail -- on the
// port's paths, a mismatch score outside int8.  Cell semantics are bit-exact
// with it and with its XLA twin (nw_jax.py:184-259): every lane i < M of
// every diagonal d < D = M + N - 1 is computed, with the boundaries on lane
// 0 and on j == 0 (diag_top, diag_left, left_col, top_hm1), the query-right
// and target-right gap classes, the ambiguity and n_mismatch rules on the
// substitution value, strict '>' for every direction bit.  Only valid cells
// (j in [0, tlen), i < qlen) set a direction byte and fold into hmin/hmax
// (both starting at 0); the score is h at d == qlen + tlen - 2 on lane
// qlen - 1; overflow is hmin <= score_min or hmax >= SHRT_MAX.
//
// Wire: q4 (B, M) and t4 (B, N) int8 4-bit codes (code 0 is the padding),
// qlen/tlen (B,) int32.  Out: score (B,) int32, overflow (B,) bool, dirs
// (D, B, Ms) uint8 with cell (i, j) of pair b at [i + j, b, i]; Ms is M
// rounded up to 128 (the TPU kernel's lane padding), and every byte at a
// lane >= M is 0.  All arithmetic is int32: a mismatch score such as -200
// never passes through an 8-bit value.
//
// What bounds it on the H100: at the search prefetch's shape (B=512,
// M=N=640) the dirs plane written once, 419 MB (0.126 ms at 3.35 TB/s),
// against ~20 int32 operations for each of the 2.1e8 DP cells (0.125 ms at
// 33.5e12 int32 ops/s).  Design: one block per pair, threads over the query
// lanes i (striding when M exceeds the block), a loop over the D diagonals
// with one __syncthreads each.  Each lane's state after diagonal d -- H(d),
// H(d-1), E(d), F(d) as one int4 -- lives in a double-buffered array in
// shared memory (a global scratch when 32 bytes a lane do not fit): lane i
// reads its own and lane i-1's entries of the previous diagonal's buffer
// (H(i-1, d-2) and F(i-1, d-1)) and writes its own into the other one.  The
// query and target codes of the pair sit in shared memory.  Each diagonal's
// Ms direction bytes go out as one coalesced row of dirs[d, b, :]; hmin,
// hmax and the score are folded at the end in a block reduction.  What holds
// it back: half of the D x M lanes it sweeps lie outside the M x N matrix
// (the wavefront's triangles), every cell's state makes a round trip through
// shared memory, and the barrier per diagonal serialises the block.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_THREADS 1024
#define SHRT_MAX_ 32767
#define DIR_UP 1
#define DIR_LEFT 2
#define DIR_EXTUP 4
#define DIR_EXTLEFT 8

struct Scheme {
    int match, mismatch;
    int go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r;
    int ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r;
    int n_mismatch, score_min;
};

__device__ __forceinline__ bool ambiguous(int c)
{
    return !(c == 1 || c == 2 || c == 4 || c == 8);
}

// the block-wide fold of one value (op 0: min, 1: max, 2: sum) into lane 0
// of warp 0; red holds one slot per warp
__device__ __forceinline__ int block_fold(int v, int op, int* red)
{
    for (int off = 16; off > 0; off >>= 1) {
        const int o = __shfl_down_sync(0xffffffffu, v, off);
        v = op == 0 ? min(v, o) : op == 1 ? max(v, o) : v + o;
    }
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < nwarps; ++w)
            v = op == 0 ? min(v, red[w]) : op == 1 ? max(v, red[w])
                                                   : v + red[w];
    __syncthreads();
    return v;
}

template <bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
nw_wavefront_kernel(const int8_t* __restrict__ q4,
                    const int32_t* __restrict__ qlen,
                    const int8_t* __restrict__ t4,
                    const int32_t* __restrict__ tlen,
                    int M, int N, int B, int Ms, Scheme s,
                    int32_t* __restrict__ score_out,
                    bool* __restrict__ over_out,
                    uint8_t* __restrict__ dirs,
                    int4* __restrict__ gstate)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int red[MAX_THREADS / 32];
    const int b = blockIdx.x;
    const int tid = threadIdx.x, T = blockDim.x;
    // state[(d & 1) * M + i] = (H(d), H(d-1), E(d), F(d)) of lane i
    int4* state = SMEM ? reinterpret_cast<int4*>(smem)
                       : gstate + (size_t)b * 2 * M;
    int8_t* qs = reinterpret_cast<int8_t*>(smem + (SMEM ? 32 * (size_t)M : 0));
    int8_t* ts = qs + M;
    for (int k = tid; k < M; k += T) {
        qs[k] = q4[(size_t)b * M + k];
        // diagonal -1: every carry 0 (nw_pallas.py:77-83)
        state[M + k] = make_int4(0, 0, 0, 0);
    }
    for (int k = tid; k < N; k += T) ts[k] = t4[(size_t)b * N + k];
    __syncthreads();

    const int ql = qlen[b], tl = tlen[b];
    const int QR_q_i = s.go_q_i + s.ge_q_i;
    const int QR_q_r = s.go_q_r + s.ge_q_r;
    const int QR_t_i = s.go_t_i + s.ge_t_i;
    const int QR_t_r = s.go_t_r + s.ge_t_r;
    const int D = M + N - 1;
    const int d_end = ql + tl - 2;
    int hmin = 0, hmax = 0, score = 0;
    for (int d = 0; d < D; ++d) {
        const int4* prev = state + ((d + 1) & 1) * M;
        int4* cur = state + (d & 1) * M;
        uint8_t* drow = dirs + ((size_t)d * B + b) * Ms;
        for (int i = tid; i < Ms; i += T) {
            if (i >= M) {
                drow[i] = 0;
                continue;
            }
            const int jb = d - i;
            const int qc = qs[i];
            const int tc = (jb >= 0 && jb < N) ? ts[jb] : 0;
            int V;
            if (s.n_mismatch && (qc == 15 || tc == 15))
                V = s.mismatch;
            else if (ambiguous(qc) || ambiguous(tc))
                V = 0;
            else
                V = (qc == tc) ? s.match : s.mismatch;

            const bool last_q = (i == ql - 1);
            const int QR_q = last_q ? QR_q_r : QR_q_i;
            const int R_q = last_q ? s.ge_q_r : s.ge_q_i;
            const bool right_t = (jb == tl - 1);
            const int QR_t = right_t ? QR_t_r : QR_t_i;
            const int R_t = right_t ? s.ge_t_r : s.ge_t_i;

            const int4 own = prev[i];
            int diag_in, F_in;
            if (i == 0) {
                diag_in = (jb == 0) ? 0 : -(s.go_q_l + jb * s.ge_q_l);
                F_in = -(s.go_q_l + (jb + 1) * s.ge_q_l) - QR_t;
            } else {
                const int4 nb = prev[i - 1];
                diag_in = (jb == 0) ? -(s.go_t_l + i * s.ge_t_l) : nb.y;
                F_in = nb.w;
            }
            const int E_in = (jb == 0) ? -(s.go_t_l + (i + 1) * s.ge_t_l) - QR_q
                                       : own.z;

            int h = diag_in + V;
            const bool d_up = F_in > h;
            h = max(h, F_in);
            const bool d_left = E_in > h;
            h = max(h, E_in);

            const int HF = h - QR_t;
            const int Fx = F_in - R_t;
            const bool d_extup = Fx > HF;
            const int HE = h - QR_q;
            const int Ex = E_in - R_q;
            const bool d_extleft = Ex > HE;
            cur[i] = make_int4(h, own.x, max(Ex, HE), max(Fx, HF));

            const bool valid = jb >= 0 && jb < tl && i < ql;
            drow[i] = valid ? (uint8_t)((d_up ? DIR_UP : 0)
                                        | (d_left ? DIR_LEFT : 0)
                                        | (d_extup ? DIR_EXTUP : 0)
                                        | (d_extleft ? DIR_EXTLEFT : 0))
                            : (uint8_t)0;
            if (valid) {
                hmin = min(hmin, h);
                hmax = max(hmax, h);
            }
            if (d == d_end && last_q) score += h;
        }
        __syncthreads();
    }
    hmin = block_fold(hmin, 0, red);
    hmax = block_fold(hmax, 1, red);
    score = block_fold(score, 2, red);
    if (tid == 0) {
        score_out[b] = score;
        over_out[b] = hmin <= s.score_min || hmax >= SHRT_MAX_;
    }
}

// scheme: 15 ints in ScoreScheme order (match, mismatch, go_q_l, go_t_l,
// go_q_i, go_t_i, go_q_r, go_t_r, ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r,
// ge_t_r, n_mismatch), then score_min.  gstate: NULL keeps the lane state in
// shared memory (32 * M + M + N bytes of it); otherwise a (B, 2, M) int4
// scratch that holds it, and shared memory holds only the codes.
extern "C" int nw_wavefront_launch(const void* q4, const void* qlen,
                                   const void* t4, const void* tlen,
                                   int M, int N, int B, int Ms,
                                   const int* scheme, void* score,
                                   void* overflow, void* dirs, void* gstate,
                                   void* stream)
{
    Scheme s;
    s.match = scheme[0];    s.mismatch = scheme[1];
    s.go_q_l = scheme[2];   s.go_t_l = scheme[3];
    s.go_q_i = scheme[4];   s.go_t_i = scheme[5];
    s.go_q_r = scheme[6];   s.go_t_r = scheme[7];
    s.ge_q_l = scheme[8];   s.ge_t_l = scheme[9];
    s.ge_q_i = scheme[10];  s.ge_t_i = scheme[11];
    s.ge_q_r = scheme[12];  s.ge_t_r = scheme[13];
    s.n_mismatch = scheme[14];
    s.score_min = scheme[15];
    int threads = ((M + 31) / 32) * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    const bool in_smem = gstate == nullptr;
    const size_t smem = (in_smem ? 32 * (size_t)M : 0) + (size_t)M + N;
    cudaError_t err;
    if (in_smem)
        err = cudaFuncSetAttribute(nw_wavefront_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    else
        err = cudaFuncSetAttribute(nw_wavefront_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (in_smem)
        nw_wavefront_kernel<true><<<B, threads, smem, (cudaStream_t)stream>>>(
            (const int8_t*)q4, (const int32_t*)qlen, (const int8_t*)t4,
            (const int32_t*)tlen, M, N, B, Ms, s, (int32_t*)score,
            (bool*)overflow, (uint8_t*)dirs, nullptr);
    else
        nw_wavefront_kernel<false><<<B, threads, smem, (cudaStream_t)stream>>>(
            (const int8_t*)q4, (const int32_t*)qlen, (const int8_t*)t4,
            (const int32_t*)tlen, M, N, B, Ms, s, (int32_t*)score,
            (bool*)overflow, (uint8_t*)dirs, (int4*)gstate);
    return (int)cudaGetLastError();
}
