// K6: anti-diagonal wavefront global-alignment (Needleman-Wunsch) forward
// with the diagonal-major uint8 direction plane.
//
// Replaces: vsearch_tpu/ops/nw_pallas.py build_forward's kernel (the
// pl.pallas_call at nw_pallas.py:208; kernel body :58-195), the forward the
// JAX package runs when the row-scan kernel's preconditions fail -- on the
// port's paths, a mismatch score outside int8.  Cell semantics are bit-exact
// with it and with its XLA twin (nw_jax.py:184-259): the boundaries on row 0
// and on j == 0 (diag_top, diag_left, left_col, top_hm1), the query-right
// and target-right gap classes, the ambiguity and n_mismatch rules on the
// substitution value, strict '>' for every direction bit.  Only valid cells
// (j in [0, tlen), i < qlen) set a direction byte and fold into hmin/hmax
// (both starting at 0); the score is h at (qlen - 1, tlen - 1) when that
// cell lies on one of the D diagonals, else 0; overflow is hmin <=
// score_min or hmax >= SHRT_MAX.
//
// Wire: q4 (B, M) and t4 (B, N) int8 4-bit codes (code 0 is the padding),
// qlen/tlen (B,) int32.  Out: score (B,) int32, overflow (B,) bool, dirs
// (D, B, Ms) uint8, D = M + N - 1, with cell (i, j) of pair b at
// [i + j, b, i]; Ms is M rounded up to 128 (the TPU kernel's lane padding).
// Every byte of the plane is written, and every byte that is not a valid
// cell is 0.  All arithmetic is int32: a mismatch score such as -200 never
// passes through a narrow type.
//
// What bounds it on the H100: the plane written once, 419 MB at the search
// prefetch's shape (B=512, M=N=640: 0.125 ms at 3.35 TB/s), against ~20
// int32 operations for each of its 1.8e8 DP cells (0.110 ms at 33.5e12
// int32 ops/s).  It takes 0.80 ms there (PERF.md; an H100 80GB HBM3 at
// 700 W), bound by instruction issue: some 65 instructions a step
// of a warp, and a busy warp's step takes 625 cycles with 8 warps on
// each scheduler (0.83 instructions a cycle); a quarter of the warps'
// super-steps are the band pipeline's fill and drain, and pairs of
// different lengths leave a tail.  The first design (a block barrier on
// every one of the D diagonals, every lane's state through shared memory,
// half the lanes of each diagonal outside the matrix) took 2.37 ms.
//
// Design: one block a pair, K6_WARPS warps.  The rows go in bands of 32;
// warp w takes bands w, w + W, w + 2W, ...  Lane k owns row i0 + k and at
// step s computes cell (i0 + k, s - k), so all 32 cells of a step lie on
// diagonal i0 + s and the step's output is dirs[i0 + s, b, i0:i0 + 32], one
// aligned 32-byte sector stored straight from the lanes.  H and F of the
// row above come from lane k - 1 by __shfl_up_sync; the diagonal's H is the
// value received one step earlier; E never leaves the lane; the row's
// substitution values sit in one register (two bits a target code) and
// its gap class in two.  Lane 0 takes the row above from its warp's stage,
// K6_CHUNK columns copied there at the start of each chunk of steps: the
// top boundary in band 0, else the last row (H, F) of the band above,
// which that band's lane 31 wrote one column a step into a ring in shared
// memory (RING columns a link between two warps) or, from warp W - 1 to
// warp 0 of the next round, into the wrap row.  Target codes go through a
// per-warp window of TBUF columns in shared memory, read by each lane at
// its own column.
//
// Schedule: a block barrier every K6_CHUNK steps (a super-step).  A band's
// lane 31 reaches column c 31 steps after its lane 0, so a band runs SKEW
// chunks behind the band above: band g = w + W r starts at super-step
// r P + SKEW w, P = max(n, SKEW W) for n chunks a band.  The wrap row must
// hold a whole row: warp 0 is busy with its own band for n chunks while
// warp W - 1's band of the round before runs only SKEW (W - 1) chunks
// behind it, so that link buffers n - SKEW (W - 1) chunks, whatever the
// ring sizes.  It lives in dynamic shared memory (8 bytes a column, 10.5 KB
// at D = 1279) and, for a D too long for shared memory (about 28 000), in
// a (B, cols) int2 scratch the caller allocates
// (nw_wavefront_scratch_bytes).  8 warps and 32 steps a barrier are the
// fastest at B=512 (4 or 16 warps, 16 or 64 steps: 1.08-1.35x); at B=128
// 16 warps take 0.95x (tools/tune_wavefront.py).
//
// Work: a band computes only the columns its rows need, j < min(tlen,
// D - i), and rows i < min(qlen, M); its other slots of the plane are
// stored as zeros from the steps or, for the diagonals it never steps
// through, with 16-byte stores.  Cells left of j = 0 never feed a cell
// with j >= 0 (j = 0 restarts E and the diagonal), so they are skipped --
// except for a pair with tlen <= 0, whose score the oracle reads at
// (qlen - 1, tlen - 1), left of j = 0: there the bands run over the
// triangle of cells j >= -i that feed it, every cell state before a row's
// first column 0 as in the oracle's initial carries, and store zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#define K6_WARPS 8        // warps a pair: bands in flight
#define K6_CHUNK 32       // steps between two block barriers
#define LANES 32
#define FULL 0xffffffffu
#define SHRT_MAX_ 32767
#define DIR_UP 1
#define DIR_LEFT 2
#define DIR_EXTUP 4
#define DIR_EXTLEFT 8

constexpr int W = K6_WARPS;
constexpr int CH = K6_CHUNK;
// chunks a band runs behind the band above it: lane 0's chunk x needs the
// row above up to column CH x + CH - 1, which that band's lane 31 writes at
// its step CH x + CH + 30
constexpr int SKEW = 2 + 30 / CH;
constexpr int pow2_at_least(int x)
{
    int p = 1;
    while (p < x) p *= 2;
    return p;
}
// a link's ring spans the columns its consumer reads and its producer
// writes in one super-step
constexpr int RING = pow2_at_least(CH * (SKEW + 1));
// a lane's columns in one chunk: [CH x - 31, CH x + CH)
constexpr int TBUF = pow2_at_least(CH + LANES);

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

// columns of the wrap row (and of the scratch, a pair) for a launch: every
// column a band's chunks address
static int wrap_cols(int M, int N)
{
    const int D = M + N - 1;
    return (D + LANES + 2 * CH + 31) / 32 * 32;
}

__global__ void __launch_bounds__(LANES * W, 32 / W)
nw_wavefront_kernel(const int8_t* __restrict__ q4,
                    const int32_t* __restrict__ qlen,
                    const int8_t* __restrict__ t4,
                    const int32_t* __restrict__ tlen,
                    int M, int N, int B, int Ms, int cols, Scheme sc,
                    int32_t* __restrict__ score_out,
                    bool* __restrict__ over_out,
                    uint8_t* __restrict__ dirs,
                    int2* __restrict__ scratch)
{
    extern __shared__ int2 wrap_smem[];
    __shared__ int2 ring[W][RING];
    __shared__ int2 stage[W][CH];
    __shared__ int8_t tbuf[W][TBUF];
    __shared__ int red[2][W];
    __shared__ int score_sh;
    const int b = blockIdx.x;
    const int w = threadIdx.x / LANES;
    const int lane = threadIdx.x % LANES;
    int2* wrap = scratch ? scratch + (size_t)b * cols : wrap_smem;
    const int8_t* tp = t4 + (size_t)b * N;

    const int ql = qlen[b], tl = tlen[b];
    const int D = M + N - 1;
    const int QR_q_i = sc.go_q_i + sc.ge_q_i;
    const int QR_q_r = sc.go_q_r + sc.ge_q_r;
    const int QR_t_i = sc.go_t_i + sc.ge_t_i;
    const int QR_t_r = sc.go_t_r + sc.ge_t_r;
    // columns in c = j - jorg; rows computed R; steps of band 0
    const bool left = tl <= 0;
    int R = min(max(ql, 0), M);
    int jorg = 0;
    int steps = min(min(tl, D) + LANES - 1, D);
    if (left) {
        // the score cell's column is tl + ql - 2 (it exists when >= 0)
        if ((long long)ql + tl < 2 || ql > M) R = 0;
        jorg = 1 - R;
        steps = R ? tl + ql - 1 + LANES - 1 : 0;
    }
    const int nb = (R + LANES - 1) / LANES;
    const int n = (steps + CH - 1) / CH;
    const int P = max(n, SKEW * W);
    const int T = nb ? ((nb - 1) / W) * P + SKEW * ((nb - 1) % W) + n : 0;
    const size_t dstride = (size_t)B * Ms;

    auto zero_slot = [&](int g, int d0, int d1) {
        for (int d = max(d0, 0) + (lane >> 1); d < min(d1, D); d += 16)
            *reinterpret_cast<uint4*>(dirs + (size_t)d * dstride
                                      + (size_t)b * Ms + g * LANES
                                      + (lane & 1) * 16) =
                make_uint4(0, 0, 0, 0);
    };

    if (threadIdx.x == 0) score_sh = 0;
    // the slots of rows no band computes: zeros on every diagonal
    for (int g = nb + w; g < Ms / LANES; g += W) zero_slot(g, 0, D);

    int hmin = 0, hmax = 0;
    // the band's lane registers
    int i0 = 0, vsel = 0, lo = 0, hi = 0, QR_q = 0, R_q = 0;
    int diag = 0, E = 0, h_out = 0, f_out = 0;
    bool lastq = false;
    size_t didx = 0;
    for (int t = 0; t < T; ++t) {
        const int tw = t - SKEW * w;
        const int r = tw >= 0 ? tw / P : 0;
        const int x = tw - r * P;              // chunk of the band
        const int g = w + W * r;
        if (tw >= 0 && g < nb && x < n) {
            if (x == 0) {
                i0 = g * LANES;
                const int i = i0 + lane;
                const bool row_ok = i < R;
                int qc = row_ok ? q4[(size_t)b * M + i] : 0;
                if (qc < 0 || qc > 15) qc = 0;
                vsel = 0;
#pragma unroll
                for (int tc = 0; tc < 16; ++tc) {
                    int v;   // 0: mismatch, 1: match, 2: zero
                    if (sc.n_mismatch && (qc == 15 || tc == 15)) v = 0;
                    else if (ambiguous(qc) || ambiguous(tc)) v = 2;
                    else v = qc == tc ? 1 : 0;
                    vsel |= v << (2 * tc);
                }
                lastq = i == ql - 1;
                QR_q = lastq ? QR_q_r : QR_q_i;
                R_q = lastq ? sc.ge_q_r : sc.ge_q_i;
                if (left) {
                    // every state before a row's first cell is 0
                    lo = ql - 1 - i;
                    hi = tl + ql - 1;
                    diag = 0;
                    E = 0;
                } else {
                    lo = 0;
                    hi = min(tl, D - i);
                    diag = i == 0 ? 0 : -(sc.go_t_l + i * sc.ge_t_l);
                    E = -(sc.go_t_l + (i + 1) * sc.ge_t_l) - QR_q;
                }
                if (!row_ok || hi < lo) hi = lo;
                h_out = 0;
                f_out = 0;
                didx = (size_t)((long long)(i0 + jorg) * B + b) * Ms + i0
                       + lane;
                // the diagonals the band's steps do not reach
                zero_slot(g, 0, i0 + jorg);
                zero_slot(g, i0 + jorg + n * CH, D);
            }
            // lane 0's row above and every lane's target codes, one chunk
            const int c0 = x * CH;
            for (int k = lane; k < CH; k += LANES) {
                const int col = c0 + k;
                int2 a = make_int2(0, 0);
                if (g == 0) {
                    if (!left) {
                        const int h0 = -(sc.go_q_l + (col + 1) * sc.ge_q_l);
                        a = make_int2(h0, h0 - (col == tl - 1 ? QR_t_r
                                                              : QR_t_i));
                    }
                } else if (w == 0) {
                    a = wrap[col];
                } else {
                    a = ring[w][(col + CH * P * r) & (RING - 1)];
                }
                stage[w][k] = a;
                const int j = col + jorg;
                int tc = (j >= 0 && j < N) ? tp[j] : 0;
                if (tc < 0 || tc > 15) tc = 0;
                tbuf[w][col & (TBUF - 1)] = (int8_t)tc;
            }
            __syncwarp();
            int2* out = w == W - 1 ? wrap : ring[w + 1];
            const int out_off = w == W - 1 ? 0 : CH * P * r;
            const int out_mask = w == W - 1 ? -1 : RING - 1;
#pragma unroll
            for (int kk = 0; kk < CH; ++kk) {
                const int s = c0 + kk;
                const int c = s - lane;
                int h_in = __shfl_up_sync(FULL, h_out, 1);
                int f_in = __shfl_up_sync(FULL, f_out, 1);
                const int2 a = stage[w][kk];
                if (lane == 0) {
                    h_in = a.x;
                    f_in = a.y;
                }
                uint8_t byte = 0;
                if ((unsigned)(c - lo) < (unsigned)(hi - lo)) {
                    const int j = c + jorg;
                    const int tc = tbuf[w][c & (TBUF - 1)];
                    const int sel = (vsel >> (2 * tc)) & 3;
                    const int V = sel == 1 ? sc.match
                                           : (sel == 2 ? 0 : sc.mismatch);
                    const bool right_t = j == tl - 1;
                    const int QR_t = right_t ? QR_t_r : QR_t_i;
                    const int R_t = right_t ? sc.ge_t_r : sc.ge_t_i;
                    const int htemp = diag + V;
                    const bool d_up = f_in > htemp;
                    const int h2 = max(htemp, f_in);
                    const bool d_left = E > h2;
                    const int h = max(E, h2);
                    const int Fx = f_in - R_t, HF = h - QR_t;
                    const int Ex = E - R_q, HE = h - QR_q;
                    if (!left) {
                        byte = (uint8_t)((d_up ? DIR_UP : 0)
                                         | (d_left ? DIR_LEFT : 0)
                                         | (Fx > HF ? DIR_EXTUP : 0)
                                         | (Ex > HE ? DIR_EXTLEFT : 0));
                        hmin = min(hmin, h);
                        hmax = max(hmax, h);
                    }
                    if (lastq && right_t) score_sh = h;
                    E = max(Ex, HE);
                    diag = h_in;
                    h_out = h;
                    f_out = max(Fx, HF);
                }
                const int d = i0 + jorg + s;
                if ((unsigned)d < (unsigned)D) dirs[didx] = byte;
                didx += dstride;
                if (lane == LANES - 1 && c >= 0)
                    out[(c + out_off) & out_mask] = make_int2(h_out, f_out);
            }
        }
        __syncthreads();
    }

    for (int off = 16; off > 0; off >>= 1) {
        hmin = min(hmin, __shfl_xor_sync(FULL, hmin, off));
        hmax = max(hmax, __shfl_xor_sync(FULL, hmax, off));
    }
    if (lane == 0) {
        red[0][w] = hmin;
        red[1][w] = hmax;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int v = 1; v < W; ++v) {
            hmin = min(hmin, red[0][v]);
            hmax = max(hmax, red[1][v]);
        }
        score_out[b] = score_sh;
        over_out[b] = hmin <= sc.score_min || hmax >= SHRT_MAX_;
    }
}

// dynamic shared memory the wrap row takes, 0 when it does not fit beside
// the kernel's static shared memory (the row then goes to the scratch)
static int wrap_smem_bytes(int M, int N)
{
    static int static_bytes = -1, optin = 0;
    if (static_bytes < 0) {
        cudaFuncAttributes attr;
        int dev = 0;
        if (cudaFuncGetAttributes(&attr, nw_wavefront_kernel) != cudaSuccess
            || cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(
                   &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
                   != cudaSuccess)
            return -1;
        static_bytes = (int)attr.sharedSizeBytes;
    }
    const long long bytes = (long long)wrap_cols(M, N) * sizeof(int2);
    return bytes + static_bytes <= optin ? (int)bytes : 0;
}

// bytes of the (B, cols) int2 scratch a launch at (M, N, B) needs for its
// wrap row: 0 when the row fits shared memory, -1 on a CUDA error
extern "C" long long nw_wavefront_scratch_bytes(int M, int N, int B)
{
    const int smem = wrap_smem_bytes(M, N);
    if (smem < 0) return -1;
    return smem ? 0 : (long long)B * wrap_cols(M, N) * sizeof(int2);
}

// scheme: 15 ints in ScoreScheme order (match, mismatch, go_q_l, go_t_l,
// go_q_i, go_t_i, go_q_r, go_t_r, ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r,
// ge_t_r, n_mismatch), then score_min.  scratch: NULL, or the scratch of
// nw_wavefront_scratch_bytes when that is not 0.
extern "C" int nw_wavefront_launch(const void* q4, const void* qlen,
                                   const void* t4, const void* tlen,
                                   int M, int N, int B, int Ms,
                                   const int* scheme, void* score,
                                   void* overflow, void* dirs, void* scratch,
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
    const int smem = wrap_smem_bytes(M, N);
    if (smem < 0) return (int)cudaGetLastError();
    if (smem == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        nw_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    nw_wavefront_kernel<<<B, LANES * W, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q4, (const int32_t*)qlen, (const int8_t*)t4,
        (const int32_t*)tlen, M, N, B, Ms, wrap_cols(M, N), s,
        (int32_t*)score, (bool*)overflow, (uint8_t*)dirs,
        smem ? nullptr : (int2*)scratch);
    return (int)cudaGetLastError();
}
