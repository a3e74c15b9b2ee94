// K2: row-scan global-alignment (Needleman-Wunsch) forward with the
// uint16 direction + diagonal run-length plane, and K2m: the same forward
// that also writes the uint8 match-count plane.
//
// Replaces: vsearch_tpu/ops/nw_pallas2.py build_forward2's kernel (the
// pl.pallas_call at nw_pallas2.py:387), with_matches=False (K2,
// nw_rowscan_kernel<false>) and with_matches=True (K2m,
// nw_rowscan_kernel<true>; nw_pallas2.py:256-269).  Cell
// semantics are bit-exact with it: the same boundaries (H0/F0, the left
// boundary injected on the diagonal, E0), the query-right / target-right
// gap classes, the ambiguity and n_mismatch rules on the substitution
// value, strict '>' for every direction bit, the run-length restart after
// RLCAP, the score taken at (qlen-1, tlen-1), and 16-bit overflow tracking
// only when the host's static envelope (overflow_possible) asks for it.
// E is computed by its sequential recurrence
//     E(0) = E0,  E(j+1) = max(E(j) - R, htemp2(j) - QR)
// which is exactly the max-plus prefix the TPU kernel evaluates.
//
// Wire: qmT (M, B) int8 (code, -1 ambiguous, -2 N under n_mismatch),
// amT (M, B) int16 -- WIDENED from the TPU's int8 so any mismatch score
// the CLI accepts fits --, t4T (N, B) int8 target codes, qlen/tlen (B,)
// int32.  Out: score (B,) int32, overflow (B,) bool, dirs (M, N, B) uint16
// with cell (i, j) of pair b at [i, j, b].  Every cell of the M x N box is
// written, past qlen/tlen too.  Any M, N, B is accepted: the TPU's B%128,
// M%8, N%8 and int8-mismatch preconditions do not apply.
//
// K2m (the allpairs stats pipeline) takes one more input, rqT (M, B) int8,
// the raw 4-bit query codes, and writes mr (M, N, B) uint8 at [i, j, b]:
// the IUPAC match count ((rq & t) != 0, and under n_mismatch neither code
// N) within the diagonal run chunk that the run-length bits of dirs name,
// restarting with it, so MR <= RL <= RLCAP fits a byte.  Every match-plane
// statement is under `if constexpr`.
//
// What bounds it on the H100: the planes written once, 419 MB of dirs at
// the search prefetch's shape (B=512, M=N=640: 0.126 ms at 3.35 TB/s) and
// 1.97 GB of dirs and mr at the allpairs batch (B=4096, M=N=400: 0.589 ms),
// against ~20 int32 operations a cell (25 with the match plane) at 33.5e12
// int32 ops/s.  The first design, one thread a pair, was bound by latency
// instead: B threads on B/32 SMs, each walking M x N cells as one
// dependent chain through a global (N, B) scratch (89-91 ms at the search
// shape, 2.35 GCUPS).  This one is bound by instruction throughput where
// the card is full (B >= 2048: some 50-70 integer instructions a step of
// a warp, on the SM's half-rate integer pipe) and by one step's dependent
// latency where it is not (B <= 512 puts about one warp on each
// scheduler).
//
// Design: one warp a pair, striped over rows.  The rows go in bands of 32;
// lane k owns row i0 + k of its band and at step s computes cell
// (i0 + k, s - k), so a band takes N + 31 steps (fewer in a short last
// band).  H, F, the run length and the match count of the row above come
// from lane k - 1's previous step by __shfl_up_sync: one shuffle each for
// H and F, and one for a packed word that holds the run length, the match
// count, the target code and the code's two flags (ambiguous; N under
// n_mismatch), so the target code travels down the band with them.  The
// diagonal's H, run length and match count are the values the lane
// received one step earlier.  E never leaves the lane: a row's E chain is
// the lane's own sequence of steps, so no scan is needed.  The row
// constants (qm, am, rq, the query-right gap class) sit in registers.
// Lane 31 writes the band's last row (H, F, packed word) to a global
// (B, N) int4 scratch, 16 bytes a column, which the next band's lanes
// read back coalesced, 32 columns at a time, one chunk ahead, into a
// per-warp ring in shared memory from which lane 0 takes its column each
// step; band 0 computes the top boundary there instead.  The score comes
// from the lane whose row is qlen - 1, at j = tlen - 1; hmin and hmax are
// folded across the lanes at the end (min and max do not depend on order).
//
// A block holds P consecutive pairs, one warp each; all pairs of a launch
// share M and N, so their steps line up.  Each warp writes its cells of a
// 32-step chunk into a shared stage, [step][row][pair] with an odd number
// of words a (step, row) so that the 32 lanes' stores fall in 32 banks;
// after a __syncthreads the block flushes it, each thread one (row, pair)
// over the chunk's steps, so a store instruction puts out P consecutive
// values of a cell (i, j) instead of 32 scattered 2-byte stores.  P is the
// largest power of two up to 32 that still gives 128 blocks (about one an
// SM): 1-8 at the walk rounds' B=128-1024, 4 at the search prefetch's
// B=512, 16 at the cluster prefetch's B=2048 and 32 at the allpairs batch
// of 4096.  At 32 a cell's 32 mr bytes fill a whole 32-byte sector; at 16
// they filled half of one, and K2m took 1.5x as long (PERF.md, PR 5).
// Alternatives weighed: lanes over columns with a warp max-plus scan of E
// a row (the TPU's two-level scan, nw_pallas2.py:191-224) costs log2(32)
// shuffle stages a cell where the striped rows need three shuffles; row
// bands pipelined over several warps of one pair would add warps at small
// B, where the kernel is bound by latency, and were not built here: K2 is
// 2 ms of a search run's 0.18 s there (PERF.md).  K6 (nw_wavefront.cu)
// runs that design on its diagonal-major plane.
//
// Resources (ptxas, sm_90a): __launch_bounds__(32 P, 32 / P) caps each
// instantiation at 64 registers; they use 56-64, and K2m at P = 1
// spills 8 bytes.  Dynamic shared memory, the ring, the
// dirs stage and the mr stage: 14 336 bytes for K2 at P = 4, 45 056 at
// P = 16, and 122 880 for K2m at P = 32.
#include <cuda_runtime.h>
#include <stdint.h>

#define LANES 32          // rows of a band, steps of a chunk
#define MAX_PAIRS 32      // pairs (warps) of a block
#define MIN_BLOCKS 128    // blocks a launch should keep, about one an SM
#define RLCAP 255
#define SHRT_MAX_ 32767
#define FULL 0xffffffffu
// the packed word handed down a band: run length bits 0-7, match count
// bits 8-15, target code bits 16-23, and two flags of the target code
#define PK_AMB (1 << 24)  // ambiguous (V = 0)
#define PK_N (1 << 25)    // N under n_mismatch (V = mismatch, no match)

struct Scheme {
    int match, mismatch;
    int go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r;
    int ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r;
    int n_mismatch, track, score_min;
};

// the stage's row strides: an odd number of 4-byte words a (step, row), so
// the 32 lanes of a step store into 32 different banks
template <int P> struct Stage {
    static constexpr int dirs = 2 * ((P >= 2 ? P / 2 : 1) | 1);  // uint16
    static constexpr int mr = 4 * ((P >= 4 ? P / 4 : 1) | 1);    // bytes
    static constexpr size_t bytes(bool with_matches)
    {
        return (size_t)P * LANES * sizeof(int4)
               + (size_t)LANES * LANES * dirs * 2
               + (with_matches ? (size_t)LANES * LANES * mr : 0);
    }
};

template <bool WITH_MATCHES, int P>
__global__ void __launch_bounds__(LANES * P, 32 / P)
nw_rowscan_kernel(const int8_t* __restrict__ qmT,
                  const int16_t* __restrict__ amT,
                  const int32_t* __restrict__ qlen,
                  const int8_t* __restrict__ t4T,
                  const int32_t* __restrict__ tlen,
                  int M, int N, int B, Scheme s,
                  int32_t* __restrict__ score_out,
                  bool* __restrict__ over_out,
                  uint16_t* __restrict__ dirs,
                  int4* __restrict__ rows,
                  const int8_t* __restrict__ rqT,
                  uint8_t* __restrict__ mr)
{
    extern __shared__ int4 smem[];
    constexpr int DS = Stage<P>::dirs;
    constexpr int MS = Stage<P>::mr;
    const int w = threadIdx.x / LANES;
    const int lane = threadIdx.x % LANES;
    const int b0 = blockIdx.x * P;
    const int b = b0 + w;
    const bool pair_ok = b < B;
    int4* ring = smem + w * LANES;
    uint16_t* dstage = (uint16_t*)(smem + P * LANES);
    uint8_t* mstage = (uint8_t*)(dstage + LANES * LANES * DS);
    int4* row_above = rows + (size_t)(pair_ok ? b : 0) * N;
    // this thread's (row, pair) of the stage when the block flushes it
    const int fr = threadIdx.x / P;
    const int fp = threadIdx.x % P;

    const int ql = pair_ok ? qlen[b] : 0;
    const int tl = pair_ok ? tlen[b] : 0;
    const int QR_q_i = s.go_q_i + s.ge_q_i;
    const int QR_q_r = s.go_q_r + s.ge_q_r;
    const int QR_t_i = s.go_t_i + s.ge_t_i;
    const int QR_t_r = s.go_t_r + s.ge_t_r;

    int score = 0, hmin = 0, hmax = 0;
    for (int i0 = 0; i0 < M; i0 += LANES) {
        const int i = i0 + lane;
        const bool row_ok = pair_ok && i < M;
        int qm = 0, am = 0, rq = 0;
        if (row_ok) {
            qm = qmT[(size_t)i * B + b];
            am = amT[(size_t)i * B + b];
            if constexpr (WITH_MATCHES) rq = rqT[(size_t)i * B + b];
        }
        const bool q_n = s.n_mismatch && qm == -2;   // V = mismatch
        const bool rq_n = s.n_mismatch && rq == 15;  // no match
        const bool lastq = (ql == i + 1);
        const int QR_q = lastq ? QR_q_r : QR_q_i;
        const int R_q = lastq ? s.ge_q_r : s.ge_q_i;
        int diag = (i == 0) ? 0 : -(s.go_t_l + i * s.ge_t_l);
        int E = -(s.go_t_l + (i + 1) * s.ge_t_l) - QR_q;
        int rl_diag = 0, mr_diag = 0;
        int h_out = 0, f_out = 0, pk_out = 0;

        // the row above the band at column col: H, F and the packed word;
        // the top boundary, with the target code and its flags, in band 0
        auto above = [&](int col) {
            int4 v = make_int4(0, 0, 0, 0);
            if (pair_ok && col < N) {
                if (i0 == 0) {
                    const int QR_t = (col == tl - 1) ? QR_t_r : QR_t_i;
                    const int h0 = -(s.go_q_l + (col + 1) * s.ge_q_l);
                    const int t = t4T[(size_t)col * B + b];
                    const bool t_n = s.n_mismatch && t == 15;
                    const bool amb = !(t == 1 || t == 2 || t == 4 || t == 8)
                                     && !t_n;
                    v = make_int4(h0, h0 - QR_t,
                                  ((t & 0xff) << 16) | (amb ? PK_AMB : 0)
                                  | (t_n ? PK_N : 0), 0);
                } else {
                    v = row_above[col];
                }
            }
            return v;
        };

        const int nrows = min(LANES, M - i0);
        const int nchunks = (N + nrows - 1 + LANES - 1) / LANES;
        int4 next = above(lane);
        for (int c = 0; c < nchunks; ++c) {
            const int s0 = c * LANES;
            ring[lane] = next;
            __syncwarp();
            // one chunk ahead: band g - 1 wrote these columns, and this
            // band's lane 31 reaches them only in the chunk after next
            next = above(s0 + LANES + lane);
            const int jb = s0 - lane;
#pragma unroll 8
            for (int k = 0; k < LANES; ++k) {
                const int4 r = ring[k];
                int h_in = __shfl_up_sync(FULL, h_out, 1);
                int f_in = __shfl_up_sync(FULL, f_out, 1);
                int pk_in = __shfl_up_sync(FULL, pk_out, 1);
                if (lane == 0) {
                    h_in = r.x;
                    f_in = r.y;
                    pk_in = r.z;
                }
                const int j = jb + k;
                if (row_ok && (unsigned)j < (unsigned)N) {
                    const int t = (int8_t)(pk_in >> 16);
                    int V = (t == qm) ? s.match : am;
                    if (pk_in & PK_AMB) V = 0;
                    if ((pk_in & PK_N) || q_n) V = s.mismatch;

                    const int htemp = diag + V;
                    const bool dup = f_in > htemp;
                    const int htemp2 = max(htemp, f_in);
                    const bool dleft = E > htemp2;
                    const int h = max(E, htemp2);

                    const bool right_t = (j == tl - 1);
                    const int QR_t = right_t ? QR_t_r : QR_t_i;
                    const int R_t = right_t ? s.ge_t_r : s.ge_t_i;
                    const bool dextl = (E - R_q) > (h - QR_q);
                    const int Fx = f_in - R_t;
                    const int HF = h - QR_t;
                    const bool dextu = Fx > HF;

                    const bool diag_move = !(dup || dleft);
                    const bool restart = rl_diag >= RLCAP;
                    const int rl = !diag_move ? 0 : (restart ? 1 : rl_diag + 1);
                    const int at = k * LANES + lane;
                    dstage[at * DS + w] = (uint16_t)(
                        (dup ? 1 : 0) | (dleft ? 2 : 0) | (dextu ? 4 : 0)
                        | (dextl ? 8 : 0) | (rl << 4));
                    int m = 0;
                    if constexpr (WITH_MATCHES) {
                        // the match plane (nw_pallas2.py:256-269): the raw
                        // codes overlap, so an IUPAC match counts where V
                        // may be 0
                        const int is_m = ((rq & t) != 0 && !(pk_in & PK_N)
                                          && !rq_n) ? 1 : 0;
                        m = !diag_move ? 0 : (restart ? is_m : mr_diag + is_m);
                        mstage[at * MS + w] = (uint8_t)m;
                    }
                    if (lastq && right_t) score += h;
                    if (s.track) {
                        const int hv = (j < tl && i < ql) ? h : 0;
                        hmin = min(hmin, hv);
                        hmax = max(hmax, hv);
                    }

                    E = max(E - R_q, htemp2 - QR_q);
                    diag = h_in;
                    rl_diag = pk_in & 0xff;
                    if constexpr (WITH_MATCHES) mr_diag = (pk_in >> 8) & 0xff;
                    h_out = h;
                    f_out = max(Fx, HF);
                    pk_out = rl | (m << 8) | (pk_in & 0xffff0000);
                    if (lane == LANES - 1)
                        row_above[j] = make_int4(h_out, f_out, pk_out, 0);
                }
            }
            // flush the chunk: thread (fr, fp) writes row i0 + fr of pair
            // b0 + fp for the chunk's steps, so each step's store instruction
            // puts out P consecutive values of a cell (i, j) per row
            __syncthreads();
            const int ii = i0 + fr;
            if (ii < M && b0 + fp < B) {
                const int k_lo = max(0, fr - s0);
                const int k_hi = min(LANES, N + fr - s0);
                const long long base = ((long long)ii * N + s0 - fr) * B
                                       + b0 + fp;
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    const long long g = base + (long long)k * B;
                    dirs[g] = dstage[(k * LANES + fr) * DS + fp];
                    if constexpr (WITH_MATCHES)
                        mr[g] = mstage[(k * LANES + fr) * MS + fp];
                }
            }
            __syncthreads();
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        score += __shfl_xor_sync(FULL, score, off);
        hmin = min(hmin, __shfl_xor_sync(FULL, hmin, off));
        hmax = max(hmax, __shfl_xor_sync(FULL, hmax, off));
    }
    if (lane == 0 && pair_ok) {
        score_out[b] = score;
        over_out[b] = s.track && (hmin <= s.score_min || hmax >= SHRT_MAX_);
    }
}

// scheme: 15 ints in ScoreScheme order (match, mismatch, go_q_l, go_t_l,
// go_q_i, go_t_i, go_q_r, go_t_r, ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r,
// ge_t_r, n_mismatch), then track and score_min.
static Scheme make_scheme(const int* scheme)
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
    s.track = scheme[15];
    s.score_min = scheme[16];
    return s;
}

template <bool WITH_MATCHES, int P>
static int launch_p(const void* qmT, const void* amT, const void* rqT,
                    const void* qlen, const void* t4T, const void* tlen,
                    int M, int N, int B, const Scheme& s, void* score,
                    void* overflow, void* dirs, void* mr, void* rows,
                    cudaStream_t stream)
{
    const size_t smem = Stage<P>::bytes(WITH_MATCHES);
    cudaError_t err = cudaFuncSetAttribute(
        nw_rowscan_kernel<WITH_MATCHES, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    nw_rowscan_kernel<WITH_MATCHES, P><<<(B + P - 1) / P, P * LANES, smem,
                                         stream>>>(
        (const int8_t*)qmT, (const int16_t*)amT, (const int32_t*)qlen,
        (const int8_t*)t4T, (const int32_t*)tlen, M, N, B, s,
        (int32_t*)score, (bool*)overflow, (uint16_t*)dirs, (int4*)rows,
        (const int8_t*)rqT, (uint8_t*)mr);
    return (int)cudaGetLastError();
}

// P, the pairs of a block: the largest power of two up to MAX_PAIRS that
// still gives MIN_BLOCKS blocks
template <bool WITH_MATCHES>
static int launch(const void* qmT, const void* amT, const void* rqT,
                  const void* qlen, const void* t4T, const void* tlen,
                  int M, int N, int B, const int* scheme, void* score,
                  void* overflow, void* dirs, void* mr, void* rows,
                  void* stream)
{
    int P = MAX_PAIRS;
    while (P > 1 && (B + P - 1) / P < MIN_BLOCKS) P /= 2;
    const Scheme s = make_scheme(scheme);
    cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH_P(p) launch_p<WITH_MATCHES, p>(qmT, amT, rqT, qlen, t4T, tlen, \
                                              M, N, B, s, score, overflow,   \
                                              dirs, mr, rows, st)
    switch (P) {
    case 32: return LAUNCH_P(32);
    case 16: return LAUNCH_P(16);
    case 8: return LAUNCH_P(8);
    case 4: return LAUNCH_P(4);
    case 2: return LAUNCH_P(2);
    default: return LAUNCH_P(1);
    }
#undef LAUNCH_P
}

// rows: a (B, N) int4 scratch (16 bytes a column of a pair) for each band's
// last row; it needs no initial value.
extern "C" int nw_rowscan_launch(const void* qmT, const void* amT,
                                 const void* qlen, const void* t4T,
                                 const void* tlen, int M, int N, int B,
                                 const int* scheme, void* score,
                                 void* overflow, void* dirs, void* rows,
                                 void* stream)
{
    return launch<false>(qmT, amT, nullptr, qlen, t4T, tlen, M, N, B, scheme,
                         score, overflow, dirs, nullptr, rows, stream);
}

// K2m: as nw_rowscan_launch, plus rqT (M, B) int8 in and mr (M, N, B)
// uint8 out.
extern "C" int nw_rowscan_mr_launch(const void* qmT, const void* amT,
                                    const void* rqT, const void* qlen,
                                    const void* t4T, const void* tlen,
                                    int M, int N, int B, const int* scheme,
                                    void* score, void* overflow, void* dirs,
                                    void* mr, void* rows, void* stream)
{
    return launch<true>(qmT, amT, rqT, qlen, t4T, tlen, M, N, B, scheme,
                        score, overflow, dirs, mr, rows, stream);
}
