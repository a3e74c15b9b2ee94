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
// with cell (i, j) of pair b at [i, j, b].  Any M, N, B is accepted: the
// TPU's B%128, M%8, N%8 and int8-mismatch preconditions do not apply.
//
// What bounds it on the H100: at the prefetch shape (B=512, M=N=640,
// 2.1e8 cells) the floor is the 419 MB dirs plane written once (~0.126
// ms at 3.35 TB/s) against ~20 int ops a cell (~0.125 ms at 33.5e12
// int32 ops/s, half the card's 67e12 float32 rate).  This first design
// does not approach it: one thread per pair
// sweeps rows i and, within a row, columns j, so the within-row E chain
// is sequential as in the scalar oracle.  H, F and the run length of the
// previous row live in lane-contiguous (N, B) int32 scratch (4 MB at
// B=512, N=640, resident in L2), and dirs are written at (i, j, b) with b
// fastest, so every load and store of a warp is coalesced.  It is bound by
// latency: only B threads run, on B/32 SMs.  Spreading a pair over a warp
// (anti-diagonals or a segmented scan of E) is the later redesign.
//
// K2m (the allpairs stats pipeline) takes one more input, rqT (M, B) int8,
// the raw 4-bit query codes, and writes mr (M, N, B) uint8 at [i, j, b]:
// the IUPAC match count ((rq & t) != 0, and under n_mismatch neither code
// N) within the diagonal run chunk that the run-length bits of dirs name,
// restarting with it, so MR <= RL <= RLCAP fits a byte.  The diagonal
// predecessor's count is a register carried like rl_diag, and the previous
// row's counts a fourth (N, B) int32 scratch row.  At the allpairs shape
// (B=4096, M=N=400: 6.55e8 cells) its floor is the 1.97 GB of dirs and mr
// written once (0.59 ms at 3.35 TB/s).  The template keeps K2 itself as it
// was: every match-plane statement is under `if constexpr`.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 32
#define RLCAP 255
#define SHRT_MAX_ 32767

struct Scheme {
    int match, mismatch;
    int go_q_l, go_t_l, go_q_i, go_t_i, go_q_r, go_t_r;
    int ge_q_l, ge_t_l, ge_q_i, ge_t_i, ge_q_r, ge_t_r;
    int n_mismatch, track, score_min;
};

template <bool WITH_MATCHES>
__global__ void __launch_bounds__(THREADS)
nw_rowscan_kernel(const int8_t* __restrict__ qmT,
                  const int16_t* __restrict__ amT,
                  const int32_t* __restrict__ qlen,
                  const int8_t* __restrict__ t4T,
                  const int32_t* __restrict__ tlen,
                  int M, int N, int B, Scheme s,
                  int32_t* __restrict__ score_out,
                  bool* __restrict__ over_out,
                  uint16_t* __restrict__ dirs,
                  int32_t* __restrict__ Hs, int32_t* __restrict__ Fs,
                  int32_t* __restrict__ RLs,
                  const int8_t* __restrict__ rqT,
                  uint8_t* __restrict__ mr,
                  int32_t* __restrict__ MRs)
{
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    const int ql = qlen[b];
    const int tl = tlen[b];
    const int QR_q_i = s.go_q_i + s.ge_q_i;
    const int QR_q_r = s.go_q_r + s.ge_q_r;
    const int QR_t_i = s.go_t_i + s.ge_t_i;
    const int QR_t_r = s.go_t_r + s.ge_t_r;

    // virtual row -1 (top boundary) and its F
    for (int j = 0; j < N; ++j) {
        const size_t idx = (size_t)j * B + b;
        const int QR_t = (j == tl - 1) ? QR_t_r : QR_t_i;
        const int h0 = -(s.go_q_l + (j + 1) * s.ge_q_l);
        Hs[idx] = h0;
        Fs[idx] = h0 - QR_t;
        RLs[idx] = 0;
        if constexpr (WITH_MATCHES) MRs[idx] = 0;
    }

    int score = 0, hmin = 0, hmax = 0;
    for (int i = 0; i < M; ++i) {
        const int qm = qmT[(size_t)i * B + b];
        const int am = amT[(size_t)i * B + b];
        const bool lastq = (ql == i + 1);
        const int QR_q = lastq ? QR_q_r : QR_q_i;
        const int R_q = lastq ? s.ge_q_r : s.ge_q_i;
        int diag = (i == 0) ? 0 : -(s.go_t_l + i * s.ge_t_l);
        int rl_diag = 0;
        int E = -(s.go_t_l + (i + 1) * s.ge_t_l) - QR_q;
        uint16_t* drow = dirs + (size_t)i * N * B + b;
        int rq = 0, mr_diag = 0;
        uint8_t* mrow = nullptr;
        if constexpr (WITH_MATCHES) {
            rq = rqT[(size_t)i * B + b];
            mrow = mr + (size_t)i * N * B + b;
        }
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
            const size_t idx = (size_t)j * B + b;
            const int t = t4T[idx];
            const int h_up = Hs[idx];
            const int F = Fs[idx];
            const int rl_up = RLs[idx];

            int V = (t == qm) ? s.match : am;
            const bool t_is_n = s.n_mismatch && t == 15;
            const bool amb_t = !(t == 1 || t == 2 || t == 4 || t == 8)
                               && !t_is_n;
            if (amb_t) V = 0;
            if (s.n_mismatch && (t_is_n || qm == -2)) V = s.mismatch;

            const int htemp = diag + V;
            const bool dup = F > htemp;
            const int htemp2 = max(htemp, F);
            const bool dleft = E > htemp2;
            const int h = max(E, htemp2);

            const bool right_t = (j == tl - 1);
            const int QR_t = right_t ? QR_t_r : QR_t_i;
            const int R_t = right_t ? s.ge_t_r : s.ge_t_i;
            const bool dextl = (E - R_q) > (h - QR_q);
            const int Fx = F - R_t;
            const int HF = h - QR_t;
            const bool dextu = Fx > HF;

            const int rl = (dup || dleft) ? 0
                           : (rl_diag >= RLCAP ? 1 : rl_diag + 1);
            drow[(size_t)j * B] = (uint16_t)((dup ? 1 : 0) | (dleft ? 2 : 0)
                                             | (dextu ? 4 : 0)
                                             | (dextl ? 8 : 0) | (rl << 4));
            if constexpr (WITH_MATCHES) {
                // the match plane (nw_pallas2.py:256-269): the raw codes
                // overlap, so an IUPAC match counts where V may be 0
                int is_m = (rq & t) != 0;
                if (s.n_mismatch && (t == 15 || rq == 15)) is_m = 0;
                const int m = (dup || dleft) ? 0
                              : (rl_diag >= RLCAP ? is_m : mr_diag + is_m);
                mrow[(size_t)j * B] = (uint8_t)m;
                mr_diag = MRs[idx];
                MRs[idx] = m;
            }
            if (lastq && right_t) score += h;
            if (s.track) {
                const int hv = (j < tl && i < ql) ? h : 0;
                hmin = min(hmin, hv);
                hmax = max(hmax, hv);
            }

            E = max(E - R_q, htemp2 - QR_q);
            diag = h_up;
            rl_diag = rl_up;
            Hs[idx] = h;
            Fs[idx] = max(Fx, HF);
            RLs[idx] = rl;
        }
    }
    score_out[b] = score;
    over_out[b] = s.track && (hmin <= s.score_min || hmax >= SHRT_MAX_);
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

extern "C" int nw_rowscan_launch(const void* qmT, const void* amT,
                                 const void* qlen, const void* t4T,
                                 const void* tlen, int M, int N, int B,
                                 const int* scheme, void* score,
                                 void* overflow, void* dirs, void* Hs,
                                 void* Fs, void* RLs, void* stream)
{
    dim3 grid((B + THREADS - 1) / THREADS);
    nw_rowscan_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)qmT, (const int16_t*)amT, (const int32_t*)qlen,
        (const int8_t*)t4T, (const int32_t*)tlen, M, N, B,
        make_scheme(scheme), (int32_t*)score, (bool*)overflow,
        (uint16_t*)dirs, (int32_t*)Hs, (int32_t*)Fs, (int32_t*)RLs,
        nullptr, nullptr, nullptr);
    return (int)cudaGetLastError();
}

// K2m: as nw_rowscan_launch, plus rqT (M, B) int8 in, mr (M, N, B) uint8
// out and a fourth (N, B) int32 scratch row MRs.
extern "C" int nw_rowscan_mr_launch(const void* qmT, const void* amT,
                                    const void* rqT, const void* qlen,
                                    const void* t4T, const void* tlen,
                                    int M, int N, int B, const int* scheme,
                                    void* score, void* overflow, void* dirs,
                                    void* mr, void* Hs, void* Fs, void* RLs,
                                    void* MRs, void* stream)
{
    dim3 grid((B + THREADS - 1) / THREADS);
    nw_rowscan_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)qmT, (const int16_t*)amT, (const int32_t*)qlen,
        (const int8_t*)t4T, (const int32_t*)tlen, M, N, B,
        make_scheme(scheme), (int32_t*)score, (bool*)overflow,
        (uint16_t*)dirs, (int32_t*)Hs, (int32_t*)Fs, (int32_t*)RLs,
        (const int8_t*)rqT, (uint8_t*)mr, (int32_t*)MRs);
    return (int)cudaGetLastError();
}
