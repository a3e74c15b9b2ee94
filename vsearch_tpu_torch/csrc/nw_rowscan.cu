// K2: row-scan global-alignment (Needleman-Wunsch) forward with the
// uint16 direction + diagonal run-length plane, and K2m: the same forward
// that also writes the uint8 match-count plane.  K2m has two bodies: the
// 16-bit body (nw_rowscan_mr16_kernel, two pairs a warp in 16-bit halves)
// wherever the host's 16-bit envelope holds, the 32-bit body
// (nw_rowscan_kernel<true>) elsewhere; K2 is nw_rowscan_kernel<false>.
//
// Replaces: vsearch_tpu/ops/nw_pallas2.py build_forward2's kernel (the
// pl.pallas_call at nw_pallas2.py:387), with_matches=False (K2) and
// with_matches=True (K2m; the match plane nw_pallas2.py:256-269).  Cell
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
// M%8, N%8 and int8-mismatch preconditions do not apply.  K2m takes one
// more input, rqT (M, B) int8, the raw 4-bit query codes, and writes mr
// (M, N, B) uint8 at [i, j, b]: the IUPAC match count ((rq & t) != 0, and
// under n_mismatch neither code N) within the diagonal run chunk that the
// run-length bits of dirs name, restarting with it, so MR <= RL <= RLCAP
// fits a byte.
//
// What bounds them on the H100 (132 SMs at 1.98 GHz; an SM's integer
// pipes issue 64 lanes of an instruction a clock, and the three-input
// forms, IADD3, VIMNMX3, VIADDMNMX, do two operations each, so chained
// adds and min/max complete at 128 lanes a clock, tools/int_rate.py:
// 33.4e12 lane operations/s): the planes written once, 419 MB of dirs at
// the search prefetch's shape (B=512, M=N=640: 0.126 ms at 3.35 TB/s)
// and 1.97 GB of dirs and mr at the allpairs batch (B=4096, M=N=400:
// 0.589 ms), against ~20 operations a cell (25 with the match plane):
// 0.49 ms at the allpairs batch in 32-bit lanes, 0.25 ms with two 16-bit
// cells a lane, both under the bytes.  The code issues more instructions
// than that: the 32-bit body is bound by its ~65 a cell where the card
// is full (B >= 2048: 2.55 ms of issue at 64 lanes an SM a clock, 2.87
// ms at the allpairs batch) and by one step's dependent latency where it
// is not (B <= 512 puts about one warp on each scheduler).  The 16-bit
// body (1.33 ms at the allpairs batch) issues some 50-55 a step of two
// cells, 0.98-1.08 ms; a step's latency at its 16 warps an SM and its
// stores take the rest.
//
// The 32-bit body: one warp a pair, striped over rows.  The rows go in
// bands of 32; lane k owns row i0 + k of its band and at step s computes
// cell (i0 + k, s - k), so a band takes N + 31 steps (fewer in a short
// last band).  H, F, the run length and the match count of the row above
// come from lane k - 1's previous step by __shfl_up_sync: one shuffle
// each for H and F, and one for a packed word that holds the run length,
// the match count, the target code and the code's two flags (ambiguous; N
// under n_mismatch), so the target code travels down the band with them.
// The diagonal's H, run length and match count are the values the lane
// received one step earlier.  E never leaves the lane: a row's E chain is
// the lane's own sequence of steps, so no scan is needed.  Lane 31 writes
// the band's last row (H, F, packed word) to a global (B, N) int4
// scratch, 16 bytes a column, which the next band's lanes read back
// coalesced, one chunk of 32 columns ahead, into a per-warp ring in
// shared memory from which lane 0 takes its column each step; band 0
// computes the top boundary there instead.  The score comes from the lane
// whose row is qlen - 1, at j = tlen - 1; hmin and hmax are folded across
// the lanes at the end.  A block holds P consecutive pairs, one warp
// each; each warp writes its cells of a 32-step chunk into a shared
// stage, [step][row][pair] with an odd number of words a (step, row) so
// that the 32 lanes' stores fall in 32 banks; after a __syncthreads the
// block flushes it, each thread one (row, pair) over the chunk's steps, so
// a store instruction puts out P consecutive values of a cell (i, j).  P
// is the largest power of two up to 32 that still gives 128 blocks.
//
// The 16-bit body (K2m where fits_int16 holds, track is 0 and the
// substitution scores lie in [-64, 63]: the allpairs cell) takes two
// consecutive pairs b, b + 1 a warp, a couple, on the same striped rows:
// every score (H, E, F, the diagonal, the gap constants) is two uint16
// halves of one register, pair b low, each held as score + 32768 so that
// unsigned order is score order, and the envelope keeps every value and
// intermediate of the M x N box inside those halves.  The recurrences go
// through Hopper's 16x2 DPX forms: max.u16x2 (VIMNMX.U16x2) for htemp2 and
// h, __viaddmax_u16x2 (VIADDMNMX.U16x2) for the E and F updates and the
// run-length step.  Every direction bit is a strict '>' a > b of a max
// m = max(a, b): m - b is >= 0 in each half, so one 32-bit subtraction
// has no borrow between halves, and min.u16x2(m - b, 1) is the bit in
// each half (dup: htemp2 - htemp; dleft: h - htemp2; dextu: F's max less
// h - QR_t; dextl: E's new max less htemp2 - QR_q, times go_q > 0, since
// E - R_q > h - QR_q holds exactly when go_q > 0 and E - R_q > htemp2 -
// QR_q).  Additions whose halves stay inside the envelope are plain
// 32-bit adds.  V comes from two byte permutes: the column's word holds,
// for each of the four base codes, the class of the target against it
// (match, mismatch, ambiguous, N under n_mismatch), and the row's word
// holds V + 64 for each class, so prmt(row, prmt(class words, row code))
// is V + 64 in both halves.  The shuffled words are H, F, C (run length
// << 8 | match count, a half a pair; a run at RLCAP restarts through
// max(C + 0x100 wrapping, 0x100)), the two class words and a target word
// (code for the match plane, the target-right flag in bit 15 of a half):
// six shuffles serve two cells where three served one.  The rows are
// handed down the warp by a rotating shuffle, so lane 0 receives lane 31's
// registers, which lane 31 refills from the ring by one predicated load
// pair after it has written its own last row to the scratch (no select on
// lane 0).  The scratch holds 16 bytes a column for a couple (H, F, C),
// half the 32-bit body's traffic; the column words are made again each
// band from t4T, loaded a chunk ahead and derived after the chunk's steps.
// The first chunk of a band runs its steps under j >= 0; the others need
// no test: lanes past column N compute values nothing reads, and lane 31
// writes them into 32 columns of scratch padding.  A step is some 50
// instructions for two cells (cuobjdump: 7 VIMNMX.U16x2 and 3
// VIADDMNMX.U16x2 among them) against ~65 for one in the 32-bit body.
//
// Its stores: the stage is double-buffered, so there is one block barrier
// a chunk, and the block stores chunk n - 1's stage while it computes
// chunk n: each thread one step of its share in every odd step (8 bytes
// of dirs and 4 of mr, four pairs a cell, where 4 | B and the planes are
// aligned; otherwise single values, the whole chunk at the next chunk's
// start: small batches and odd ones).  Stored in one burst after each
// chunk behind two barriers, as the 32-bit body does, the stores left the
// card's memory idle while the warps computed, and the body ran 1.73 ms
// at the allpairs batch (PERF.md).  A block holds P couples (up to 16, the most that still give 128 blocks:
// 16 at the allpairs batch of 4096, 128 registers a thread).
//
// Alternatives weighed: lanes over columns with a warp max-plus scan of E
// a row (the TPU's two-level scan, nw_pallas2.py:191-224) costs log2(32)
// shuffle stages a cell where the striped rows need three shuffles; row
// bands pipelined over several warps of one pair would add warps at small
// B, where K2 is bound by latency.  K6 (nw_wavefront.cu) runs that design
// on its diagonal-major plane.
//
// Resources (ptxas, sm_90a): __launch_bounds__(32 P, 32 / P) caps each
// 32-bit instantiation at 64 registers; they use 56-64, and K2m at P = 1
// spills 8 bytes; the 16-bit body, __launch_bounds__(32 P, 16 / P), uses
// 107-128.  Dynamic shared memory, the ring, the dirs stage and the mr
// stage: 14 336 bytes for K2 at P = 4, 45 056 at P = 16, 122 880 for the
// 32-bit K2m at P = 32; 229 376 for the 16-bit body at 16 couples (its
// two stages).
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

// ---- K2m, the 16-bit body: a couple of pairs a warp ----

#define MAX_COUPLES 16     // couples (warps) of a block
#define SCORE_BIAS 32768   // a score s is held as the uint16 s + 32768
#define V_BIAS 64          // the row's V words hold V + 64 (V in [-64, 63])
#define HALF_ONES 0x00010001u

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s)
{
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
    return d;
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b)
{
    uint32_t d;
    asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b)
{
    uint32_t d;
    asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// where pred is not 0, the 32-byte ring entry at shared address addr into
// (a, b, c) and (d, e, f) in place; elsewhere the registers keep their
// values (one predicated load pair, no branch and no moves)
__device__ __forceinline__ void refill_if(uint32_t pred, uint32_t addr,
                                          uint32_t& a, uint32_t& b,
                                          uint32_t& c, uint32_t& d,
                                          uint32_t& e, uint32_t& f)
{
    uint32_t pad0, pad1;
    asm volatile("{\n\t.reg .pred q;\n\t"
                 "setp.ne.u32 q, %8, 0;\n\t"
                 "@q ld.shared.v4.u32 {%0, %1, %2, %6}, [%9];\n\t"
                 "@q ld.shared.v4.u32 {%3, %4, %5, %7}, [%9+16];\n\t}"
                 : "+r"(a), "+r"(b), "+r"(c), "+r"(d), "+r"(e), "+r"(f),
                   "=r"(pad0), "=r"(pad1)
                 : "r"(pred), "r"(addr)
                 : "memory");
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi)
{
    return ((uint32_t)lo & 0xffffu) | ((uint32_t)hi << 16);
}

// the class of target code t against each base code k (byte k): 0 match,
// 1 mismatch, 2 ambiguous, 3 N under n_mismatch; each byte also carries
// base (0x80 for the low pair: the high nibble then selects a zero byte in
// the second permute; 0x84 for the high pair, whose classes index bytes
// 4-7)
__device__ __forceinline__ uint32_t class_word(int t, bool n_mismatch,
                                               uint32_t base)
{
    const uint32_t w = base * 0x01010101u;
    if (n_mismatch && t == 15) return w + 0x03030303u;
    if (!(t == 1 || t == 2 || t == 4 || t == 8)) return w + 0x02020202u;
    return w + (0x01010101u & ~(0xffu << (8 * (__ffs(t) - 1))));
}

// the code a target contributes to the match plane: none for N under
// n_mismatch
__device__ __forceinline__ int match_code(int t, bool n_mismatch)
{
    return (n_mismatch && t == 15) ? 0 : (t & 15);
}

// a column as the couple's row above a band sees it: H, F, C (run length
// << 8 | match count) a half a pair, and the column's two class words and
// its target word (match-plane code, target-right flag in bit 15)
struct Col {
    uint4 hfc;
    uint4 tcl;
};

// two stages, [step][row][couple]: chunk n writes stage n % 2 while the
// block stores chunk n - 1's from the other
template <int P> struct Stage16 {
    static constexpr int dirs = P | 1;                               // words
    static constexpr int mr = 2 * ((P >= 2 ? P / 2 : 1) | 1);        // uint16
    static constexpr int dirs_size = LANES * LANES * dirs;
    static constexpr int mr_size = LANES * LANES * mr;
    static constexpr size_t bytes()
    {
        return (size_t)P * LANES * sizeof(Col) + 2 * (size_t)dirs_size * 4
               + 2 * (size_t)mr_size * 2;
    }
};

template <int P>
__global__ void __launch_bounds__(LANES * P, MAX_COUPLES / P)
nw_rowscan_mr16_kernel(const int8_t* __restrict__ qmT,
                       const int16_t* __restrict__ amT,
                       const int32_t* __restrict__ qlen,
                       const int8_t* __restrict__ t4T,
                       const int32_t* __restrict__ tlen,
                       int M, int N, int B, Scheme s, int wide,
                       int32_t* __restrict__ score_out,
                       bool* __restrict__ over_out,
                       uint16_t* __restrict__ dirs,
                       uint4* __restrict__ rows,
                       const int8_t* __restrict__ rqT,
                       uint8_t* __restrict__ mr)
{
    extern __shared__ uint4 smem16[];
    constexpr int DS = Stage16<P>::dirs;
    constexpr int MS = Stage16<P>::mr;
    const int w = threadIdx.x / LANES;
    const int lane = threadIdx.x % LANES;
    const int src = (lane + LANES - 1) % LANES;   // the rotating shuffle
    const int c0 = blockIdx.x * P;
    const int b = 2 * (c0 + w);                   // pairs b, b + 1
    const bool lo_ok = b < B;
    const bool hi_ok = b + 1 < B;
    Col* ring = (Col*)smem16 + w * LANES;
    const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
    const uint32_t is31 = lane == LANES - 1;
    uint32_t* const dstage0 = (uint32_t*)((Col*)smem16 + P * LANES);
    uint16_t* const mstage0 = (uint16_t*)(dstage0 + 2 * Stage16<P>::dirs_size);
    uint4* rowp = rows + (size_t)(lo_ok ? c0 + w : 0) * (N + LANES);
    const bool st31 = lane == LANES - 1 && lo_ok;
    const bool nmis = s.n_mismatch != 0;

    // the stores of a chunk from its stage buffer fb.  Where wide (4 | B,
    // P even, aligned planes) thread (r2, fq, kh) writes row i0 + r2 of
    // couples c0 + 2 fq and + 1 for half kh of the chunk's steps, 8 bytes
    // of dirs and 4 of mr a cell (four pairs), one step of them in each
    // odd step of the next chunk (flush_prep, flush_part); otherwise
    // thread (fr, fp) writes couple c0 + fp's single values over the
    // chunk's steps (flush_all)
    constexpr int NQ = P / 2 > 0 ? P / 2 : 1;
    const int fq = threadIdx.x % NQ;
    const int r2 = (threadIdx.x / NQ) % LANES;
    const int k0 = threadIdx.x / NQ / LANES * (LANES / 2);
    int q_lo = 0, q_hi = 0;
    uint16_t* pd = dirs;
    uint8_t* pm = mr;
    const uint32_t* pds = dstage0;
    const uint16_t* pms = mstage0;
    auto flush_prep = [&](int fb, int fi0, int fs0) {
        const int ii = fi0 + r2;
        const int bb = 2 * (c0 + 2 * fq);
        q_lo = q_hi = 0;
        if (ii < M && bb < B) {
            q_lo = max(0, r2 - fs0 - k0);
            q_hi = max(q_lo, min(LANES / 2, N + r2 - fs0 - k0));
            const long long g = ((long long)ii * N + fs0 - r2 + k0) * B + bb;
            pd = dirs + g;
            pm = mr + g;
        }
        // (pd, pm advance by a step's B each call of flush_part)
        pds = dstage0 + fb * Stage16<P>::dirs_size + (k0 * LANES + r2) * DS
              + 2 * fq;
        pms = mstage0 + fb * Stage16<P>::mr_size + (k0 * LANES + r2) * MS
              + 2 * fq;
    };
    auto flush_part = [&](int q) {
        if ((unsigned)(q - q_lo) < (unsigned)(q_hi - q_lo)) {
            const uint32_t* d = pds + q * LANES * DS;
            *(uint2*)pd = make_uint2(d[0], d[1]);
            *(uint32_t*)pm = *(const uint32_t*)(pms + q * LANES * MS);
        }
        pd += B;
        pm += B;
    };
    auto flush_all = [&](int fb, int fi0, int fs0) {
        if (wide) {
            flush_prep(fb, fi0, fs0);
            for (int q = 0; q < LANES / 2; ++q) flush_part(q);
            return;
        }
        const uint32_t* ds = dstage0 + fb * Stage16<P>::dirs_size;
        const uint16_t* ms = mstage0 + fb * Stage16<P>::mr_size;
        const int fr = threadIdx.x / P;
        const int fp = threadIdx.x % P;
        const int ii = fi0 + fr;
        const int bb = 2 * (c0 + fp);
        if (ii < M && bb < B) {
            const int k_lo = max(0, fr - fs0);
            const int k_hi = min(LANES, N + fr - fs0);
            long long g = ((long long)ii * N + fs0 - fr + k_lo) * B + bb;
            for (int k = k_lo; k < k_hi; ++k, g += B) {
                const int at = k * LANES + fr;
                const uint32_t d = ds[at * DS + fp];
                const uint32_t m = ms[at * MS + fp];
                dirs[g] = (uint16_t)d;
                mr[g] = (uint8_t)m;
                if (bb + 1 < B) {
                    dirs[g + 1] = (uint16_t)(d >> 16);
                    mr[g + 1] = (uint8_t)(m >> 8);
                }
            }
        }
    };
    // the chunks so far, and the last one's band and first step
    int cc = 0, p_i0 = 0, p_s0 = 0;

    const int ql_lo = lo_ok ? qlen[b] : 0, ql_hi = hi_ok ? qlen[b + 1] : 0;
    const int tl_lo = lo_ok ? tlen[b] : 0, tl_hi = hi_ok ? tlen[b + 1] : 0;
    const int QR_q_i = s.go_q_i + s.ge_q_i;
    const int QR_q_r = s.go_q_r + s.ge_q_r;
    const int QR_t_i = s.go_t_i + s.ge_t_i;
    const int QR_t_r = s.go_t_r + s.ge_t_r;
    const uint32_t QRt_r2 = pack2(QR_t_r, QR_t_r);
    const uint32_t QRt_i2 = pack2(QR_t_i, QR_t_i);
    const uint32_t nRt_r2 = pack2(-s.ge_t_r, -s.ge_t_r);
    const uint32_t nRt_i2 = pack2(-s.ge_t_i, -s.ge_t_i);

    uint32_t acc = 0;
    for (int i0 = 0; i0 < M; i0 += LANES) {
        const int i = i0 + lane;
        const bool row_ok = i < M;
        // the row's constants, a half a pair: the V table (V + 64 for each
        // class), the base code that picks its class byte, the query gap
        // class, the match-plane code, the score row
        uint32_t rv[2], qsel[2];
        int QRq[2], Rq[2], gm[2], rqm[2];
        bool lq[2];
        for (int h = 0; h < 2; ++h) {
            const int bb = b + h;
            const bool ok = row_ok && (h ? hi_ok : lo_ok);
            const int qm = ok ? qmT[(size_t)i * B + bb] : 0;
            const int am = ok ? amT[(size_t)i * B + bb] : 0;
            const int rq = ok ? rqT[(size_t)i * B + bb] : 0;
            const int ql = h ? ql_hi : ql_lo;
            lq[h] = row_ok && ql == i + 1;
            QRq[h] = lq[h] ? QR_q_r : QR_q_i;
            Rq[h] = lq[h] ? s.ge_q_r : s.ge_q_i;
            gm[h] = QRq[h] - Rq[h] > 0;
            rqm[h] = (nmis && rq == 15) ? 0 : (rq & 15);
            int v0 = am, v1 = am, v2 = 0, v3 = s.mismatch;   // ambiguous
            qsel[h] = 0;
            if (qm == 1 || qm == 2 || qm == 4 || qm == 8) {
                v0 = s.match;
                qsel[h] = __ffs(qm) - 1;
            } else if (nmis && qm == -2) {
                v0 = v1 = v2 = s.mismatch;
            }
            rv[h] = (uint32_t)(v0 + V_BIAS) | ((uint32_t)(v1 + V_BIAS) << 8)
                    | ((uint32_t)(v2 + V_BIAS) << 16)
                    | ((uint32_t)(v3 + V_BIAS) << 24);
        }
        const uint32_t RVa = rv[0], RVb = rv[1];
        const uint32_t vsel = qsel[0] | ((4 + qsel[1]) << 4);
        const uint32_t QRq2 = pack2(QRq[0], QRq[1]);
        const uint32_t nRq2 = pack2(-Rq[0], -Rq[1]);
        const uint32_t gm01 = pack2(gm[0], gm[1]);
        const uint32_t rq2 = pack2(rqm[0], rqm[1]);
        const uint32_t lqm = pack2(lq[0] ? 0xffff : 0, lq[1] ? 0xffff : 0);
        const int d0 = SCORE_BIAS - ((i == 0) ? 0 : s.go_t_l + i * s.ge_t_l);
        uint32_t diag = pack2(d0, d0);
        const int e0 = SCORE_BIAS - (s.go_t_l + (i + 1) * s.ge_t_l);
        uint32_t E = pack2(e0 - QRq[0], e0 - QRq[1]);
        uint32_t Cd = 0, sc = 0;
        // the shuffled registers: lane 31's are refilled from the ring
        uint32_t Hout = 0, Fout = 0, Cout = 0, Ca = 0, Cb = 0, Tw = 0;

        // the loads of column col for the row above the band: the target
        // codes and, after band 0, the scratch row; above() makes the
        // column of them (the top boundary in band 0, and the column's
        // class and target words) once they have arrived
        struct Raw {
            uint4 hfc;
            int tlo, thi;
        };
        auto fetch = [&](int col) {
            Raw r;
            r.hfc = make_uint4(0, 0, 0, 0);
            r.tlo = r.thi = 0;
            if (lo_ok && col < N) {
                r.tlo = t4T[(size_t)col * B + b];
                r.thi = hi_ok ? t4T[(size_t)col * B + b + 1] : 0;
                if (i0 > 0) r.hfc = rowp[col];
            }
            return r;
        };
        auto above = [&](int col, const Raw& r) {
            Col v;
            v.hfc = r.hfc;
            v.tcl = make_uint4(0, 0, 0, 0);
            if (lo_ok && col < N) {
                const int tlo = r.tlo, thi = r.thi;
                const bool rlo = col == tl_lo - 1, rhi = col == tl_hi - 1;
                v.tcl.x = class_word(tlo, nmis, 0x80u);
                v.tcl.y = class_word(thi, nmis, 0x84u);
                v.tcl.z = pack2(match_code(tlo, nmis) | (rlo ? 0x8000 : 0),
                                match_code(thi, nmis) | (rhi ? 0x8000 : 0));
                if (i0 == 0) {
                    const int h0 = SCORE_BIAS
                                   - (s.go_q_l + (col + 1) * s.ge_q_l);
                    v.hfc.x = pack2(h0, h0);
                    v.hfc.y = pack2(h0 - (rlo ? QR_t_r : QR_t_i),
                                    h0 - (rhi ? QR_t_r : QR_t_i));
                }
            }
            return v;
        };
        // lane 31 takes ring entry e into its shuffled registers: lane 0
        // receives them by the rotating shuffle
        auto refill = [&](int e) {
            refill_if(is31, ring_s + e * (uint32_t)sizeof(Col), Hout, Fout,
                      Cout, Ca, Cb, Tw);
        };

        const int nrows = min(LANES, M - i0);
        const int nchunks = (N + nrows - 1 + LANES - 1) / LANES;
        Col next = above(lane, fetch(lane));
        for (int c = 0; c < nchunks; ++c, ++cc) {
            const int s0 = c * LANES;
            ring[lane] = next;
            __syncwarp();
            refill(0);
            // one chunk ahead, made into columns after this chunk's steps:
            // band g - 1 wrote these columns, and this band's lane 31
            // overwrites them only in the next chunk
            const Raw raw = fetch(s0 + LANES + lane);
            const int jb = s0 - lane;
            // the last chunk's stage is complete, and the one before it
            // stored: its buffer is this chunk's
            __syncthreads();
            const int fb = cc & 1;
            uint32_t* const dstage = dstage0 + fb * Stage16<P>::dirs_size;
            uint16_t* const mstage = mstage0 + fb * Stage16<P>::mr_size;
            q_lo = q_hi = 0;
            if (cc > 0) {
                if (wide)
                    flush_prep(fb ^ 1, p_i0, p_s0);
                else
                    flush_all(fb ^ 1, p_i0, p_s0);
            }

            // step k of the chunk: cell (i, jb + k) of both pairs
            auto step = [&](int k, bool guard) {
                const uint32_t Hin = __shfl_sync(FULL, Hout, src);
                const uint32_t Fin = __shfl_sync(FULL, Fout, src);
                const uint32_t Cin = __shfl_sync(FULL, Cout, src);
                Ca = __shfl_sync(FULL, Ca, src);
                Cb = __shfl_sync(FULL, Cb, src);
                Tw = __shfl_sync(FULL, Tw, src);
                const int j = jb + k;
                if (!guard || j >= 0) {
                    const uint32_t V = prmt(RVa, RVb, prmt(Ca, Cb, vsel));
                    const uint32_t htemp = diag + V - V_BIAS * HALF_ONES;
                    const uint32_t htemp2 = max2(htemp, Fin);
                    const uint32_t h = max2(htemp2, E);
                    // strict '>' bits: a max less one of its operands
                    const uint32_t dup = min2(htemp2 - htemp, HALF_ONES);
                    const uint32_t dleft = min2(h - htemp2, HALF_ONES);
                    const uint32_t rtm = prmt(Tw, 0, 0xBB99);
                    const uint32_t QRt = (rtm & QRt_r2) | (~rtm & QRt_i2);
                    const uint32_t nRt = (rtm & nRt_r2) | (~rtm & nRt_i2);
                    const uint32_t HF = h - QRt;
                    const uint32_t fo = __viaddmax_u16x2(Fin, nRt, HF);
                    const uint32_t dextu = min2(fo - HF, HALF_ONES);
                    const uint32_t HQ = htemp2 - QRq2;
                    const uint32_t En = __viaddmax_u16x2(E, nRq2, HQ);
                    const uint32_t dextl = min2(En - HQ, gm01);
                    // run length and match count: a diagonal move extends
                    // the diagonal's (restarting after RLCAP), others clear
                    const uint32_t ism = min2(rq2 & Tw, HALF_ONES);
                    const uint32_t z = __viaddmax_u16x2(Cd, 0x01000100u,
                                                        0x01000100u);
                    const uint32_t lu = dup | dleft;
                    const uint32_t Cn = (z + ism) & ~(lu * 0xffffu);
                    const uint32_t dw = ((((dextl * 2 + dextu) * 2 + dleft)
                                          * 2) + dup)
                                        | ((Cn >> 4) & 0x0ff00ff0u);
                    const int at = k * LANES + lane;
                    dstage[at * DS + w] = dw;
                    mstage[at * MS + w] = (uint16_t)prmt(Cn, 0, 0x0020);
                    sc |= h & rtm;
                    // (the fourth word is never read)
                    if (st31) rowp[j] = make_uint4(h, fo, Cn, Tw);
                    Hout = h;
                    Fout = fo;
                    Cout = Cn;
                    E = En;
                    diag = Hin;
                    Cd = Cin;
                }
                if (k < LANES - 1) refill(k + 1);
                if (P % 2 == 0 && (k & 1)) flush_part(k >> 1);
            };
            if (c == 0) {
#pragma unroll 4
                for (int k = 0; k < LANES; ++k) step(k, true);
            } else {
#pragma unroll
                for (int k = 0; k < LANES; ++k) step(k, false);
            }
            acc |= sc & lqm;
            sc = 0;
            p_i0 = i0;
            p_s0 = s0;
            next = above(s0 + LANES + lane, raw);
        }
    }
    __syncthreads();
    flush_all((cc - 1) & 1, p_i0, p_s0);
    // the score cells: one lane of one band a pair holds a half
    for (int off = 16; off > 0; off >>= 1)
        acc |= __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) {
        if (lo_ok) {
            const bool valid = ql_lo >= 1 && ql_lo <= M && tl_lo >= 1
                               && tl_lo <= N;
            score_out[b] = valid ? (int)(acc & 0xffffu) - SCORE_BIAS : 0;
            over_out[b] = false;
        }
        if (hi_ok) {
            const bool valid = ql_hi >= 1 && ql_hi <= M && tl_hi >= 1
                               && tl_hi <= N;
            score_out[b + 1] = valid ? (int)(acc >> 16) - SCORE_BIAS : 0;
            over_out[b + 1] = false;
        }
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

template <int P>
static int launch16_p(const void* qmT, const void* amT, const void* rqT,
                      const void* qlen, const void* t4T, const void* tlen,
                      int M, int N, int B, const Scheme& s, int wide,
                      void* score, void* overflow, void* dirs, void* mr,
                      void* rows, cudaStream_t stream)
{
    const size_t smem = Stage16<P>::bytes();
    cudaError_t err = cudaFuncSetAttribute(
        nw_rowscan_mr16_kernel<P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int couples = (B + 1) / 2;
    nw_rowscan_mr16_kernel<P><<<(couples + P - 1) / P, P * LANES, smem,
                                stream>>>(
        (const int8_t*)qmT, (const int16_t*)amT, (const int32_t*)qlen,
        (const int8_t*)t4T, (const int32_t*)tlen, M, N, B, s, wide,
        (int32_t*)score, (bool*)overflow, (uint16_t*)dirs, (uint4*)rows,
        (const int8_t*)rqT, (uint8_t*)mr);
    return (int)cudaGetLastError();
}

// K2m's 16-bit body, for a scheme and geometry inside the host's 16-bit
// envelope (ops/nw_rowscan.py rowscan16): as nw_rowscan_mr_launch, with
// rows a ((B + 1) / 2, N + 32) int4 scratch (16 bytes a column of a
// couple, 32 columns of padding).  P, the couples of a block: the largest
// power of two up to MAX_COUPLES that still gives MIN_BLOCKS blocks.
extern "C" int nw_rowscan_mr16_launch(const void* qmT, const void* amT,
                                      const void* rqT, const void* qlen,
                                      const void* t4T, const void* tlen,
                                      int M, int N, int B,
                                      const int* scheme, void* score,
                                      void* overflow, void* dirs, void* mr,
                                      void* rows, void* stream)
{
    const int couples = (B + 1) / 2;
    if (couples == 0) return 0;
    int P = MAX_COUPLES;
    while (P > 1 && (couples + P - 1) / P < MIN_BLOCKS) P /= 2;
    const Scheme s = make_scheme(scheme);
    // the flush's stores: 64-bit dirs and 32-bit mr, four pairs, where B
    // and the block's first pair are multiples of 4 and the planes are
    // aligned; single values otherwise
    const int wide = B % 4 == 0 && P % 2 == 0 && (uintptr_t)dirs % 8 == 0
                     && (uintptr_t)mr % 4 == 0;
    cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH16(p) launch16_p<p>(qmT, amT, rqT, qlen, t4T, tlen, M, N, B, s, \
                                  wide, score, overflow, dirs, mr, rows, st)
    switch (P) {
    case 16: return LAUNCH16(16);
    case 8: return LAUNCH16(8);
    case 4: return LAUNCH16(4);
    case 2: return LAUNCH16(2);
    default: return LAUNCH16(1);
    }
#undef LAUNCH16
}
