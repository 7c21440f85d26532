// Batched 8-bit banded striped pairwise DP, for Hopper (sm_90a).
//
// Replaces the TPU kernel bsalign_tpu/ops/banded8_pallas.py::_get_call.kernel
// in all three of its emit modes: the adaptively banded, striped difference
// DP of bsalign.h:2084-4050 (band move with the mimic-insertion overhang,
// row recurrence with the active F-loop, adaptive and global band steering,
// best-end tracking) for global/overlap/extend and piecewise 0/1/2. Per row
// it emits, by the EMIT template argument:
//   codes:  the 4-bit m/d/eo/fo decision bits of each cell
//           (bsalign_tpu/align/btcodes.codes_from_rows), packed 8 nibbles per
//           int32 word along the stripe axis (piecewise 0/1 only);
//   planes: the int8 u/e/q difference planes, the stripe anchors and the band
//           offset, which the host's backcal walks (piecewise 2 needs this);
//   none:   nothing (scores only: the long-read mode's first pass).
// Every emit writes the final planes, anchors and registers, and a call
// resumes a run at global row row0 from an earlier call's final state
// (init_* and init_reg), so long targets run in row chunks. The plain
// PyTorch version of the same function is
// bsalign_tpu_torch/ops/banded8.py::forward_plain; the two agree bit for bit.
// This is the narrow row, launched for bands below WIDE_W stripes
// (ops/_cuda.py); banded8_wide.cu computes the same function for wider
// bands with a block of threads a pair.
//
// What bounds it on this card: neither bytes nor operations but latency.
// Each pair is a serial chain of T rows, and each row a chain of W stripes
// (two passes), a 15-step ripple over lane heads and the band steering's
// cross-lane sums, so a pair's time is T times the latency of one row, and
// a launch of a few hundred pairs puts one warp on each SM with nothing to
// hide that latency behind.
//
// What the design does about it: one half-warp (16 threads) per pair, thread
// j owning striped lane j of every stripe, exactly the 16 int8 lanes of the
// reference's SSE vectors; cross-lane steps (the stripe carry at x == 0, the
// F-loop ripple, the running maxima of the code pass, the steering sums)
// are half-warp shuffles. The row step keeps memory off its dependent chain:
//   - stripes go in groups of G = 8, one 8-byte shared-memory word per lane,
//     group and plane, with the group's 8 steps unrolled (a masked last group
//     serves every W from 1 up);
//   - the query is read as bytes through the read-only path, each lane's
//     window loaded at the end of the row before (where the row's band
//     move is planned), and turned into scores by a byte permute against
//     the row's four scores;
//   - the 20 substitution scores live in registers from the kernel's start,
//     and the next row's target base and diagonal target are loaded a row
//     ahead;
//   - the first group of each plane stays in registers from one row to the
//     next, so a row whose band does not move reads no shared memory before
//     its passes, and getscore's prefix sums are byte dot products (dp4a);
//   - saturating int8 arithmetic and the three-way maxima use Hopper's DPX
//     instructions (__viaddmin_s32, __vimax3_s32): two dependent steps for a
//     saturating add, one for a three-way max, the same integer functions;
//   - the codes emit's lane sums and running maximum are taken inside pass 2,
//     so the code pass is one loop after the lane scan;
//   - both pairs of a warp run every shuffle together, with the whole
//     warp's mask: a frozen pair (or the missing pair of an odd batch) runs
//     beside a live one with its band held and its writes dropped, so no
//     shuffle carries a divergence guard.
// Band state lives in shared memory as int8 planes (u, plus e for piecewise
// >= 1 and q for piecewise 2), double-buffered, each lane's W stripes padded
// to an odd number of 8-byte words (no bank conflicts). Two pairs share a
// warp and a block by default, so a launch of 256 pairs spreads over 128 SMs.
// A band whose planes do not fit the block's 227 KB of shared memory (past
// 57,984 / 29,056 / 19,328 at piecewise 0 / 1 / 2) keeps the same planes,
// in the same layout, in a scratch of device memory that the launcher
// allocates, 2 x BUF bytes per pair slot (the GS template flag): the row
// step is the same code reading and writing through another pointer. Each
// pair's scratch is its own warp's alone, so its reads after a write are
// ordered by the same __syncwarp, and a row's few hundred KB stay in L2.
//
// Layouts (batch-minor as in the JAX package; int32 unless stated):
//   qb uint8 [B, QPU] (query codes; 4 past the query scores MIN8),
//   tseq [B, T], qlen/tlen/rbz [B], rby [T, B], mtx5 [5, 4],
//   init_us/init_es/init_qs [W, 16, B], init_ub [17, B], init_reg [8, B];
//   codes [T, CPW, 16, B]; us_o/es_o/qs_o int8 [T, W*16, B] (index x*16 + j),
//   ubegs [T, 17, B]; begs [T, B]; fin_us/fin_es/fin_qs [W, 16, B],
//   fin_ub [17, B], fin_reg [8, B] = rbeg, mov, 0, best score, best qe,
//   best te, 0, 0; cycles int64 [NPHASE, B] or null. tseq and rby hold this
//   call's T rows: local row r is global row row0 + r, and every test of the
//   recurrence uses the global row. init_reg slot 2 (the TPU's window-slack
//   counter) is not read.
// Rows at and past a pair's tlen write codes, planes and anchors 0 and
// begs = the frozen rbeg.

#include <type_traits>

#include "banded8_common.cuh"

namespace {

// Sum of lane bytes 0..x of the plane whose lane starts at lb (group 0
// given as w0).
__device__ __forceinline__ int lane_prefix(u64 w0, const int8_t *lb, int x) {
    if (x < G) return bytesum(w0, x);
    int s = bytesum(w0, 7);
    int g = 1;
    for (; (g + 1) * G <= x; ++g) s += bytesum(lds64(lb + g * G), 7);
    return s + bytesum(lds64(lb + g * G), x - g * G);
}

// H at natural band position pos of the plane whose lane j starts at lb
// (group 0 in w0), with anchors (ub_j, ub16): lane y's prefix sum over
// stripes 0..x plus its anchor. Past the band the stripe sum is 0 and the
// anchor ub[16] (pos // W == 16) or 0.
__device__ __forceinline__ int getscore(u64 w0, const int8_t *lb, int ub_j,
                                        int ub16, int W, unsigned mw,
                                        int pos) {
    const int y = div_w(min(pos, (WS + 1) * W), mw);
    const int x = min(pos - y * W, W - 1);
    const int v = __shfl_sync(FULL, ub_j + lane_prefix(w0, lb, x),
                              min(y, WS - 1), WS);
    return y < WS ? v : (y == WS ? ub16 : 0);
}

// The band move of one plane when each lane holds all its stripes in one
// word (W <= 8): natural band position j*W + x takes old position
// j*W + x + mov, so lane j's new word is lane j+cyc's bytes mv..W-1 then
// lane j+cyc+1's bytes 0..mv-1, and 0 past the band's last lane.
__device__ __forceinline__ u64 band_shift(u64 w, int j, int cyc, int mv,
                                          int W) {
    const int s0 = j + cyc;
    const u64 a = __shfl_sync(FULL, w, min(s0, WS - 1), WS);
    const u64 c = __shfl_sync(FULL, w, min(s0 + 1, WS - 1), WS);
    const int sh = 8 * (W - mv);   // 8..64
    const u64 lo = s0 < WS ? a >> (8 * mv) : 0;
    const u64 hi = s0 + 1 < WS && sh < 64 ? c << sh : 0;
    const u64 keep = W == G ? ~0ull : (1ull << (8 * W)) - 1;
    return (lo | hi) & keep;
}
// Active F-loops over lane heads (bsalign.h:2639-2652) for N gap states
// (f, and g at piecewise 2) side by side: f[n] holds lane j's pass-1 value
// at the end of its block and becomes the value entering lane j, with the
// int8 wrap on stores; t[n] = W * the state's gap extension. The lane
// values and the steps t - (ub[jj+1] - ub[jj]) are known before the
// ripples, which are then one compare-and-select per lane head each.
template <int N>
__device__ __forceinline__ void fpen(int (&f)[N], const int *ubv,
                                     const int (&t)[N], int j) {
    int d[WS], fi[N][WS], s[N], fj[N];
#pragma unroll
    for (int jj = 0; jj < WS; ++jj) d[jj] = ubv[jj + 1] - ubv[jj];
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int jj = 1; jj < WS; ++jj)
            fi[n][jj] = __shfl_sync(FULL, f[n], jj - 1, WS);
        fj[n] = MIN8;
        s[n] = t[n] + MIN8 - d[0];
    }
#pragma unroll
    for (int jj = 1; jj < WS; ++jj) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
            const int w = wrap8(s[n]);
            const int fi2 = fi[n][jj] < s[n] ? w : fi[n][jj];
            if (j == jj) fj[n] = fi2;
            s[n] = fi2 + (t[n] - d[jj]);
        }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) f[n] = fj[n];
}

// PW: piecewise 0/1/2; MT: mode type 0 global, 1 overlap, 2 extend;
// EMIT: EMIT_CODES (PW < 2), EMIT_PLANES or EMIT_NONE; GS: the planes in
// device memory (p.gs) instead of shared memory.
template <int PW, int MT, int EMIT, bool GS>
__global__ void banded8_rows_kernel(const Params p) {
    static_assert(EMIT != EMIT_CODES || PW < 2, "codes cover piecewise 0/1");
    constexpr bool GLOBAL = MT == 0, OVERLAP = MT == 1;
    constexpr int NPL = PW + 1;   // planes per buffer: u, e, q
    extern __shared__ __align__(16) int8_t smem[];
    const int half = threadIdx.x / WS;
    const int j = threadIdx.x % WS;
    // a block's last pair may be missing: its half-warp runs beside the
    // other as a pair frozen from its first row, reading pair B - 1 and
    // writing nothing, so that the warp's shuffles stay whole
    const bool real = blockIdx.x * p.ppb + half < p.B;
    const int b = real ? blockIdx.x * p.ppb + half : p.B - 1;
    const unsigned mask = 0xFFFFu << (threadIdx.x & 16);
    const int W = p.W, BW = W * WS, B = p.B, T = p.T;
    const int NG = (W + G - 1) / G;        // groups of stripes (= CPW)
    const int WP = G * (NG | 1);           // lane stride in bytes
    const int PL = WS * WP;                // plane
    const int BUF = NPL * PL;              // buffer of planes
    const unsigned mw = 0xFFFFFFFFu / (unsigned)W + 1u;
    const int GapE = p.gape1, GapOE = p.gapo1 + p.gape1;
    const int GapP = p.gape2, GapQP = p.gapo2 + p.gape2;
    const int GapOQ = min(max(GapOE - GapQP, -128), 127);
    // max(sat8(y), GapOE) = max(min(y, 127), loE), and so for q
    const int loE = max(GapOE, -128), loQ = max(GapQP, -128);
    const int qlen = p.qlen[b], tlen = real ? p.tlen[b] : 0;
    const int *__restrict__ tseq = p.tseq + (size_t)b * T;
    const int *__restrict__ rby = p.rby;
    const uint8_t *__restrict__ qrow = p.qb + (size_t)b * p.QPU;
    const int rbz = GLOBAL ? p.rbz[b] : 1;

    // the row's scores of query codes 0..3 as bytes, by target base
    unsigned S4[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        unsigned s = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
            s |= (unsigned)(uint8_t)p.mtx5[c * 4 + t] << (8 * c);
        S4[t] = s;
    }

    // the pair's two buffers: cell (x, lane j) of plane k in buffer c lies
    // at sp + c * BUF + k * PL + j * WP + x (GS: in the scratch slot of the
    // block's pair `half`, a missing pair's slot too)
    int8_t *const sp = GS ? p.gs + (size_t)(blockIdx.x * p.ppb + half) * 2 * BUF
                          : smem + (size_t)half * 2 * BUF;
    for (int x = 0; x < NG * G; ++x) {
        const size_t k = ((size_t)x * WS + j) * B + b;
        int8_t *c = sp + j * WP + x;
        c[0] = x < W ? (int8_t)p.init_us[k] : 0;
        if (PW >= 1) c[PL] = x < W ? (int8_t)p.init_es[k] : 0;
        if (PW == 2) c[2 * PL] = x < W ? (int8_t)p.init_qs[k] : 0;
    }
    int ub_j = p.init_ub[(size_t)j * B + b];
    int ub16 = p.init_ub[(size_t)WS * B + b];
    int rbeg = p.init_reg[b], mov = p.init_reg[(size_t)B + b];
    int best_s = p.init_reg[(size_t)3 * B + b];
    int best_qe = p.init_reg[(size_t)4 * B + b];
    int best_te = p.init_reg[(size_t)5 * B + b];
    int cur = 0;
    // group 0 of the current band's planes, kept in registers
    u64 OU = lds64(sp + j * WP), OE = 0, OQ = 0;
    if (PW >= 1) OE = lds64(sp + PL + j * WP);
    if (PW == 2) OQ = lds64(sp + 2 * PL + j * WP);
    // the next row's target base and diagonal target, loaded a row ahead
    int tb_nx = T > 0 ? __ldg(tseq) : 0;
    // a row's band move and query window, planned at the end of the row
    // before it, so that the window's loads are in flight during its emit
    bool cm_nx = false;
    int me_nx = 0;
    QWin qw_nx;
    auto plan = [&](int i_n, int rb, int mv_) {
        cm_nx = i_n < tlen && mv_ > 0 && rb + BW < qlen;
        me_nx = cm_nx ? min(mv_, max(0, qlen - (rb + BW))) : 0;
        qw_nx = qwin(qrow, rb + me_nx + j * W);
    };
    plan(p.row0, rbeg, mov);
    int rby_nx = GLOBAL && T > 0 ? __ldg(rby + b) : 0;
    // cycle split: clock64() deltas per phase, summed over active rows; the
    // guard is uniform, and every main path passes a null pointer
    const bool split = p.cycles != nullptr;
    long long acc[NPHASE] = {0, 0, 0, 0, 0, 0, 0}, tk = 0;
    bool live = false;   // this row lies below the pair's tlen
    auto tick = [&](int k) {
        if (split) {
            const long long t = clock64();
            if (live) acc[k] += t - tk;
            tk = t;
        }
    };
    __syncwarp(mask);

    for (int r = 0; r < T; ++r) {
        const int i = p.row0 + r;   // global row
        const int tb = tb_nx, rby_i = rby_nx;
        if (r + 1 < T) {
            tb_nx = __ldg(tseq + r + 1);
            if (GLOBAL) rby_nx = __ldg(rby + (size_t)(r + 1) * B + b);
        }
        live = i < tlen;
        if (!live && real) {   // frozen pair: zero row outputs, band stays
            if (EMIT == EMIT_CODES) {
                for (int k = 0; k < NG; ++k)
                    p.codes[(((size_t)r * NG + k) * WS + j) * B + b] = 0;
            } else if (EMIT == EMIT_PLANES) {
                for (int x = 0; x < W; ++x) {
                    const size_t k = ((size_t)r * BW + x * WS + j) * B + b;
                    p.us_o[k] = 0;
                    if (PW >= 1) p.es_o[k] = 0;
                    if (PW == 2) p.qs_o[k] = 0;
                }
                p.ubegs[((size_t)r * (WS + 1) + j) * B + b] = 0;
                if (j == 0) p.ubegs[((size_t)r * (WS + 1) + WS) * B + b] = 0;
            }
            if (EMIT != EMIT_NONE && j == 0) p.begs[(size_t)r * B + b] = rbeg;
        }
        // a frozen pair beside a live one runs the row with it, its band
        // held still and its results dropped
        if (!__any_sync(FULL, live)) continue;
        if (split) tk = clock64();
        const bool cond_move = cm_nx;
        const int mov_eff = me_nx;
        const int rbeg_n = rbeg + mov_eff;
        const int qa = rbeg_n + j * W;   // query position of (x=0, lane j)
        const QWin qw0 = qw_nx;
        const unsigned S = tb == 1 ? S4[1] : tb == 2 ? S4[2]
                         : tb == 3 ? S4[3] : S4[0];
        int8_t *const ob = sp + cur * BUF;   // the current band
        const int8_t *const olb = ob + j * WP;
        const int rh_s = getscore(OU, olb, ub_j, ub16, W, mw,
                                  max(mov_eff - 1, 0));
        const int rh_move = cond_move ? rh_s : 0;
        int inner = 0;
        if (!OVERLAP && i != 0) {
            inner = p.gapo1 + p.gape1 * i;
            if (PW == 2) inner = max(inner, p.gapo2 + p.gape2 * i);
        }
        const int rh = cond_move ? rh_move : (rbeg > 0 ? SCORE_MIN : inner);

        // ---- band move (bsalign.h:2244-2392) into the other buffer ----
        // nb holds this row's moved planes, db the planes pass 2 writes
        const bool reset = mov_eff >= BW;   // full reset (bsalign.h:2253-2259)
        const int cyc = div_w(min(mov_eff, BW), mw);
        const int mv = reset ? 0 : mov_eff - cyc * W;
        int8_t *const nb = mov_eff == 0 ? ob : sp + (1 - cur) * BUF;
        int8_t *const db = mov_eff == 0 ? sp + (1 - cur) * BUF : ob;
        const int s_mv = ub_j + (mv > 0 ? lane_prefix(OU, olb, mv - 1) : 0);
        const int gs = __shfl_sync(FULL, s_mv, min(j + cyc, WS - 1), WS);
        u64 NU = OU, NE = OE, NQ = OQ;   // group 0 of the moved planes
        if (NG == 1) {   // from the registers of the other lanes
            NU = band_shift(OU, j, cyc, mv, W);
            if (PW >= 1) NE = band_shift(OE, j, cyc, mv, W);
            if (PW == 2) NQ = band_shift(OQ, j, cyc, mv, W);
        }
        int ub0_j = ub_j, ub0_16 = ub16;
        if (mov_eff > 0) {
            int8_t *const mlb = nb + j * WP;
            if (reset) {
                NU = NE = NQ = 0;
                for (int g = 0; NG > 1 && g < NG; ++g) {
                    sts64(mlb + g * G, 0);
                    if (PW >= 1) sts64(mlb + PL + g * G, 0);
                    if (PW == 2) sts64(mlb + 2 * PL + g * G, 0);
                }
                ub0_j = SCORE_MIN; ub0_16 = SCORE_MIN;
            } else {
                ub0_j = j < WS - cyc ? gs : ub16;
                // running overhang cost at the end of lane block jb
                const int p0 = BW - mov_eff;
                auto adj = [&](int jb) {
                    const int rel = (jb + 1) * W - 1 - p0;
                    if (rel < 0) return 0;
                    const int n1 = min(rel, p.d_oh - 1);
                    const int n2 = max(rel - p.d_oh + 1, 0);
                    return p.c_oh + p.gape1 * n1 + p.gape2 * n2;
                };
                if (j >= 1) ub0_j += adj(j - 1);
                ub0_16 += adj(WS - 1);
                if (NG == 1) {
                    // the overhang cells (natural position p >= p0) read 0
                    // and take the mimic-insertion costs: c_oh at p0,
                    // gape1 below p0 + d_oh, gape2 from there
                    const int k0 = p0 - j * W;
                    if (k0 < W) {
                        const u64 one = 0x0101010101010101ull;
                        const u64 m1 = bytes_from(k0);
                        const u64 m2 = bytes_from(k0 + min(p.d_oh, BW));
                        u64 fill = (one * (uint8_t)p.gape1 & m1 & ~m2)
                                 | (one * (uint8_t)p.gape2 & m2);
                        if (k0 >= 0)
                            fill = (fill & ~(0xFFull << (8 * k0)))
                                 | put_byte(p.c_oh, k0);
                        NU |= fill & (W == G ? ~0ull : (1ull << (8 * W)) - 1);
                    }
                }
                // cell x of lane j takes old natural position j*W + x + mov:
                // lane j + cyc (+1 past the lane's end), stripe x + mv (- W)
                for (int g = 0; NG > 1 && g < NG; ++g) {
                    u64 wu = 0, we = 0, wq = 0;
                    const int kn = min(G, W - g * G);
#pragma unroll
                    for (int k = 0; k < G; ++k) {
                        if (k < kn) {
                            const int t = g * G + k + mv;
                            const int wr = t >= W;
                            const int sl = j + cyc + wr, sx = t - wr * W;
                            const int pn = j * W + g * G + k;
                            int vu, ve = 0, vq = 0;
                            if (sl < WS) {
                                const int8_t *c = ob + sl * WP + sx;
                                vu = c[0];
                                if (PW >= 1) ve = c[PL];
                                if (PW == 2) vq = c[2 * PL];
                            } else {
                                vu = pn == p0 ? p.c_oh
                                   : (pn < p0 + p.d_oh ? p.gape1 : p.gape2);
                            }
                            wu |= put_byte(vu, k);
                            we |= put_byte(ve, k);
                            wq |= put_byte(vq, k);
                        }
                    }
                    sts64(mlb + g * G, wu);
                    if (PW >= 1) sts64(mlb + PL + g * G, we);
                    if (PW == 2) sts64(mlb + 2 * PL + g * G, wq);
                    if (g == 0) { NU = wu; NE = we; NQ = wq; }
                }
            }
            // every lane has read the current band before pass 2 writes it
            if (NG > 1) __syncwarp(mask);
        }
        const int8_t *const nlb = nb + j * WP;
        int8_t *const dlb = db + j * WP;
        tick(0);

        // ---- row head ----
        const int ub0_0 = __shfl_sync(FULL, ub0_j, 0, WS);
        const int n0 = sbyte(NU, 0);
        const int t0 = PW == 0 ? n0 + GapE
                     : PW == 1 ? n0 + sbyte(NE, 0)
                     : n0 + max(sbyte(NE, 0), sbyte(NQ, 0));
        const int sc0 = qscore(qw0, S, 0);
        int h0 = (rh - ub0_0) + sc0;
        h0 = h0 >= t0 ? min(h0, MAX8) : MIN8;
        h0 = wrap8(h0);
        const int qp0 = j == 0 ? h0 : sc0;
        tick(1);

        // ---- pass 1: f (and g) entering each lane block ----
        int h = qp0, f = MIN8, gg = MIN8;
        for (int g = 0; g < NG; ++g) {
            const u64 wu = g == 0 ? NU : lds64(nlb + g * G);
            const u64 we = PW == 0 ? 0 : g == 0 ? NE : lds64(nlb + PL + g * G);
            const u64 wq = PW < 2 ? 0 : g == 0 ? NQ : lds64(nlb + 2 * PL + g * G);
            const QWin qw = g == 0 ? qw0 : qwin(qrow, qa + g * G);
            auto group = [&](auto full, int kn) {
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    if (decltype(full)::value || k < kn) {
                        const int u = sbyte(wu, k);
                        if (PW == 0) {
                            const int e = adds8(u, GapE);
                            h = max3(e, h, f);
                            f = adds8(adds8(h, GapE), -u);
                        } else if (PW == 1) {
                            const int e = adds8(sbyte(we, k), u);
                            h = max3(e, h, f);
                            f = adds8(f, GapE);
                            h = adds8(h, GapOE);
                            f = adds8(max(f, h), -u);
                        } else {
                            const int e = adds8(sbyte(we, k), u);
                            const int q = adds8(sbyte(wq, k), u);
                            h = max3(max3(e, h, q), f, gg);
                            f = adds8(f, GapE);
                            h = adds8(h, GapOE);
                            f = adds8(max(f, h), -u);
                            gg = adds8(gg, GapP);
                            h = adds8(h, -GapOQ);
                            gg = adds8(max(gg, h), -u);
                        }
                        h = qscore(qw, S, k + 1);
                    }
                }
            };
            const int kn = W - g * G;
            if (kn >= G) group(std::true_type{}, G);
            else group(std::false_type{}, kn);
        }
        tick(2);
        // ---- active F-loops over lane heads (bsalign.h:2639-2652) ----
        int ubv[WS + 1];
#pragma unroll
        for (int k = 0; k < WS; ++k) ubv[k] = __shfl_sync(FULL, ub0_j, k, WS);
        ubv[WS] = ub0_16;
        if (PW < 2) {
            int fs[1] = {f};
            fpen<1>(fs, ubv, {W * GapE}, j);
            f = fs[0];
        } else {
            int fs[2] = {f, gg};
            fpen<2>(fs, ubv, {W * GapE, W * GapP}, j);
            f = fs[0];
            gg = fs[1];
        }
        tick(3);

        // ---- pass 2: new difference planes ----
        // codes: the lane's sum of the moved u, and the sums S(x) of the new
        // u over stripes 1..x with the maximum of S(x) - x * GapE
        int z = qp0, v = 0, u_l = 0, h_l = 0, us1_0 = 0;
        int usum_n = 0, srel = 0, relmax = 0;
        u64 DU = 0, DE = 0, DQ = 0;   // group 0 of the new planes
        for (int g = 0; g < NG; ++g) {
            const u64 wu = g == 0 ? NU : lds64(nlb + g * G);
            const u64 we = PW == 0 ? 0 : g == 0 ? NE : lds64(nlb + PL + g * G);
            const u64 wq = PW < 2 ? 0 : g == 0 ? NQ : lds64(nlb + 2 * PL + g * G);
            const QWin qw = g == 0 ? qw0 : qwin(qrow, qa + g * G);
            u64 ou = 0, oe = 0, oq = 0;
            auto group = [&](auto full, int kn) {
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    if (decltype(full)::value || k < kn) {
                        const int u = sbyte(wu, k);
                        int us1;
                        if (PW == 0) {
                            const int e = adds8(u, GapE);
                            h = max3(e, z, f);
                            us1 = adds8(h, -v);
                            v = adds8(h, -u);
                            f = adds8(adds8(h, GapE), -u);
                        } else if (PW == 1) {
                            int e = adds8(sbyte(we, k), u);
                            h = max3(e, z, f);
                            us1 = adds8(h, -v);
                            v = adds8(h, -u);
                            e = max(__viaddmin_s32(adds8(e, GapE), -h, 127),
                                    loE);
                            oe |= put_byte(e, k);
                            f = adds8(f, GapE);
                            h = adds8(h, GapOE);
                            f = adds8(max(f, h), -u);
                        } else {
                            int e = adds8(sbyte(we, k), u);
                            int q = adds8(sbyte(wq, k), u);
                            h = max3(max3(e, z, q), f, gg);
                            us1 = adds8(h, -v);
                            v = adds8(h, -u);
                            e = max(__viaddmin_s32(adds8(e, GapE), -h, 127),
                                    loE);
                            oe |= put_byte(e, k);
                            q = max(__viaddmin_s32(adds8(q, GapP), -h, 127),
                                    loQ);
                            oq |= put_byte(q, k);
                            f = adds8(f, GapE);
                            h = adds8(h, GapOE);
                            f = adds8(max(f, h), -u);
                            gg = adds8(gg, GapP);
                            h = adds8(h, -GapOQ);
                            gg = adds8(max(gg, h), -u);
                        }
                        ou |= put_byte(us1, k);
                        if (EMIT == EMIT_CODES) {
                            usum_n += u;
                            if (g > 0 || k > 0) {
                                srel += us1;
                                relmax = max(relmax, srel - (g * G + k) * GapE);
                            }
                        }
                        if (g == 0 && k == 0) us1_0 = us1;
                        u_l = u;
                        h_l = h;
                        z = qscore(qw, S, k + 1);
                    }
                }
            };
            const int kn = W - g * G;
            if (kn >= G) group(std::true_type{}, G);
            else group(std::false_type{}, kn);
            if (g == 0) {   // u's group 0 is stored once the tail fixes x = 0
                DU = ou; DE = oe; DQ = oq;
            } else {
                sts64(dlb + g * G, ou);
            }
            if (PW >= 1) sts64(dlb + PL + g * G, oe);
            if (PW == 2) sts64(dlb + 2 * PL + g * G, oq);
        }
        // ---- tail (bsalign.h:2618-2636) ----
        const int h_fin = PW == 0 ? h_l
                        : adds8(h_l, -(PW == 1 ? GapOE : GapQP));
        const int v2 = adds8(h_fin, -u_l);
        int v3 = __shfl_up_sync(FULL, v2, 1, WS);
        if (j == 0) v3 = 0;
        us1_0 = adds8(us1_0, -v3);
        const int ub1_j = j == 0 ? ub0_j + us1_0 : ub0_j + v3;
        const int ub1_16 = ub0_16 + __shfl_sync(FULL, v2, WS - 1, WS);
        const int du0 = j == 0 ? 0 : us1_0;
        DU = (DU & ~0xFFull) | put_byte(du0, 0);
        sts64(dlb, DU);
        tick(4);

        // ---- adaptive band + global steering (bsalign.h:3331, 4006) ----
        const int ub1_0 = __shfl_sync(FULL, ub1_j, 0, WS);
        int nxt = __shfl_down_sync(FULL, ub1_j, 1, WS);
        if (j == WS - 1) nxt = ub1_16;
        // each half-warp's sum, from two reductions over the warp
        const unsigned ad = (unsigned)abs(nxt - ub1_j);
        const unsigned ns0 = __reduce_add_sync(FULL, threadIdx.x & 16 ? 0u : ad);
        const unsigned ns1 = __reduce_add_sync(FULL, threadIdx.x & 16 ? ad : 0u);
        const unsigned nsum = threadIdx.x & 16 ? ns1 : ns0;
        const int nq = (int)nsum / WS;
        int noisy = max(WS, (nq >= 0 && nq < (1 << 20) ? div_w(nq, mw)
                                                      : nq / W) * WS / 2);
        int rbx = ub1_0 + noisy < ub1_16 ? 2 : (ub1_0 > ub1_16 + noisy ? 0 : 1);
        if (i <= BW / 4) rbx = 0;
        if (rbeg_n + BW >= qlen) rbx = 0;
        int mov_n;
        if (GLOBAL) {
            const int m1 = tlen - i - 1;
            const int D = qlen + rbz - 1 - rbeg_n - BW;
            const bool quick = D >= 0 && (long long)m1 * rbz <= D;
            int movq = 0;
            if (quick) {   // the last rows of a pair only
                const unsigned num = (unsigned)(qlen - (rbeg_n + BW));
                const unsigned den = (unsigned)max(1, m1);
                movq = (int)(1u + num / den);
            }
            mov_n = quick ? movq
                  : (rbeg_n < rby_i - BW ? rbx + 1
                  : (rbeg_n > rby_i ? max(0, rbx - 1) : rbx));
        } else {
            mov_n = rbx;
            // best end (bsalign.h:4023-4032)
            const int sc = getscore(DU, dlb, ub1_j, ub1_16, W, mw,
                                    max(qlen - 1 - rbeg_n, 0));
            if (live && rbeg_n + BW >= qlen) {
                if (sc > best_s) {
                    best_s = sc;
                    best_qe = qlen - 1;
                    best_te = i;
                }
            }
        }
        if (live) plan(i + 1, rbeg_n, mov_n);
        tick(5);

        if (EMIT == EMIT_PLANES && live) {
            // each thread reads back only the lane it wrote
            for (int g = 0; g < NG; ++g) {
                const u64 wu = g == 0 ? DU : lds64(dlb + g * G);
                const u64 we = PW == 0 ? 0 : g == 0 ? DE : lds64(dlb + PL + g * G);
                const u64 wq = PW < 2 ? 0 : g == 0 ? DQ : lds64(dlb + 2 * PL + g * G);
                const int kn = min(G, W - g * G);
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    if (k < kn) {
                        const size_t o =
                            ((size_t)r * BW + (g * G + k) * WS + j) * B + b;
                        p.us_o[o] = (int8_t)sbyte(wu, k);
                        if (PW >= 1) p.es_o[o] = (int8_t)sbyte(we, k);
                        if (PW == 2) p.qs_o[o] = (int8_t)sbyte(wq, k);
                    }
                }
            }
            p.ubegs[((size_t)r * (WS + 1) + j) * B + b] = ub1_j;
            if (j == 0) p.ubegs[((size_t)r * (WS + 1) + WS) * B + b] = ub1_16;
        }
        if (EMIT == EMIT_CODES) {
            // ---- traceback codes (banded8_pallas.calc_codes) ----
            // lane ends of the previous-row H and of the F-open base, and
            // the lane's maximum of that base, from pass 2's sums
            const int lane0 = j * W;
            const int ha0 = ub1_j + du0;
            const int hp_end = ub0_j + usum_n;
            const int rowmax = ha0 + relmax + (GapOE - GapE) - lane0 * GapE;
            const int base_last = ha0 + srel + (GapOE - GapE)
                                - (lane0 + W - 1) * GapE;
            // exclusive prefix max of the lane maxima over lower lanes
            int incl = rowmax;
#pragma unroll
            for (int o = 1; o < WS; o <<= 1) {
                const int t = __shfl_up_sync(FULL, incl, o, WS);
                if (j >= o) incl = max(incl, t);
            }
            int ex = __shfl_up_sync(FULL, incl, 1, WS);
            const int hp_up = __shfl_up_sync(FULL, hp_end, 1, WS);
            const int base_up = __shfl_up_sync(FULL, base_last, 1, WS);
            int diag0 = mov_eff > 0 ? rh_move : (rbeg_n > 0 ? ub0_0 : inner);
            if (mov_eff > BW) diag0 = NEGK;
            if (j == 0) ex = NEGK;
            // one nibble per cell, one word per group
            int prevh = j == 0 ? diag0 : hp_up;   // H(i-1, p-1)
            int prev_racc = ex;                   // running max at p-1
            int prev_base = j == 0 ? NEGK + 1 : base_up;
            int pm = NEGK;
            int hp = ub0_j, ha = ub1_j;
            const int pend = BW - mov_eff;
            for (int g = 0; g < NG; ++g) {
                const u64 wu = g == 0 ? NU : lds64(nlb + g * G);
                const u64 we = PW == 0 ? 0 : g == 0 ? NE : lds64(nlb + PL + g * G);
                const u64 wd = g == 0 ? DU : lds64(dlb + g * G);
                const u64 wde = PW == 0 ? 0 : g == 0 ? DE : lds64(dlb + PL + g * G);
                const QWin qw = g == 0 ? qw0 : qwin(qrow, qa + g * G);
                const int kn = min(G, W - g * G);
                // cells k <= kok lie inside the band's new part, cells
                // k < kq over the query: nibble masks of those cells
                const int g0 = lane0 + g * G;
                const int kok = pend - g0, kq = qlen - rbeg_n - g0;
                const unsigned okm = nibbles_below(kok + 1);
                const unsigned qm = nibbles_below(kq);
                const int cb = (GapOE - GapE) - g0 * GapE;
                unsigned md = 0, eofo = 0;
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    if (k < kn) {
                        const int u0 = sbyte(wu, k);
                        hp += u0;
                        ha += sbyte(wd, k);
                        const int delta = ha - prevh;
                        const int usum = k == kok ? GapOE
                            : (PW ? u0 + sbyte(we, k) : u0 + GapOE);
                        md |= ((unsigned)(delta == qscore(qw, S, k))
                               | ((unsigned)(delta == usum) << 1)) << (4 * k);
                        const bool eo = PW ? sbyte(wde, k) == GapOE : true;
                        eofo |= ((unsigned)eo << (4 * k + 2))
                              | ((unsigned)(prev_racc == prev_base)
                                 << (4 * k + 3));
                        const int bs = ha + cb - k * GapE;
                        pm = max(pm, bs);
                        prevh = hp;
                        prev_racc = max(pm, ex);
                        prev_base = bs;
                    }
                }
                const unsigned word = ((md & okm) | eofo) & qm;
                if (live)
                    p.codes[(((size_t)r * NG + g) * WS + j) * B + b] = (int)word;
            }
        }
        if (EMIT != EMIT_NONE && live && j == 0)
            p.begs[(size_t)r * B + b] = rbeg_n;

        if (live) {
            cur = db == sp ? 0 : 1;
            OU = DU; OE = DE; OQ = DQ;
            rbeg = rbeg_n;
            mov = mov_n;
            ub_j = ub1_j;
            ub16 = ub1_16;
        }
        __syncwarp(mask);
        tick(6);
    }

    if (!real) return;
    const int8_t *const fb = sp + cur * BUF + j * WP;
    for (int x = 0; x < W; ++x) {
        const size_t k = ((size_t)x * WS + j) * B + b;
        p.fin_us[k] = fb[x];
        if (PW >= 1) p.fin_es[k] = fb[PL + x];
        if (PW == 2) p.fin_qs[k] = fb[2 * PL + x];
    }
    p.fin_ub[(size_t)j * B + b] = ub_j;
    if (j == 0) {
        p.fin_ub[(size_t)WS * B + b] = ub16;
        const int reg[8] = {rbeg, mov, 0, best_s, best_qe, best_te, 0, 0};
        for (int k = 0; k < 8; ++k) p.fin_reg[(size_t)k * B + b] = reg[k];
        if (split)
            for (int k = 0; k < NPHASE; ++k)
                p.cycles[(size_t)k * B + b] = acc[k];
    }
}

template <int PW, int MT, int EMIT, bool GS>
cudaError_t launch(const Params &p, cudaStream_t stream) {
    // ppb pairs of two buffers of PW + 1 planes, each of 16 lanes padded to
    // an odd number of 8-byte words; none with the planes in device memory
    const int NG = (p.W + G - 1) / G;
    const size_t smem =
        GS ? 0 : (size_t)p.ppb * 2 * (PW + 1) * WS * G * (NG | 1);
    auto kern = banded8_rows_kernel<PW, MT, EMIT, GS>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    if (p.ppb % 2) return cudaErrorInvalidValue;   // whole warps of two pairs
    const int grid = (p.B + p.ppb - 1) / p.ppb;
    kern<<<grid, WS * p.ppb, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int PW, int MT, int EMIT>
cudaError_t launch_store(const Params &p, cudaStream_t s) {
    if (p.gs) return launch<PW, MT, EMIT, true>(p, s);
    return launch<PW, MT, EMIT, false>(p, s);
}

template <int PW, int MT>
cudaError_t launch_emit(const Params &p, int emit, cudaStream_t s) {
    if (emit == EMIT_PLANES) return launch_store<PW, MT, EMIT_PLANES>(p, s);
    if (emit == EMIT_NONE) return launch_store<PW, MT, EMIT_NONE>(p, s);
    if constexpr (PW < 2) {
        if (emit == EMIT_CODES) return launch_store<PW, MT, EMIT_CODES>(p, s);
    }
    return cudaErrorInvalidValue;
}

template <int PW>
cudaError_t launch_mode(const Params &p, int mt, int emit, cudaStream_t s) {
    if (mt == 0) return launch_emit<PW, 0>(p, emit, s);
    if (mt == 1) return launch_emit<PW, 1>(p, emit, s);
    return launch_emit<PW, 2>(p, emit, s);
}

}  // namespace

// mode_type: 0 global, 1 overlap, 2 extend; emit: 0 codes (piecewise 0/1),
// 1 planes, 2 none. qb is the uint8 [B, QPU] query (QPU a multiple of 4
// that reaches 12 bytes past the last band window). Outputs a call does not
// write may be null; cycles, when not null, receives the int64 [7, B] cycle
// split of each pair. gs, when not null, is the planes' scratch in device
// memory (2 x (piecewise + 1) x 16 x 8 x (ceil(W / 8) | 1) bytes for each
// of the launch's pair slots, B rounded up to pairs_per_block), and the
// launch takes no shared memory. Returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown combination).
extern "C" int bsa_banded8_rows(
    const void *qb, const void *tseq, const void *qlen, const void *tlen,
    const void *rbz, const void *rby, const void *mtx5, const void *init_us,
    const void *init_es, const void *init_qs, const void *init_ub,
    const void *init_reg, void *codes, void *us_o, void *es_o, void *qs_o,
    void *ubegs, void *begs, void *fin_us, void *fin_es, void *fin_qs,
    void *fin_ub, void *fin_reg, void *cycles, void *gs, int B, int QPU,
    int T, int row0, int W,
    int mode_type, int piecewise, int emit, int gapo1, int gape1, int gapo2,
    int gape2, int d_oh, int c_oh, int pairs_per_block, void *stream) {
    Params p;
    p.qb = (const uint8_t *)qb; p.tseq = (const int *)tseq;
    p.qlen = (const int *)qlen; p.tlen = (const int *)tlen;
    p.rbz = (const int *)rbz; p.rby = (const int *)rby;
    p.mtx5 = (const int *)mtx5;
    p.init_us = (const int *)init_us; p.init_es = (const int *)init_es;
    p.init_qs = (const int *)init_qs; p.init_ub = (const int *)init_ub;
    p.init_reg = (const int *)init_reg;
    p.codes = (int *)codes;
    p.us_o = (int8_t *)us_o; p.es_o = (int8_t *)es_o; p.qs_o = (int8_t *)qs_o;
    p.ubegs = (int *)ubegs; p.begs = (int *)begs;
    p.fin_us = (int *)fin_us; p.fin_es = (int *)fin_es;
    p.fin_qs = (int *)fin_qs; p.fin_ub = (int *)fin_ub;
    p.fin_reg = (int *)fin_reg;
    p.cycles = (long long *)cycles;
    p.replays = nullptr;
    p.gs = (int8_t *)gs;
    p.B = B; p.QPU = QPU; p.T = T; p.row0 = row0; p.W = W;
    p.gapo1 = gapo1; p.gape1 = gape1; p.gapo2 = gapo2; p.gape2 = gape2;
    p.d_oh = d_oh; p.c_oh = c_oh; p.ppb = pairs_per_block;
    p.K = p.R = 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (piecewise == 0) return (int)launch_mode<0>(p, mode_type, emit, s);
    if (piecewise == 1) return (int)launch_mode<1>(p, mode_type, emit, s);
    if (piecewise == 2) return (int)launch_mode<2>(p, mode_type, emit, s);
    return (int)cudaErrorInvalidValue;
}
