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
//
// What bounds it on this card: not bytes. Each pair is a serial chain of
// T rows, and each row is a serial chain of W stripes (two passes plus the
// code pass), so a pair's latency is T * W dependent steps, and the card is
// filled only by running many pairs at once. A 2 kb pair at band 128 reads
// and writes a few hundred bytes of state per row from shared memory and
// emits 64 bytes of codes, or 456 bytes of planes and anchors, per row:
// far below the memory roofline.
//
// What the design does about it: one half-warp (16 threads) per pair, thread
// j owning striped lane j of every stripe, exactly the 16 int8 lanes of the
// reference's SSE vectors. The W-step stripe loops run in parallel across
// the 16 lanes; cross-lane steps (the stripe carry at x == 0, the F-loop
// ripples over lane heads, the running maxima of the code pass, the band
// steering sums) are half-warp shuffles. Band state lives in shared memory
// as int8 planes (u, plus e for piecewise >= 1 and q for piecewise 2),
// double-buffered so the band move is one pass that writes the shifted
// planes: 2 * (piecewise + 1) * band bytes per pair. Each pair has its own
// control flow, so the exact per-row schedule is the whole kernel: no
// batch-wide fast/slow tier, no deferred replay and no query-window slack
// counter. Two pairs share a warp and a block by default, so a launch of 256
// pairs spreads over 128 SMs.
//
// Layouts (batch-minor as in the JAX package; int32 unless stated):
//   qpad [B, QP], tseq [B, T], qlen/tlen/rbz [B], rby [T, B], mtx5 [5, 4],
//   init_us/init_es/init_qs [W, 16, B], init_ub [17, B], init_reg [8, B];
//   codes [T, CPW, 16, B]; us_o/es_o/qs_o int8 [T, W*16, B] (index x*16 + j),
//   ubegs [T, 17, B]; begs [T, B]; fin_us/fin_es/fin_qs [W, 16, B],
//   fin_ub [17, B], fin_reg [8, B] = rbeg, mov, 0, best score, best qe,
//   best te, 0, 0. tseq and rby hold this call's T rows: local row r is
//   global row row0 + r, and every test of the recurrence uses the global
//   row. init_reg slot 2 (the TPU's window-slack counter) is not read.
// Rows at and past a pair's tlen write codes, planes and anchors 0 and
// begs = the frozen rbeg.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WS = 16;
constexpr int MIN8 = -63;
constexpr int MAX8 = 63;
constexpr int SCORE_MIN = -(0x7FFFFFFF >> 2);
constexpr int NEGK = -(1 << 30);
constexpr int EMIT_CODES = 0, EMIT_PLANES = 1, EMIT_NONE = 2;

struct Params {
    const int *qpad, *tseq, *qlen, *tlen, *rbz, *rby, *mtx5;
    const int *init_us, *init_es, *init_qs, *init_ub, *init_reg;
    int *codes;
    int8_t *us_o, *es_o, *qs_o;
    int *ubegs, *begs, *fin_us, *fin_es, *fin_qs, *fin_ub, *fin_reg;
    int B, QP, T, row0, W, gapo1, gape1, gapo2, gape2, d_oh, c_oh, ppb;
};

__device__ __forceinline__ int sat8(int v) { return min(max(v, -128), 127); }
__device__ __forceinline__ int adds8(int a, int b) { return sat8(a + b); }
__device__ __forceinline__ int subs8(int a, int b) { return sat8(a - b); }
__device__ __forceinline__ int wrap8(int v) { return ((v + 128) & 0xFF) - 128; }

// H at natural band position pos of the plane u with anchors (ub_j, ub16):
// lane y's prefix sum over stripes 0..x plus its anchor. Past the band the
// stripe sum is 0 and the anchor ub[16] (pos // W == 16) or 0.
__device__ __forceinline__ int getscore(unsigned mask, const int8_t *u,
                                        int ub_j, int ub16, int j, int W,
                                        int pos) {
    const int x = pos % W, y = pos / W;
    if (y == WS) return ub16;
    if (y > WS) return 0;
    int s = ub_j;
    for (int k = 0; k <= x; ++k) s += u[k * WS + j];
    return __shfl_sync(mask, s, y, WS);
}

// Active F-loop over lane heads (bsalign.h:2639-2652) for one gap state:
// f holds lane j's pass-1 value at the end of its block; returns the value
// entering lane j, with the int8 wrap on stores. t = W * gap extension.
__device__ __forceinline__ int fpen(unsigned mask, int f, const int *ubv,
                                    int t, int j) {
    int fj = MIN8;
    int s = t + MIN8 - (ubv[1] - ubv[0]);
#pragma unroll
    for (int jj = 1; jj < WS; ++jj) {
        const int fi = __shfl_sync(mask, f, jj - 1, WS);
        const int fi2 = fi < s ? wrap8(s) : fi;
        if (j == jj) fj = fi2;
        s = t + fi2 - (ubv[jj + 1] - ubv[jj]);
    }
    return fj;
}

// PW: piecewise 0/1/2; MT: mode type 0 global, 1 overlap, 2 extend;
// EMIT: EMIT_CODES (PW < 2), EMIT_PLANES or EMIT_NONE.
template <int PW, int MT, int EMIT>
__global__ void banded8_rows_kernel(Params p) {
    static_assert(EMIT != EMIT_CODES || PW < 2, "codes cover piecewise 0/1");
    constexpr bool GLOBAL = MT == 0, OVERLAP = MT == 1;
    constexpr int NPL = PW + 1;   // planes per buffer: u, e, q
    extern __shared__ int8_t smem[];
    const int half = threadIdx.x / WS;
    const int j = threadIdx.x % WS;
    const int b = blockIdx.x * p.ppb + half;
    if (b >= p.B) return;  // uniform over the half-warp
    const unsigned mask = 0xFFFFu << (threadIdx.x & 16);
    const int W = p.W, BW = W * WS, B = p.B, T = p.T, QP = p.QP;
    const int CPW = (W + 7) / 8;
    const int GapE = p.gape1, GapOE = p.gapo1 + p.gape1;
    const int GapP = p.gape2, GapQP = p.gapo2 + p.gape2;
    const int GapOQ = sat8(GapOE - GapQP);
    const int qlen = p.qlen[b], tlen = p.tlen[b];

    int8_t *base = smem + (size_t)half * 2 * NPL * BW;
    int8_t *PU[2] = {base, base + NPL * BW};
    int8_t *PE[2] = {PU[0] + BW, PU[1] + BW};
    int8_t *PQ[2] = {PU[0] + 2 * BW, PU[1] + 2 * BW};
    for (int x = 0; x < W; ++x) {
        const size_t k = ((size_t)x * WS + j) * B + b;
        PU[0][x * WS + j] = (int8_t)p.init_us[k];
        if (PW >= 1) PE[0][x * WS + j] = (int8_t)p.init_es[k];
        if (PW == 2) PQ[0][x * WS + j] = (int8_t)p.init_qs[k];
    }
    int ub_j = p.init_ub[(size_t)j * B + b];
    int ub16 = p.init_ub[(size_t)WS * B + b];
    int rbeg = p.init_reg[b], mov = p.init_reg[(size_t)B + b];
    int best_s = p.init_reg[(size_t)3 * B + b];
    int best_qe = p.init_reg[(size_t)4 * B + b];
    int best_te = p.init_reg[(size_t)5 * B + b];
    int cur = 0;
    const int *qrow = p.qpad + (size_t)b * QP;
    __syncwarp(mask);

    for (int r = 0; r < T; ++r) {
        const int i = p.row0 + r;   // global row
        if (i >= tlen) {   // frozen pair: zero row outputs, band stays
            if (EMIT == EMIT_CODES) {
                for (int k = 0; k < CPW; ++k)
                    p.codes[(((size_t)r * CPW + k) * WS + j) * B + b] = 0;
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
            continue;
        }
        const bool cond_move = mov > 0 && rbeg + BW < qlen;
        const int mov_eff = cond_move ? min(mov, max(0, qlen - (rbeg + BW))) : 0;
        const int rbeg_n = rbeg + mov_eff;
        const int8_t *ou = PU[cur];
        const int8_t *oe = PE[cur];
        const int8_t *oq = PQ[cur];
        const int rh_move = cond_move
            ? getscore(mask, ou, ub_j, ub16, j, W, mov_eff - 1) : 0;
        int inner = 0;
        if (!OVERLAP && i != 0) {
            inner = p.gapo1 + p.gape1 * i;
            if (PW == 2) inner = max(inner, p.gapo2 + p.gape2 * i);
        }
        const int rh = cond_move ? rh_move : (rbeg > 0 ? SCORE_MIN : inner);

        // ---- band move (bsalign.h:2244-2392) into the other buffer ----
        int8_t *nu, *ne, *nq;
        int ub0_j, ub0_16, dst;
        if (mov_eff == 0) {
            nu = PU[cur]; ne = PE[cur]; nq = PQ[cur];
            ub0_j = ub_j; ub0_16 = ub16;
            dst = 1 - cur;
        } else {
            nu = PU[1 - cur]; ne = PE[1 - cur]; nq = PQ[1 - cur];
            dst = cur;
            if (mov_eff >= BW) {   // full reset (bsalign.h:2253-2259)
                for (int x = 0; x < W; ++x) {
                    nu[x * WS + j] = 0;
                    if (PW >= 1) ne[x * WS + j] = 0;
                    if (PW == 2) nq[x * WS + j] = 0;
                }
                ub0_j = SCORE_MIN; ub0_16 = SCORE_MIN;
            } else {
                const int cyc = mov_eff / W, mv = mov_eff % W, dv = W - mv;
                int s = ub_j;
                for (int x = 0; x < mv; ++x) s += ou[x * WS + j];
                const int g = __shfl_sync(mask, s, min(j + cyc, WS - 1), WS);
                ub0_j = j < WS - cyc ? g : ub16;
                ub0_16 = ub16;
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
                for (int x = 0; x < W; ++x) {
                    const int sl = x < dv ? j + cyc : j + cyc + 1;
                    const int sx = x < dv ? x + mv : x - dv;
                    int vu = sl < WS ? ou[sx * WS + sl] : 0;
                    const int pn = j * W + x;
                    if (pn >= p0)
                        vu = pn == p0 ? p.c_oh
                                      : (pn < p0 + p.d_oh ? p.gape1 : p.gape2);
                    nu[x * WS + j] = (int8_t)vu;
                    if (PW >= 1) ne[x * WS + j] = sl < WS ? oe[sx * WS + sl] : 0;
                    if (PW == 2) nq[x * WS + j] = sl < WS ? oq[sx * WS + sl] : 0;
                }
            }
            __syncwarp(mask);
        }
        int8_t *du = PU[dst];
        int8_t *de = PE[dst];
        int8_t *dq = PQ[dst];

        // ---- query scores: codes of 4 and above score MIN8 ----
        const int tb = p.tseq[(size_t)b * T + r];
        const int s0 = p.mtx5[0 * 4 + tb], s1 = p.mtx5[1 * 4 + tb];
        const int s2 = p.mtx5[2 * 4 + tb], s3 = p.mtx5[3 * 4 + tb];
        auto qsc = [&](int pos) {
            const int c = pos < QP ? qrow[pos] : 4;
            return c == 0 ? s0 : c == 1 ? s1 : c == 2 ? s2 : c == 3 ? s3 : MIN8;
        };
        const int qoff = rbeg_n + j * W;   // query position of (x=0, lane j)

        // ---- row head ----
        const int ub0_0 = __shfl_sync(mask, ub0_j, 0, WS);
        const int t0 = PW == 0 ? nu[0] + GapE
                     : PW == 1 ? nu[0] + ne[0] : nu[0] + max(ne[0], nq[0]);
        int h0 = (rh - ub0_0) + qsc(rbeg_n);
        h0 = h0 >= t0 ? min(h0, MAX8) : MIN8;
        h0 = wrap8(h0);
        const int qp0 = j == 0 ? h0 : qsc(qoff);

        // ---- pass 1: f (and g) entering each lane block ----
        int h = qp0, f = MIN8, gg = MIN8;
        for (int x = 0; x < W; ++x) {
            const int u = nu[x * WS + j];
            if (PW == 0) {
                const int e = adds8(u, GapE);
                h = max(max(e, h), f);
                f = subs8(adds8(h, GapE), u);
            } else if (PW == 1) {
                const int e = adds8(ne[x * WS + j], u);
                h = max(max(e, h), f);
                f = adds8(f, GapE);
                h = adds8(h, GapOE);
                f = subs8(max(f, h), u);
            } else {
                const int e = adds8(ne[x * WS + j], u);
                const int q = adds8(nq[x * WS + j], u);
                h = max(max(max(e, h), q), f);
                h = max(gg, h);
                f = adds8(f, GapE);
                h = adds8(h, GapOE);
                f = subs8(max(f, h), u);
                gg = adds8(gg, GapP);
                h = subs8(h, GapOQ);
                gg = subs8(max(gg, h), u);
            }
            h = qsc(qoff + x + 1);
        }
        // ---- active F-loops over lane heads (bsalign.h:2639-2652) ----
        int ubv[WS + 1];
#pragma unroll
        for (int k = 0; k < WS; ++k) ubv[k] = __shfl_sync(mask, ub0_j, k, WS);
        ubv[WS] = ub0_16;
        f = fpen(mask, f, ubv, W * GapE, j);
        if (PW == 2) gg = fpen(mask, gg, ubv, W * GapP, j);

        // ---- pass 2: new difference planes ----
        int z = qp0, v = 0, u_l = 0, h_l = 0, us1_0 = 0;
        for (int x = 0; x < W; ++x) {
            const int u = nu[x * WS + j];
            int us1;
            if (PW == 0) {
                const int e = adds8(u, GapE);
                h = max(max(e, z), f);
                us1 = subs8(h, v);
                v = subs8(h, u);
                f = subs8(adds8(h, GapE), u);
            } else if (PW == 1) {
                int e = adds8(ne[x * WS + j], u);
                h = max(max(e, z), f);
                us1 = subs8(h, v);
                v = subs8(h, u);
                e = max(subs8(adds8(e, GapE), h), GapOE);
                de[x * WS + j] = (int8_t)e;
                f = adds8(f, GapE);
                h = adds8(h, GapOE);
                f = subs8(max(f, h), u);
            } else {
                int e = adds8(ne[x * WS + j], u);
                h = max(e, z);
                int q = adds8(nq[x * WS + j], u);
                h = max(max(max(q, h), f), gg);
                us1 = subs8(h, v);
                v = subs8(h, u);
                e = max(subs8(adds8(e, GapE), h), GapOE);
                de[x * WS + j] = (int8_t)e;
                q = max(subs8(adds8(q, GapP), h), GapQP);
                dq[x * WS + j] = (int8_t)q;
                f = adds8(f, GapE);
                h = adds8(h, GapOE);
                f = subs8(max(f, h), u);
                gg = adds8(gg, GapP);
                h = subs8(h, GapOQ);
                gg = subs8(max(gg, h), u);
            }
            if (x == 0) us1_0 = us1;
            du[x * WS + j] = (int8_t)us1;
            u_l = u;
            h_l = h;
            z = qsc(qoff + x + 1);
        }
        // ---- tail (bsalign.h:2618-2636) ----
        const int h_fin = PW == 0 ? h_l
                        : subs8(h_l, PW == 1 ? GapOE : GapQP);
        const int v2 = subs8(h_fin, u_l);
        int v3 = __shfl_up_sync(mask, v2, 1, WS);
        if (j == 0) v3 = 0;
        us1_0 = subs8(us1_0, v3);
        const int ub1_j = j == 0 ? ub0_j + us1_0 : ub0_j + v3;
        const int ub1_16 = ub0_16 + __shfl_sync(mask, v2, WS - 1, WS);
        du[j] = (int8_t)(j == 0 ? 0 : us1_0);

        // ---- adaptive band + global steering (bsalign.h:3331, 4006) ----
        const int ub1_0 = __shfl_sync(mask, ub1_j, 0, WS);
        int nxt = __shfl_down_sync(mask, ub1_j, 1, WS);
        if (j == WS - 1) nxt = ub1_16;
        unsigned nsum = (unsigned)abs(nxt - ub1_j);
#pragma unroll
        for (int o = 8; o >= 1; o >>= 1)
            nsum += __shfl_xor_sync(mask, nsum, o, WS);
        int noisy = max(WS, (int)nsum / WS / W * WS / 2);
        int rbx = ub1_0 + noisy < ub1_16 ? 2 : (ub1_0 > ub1_16 + noisy ? 0 : 1);
        if (i <= BW / 4) rbx = 0;
        if (rbeg_n + BW >= qlen) rbx = 0;
        int mov_n;
        if (GLOBAL) {
            const int rbz = p.rbz[b];
            const int m1 = tlen - i - 1;
            const int D = qlen + rbz - 1 - rbeg_n - BW;
            const bool quick = D >= 0 && m1 <= D / rbz;
            const unsigned num = (unsigned)(qlen - (rbeg_n + BW));
            const unsigned den = (unsigned)max(1, m1);
            const int movq = (int)(1u + num / den);
            const int rby_i = p.rby[(size_t)r * B + b];
            mov_n = quick ? movq
                  : (rbeg_n < rby_i - BW ? rbx + 1
                  : (rbeg_n > rby_i ? max(0, rbx - 1) : rbx));
        } else {
            mov_n = rbx;
            // best end (bsalign.h:4023-4032)
            if (rbeg_n + BW >= qlen) {
                const int sc = getscore(mask, du, ub1_j, ub1_16, j, W,
                                        max(qlen - 1 - rbeg_n, 0));
                if (sc > best_s) {
                    best_s = sc;
                    best_qe = qlen - 1;
                    best_te = i;
                }
            }
        }

        if (EMIT == EMIT_PLANES) {
            // each thread reads back only the lane it wrote
            for (int x = 0; x < W; ++x) {
                const size_t k = ((size_t)r * BW + x * WS + j) * B + b;
                p.us_o[k] = du[x * WS + j];
                if (PW >= 1) p.es_o[k] = de[x * WS + j];
                if (PW == 2) p.qs_o[k] = dq[x * WS + j];
            }
            p.ubegs[((size_t)r * (WS + 1) + j) * B + b] = ub1_j;
            if (j == 0) p.ubegs[((size_t)r * (WS + 1) + WS) * B + b] = ub1_16;
        }
        if (EMIT == EMIT_CODES) {
            // ---- traceback codes (banded8_pallas.calc_codes) ----
            // pass A: lane ends of the previous-row H and of the F-open base
            int hp = ub0_j, ha = ub1_j, rowmax = NEGK, base_last = 0;
            for (int x = 0; x < W; ++x) {
                hp += nu[x * WS + j];
                ha += du[x * WS + j];
                const int bs = ha + (GapOE - GapE) - (j * W + x) * GapE;
                rowmax = max(rowmax, bs);
                base_last = bs;
            }
            // exclusive prefix max of the lane maxima over lower lanes
            int incl = rowmax;
#pragma unroll
            for (int o = 1; o < WS; o <<= 1) {
                const int t = __shfl_up_sync(mask, incl, o, WS);
                if (j >= o) incl = max(incl, t);
            }
            int ex = __shfl_up_sync(mask, incl, 1, WS);
            const int hp_up = __shfl_up_sync(mask, hp, 1, WS);
            const int base_up = __shfl_up_sync(mask, base_last, 1, WS);
            int diag0 = mov_eff > 0 ? rh_move : (rbeg_n > 0 ? ub0_0 : inner);
            if (mov_eff > BW) diag0 = NEGK;
            if (j == 0) ex = NEGK;
            // pass B: one nibble per cell
            int prevh = j == 0 ? diag0 : hp_up;   // H(i-1, p-1)
            int prev_racc = ex;                   // running max at p-1
            int prev_base = j == 0 ? NEGK + 1 : base_up;
            int pm = NEGK;
            hp = ub0_j;
            ha = ub1_j;
            unsigned word = 0;
            for (int x = 0; x < W; ++x) {
                const int u0 = nu[x * WS + j];
                hp += u0;
                ha += du[x * WS + j];
                const int pn = j * W + x;
                const bool ok = pn <= BW - mov_eff;
                const int delta = ha - prevh;
                const bool m = ok && delta == qsc(rbeg_n + pn);
                int usum = PW ? u0 + ne[x * WS + j] : u0 + GapOE;
                if (pn == BW - mov_eff) usum = GapOE;
                const bool d = ok && delta == usum;
                const int eo = PW ? (de[x * WS + j] == GapOE) : 1;
                const bool fo = prev_racc == prev_base;
                const int bs = ha + (GapOE - GapE) - pn * GapE;
                pm = max(pm, bs);
                unsigned code = (unsigned)m | ((unsigned)d << 1)
                              | ((unsigned)eo << 2) | ((unsigned)fo << 3);
                if (rbeg_n + pn >= qlen) code = 0;
                word |= code << (4 * (x & 7));
                if ((x & 7) == 7 || x == W - 1) {
                    p.codes[(((size_t)r * CPW + (x >> 3)) * WS + j) * B + b] =
                        (int)word;
                    word = 0;
                }
                prevh = hp;
                prev_racc = max(pm, ex);
                prev_base = bs;
            }
        }
        if (EMIT != EMIT_NONE && j == 0) p.begs[(size_t)r * B + b] = rbeg_n;

        cur = dst;
        rbeg = rbeg_n;
        mov = mov_n;
        ub_j = ub1_j;
        ub16 = ub1_16;
        __syncwarp(mask);
    }

    for (int x = 0; x < W; ++x) {
        const size_t k = ((size_t)x * WS + j) * B + b;
        p.fin_us[k] = PU[cur][x * WS + j];
        if (PW >= 1) p.fin_es[k] = PE[cur][x * WS + j];
        if (PW == 2) p.fin_qs[k] = PQ[cur][x * WS + j];
    }
    p.fin_ub[(size_t)j * B + b] = ub_j;
    if (j == 0) {
        p.fin_ub[(size_t)WS * B + b] = ub16;
        const int reg[8] = {rbeg, mov, 0, best_s, best_qe, best_te, 0, 0};
        for (int k = 0; k < 8; ++k) p.fin_reg[(size_t)k * B + b] = reg[k];
    }
}

template <int PW, int MT, int EMIT>
cudaError_t launch(const Params &p, cudaStream_t stream) {
    const size_t smem = (size_t)p.ppb * 2 * (PW + 1) * p.W * WS;
    auto kern = banded8_rows_kernel<PW, MT, EMIT>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const int grid = (p.B + p.ppb - 1) / p.ppb;
    kern<<<grid, WS * p.ppb, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int PW, int MT>
cudaError_t launch_emit(const Params &p, int emit, cudaStream_t s) {
    if (emit == EMIT_PLANES) return launch<PW, MT, EMIT_PLANES>(p, s);
    if (emit == EMIT_NONE) return launch<PW, MT, EMIT_NONE>(p, s);
    if constexpr (PW < 2) {
        if (emit == EMIT_CODES) return launch<PW, MT, EMIT_CODES>(p, s);
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
// 1 planes, 2 none. Outputs a call does not write may be null. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown combination).
extern "C" int bsa_banded8_rows(
    const void *qpad, const void *tseq, const void *qlen, const void *tlen,
    const void *rbz, const void *rby, const void *mtx5, const void *init_us,
    const void *init_es, const void *init_qs, const void *init_ub,
    const void *init_reg, void *codes, void *us_o, void *es_o, void *qs_o,
    void *ubegs, void *begs, void *fin_us, void *fin_es, void *fin_qs,
    void *fin_ub, void *fin_reg, int B, int QP, int T, int row0, int W,
    int mode_type, int piecewise, int emit, int gapo1, int gape1, int gapo2,
    int gape2, int d_oh, int c_oh, int pairs_per_block, void *stream) {
    Params p;
    p.qpad = (const int *)qpad; p.tseq = (const int *)tseq;
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
    p.B = B; p.QP = QP; p.T = T; p.row0 = row0; p.W = W;
    p.gapo1 = gapo1; p.gape1 = gape1; p.gapo2 = gapo2; p.gape2 = gape2;
    p.d_oh = d_oh; p.c_oh = c_oh; p.ppb = pairs_per_block;
    cudaStream_t s = (cudaStream_t)stream;
    if (piecewise == 0) return (int)launch_mode<0>(p, mode_type, emit, s);
    if (piecewise == 1) return (int)launch_mode<1>(p, mode_type, emit, s);
    if (piecewise == 2) return (int)launch_mode<2>(p, mode_type, emit, s);
    return (int)cudaErrorInvalidValue;
}
