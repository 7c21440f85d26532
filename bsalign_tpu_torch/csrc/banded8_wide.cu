// Kernel A's wide row, for Hopper (sm_90a): the function of
// banded8_rows_kernel (banded8.cu) in every emit, piecewise 0/1/2,
// global/overlap/extend and resumed from init_* at row0, with the same
// Params and the same input and output layouts, for wide bands. With
// banded8.cu it replaces the TPU kernel
// bsalign_tpu/ops/banded8_pallas.py::_get_call.kernel; its row is the
// parallel form of that kernel's row_scan (:545-634) and exact replay
// (:946-992). ops/_cuda.py launches it for W >= WIDE_W stripes.
//
// What bounds it on this card: the row's latency. The narrow design runs a
// pair's row as 16 serial chains of W stripes, one thread a lane, so a row
// costs W stripes of latency and a launch of a few pairs leaves the card
// idle. Here a pair has a block of 16 x K threads; lane j's K threads each
// own a run of R stripes (a multiple of 8 and an odd number of 8-byte
// words, so that a lane's threads read shared memory without bank
// conflicts), and the row's chains are cut at the runs:
//   - each run composes its stripes' f (and g) steps into one max-plus
//     affine map, f -> max(f + a, b) at piecewise 0/1 and at piecewise 2 a
//     2x2 max-plus matrix with a constant on (f, g) (g's step reads f
//     through h), without the clamp at 127, so the maps compose exactly;
//   - a scan of the maps along the lane (shuffles, log K steps) proposes
//     each run's entering f (and g): from MIN8 in pass 1, from the lane's
//     head after the F-loop in pass 2;
//   - each run then runs the serial saturating step, the narrow row's
//     integer functions in its order, from its proposal, and a boundary
//     check (run k's exit equals run k + 1's proposal) proves the row by
//     induction over the runs. A proposal can be wrong only where the
//     dropped clamp bites; a row whose check fails anywhere
//     (__syncthreads_or) is replayed here: one thread a lane runs the
//     lane's serial chain for the exact entries, from which the runs
//     compute again, before any output of the row is written. `replays`
//     (null on the main paths) counts those rows;
//   - pass 2's v reads only the stripe before: a run's first us1 takes the
//     run before's last v by one shuffle once the runs are done;
//   - the band move copies nothing: the planes lie in natural band order
//     (cell (x, j) at byte j * W + x) in two buffers, a row reads the old
//     one at offset mov (cells past the old band take the mimic-insertion
//     costs) and writes its new planes into the other;
//   - getscore's and the anchors' lane sums and the codes emit's lane sums
//     and running maxima are scans over runs (shuffles within a lane, one
//     value a lane through shared memory); the F-loop over the 16 lane
//     heads and the steering run in every thread from shared memory.
// A row takes five block barriers (one more, and a second pass 2, on a
// replay). The planes live in shared memory while two buffers of
// piecewise + 1 planes of the band rounded up to 8 bytes plus 8 fit beside
// the row's scalars in 227 KB, and past that in a scratch of device memory
// (GS), one slot a pair, read and written through the same code.

#include <type_traits>

#include "banded8_common.cuh"

namespace {

constexpr int NEGM = -(1 << 29);   // the maps' minus infinity
constexpr int WIDE_THREADS = 512;  // 16 lanes of at most 32 threads
// ints of the block's shared scalars (see the kernel); ops/_cuda.py's
// WIDE_SCALAR_BYTES is 4 x this
constexpr int NSCALAR = 1208;

struct Costs {   // the row step's gap costs, bsalign.h's names
    int E, OE, P, QP, OQ, loE, loQ;
};

// m: the part of a cell's h that reads neither f nor g
template <int PW>
__device__ __forceinline__ int cell_m(int u, int e_in, int q_in, int z,
                                      const Costs &c) {
    if (PW == 0) return max(adds8(u, c.E), z);
    if (PW == 1) return max(adds8(e_in, u), z);
    return max3(adds8(e_in, u), z, adds8(q_in, u));
}

// One stripe of the serial f (and g) chain: the narrow row's pass-1 step
template <int PW>
__device__ __forceinline__ void fstep(int u, int m, int &f, int &g,
                                      const Costs &c) {
    if (PW == 0) {
        f = adds8(adds8(max(m, f), c.E), -u);
    } else if (PW == 1) {
        int h = max(m, f);
        f = adds8(f, c.E);
        h = adds8(h, c.OE);
        f = adds8(max(f, h), -u);
    } else {
        int h = max3(m, f, g);
        f = adds8(f, c.E);
        h = adds8(h, c.OE);
        f = adds8(max(f, h), -u);
        g = adds8(g, c.P);
        h = adds8(h, -c.OQ);
        g = adds8(max(g, h), -u);
    }
}

// The chain's steps without the clamp at 127, as max-plus affine maps.
// a.then(b) applies a, then b.
template <bool TWO>
struct FMap;

template <>
struct FMap<false> {   // f -> max(f + a, b)
    int a, b;
    __device__ static FMap id() { return {0, NEGM}; }
    template <int PW>
    __device__ static FMap cell(int u, int m, const Costs &c) {
        const int X = PW == 0 ? c.E : c.OE;
        const int aX = PW == 0 ? c.E : max(c.E, c.OE);
        return {aX - u, max(max(m + X, -128) - u, -128)};
    }
    __device__ FMap then(const FMap &n) const {
        return {a + n.a, max(max(b + n.a, n.b), NEGM)};
    }
    __device__ void apply(int &f, int &) const { f = max(f + a, b); }
    __device__ FMap up(int d, int K) const {
        return {__shfl_up_sync(FULL, a, d, K), __shfl_up_sync(FULL, b, d, K)};
    }
};

template <>
struct FMap<true> {   // (f, g) -> A (f, g) + B in max-plus
    int a00, a01, a10, a11, b0, b1;
    __device__ static FMap id() { return {0, NEGM, NEGM, 0, NEGM, NEGM}; }
    template <int PW>
    __device__ static FMap cell(int u, int m, const Costs &c) {
        const int cm = max(m + c.OE, -128);
        return {max(c.E, c.OE) - u, c.OE - u, c.OE - c.OQ - u,
                max(c.P, c.OE - c.OQ) - u, max(cm - u, -128),
                max(max(cm - c.OQ, -128) - u, -128)};
    }
    __device__ FMap then(const FMap &n) const {
        return {max(max(n.a00 + a00, n.a01 + a10), NEGM),
                max(max(n.a00 + a01, n.a01 + a11), NEGM),
                max(max(n.a10 + a00, n.a11 + a10), NEGM),
                max(max(n.a10 + a01, n.a11 + a11), NEGM),
                max(max3(n.a00 + b0, n.a01 + b1, n.b0), NEGM),
                max(max3(n.a10 + b0, n.a11 + b1, n.b1), NEGM)};
    }
    __device__ void apply(int &f, int &g) const {
        const int nf = max3(f + a00, g + a01, b0);
        g = max3(f + a10, g + a11, b1);
        f = nf;
    }
    __device__ FMap up(int d, int K) const {
        return {__shfl_up_sync(FULL, a00, d, K), __shfl_up_sync(FULL, a01, d, K),
                __shfl_up_sync(FULL, a10, d, K), __shfl_up_sync(FULL, a11, d, K),
                __shfl_up_sync(FULL, b0, d, K), __shfl_up_sync(FULL, b1, d, K)};
    }
};

// 8 bytes of a plane at natural position p (two aligned words, a funnel
// shift); the plane holds one word past its band
__device__ __forceinline__ u64 ld_nat(const int8_t *pl, int p) {
    const u64 *w = reinterpret_cast<const u64 *>(pl) + (p >> 3);
    const u64 lo = w[0], hi = w[1];
    const unsigned s = (unsigned)(p & 7) * 8;
    const bool up = s >= 32;
    const unsigned x0 = up ? (unsigned)(lo >> 32) : (unsigned)lo;
    const unsigned x1 = up ? (unsigned)hi : (unsigned)(lo >> 32);
    const unsigned x2 = up ? (unsigned)(hi >> 32) : (unsigned)hi;
    return (u64)__funnelshift_r(x0, x1, s)
         | ((u64)__funnelshift_r(x1, x2, s) << 32);
}

// bytes 0..n-1 of w into a plane at natural position p: one word store
// where aligned and whole, else byte stores (W not a multiple of 8)
__device__ __forceinline__ void st_nat(int8_t *pl, int p, u64 w, int n) {
    if (n == G && (p & 7) == 0) {
        *reinterpret_cast<u64 *>(pl + p) = w;
        return;
    }
    for (int t = 0; t < n; ++t) pl[p + t] = (int8_t)(w >> (8 * t));
}

struct Move {   // new cell p reads old cell p + mov; p >= p0 lies past it
    int mov, p0;
    bool reset;   // mov >= the band: every plane reads 0
};

// The moved planes' 8 cells at natural position p of the new band
// (bsalign.h:2244-2392): the old planes at p + mov; past the old band u
// takes the mimic-insertion costs (c_oh at p0, gape1 below p0 + d_oh,
// gape2 from there) and e and q read 0.
template <int NPL>
__device__ __forceinline__ void ld_moved(const int8_t *ob, int PB, int BW,
                                         int p, const Move &mv,
                                         const Params &P, u64 &wu, u64 &we,
                                         u64 &wq) {
    wu = we = wq = 0;
    if (mv.reset) return;
    const int q = p + mv.mov;
    if (q < BW) {
        wu = ld_nat(ob, q);
        if (NPL >= 2) we = ld_nat(ob + PB, q);
        if (NPL == 3) wq = ld_nat(ob + 2 * PB, q);
    }
    if (p + G > mv.p0) {
        const int k0 = mv.p0 - p;
        const u64 one = 0x0101010101010101ull;
        const u64 m1 = bytes_from(k0);
        const u64 m2 = bytes_from(k0 + min(P.d_oh, BW));
        u64 fill = (one * (uint8_t)P.gape1 & m1 & ~m2)
                 | (one * (uint8_t)P.gape2 & m2);
        if (k0 >= 0) fill = (fill & ~(0xFFull << (8 * k0)))
                          | put_byte(P.c_oh, k0);
        wu = (wu & ~m1) | fill;
        we &= ~m1;
        wq &= ~m1;
    }
}

// What pass 2 leaves in a thread for its run
struct Run2 {
    int f, g, v, h_first, us1f, h_l, u_l;
    int su, sn, mr, be;   // codes' and best end's sums (see pass2)
    u64 fu;               // the run's first word of u, stored in finish
};

// PW: piecewise 0/1/2; MT: 0 global, 1 overlap, 2 extend; EMIT as the
// narrow kernel; GS: the planes in device memory (p.gs).
template <int PW, int MT, int EMIT, bool GS>
__global__ void __launch_bounds__(WIDE_THREADS)
banded8_wide_kernel(const Params p) {
    static_assert(EMIT != EMIT_CODES || PW < 2, "codes cover piecewise 0/1");
    constexpr bool GLOBAL = MT == 0, OVERLAP = MT == 1, TWO = PW == 2;
    constexpr int NPL = PW + 1;
    using Map = FMap<TWO>;
    extern __shared__ __align__(16) int8_t smem[];
    const int K = p.K, R = p.R;
    const int tid = threadIdx.x, j = tid / K, k = tid - j * K;
    const int b = blockIdx.x;
    const int W = p.W, BW = W * WS, B = p.B, T = p.T;
    const int x0 = k * R, n = max(0, min(R, W - x0));   // the run
    const int kl = (W - 1) / R;   // the lane's last thread with stripes
    const int NG = (W + G - 1) / G;
    const int PB = ((BW + G - 1) & ~(G - 1)) + G;   // a plane, with a word
    const int BUF = NPL * PB;
    const int lane0 = j * W;
    Costs c;
    c.E = p.gape1;
    c.OE = p.gapo1 + p.gape1;
    c.P = p.gape2;
    c.QP = p.gapo2 + p.gape2;
    c.OQ = min(max(c.OE - c.QP, -128), 127);
    c.loE = max(c.OE, -128);
    c.loQ = max(c.QP, -128);
    const int qlen = p.qlen[b], tlen = p.tlen[b];
    const int *__restrict__ tseq = p.tseq + (size_t)b * T;
    const uint8_t *__restrict__ qrow = p.qb + (size_t)b * p.QPU;
    const int rbz = GLOBAL ? p.rbz[b] : 1;
    unsigned S4[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        unsigned s = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            s |= (unsigned)(uint8_t)p.mtx5[q * 4 + t] << (8 * q);
        S4[t] = s;
    }

    // two buffers of NPL planes, natural order; then the shared scalars
    int8_t *const sp = GS ? p.gs + (size_t)b * 2 * BUF : smem;
    int *const sx = reinterpret_cast<int *>(smem + (GS ? 0 : 2 * BUF));
    int *const s_ub = sx;           // [2][17] anchors: current, new
    int *const s_ub0 = sx + 34;     // [2][17] moved anchors, by row parity
    int *const s_rh = sx + 68;      // [2] lane y's sum for the row head
    int *const s_fend = sx + 70;    // [16][2] pass 1's lane ends
    int *const s_v2 = sx + 102;     // [16] the lanes' v2 (the tail)
    int *const s_sc = sx + 118;     // [1] the best end's score
    int *const s_tot = sx + 120;    // [16][4] codes: lane sums, max, ha0
    int *const s_ent = sx + 184;    // [16][32][2] replayed entries

    for (int x = x0; x < x0 + n; ++x) {
        const size_t q = ((size_t)x * WS + j) * B + b;
        sp[lane0 + x] = (int8_t)p.init_us[q];
        if (PW >= 1) sp[PB + lane0 + x] = (int8_t)p.init_es[q];
        if (PW == 2) sp[2 * PB + lane0 + x] = (int8_t)p.init_qs[q];
    }
    if (tid <= WS) s_ub[tid] = p.init_ub[(size_t)tid * B + b];
    int rbeg = p.init_reg[b], mov = p.init_reg[(size_t)B + b];
    int best_s = p.init_reg[(size_t)3 * B + b];
    int best_qe = p.init_reg[(size_t)4 * B + b];
    int best_te = p.init_reg[(size_t)5 * B + b];
    int cur = 0, ubc = 0, nrep = 0;
    bool cm_nx = false;
    int me_nx = 0;
    auto plan = [&](int i_n, int rb, int mv_) {
        cm_nx = i_n < tlen && mv_ > 0 && rb + BW < qlen;
        me_nx = cm_nx ? min(mv_, max(0, qlen - (rb + BW))) : 0;
    };
    plan(p.row0, rbeg, mov);
    // the next row's target base and diagonal target, loaded a row ahead
    int tb_nx = T > 0 ? __ldg(tseq) : 0;
    int rby_nx = GLOBAL && T > 0 ? __ldg(p.rby + b) : 0;
    // cycle split, counted by thread 0; every main path passes null
    const bool split = p.cycles != nullptr;
    long long acc[NPHASE] = {0, 0, 0, 0, 0, 0, 0}, tk = 0;
    auto tick = [&](int ph) {
        if (split && tid == 0) {
            const long long t = clock64();
            acc[ph] += t - tk;
            tk = t;
        }
    };
    __syncthreads();

    for (int r = 0; r < T; ++r) {
        const int i = p.row0 + r;   // global row
        const int tb = tb_nx, rby_i = rby_nx;
        if (r + 1 < T) {
            tb_nx = __ldg(tseq + r + 1);
            if (GLOBAL) rby_nx = __ldg(p.rby + (size_t)(r + 1) * B + b);
        }
        if (i >= tlen) {   // frozen pair: zero row outputs, band stays
            if (EMIT == EMIT_CODES) {
                for (int g = x0 / G; g * G < x0 + n; ++g)
                    p.codes[(((size_t)r * NG + g) * WS + j) * B + b] = 0;
            } else if (EMIT == EMIT_PLANES) {
                for (int x = x0; x < x0 + n; ++x) {
                    const size_t o = ((size_t)r * BW + x * WS + j) * B + b;
                    p.us_o[o] = 0;
                    if (PW >= 1) p.es_o[o] = 0;
                    if (PW == 2) p.qs_o[o] = 0;
                }
                if (k == 0) p.ubegs[((size_t)r * (WS + 1) + j) * B + b] = 0;
                if (tid == 0)
                    p.ubegs[((size_t)r * (WS + 1) + WS) * B + b] = 0;
            }
            if (EMIT != EMIT_NONE && tid == 0) p.begs[(size_t)r * B + b] = rbeg;
            continue;
        }
        if (split && tid == 0) tk = clock64();
        const int par = r & 1;
        const bool cond_move = cm_nx;
        const int mov_eff = me_nx;
        const int rbeg_n = rbeg + mov_eff;
        const unsigned S = tb == 1 ? S4[1] : tb == 2 ? S4[2]
                         : tb == 3 ? S4[3] : S4[0];
        const int8_t *const ob = sp + cur * BUF;   // the current band
        int8_t *const nb = sp + (1 - cur) * BUF;   // the new planes
        const int *const ub = s_ub + ubc * (WS + 1);
        int *const ub1s = s_ub + (ubc ^ 1) * (WS + 1);
        int inner = 0;
        if (!OVERLAP && i != 0) {
            inner = p.gapo1 + p.gape1 * i;
            if (PW == 2) inner = max(inner, p.gapo2 + p.gape2 * i);
        }
        Move mv;
        mv.mov = mov_eff;
        mv.p0 = BW - mov_eff;
        mv.reset = mov_eff >= BW;

        // ---- band move (bsalign.h:2244-2392): the moved anchors, and the
        // row head's getscore at mov - 1 on the old planes ----
        const int *ub0s = ub;
        const int pos = mov_eff - 1;
        const int y = mov_eff > 0 ? min(pos, (WS + 1) * W) / W : 0;
        if (mov_eff > 0) {
            const int cyc = min(mov_eff, BW) / W;
            const int m_in = mv.reset ? 0 : mov_eff - cyc * W;
            const int xr = min(pos - y * W, W - 1);
            // lane j's old u over stripes x < m_in (what the lane hands to
            // lane j - cyc's anchor), and lane y's over x <= xr
            const int lim = min(x0 + n, max(m_in, j == y ? xr + 1 : 0));
            int sa = 0, sb = 0;
            for (int x = x0; x < lim; x += G) {
                const u64 w = ld_nat(ob, lane0 + x);
                const int kn = min(G, x0 + n - x);
                const int ka = min(m_in - x, kn) - 1;
                const int kb = min(xr + 1 - x, kn) - 1;
                if (ka >= 0) sa += bytesum(w, ka);
                if (j == y && kb >= 0) sb += bytesum(w, kb);
            }
            for (int o = K / 2; o > 0; o >>= 1) {
                sa += __shfl_xor_sync(FULL, sa, o, K);
                sb += __shfl_xor_sync(FULL, sb, o, K);
            }
            int *const u0w = s_ub0 + par * (WS + 1);
            if (k == 0) {
                if (mv.reset) {   // full reset (bsalign.h:2253-2259)
                    u0w[j] = SCORE_MIN;
                    if (j == 0) u0w[WS] = SCORE_MIN;
                } else {
                    // running overhang cost at the end of lane block jb
                    auto adj = [&](int jb) {
                        const int rel = (jb + 1) * W - 1 - mv.p0;
                        if (rel < 0) return 0;
                        const int n1 = min(rel, p.d_oh - 1);
                        const int n2 = max(rel - p.d_oh + 1, 0);
                        return p.c_oh + p.gape1 * n1 + p.gape2 * n2;
                    };
                    if (j >= cyc)
                        u0w[j - cyc] = ub[j] + sa
                                     + (j - cyc >= 1 ? adj(j - cyc - 1) : 0);
                    if (j >= WS - cyc) u0w[j] = ub[WS] + adj(j - 1);
                    if (j == 0) u0w[WS] = ub[WS] + adj(WS - 1);
                }
                if (j == y) s_rh[par] = ub[y] + sb;
            }
            ub0s = u0w;
        }
        __syncthreads();
        const int rh_s = mov_eff <= 0 ? 0 : y < WS ? s_rh[par]
                       : (y == WS ? ub[WS] : 0);
        const int ub0_j = ub0s[j], ub0_0 = ub0s[0];
        const int rh_move = cond_move ? rh_s : 0;
        const int rh = cond_move ? rh_move : (rbeg > 0 ? SCORE_MIN : inner);
        tick(0);

        // ---- row head: lane 0's first cell (thread 0) ----
        int h0 = 0;
        if (tid == 0) {
            u64 wu, we, wq;
            ld_moved<NPL>(ob, PB, BW, 0, mv, p, wu, we, wq);
            const int n0 = sbyte(wu, 0);
            const int t0 = PW == 0 ? n0 + c.E
                         : PW == 1 ? n0 + sbyte(we, 0)
                         : n0 + max(sbyte(we, 0), sbyte(wq, 0));
            h0 = (rh - ub0_0) + qscore(qwin(qrow, rbeg_n), S, 0);
            h0 = h0 >= t0 ? min(h0, MAX8) : MIN8;
            h0 = wrap8(h0);
        }
        tick(1);

        // fn(x, t, u, e_in, q_in, z) on the stripes x = [xa, xa + cnt) of
        // the thread's lane, 8 at a time (t in the group) from the moved
        // planes and the query window (lane 0's first cell takes the row
        // head); done(x, kn) after each group of kn stripes from x
        auto sweep = [&](int xa, int cnt, auto &&fn, auto &&done) {
            for (int x = xa; x < xa + cnt; x += G) {
                u64 wu, we, wq;
                ld_moved<NPL>(ob, PB, BW, lane0 + x, mv, p, wu, we, wq);
                const QWin qw = qwin(qrow, rbeg_n + lane0 + x);
                const bool head = tid == 0 && x == 0;
                const int kn = min(G, xa + cnt - x);
                auto body = [&](auto full) {
#pragma unroll
                    for (int t = 0; t < G; ++t) {
                        if (decltype(full)::value || t < kn)
                            fn(x + t, t, sbyte(wu, t), sbyte(we, t),
                               sbyte(wq, t),
                               t == 0 && head ? h0 : qscore(qw, S, t));
                    }
                };
                if (kn >= G) body(std::true_type{});
                else body(std::false_type{});
                done(x, kn);
            }
        };
        auto nop = [](int, int) {};
        // the serial f (and g) chain over stripes [xa, xa + cnt)
        auto chain = [&](int xa, int cnt, int &f, int &g) {
            sweep(xa, cnt, [&](int, int, int u, int e_in, int q_in, int z) {
                fstep<PW>(u, cell_m<PW>(u, e_in, q_in, z, c), f, g, c);
            }, nop);
        };

        // ---- pass 1: the run's map, the lane's scan, the exact runs ----
        Map M = Map::id();
        sweep(x0, n, [&](int, int, int u, int e_in, int q_in, int z) {
            M = M.then(Map::template cell<PW>(
                u, cell_m<PW>(u, e_in, q_in, z, c), c));
        }, nop);
        for (int d = 1; d < K; d <<= 1) {   // inclusive scan along the lane
            const Map o = M.up(d, K);
            if (k >= d) M = o.then(M);
        }
        Map E = M.up(1, K);   // exclusive: the runs before this one
        if (k == 0) E = Map::id();
        bool replayed = false;
        {
            int pf = MIN8, pg = MIN8;
            E.apply(pf, pg);   // the proposal
            int f = pf, g = pg;
            chain(x0, n, f, g);
            const int nf = __shfl_down_sync(FULL, pf, 1, K);
            const int ng = __shfl_down_sync(FULL, pg, 1, K);
            const bool bad = k < kl && (f != nf || (TWO && g != ng));
            if (k == kl) {
                s_fend[2 * j] = f;
                s_fend[2 * j + 1] = g;
            }
            if (__syncthreads_or(bad)) {   // replay: the lanes' serial ends
                replayed = true;
                if (k == 0) {
                    int rf = MIN8, rg = MIN8;
                    chain(0, W, rf, rg);
                    s_fend[2 * j] = rf;
                    s_fend[2 * j + 1] = rg;
                }
                __syncthreads();
            }
        }
        tick(2);

        // ---- active F-loops over lane heads (bsalign.h:2639-2652), each
        // thread up to its own lane ----
        int fh = MIN8, gh = MIN8;
        {
            const int tE = W * c.E, tP = W * c.P;
            const int d0 = ub0s[1] - ub0s[0];
            int sf = tE + MIN8 - d0, sg = tP + MIN8 - d0;
            for (int jj = 1; jj <= j; ++jj) {
                const int d = ub0s[jj + 1] - ub0s[jj];
                const int fi = s_fend[2 * (jj - 1)];
                fh = fi < sf ? wrap8(sf) : fi;
                sf = fh + (tE - d);
                if (TWO) {
                    const int gi = s_fend[2 * (jj - 1) + 1];
                    gh = gi < sg ? wrap8(sg) : gi;
                    sg = gh + (tP - d);
                }
            }
        }
        tick(3);

        // ---- pass 2: new difference planes, each run from its entry ----
        // codes: su the run's sum of the moved u; sn the sum of its us1
        // past its first cell and mr the maximum of sn(x) - x * GapE over
        // its cells (the first counts 0 - x0 * GapE, with x0 = 0 in a
        // lane's first run, whose first us1 the code sums leave out);
        // best end: be the sum of its us1 past its first cell up to
        // stripe xb of lane yb
        const bool reach = !GLOBAL && rbeg_n + BW >= qlen;
        const int pos_b = max(qlen - 1 - rbeg_n, 0);
        const int yb = min(pos_b, (WS + 1) * W) / W;
        const int xb = min(pos_b - yb * W, W - 1);
        auto pass2 = [&](int f, int g) {
            Run2 q;
            q.h_first = q.h_l = q.u_l = 0;
            q.su = q.sn = q.be = 0;
            q.mr = k == 0 ? 0 : -x0 * c.E;
            q.fu = 0;
            int v = 0;   // the run before's v is taken in finish2
            u64 ou = 0, oe = 0, oq = 0;
            sweep(x0, n, [&](int x, int t, int u, int e_in, int q_in,
                             int z) {
                int h, us1;
                if (PW == 0) {
                    const int e = adds8(u, c.E);
                    h = max3(e, z, f);
                    if (x == x0) q.h_first = h;
                    us1 = adds8(h, -v);
                    v = adds8(h, -u);
                    f = adds8(adds8(h, c.E), -u);
                } else if (PW == 1) {
                    int e = adds8(e_in, u);
                    h = max3(e, z, f);
                    if (x == x0) q.h_first = h;
                    us1 = adds8(h, -v);
                    v = adds8(h, -u);
                    e = max(__viaddmin_s32(adds8(e, c.E), -h, 127), c.loE);
                    oe |= put_byte(e, t);
                    f = adds8(f, c.E);
                    h = adds8(h, c.OE);
                    f = adds8(max(f, h), -u);
                } else {
                    int e = adds8(e_in, u);
                    int qq = adds8(q_in, u);
                    h = max3(max3(e, z, qq), f, g);
                    if (x == x0) q.h_first = h;
                    us1 = adds8(h, -v);
                    v = adds8(h, -u);
                    e = max(__viaddmin_s32(adds8(e, c.E), -h, 127), c.loE);
                    oe |= put_byte(e, t);
                    qq = max(__viaddmin_s32(adds8(qq, c.P), -h, 127), c.loQ);
                    oq |= put_byte(qq, t);
                    f = adds8(f, c.E);
                    h = adds8(h, c.OE);
                    f = adds8(max(f, h), -u);
                    g = adds8(g, c.P);
                    h = adds8(h, -c.OQ);
                    g = adds8(max(g, h), -u);
                }
                ou |= put_byte(us1, t);
                if (x != x0) {
                    if (EMIT == EMIT_CODES) {
                        q.sn += us1;
                        q.mr = max(q.mr, q.sn - x * c.E);
                    }
                    if (x <= xb) q.be += us1;
                }
                if (EMIT == EMIT_CODES) q.su += u;
                q.u_l = u;
                q.h_l = h;
            }, [&](int x, int kn) {
                if (x == x0) q.fu = ou;
                else st_nat(nb, lane0 + x, ou, kn);
                if (PW >= 1) st_nat(nb + PB, lane0 + x, oe, kn);
                if (PW == 2) st_nat(nb + 2 * PB, lane0 + x, oq, kn);
                ou = oe = oq = 0;
            });
            q.f = f;
            q.g = g;
            q.v = v;
            return q;
        };
        // the run's first us1 from the run before's last v, its first word
        // stored; the lane's last run gives the tail its v2
        auto finish2 = [&](Run2 &q) {
            int vin = __shfl_up_sync(FULL, q.v, 1, K);
            if (k == 0) vin = 0;
            q.us1f = adds8(q.h_first, -vin);
            if (n > 0) {
                q.fu = (q.fu & ~0xFFull) | put_byte(q.us1f, 0);
                st_nat(nb, lane0 + x0, q.fu, min(G, n));
            }
            if (k == kl) {
                const int h_fin = PW == 0 ? q.h_l
                                : adds8(q.h_l, -(PW == 1 ? c.OE : c.QP));
                s_v2[j] = adds8(h_fin, -q.u_l);
            }
        };
        int qf = fh, qg = gh;
        E.apply(qf, qg);   // the proposal
        Run2 r2 = pass2(qf, qg);
        {
            const int nf = __shfl_down_sync(FULL, qf, 1, K);
            const int ng = __shfl_down_sync(FULL, qg, 1, K);
            const bool bad = k < kl && (r2.f != nf || (TWO && r2.g != ng));
            finish2(r2);
            if (__syncthreads_or(bad)) {   // replay: exact entries, again
                replayed = true;
                if (k == 0) {
                    int rf = fh, rg = gh;
                    for (int kk = 0; kk <= kl; ++kk) {
                        s_ent[(j * 32 + kk) * 2] = rf;
                        s_ent[(j * 32 + kk) * 2 + 1] = rg;
                        chain(kk * R, min(R, W - kk * R), rf, rg);
                    }
                }
                __syncthreads();
                const int kk = min(k, kl);
                r2 = pass2(s_ent[(j * 32 + kk) * 2],
                           s_ent[(j * 32 + kk) * 2 + 1]);
                finish2(r2);
                __syncthreads();
            }
        }
        // codes: exclusive scans over the lane's runs of (su) and (sn, mr)
        int su_ex = 0, sn_ex = 0, m_ex = NEGK;
        if (EMIT == EMIT_CODES) {
            int ru = n > 0 ? r2.su : 0;
            int rn = n == 0 ? 0 : k == 0 ? r2.sn : r2.us1f + r2.sn;
            int rm = n == 0 ? NEGK : k == 0 ? r2.mr : r2.us1f + r2.mr;
            for (int d = 1; d < K; d <<= 1) {
                const int ou = __shfl_up_sync(FULL, ru, d, K);
                const int on = __shfl_up_sync(FULL, rn, d, K);
                const int om = __shfl_up_sync(FULL, rm, d, K);
                if (k >= d) {
                    rm = max(om, on + rm);
                    rn += on;
                    ru += ou;
                }
            }
            su_ex = __shfl_up_sync(FULL, ru, 1, K);
            sn_ex = __shfl_up_sync(FULL, rn, 1, K);
            m_ex = __shfl_up_sync(FULL, rm, 1, K);
            if (k == kl) {
                s_tot[4 * j] = ru;
                s_tot[4 * j + 1] = rn;
                s_tot[4 * j + 2] = rm;
            }
        }
        // best end: lane yb's sum over stripes 0..xb
        int be = reach && j == yb && n > 0
               ? (x0 <= xb ? r2.us1f : 0) + r2.be : 0;
        if (reach)
            for (int o = K / 2; o > 0; o >>= 1)
                be += __shfl_xor_sync(FULL, be, o, K);

        // ---- tail (bsalign.h:2618-2636), thread 0 of each lane ----
        if (k == 0) {
            const int v3 = j == 0 ? 0 : s_v2[j - 1];
            const int us1_0 = adds8(r2.us1f, -v3);
            const int ub1_j = j == 0 ? ub0_j + us1_0 : ub0_j + v3;
            const int du0 = j == 0 ? 0 : us1_0;
            nb[lane0] = (int8_t)du0;
            ub1s[j] = ub1_j;
            if (EMIT == EMIT_CODES) s_tot[4 * j + 3] = ub1_j + du0;
            if (j == 0) ub1s[WS] = ub0s[WS] + s_v2[WS - 1];
            if (reach && j == yb) s_sc[0] = ub1_j + be + (du0 - r2.us1f);
            if (reach && yb == WS && j == 0)
                s_sc[0] = ub0s[WS] + s_v2[WS - 1];
        }
        __syncthreads();
        tick(4);

        // ---- adaptive band + global steering (bsalign.h:3331, 4006) ----
        const int ub1_j = ub1s[j], ub1_0 = ub1s[0], ub1_16 = ub1s[WS];
        unsigned nsum = 0;
#pragma unroll
        for (int l = 0; l < WS; ++l)
            nsum += (unsigned)abs(ub1s[l + 1] - ub1s[l]);
        const int nq = (int)nsum / WS;
        const int noisy = max(WS, (nq / W) * WS / 2);
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
            if (reach) {   // best end (bsalign.h:4023-4032)
                const int sc = yb <= WS ? s_sc[0] : 0;
                if (sc > best_s) {
                    best_s = sc;
                    best_qe = qlen - 1;
                    best_te = i;
                }
            }
        }
        plan(i + 1, rbeg_n, mov_n);
        tick(5);

        if (EMIT == EMIT_PLANES) {
            // the block's threads in turn along the output's cell order
            // x * 16 + j, so that neighbours store neighbouring bytes
            for (int o = tid; o < BW; o += blockDim.x) {
                const int q = (o & (WS - 1)) * W + (o >> 4);
                const size_t oi = ((size_t)r * BW + o) * B + b;
                p.us_o[oi] = nb[q];
                if (PW >= 1) p.es_o[oi] = nb[PB + q];
                if (PW == 2) p.qs_o[oi] = nb[2 * PB + q];
            }
            if (k == 0) p.ubegs[((size_t)r * (WS + 1) + j) * B + b] = ub1_j;
            if (tid == 0)
                p.ubegs[((size_t)r * (WS + 1) + WS) * B + b] = ub1_16;
        }
        if (EMIT == EMIT_CODES) {
            // ---- traceback codes (banded8_pallas.calc_codes), each run
            // entered with its lane's sums and maxima so far ----
            const int C = c.OE - c.E;
            int ex = NEGK;   // running max of the F-open base, lower lanes
            for (int l = 0; l < j; ++l)
                ex = max(ex, s_tot[4 * l + 3] + s_tot[4 * l + 2] + C
                                 - l * W * c.E);
            int diag0 = mov_eff > 0 ? rh_move : (rbeg_n > 0 ? ub0_0 : inner);
            if (mov_eff > BW) diag0 = NEGK;
            const int ha0 = s_tot[4 * j + 3];
            int hp, prevh, ha, pm, prev_racc, prev_base;
            if (k == 0) {
                hp = ub0_j;
                ha = ub1_j;
                pm = NEGK;
                prev_racc = ex;
                prevh = j == 0 ? diag0 : ub0s[j - 1] + s_tot[4 * (j - 1)];
                prev_base = j == 0 ? NEGK + 1
                          : s_tot[4 * (j - 1) + 3] + s_tot[4 * (j - 1) + 1]
                            + C - (lane0 - 1) * c.E;
            } else {
                hp = ub0_j + su_ex;
                prevh = hp;
                ha = ha0 + sn_ex;
                pm = ha0 + m_ex + C - lane0 * c.E;
                prev_racc = max(pm, ex);
                prev_base = ha0 + sn_ex + C - (lane0 + x0 - 1) * c.E;
            }
            const int pend = BW - mov_eff;
            for (int x = x0; x < x0 + n; x += G) {
                u64 wu, we, wq;
                ld_moved<NPL>(ob, PB, BW, lane0 + x, mv, p, wu, we, wq);
                const u64 wd = ld_nat(nb, lane0 + x);
                const u64 wde = PW ? ld_nat(nb + PB, lane0 + x) : 0;
                const QWin qw = qwin(qrow, rbeg_n + lane0 + x);
                const int kn = min(G, x0 + n - x);
                // cells t <= kok lie inside the band's new part, cells
                // t < kq over the query
                const int g0 = lane0 + x;
                const int kok = pend - g0, kq = qlen - rbeg_n - g0;
                const unsigned okm = nibbles_below(kok + 1);
                const unsigned qm = nibbles_below(kq);
                const int cb = C - g0 * c.E;
                unsigned md = 0, eofo = 0;
#pragma unroll
                for (int t = 0; t < G; ++t) {
                    if (t < kn) {
                        const int u0 = sbyte(wu, t);
                        hp += u0;
                        ha += sbyte(wd, t);
                        const int delta = ha - prevh;
                        const int usum = t == kok ? c.OE
                            : (PW ? u0 + sbyte(we, t) : u0 + c.OE);
                        md |= ((unsigned)(delta == qscore(qw, S, t))
                               | ((unsigned)(delta == usum) << 1)) << (4 * t);
                        const bool eo = PW ? sbyte(wde, t) == c.OE : true;
                        eofo |= ((unsigned)eo << (4 * t + 2))
                              | ((unsigned)(prev_racc == prev_base)
                                 << (4 * t + 3));
                        const int bs = ha + cb - t * c.E;
                        pm = max(pm, bs);
                        prevh = hp;
                        prev_racc = max(pm, ex);
                        prev_base = bs;
                    }
                }
                p.codes[(((size_t)r * NG + x / G) * WS + j) * B + b] =
                    (int)(((md & okm) | eofo) & qm);
            }
        }
        if (EMIT != EMIT_NONE && tid == 0) p.begs[(size_t)r * B + b] = rbeg_n;

        nrep += replayed;
        cur ^= 1;
        ubc ^= 1;
        rbeg = rbeg_n;
        mov = mov_n;
        tick(6);
    }

    const int8_t *const fb = sp + cur * BUF;
    for (int x = x0; x < x0 + n; ++x) {
        const size_t q = ((size_t)x * WS + j) * B + b;
        p.fin_us[q] = fb[lane0 + x];
        if (PW >= 1) p.fin_es[q] = fb[PB + lane0 + x];
        if (PW == 2) p.fin_qs[q] = fb[2 * PB + lane0 + x];
    }
    if (tid <= WS) p.fin_ub[(size_t)tid * B + b] = s_ub[ubc * (WS + 1) + tid];
    if (tid == 0) {
        const int reg[8] = {rbeg, mov, 0, best_s, best_qe, best_te, 0, 0};
        for (int q = 0; q < 8; ++q) p.fin_reg[(size_t)q * B + b] = reg[q];
        if (split)
            for (int q = 0; q < NPHASE; ++q)
                p.cycles[(size_t)q * B + b] = acc[q];
        if (p.replays) p.replays[b] = nrep;
    }
}

template <int PW, int MT, int EMIT, bool GS>
cudaError_t launch(const Params &p, cudaStream_t stream) {
    const int PB = ((p.W * WS + G - 1) & ~(G - 1)) + G;
    const size_t smem = (GS ? 0 : (size_t)2 * (PW + 1) * PB)
                      + NSCALAR * sizeof(int);
    auto kern = banded8_wide_kernel<PW, MT, EMIT, GS>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kern<<<p.B, WS * p.K, smem, stream>>>(p);
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

// bsa_banded8_rows's arguments and outputs (banded8.cu), one pair a block:
// K threads a lane (2, 4, 8, 16 or 32) and runs of R stripes (a multiple of
// 8, with (W - 1) / R < K); gs, when not null, holds 2 x (piecewise + 1) x
// (16 W rounded up to 8, plus 8) bytes a pair; replays, when not null,
// receives the int32 [B] count of each pair's replayed rows.
extern "C" int bsa_banded8_wide_rows(
    const void *qb, const void *tseq, const void *qlen, const void *tlen,
    const void *rbz, const void *rby, const void *mtx5, const void *init_us,
    const void *init_es, const void *init_qs, const void *init_ub,
    const void *init_reg, void *codes, void *us_o, void *es_o, void *qs_o,
    void *ubegs, void *begs, void *fin_us, void *fin_es, void *fin_qs,
    void *fin_ub, void *fin_reg, void *cycles, void *replays, void *gs,
    int B, int QPU, int T, int row0, int W, int mode_type, int piecewise,
    int emit, int gapo1, int gape1, int gapo2, int gape2, int d_oh, int c_oh,
    int K, int R, void *stream) {
    if (B < 1 || K < 2 || K > 32 || (K & (K - 1)) || R < G || R % G
        || (W - 1) / R >= K)
        return (int)cudaErrorInvalidValue;
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
    p.replays = (int *)replays;
    p.gs = (int8_t *)gs;
    p.B = B; p.QPU = QPU; p.T = T; p.row0 = row0; p.W = W;
    p.gapo1 = gapo1; p.gape1 = gape1; p.gapo2 = gapo2; p.gape2 = gape2;
    p.d_oh = d_oh; p.c_oh = c_oh; p.ppb = 1;
    p.K = K; p.R = R;
    cudaStream_t s = (cudaStream_t)stream;
    if (piecewise == 0) return (int)launch_mode<0>(p, mode_type, emit, s);
    if (piecewise == 1) return (int)launch_mode<1>(p, mode_type, emit, s);
    if (piecewise == 2) return (int)launch_mode<2>(p, mode_type, emit, s);
    return (int)cudaErrorInvalidValue;
}
