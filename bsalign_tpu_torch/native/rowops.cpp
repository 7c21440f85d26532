// Native row primitives for the banded striped 8-bit DP.
//
// Bit-exact C++ ports of the Python oracle (bsalign_tpu/oracle/banded8.py,
// itself validated byte-exact against the reference bsalign binary,
// bsalign.h:2084-3349). These are the host-side hot loops of the POA engine
// (per-graph-node row updates, bspoa.h:2232-2272): the TPU batches whole
// pairwise workloads, but POA's per-read incremental graph alignment is
// latency-bound scalar work where a native library is the right tool.
//
// All arithmetic is int8-saturating with int64 stripe anchors, matching the
// reference's SSE semantics lane for lane. Plain 16-wide loops; g++ -O3
// autovectorizes them to SIMD.
//
// Build: g++ -O3 -shared -fPIC rowops.cpp -o librowops.so  (see build.py)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

typedef int8_t i8;
typedef int16_t i16;
typedef int32_t i32;
typedef int64_t i64;

static const int WSZ = 16;
static const int SCORE_EPI8_MIN = -63;   // constants.py SCORE_EPI8_MIN
static const int SCORE_EPI8_MAX = 63;    // constants.py SCORE_EPI8_MAX
static const i64 SCORE_MIN_I = -(0x7FFFFFFFLL >> 2);  // constants.SCORE_MIN

static inline i8 adds8(i8 a, i8 b) {
    int s = (int)a + (int)b;
    if (s > 127) s = 127;
    if (s < -128) s = -128;
    return (i8)s;
}

static inline i8 subs8(i8 a, i8 b) {
    int s = (int)a - (int)b;
    if (s > 127) s = 127;
    if (s < -128) s = -128;
    return (i8)s;
}

static inline i8 max8(i8 a, i8 b) { return a > b ? a : b; }

// 16-lane saturating int8 vector path for the striped row kernels. The
// semantics of paddsb/psubsb/pmaxsb are exactly adds8/subs8/max8, so the
// vector and scalar bodies are bit-identical; the scalar bodies remain as
// the portable fallback (and the reviewed ground truth).
#if defined(__SSE4_1__)
#include <immintrin.h>
#define BSA_V16 1
typedef __m128i v16;
static inline v16 vld16(const i8 *p) {
    return _mm_loadu_si128(reinterpret_cast<const __m128i *>(p));
}
static inline void vst16(i8 *p, v16 a) {
    _mm_storeu_si128(reinterpret_cast<__m128i *>(p), a);
}
#endif

static inline i8 wrap8(i64 x) { return (i8)(uint8_t)(x & 0xFF); }

static inline int c_div(int a, int b) { return a / b; }  // C truncation

// out[j] = x[j+k], zero fill
static inline void lane_dn(const i8 *x, int k, i8 *out) {
    if (k >= WSZ) {
        memset(out, 0, WSZ);
        return;
    }
    memcpy(out, x + k, (size_t)(WSZ - k));
    memset(out + WSZ - k, 0, (size_t)k);
}

struct Row {
    i8 *us;      // [W][16]
    i8 *es;      // [W][16] or null
    i8 *qs;      // [W][16] or null
    i64 *ubegs;  // [17]
};

// ---- row_movx (oracle row_movx / bsalign.h:2244-2392) ----
static void row_movx(const Row &prev, Row &cur, int W, int movx,
                     int piecewise, int nt_max, int nt_min, int gapo1,
                     int gape1, int gapo2, int gape2) {
    const int B = W * WSZ;
    if (movx >= B) {
        memset(cur.us, 0, (size_t)W * WSZ);
        if (piecewise) memset(cur.es, 0, (size_t)W * WSZ);
        if (piecewise == 2) memset(cur.qs, 0, (size_t)W * WSZ);
        for (int i = 0; i <= WSZ; i++) cur.ubegs[i] = SCORE_MIN_I;
        return;
    }
    if (movx == 0) {
        memcpy(cur.us, prev.us, (size_t)W * WSZ);
        if (piecewise) memcpy(cur.es, prev.es, (size_t)W * WSZ);
        if (piecewise == 2) memcpy(cur.qs, prev.qs, (size_t)W * WSZ);
        memcpy(cur.ubegs, prev.ubegs, sizeof(i64) * (WSZ + 1));
        return;
    }
    memset(cur.us, 0, (size_t)W * WSZ);
    if (piecewise) memset(cur.es, 0, (size_t)W * WSZ);
    if (piecewise == 2) memset(cur.qs, 0, (size_t)W * WSZ);
    const int cyc = movx / W;
    const int mov = movx % W;
    const int div = W - mov;
    for (int i = 0; i < div; i++)
        lane_dn(prev.us + (size_t)(i + mov) * WSZ, cyc, cur.us + (size_t)i * WSZ);
    if (piecewise)
        for (int i = 0; i < div; i++)
            lane_dn(prev.es + (size_t)(i + mov) * WSZ, cyc,
                    cur.es + (size_t)i * WSZ);
    if (piecewise == 2)
        for (int i = 0; i < div; i++)
            lane_dn(prev.qs + (size_t)(i + mov) * WSZ, cyc,
                    cur.qs + (size_t)i * WSZ);
    if (mov) {
        i64 ubt[WSZ];
        for (int j = 0; j < WSZ; j++) ubt[j] = prev.ubegs[j];
        for (int i = div; i < W; i++) {
            const i8 *pu = prev.us + (size_t)(i - div) * WSZ;
            for (int j = 0; j < WSZ; j++) ubt[j] += pu[j];
            lane_dn(pu, cyc + 1, cur.us + (size_t)i * WSZ);
        }
        if (piecewise)
            for (int i = div; i < W; i++)
                lane_dn(prev.es + (size_t)(i - div) * WSZ, cyc + 1,
                        cur.es + (size_t)i * WSZ);
        if (piecewise == 2)
            for (int i = div; i < W; i++)
                lane_dn(prev.qs + (size_t)(i - div) * WSZ, cyc + 1,
                        cur.qs + (size_t)i * WSZ);
        for (int k = 0; k < WSZ - cyc; k++) cur.ubegs[k] = ubt[cyc + k];
    } else {
        for (int k = 0; k < WSZ - cyc; k++) cur.ubegs[k] = prev.ubegs[cyc + k];
    }
    for (int k = WSZ - cyc; k <= WSZ; k++) cur.ubegs[k] = prev.ubegs[WSZ];

    // mimic insertions on the overhang (bsalign.h:2357-2390)
    const int d = (piecewise == 2) ? c_div(gapo1 - gapo2, gape2 - gape1)
                                   : B + 1;
    const int i0 = B - movx;
    int a = i0 % W;
    int a2 = (i0 + d) % W;
    int b = i0 / W;
    const int b2 = (i0 + d) / W;
    i64 c;
    if (piecewise == 2)
        c = (i64)((nt_min < gapo2 + gape2 ? nt_min : gapo2 + gape2) - 1 -
                  nt_max + (gapo2 + gape2));
    else
        c = (i64)((nt_min < gapo1 + gape1 ? nt_min : gapo1 + gape1) - 1 -
                  nt_max + (gapo1 + gape1));
    cur.us[(size_t)(i0 % W) * WSZ + (i0 / W)] = wrap8(c);
    a += 1;
    bool broke = false;
    while (b < WSZ && b <= b2) {
        if (b == b2) {
            c += (i64)(a2 - a) * gape1;
            while (a < a2) {
                cur.us[(size_t)a * WSZ + b] = (i8)gape1;
                a++;
            }
            a = a2;
            if (a2 < W) { broke = true; break; }
        }
        c += (i64)(W - a) * gape1;
        while (a < W) {
            cur.us[(size_t)a * WSZ + b] = (i8)gape1;
            a++;
        }
        cur.ubegs[b + 1] += c;
        a = 0;
        b++;
    }
    (void)broke;
    while (b < WSZ) {
        c += (i64)(W - a) * gape2;
        while (a < W) {
            cur.us[(size_t)a * WSZ + b] = (i8)gape2;
            a++;
        }
        cur.ubegs[b + 1] += c;
        a = 0;
        b++;
    }
}

// ---- active F-loop (bsalign.h:2639-2652) ----
static void fpenetration(i8 *f /*in/out [16]*/, const i64 *ubegs, int gape,
                         int W) {
    i8 fs[WSZ];
    fs[0] = (i8)SCORE_EPI8_MIN;
    for (int j = 1; j < WSZ; j++) fs[j] = f[j - 1];
    const i64 t = (i64)W * gape;
    i64 s = t + (i64)fs[0] - (ubegs[1] - ubegs[0]);
    for (int i = 1; i < WSZ; i++) {
        if ((i64)fs[i] < s) fs[i] = wrap8(s);
        s = t + (i64)fs[i] - (ubegs[i + 1] - ubegs[i]);
    }
    memcpy(f, fs, WSZ);
}

static i64 row_cal_tail(const i8 *h, const i8 *u, const i8 *v, Row &cur,
                        const i64 *prev_ubegs) {
    i8 v2[WSZ];
    for (int j = 0; j < WSZ; j++) v2[j] = subs8(h[j], u[j]);
    for (int i = 1; i <= WSZ; i++)
        cur.ubegs[i] = prev_ubegs[i] + (i64)v2[i - 1];
    i8 v3[WSZ];
    v3[0] = 0;
    for (int j = 1; j < WSZ; j++) v3[j] = v2[j - 1];
    for (int j = 0; j < WSZ; j++) cur.us[j] = subs8(cur.us[j], v3[j]);
    cur.ubegs[0] = prev_ubegs[0] + (i64)cur.us[0];
    cur.us[0] = 0;
    (void)v;
    return cur.ubegs[0];
}

static inline i64 h0_init(i64 rh, i64 ub0, int qp0, i64 t) {
    i64 h0 = (rh - ub0) + qp0;
    if (h0 >= t) {
        if (h0 > SCORE_EPI8_MAX) h0 = SCORE_EPI8_MAX;
    } else {
        h0 = SCORE_EPI8_MIN;
    }
    return h0;
}

// qprof row pointer: qprof + ((size_t)(rbeg + i) * 4 + base) * 16
#define QPROW(i) (qprof + ((size_t)(rbeg + (i)) * 4 + tbase) * WSZ)

static void piece0_row_cal(int rbeg, int tbase, const Row &prev, Row &cur,
                           const i8 *qprof, int gape1, int W, i64 rh) {
    const i8 GapE = (i8)gape1;
    i8 f[WSZ], h[WSZ], v[WSZ], u[WSZ], e[WSZ];
    for (int j = 0; j < WSZ; j++) f[j] = (i8)SCORE_EPI8_MIN;
    const i64 h0 = h0_init(rh, prev.ubegs[0], QPROW(0)[0],
                           (i64)prev.us[0] + gape1);
    memcpy(h, QPROW(0), WSZ);
    h[0] = wrap8(h0);
#if BSA_V16
    {
        const v16 vGapE = _mm_set1_epi8(GapE);
        v16 vf = vld16(f), vh = vld16(h);
        for (int i = 0; i < W; i++) {
            const v16 vpu = vld16(prev.us + (size_t)i * WSZ);
            v16 hh = _mm_max_epi8(_mm_adds_epi8(vpu, vGapE), vh);
            hh = _mm_max_epi8(vf, hh);
            vf = _mm_subs_epi8(_mm_adds_epi8(hh, vGapE), vpu);
            vh = vld16(QPROW(i + 1));
        }
        vst16(f, vf);
    }
#else
    for (int i = 0; i < W; i++) {
        const i8 *pu = prev.us + (size_t)i * WSZ;
        for (int j = 0; j < WSZ; j++) {
            i8 ee = adds8(pu[j], GapE);
            i8 hh = max8(ee, h[j]);
            hh = max8(f[j], hh);
            i8 ff = adds8(hh, GapE);
            f[j] = subs8(ff, pu[j]);
        }
        memcpy(h, QPROW(i + 1), WSZ);
    }
#endif
    fpenetration(f, prev.ubegs, gape1, W);
    i8 z[WSZ];
    memcpy(z, QPROW(0), WSZ);
    z[0] = wrap8(h0);
    memset(v, 0, WSZ);
    memset(u, 0, WSZ);
#if BSA_V16
    {
        const v16 vGapE = _mm_set1_epi8(GapE);
        v16 vz = vld16(z), vf = vld16(f);
        v16 vv = _mm_setzero_si128(), vu = _mm_setzero_si128();
        v16 vh = _mm_setzero_si128();
        for (int i = 0; i < W; i++) {
            vu = vld16(prev.us + (size_t)i * WSZ);
            v16 hh = _mm_max_epi8(_mm_adds_epi8(vu, vGapE), vz);
            hh = _mm_max_epi8(vf, hh);
            vst16(cur.us + (size_t)i * WSZ, _mm_subs_epi8(hh, vv));
            vv = _mm_subs_epi8(hh, vu);
            vf = _mm_subs_epi8(_mm_adds_epi8(hh, vGapE), vu);
            vh = hh;
            vz = vld16(QPROW(i + 1));
        }
        vst16(h, vh);
        vst16(u, vu);
        vst16(v, vv);
        (void)e;
    }
#else
    for (int i = 0; i < W; i++) {
        const i8 *pu = prev.us + (size_t)i * WSZ;
        i8 *cu = cur.us + (size_t)i * WSZ;
        for (int j = 0; j < WSZ; j++) {
            u[j] = pu[j];
            e[j] = adds8(u[j], GapE);
            i8 hh = max8(e[j], z[j]);
            hh = max8(f[j], hh);
            cu[j] = subs8(hh, v[j]);
            v[j] = subs8(hh, u[j]);
            i8 ff = adds8(hh, GapE);
            f[j] = subs8(ff, u[j]);
            h[j] = hh;
        }
        memcpy(z, QPROW(i + 1), WSZ);
    }
#endif
    row_cal_tail(h, u, v, cur, prev.ubegs);
}

static void piece1_row_cal(int rbeg, int tbase, const Row &prev, Row &cur,
                           const i8 *qprof, int gapo1, int gape1, int W,
                           i64 rh) {
    const i8 GapOE = (i8)(gapo1 + gape1);
    const i8 GapE = (i8)gape1;
    i8 f[WSZ], h[WSZ], v[WSZ], u[WSZ];
    for (int j = 0; j < WSZ; j++) f[j] = (i8)SCORE_EPI8_MIN;
    const i64 h0 = h0_init(rh, prev.ubegs[0], QPROW(0)[0],
                           (i64)prev.us[0] + (i64)prev.es[0]);
    memcpy(h, QPROW(0), WSZ);
    h[0] = wrap8(h0);
#if BSA_V16
    {
        const v16 vGapE = _mm_set1_epi8(GapE);
        const v16 vGapOE = _mm_set1_epi8(GapOE);
        v16 vf = vld16(f), vh = vld16(h);
        for (int i = 0; i < W; i++) {
            const v16 vpu = vld16(prev.us + (size_t)i * WSZ);
            const v16 vpe = vld16(prev.es + (size_t)i * WSZ);
            v16 hh = _mm_max_epi8(_mm_adds_epi8(vpe, vpu), vh);
            hh = _mm_max_epi8(vf, hh);
            v16 ff = _mm_adds_epi8(vf, vGapE);
            hh = _mm_adds_epi8(hh, vGapOE);
            ff = _mm_max_epi8(ff, hh);
            vf = _mm_subs_epi8(ff, vpu);
            vh = vld16(QPROW(i + 1));
        }
        vst16(f, vf);
    }
#else
    for (int i = 0; i < W; i++) {
        const i8 *pu = prev.us + (size_t)i * WSZ;
        const i8 *pe = prev.es + (size_t)i * WSZ;
        for (int j = 0; j < WSZ; j++) {
            i8 ee = adds8(pe[j], pu[j]);
            i8 hh = max8(ee, h[j]);
            hh = max8(f[j], hh);
            i8 ff = adds8(f[j], GapE);
            hh = adds8(hh, GapOE);
            ff = max8(ff, hh);
            f[j] = subs8(ff, pu[j]);
        }
        memcpy(h, QPROW(i + 1), WSZ);
    }
#endif
    fpenetration(f, prev.ubegs, gape1, W);
    i8 z[WSZ];
    memcpy(z, QPROW(0), WSZ);
    z[0] = wrap8(h0);
    memset(v, 0, WSZ);
    memset(u, 0, WSZ);
#if BSA_V16
    {
        const v16 vGapE = _mm_set1_epi8(GapE);
        const v16 vGapOE = _mm_set1_epi8(GapOE);
        v16 vz = vld16(z), vf = vld16(f);
        v16 vv = _mm_setzero_si128(), vu = _mm_setzero_si128();
        v16 vh = _mm_setzero_si128();
        for (int i = 0; i < W; i++) {
            vu = vld16(prev.us + (size_t)i * WSZ);
            v16 ee = _mm_adds_epi8(vld16(prev.es + (size_t)i * WSZ), vu);
            v16 hh = _mm_max_epi8(ee, vz);
            hh = _mm_max_epi8(vf, hh);
            vst16(cur.us + (size_t)i * WSZ, _mm_subs_epi8(hh, vv));
            vv = _mm_subs_epi8(hh, vu);
            ee = _mm_subs_epi8(_mm_adds_epi8(ee, vGapE), hh);
            vst16(cur.es + (size_t)i * WSZ, _mm_max_epi8(ee, vGapOE));
            v16 ff = _mm_adds_epi8(vf, vGapE);
            v16 h2 = _mm_adds_epi8(hh, vGapOE);
            ff = _mm_max_epi8(ff, h2);
            vf = _mm_subs_epi8(ff, vu);
            vh = h2;  // oracle mutates h via adds8(h, GapOE); tail sees it
            vz = vld16(QPROW(i + 1));
        }
        vst16(h, _mm_subs_epi8(vh, vGapOE));
        vst16(u, vu);
        vst16(v, vv);
    }
#else
    for (int i = 0; i < W; i++) {
        const i8 *pu = prev.us + (size_t)i * WSZ;
        const i8 *pe = prev.es + (size_t)i * WSZ;
        i8 *cu = cur.us + (size_t)i * WSZ;
        i8 *ce = cur.es + (size_t)i * WSZ;
        for (int j = 0; j < WSZ; j++) {
            u[j] = pu[j];
            i8 ee = adds8(pe[j], u[j]);
            i8 hh = max8(ee, z[j]);
            hh = max8(f[j], hh);
            cu[j] = subs8(hh, v[j]);
            v[j] = subs8(hh, u[j]);
            ee = adds8(ee, GapE);
            ee = subs8(ee, hh);
            ce[j] = max8(ee, GapOE);
            i8 ff = adds8(f[j], GapE);
            i8 h2 = adds8(hh, GapOE);
            ff = max8(ff, h2);
            f[j] = subs8(ff, u[j]);
            h[j] = h2;  // oracle mutates h via adds8(h, GapOE); tail sees it
        }
        memcpy(z, QPROW(i + 1), WSZ);
    }
    for (int j = 0; j < WSZ; j++) h[j] = subs8(h[j], GapOE);
#endif
    row_cal_tail(h, u, v, cur, prev.ubegs);
}

static void piece2_row_cal(int rbeg, int tbase, const Row &prev, Row &cur,
                           const i8 *qprof, int gapo1, int gape1, int gapo2,
                           int gape2, int W, i64 rh) {
    const i8 GapOE = (i8)(gapo1 + gape1);
    const i8 GapE = (i8)gape1;
    const i8 GapQP = (i8)(gapo2 + gape2);
    const i8 GapP = (i8)gape2;
    int goq = (int)GapOE - (int)GapQP;
    if (goq > 127) goq = 127;
    if (goq < -128) goq = -128;
    const i8 GapOQ = (i8)goq;
    i8 f[WSZ], g[WSZ], h[WSZ], v[WSZ], u[WSZ];
    for (int j = 0; j < WSZ; j++) {
        f[j] = (i8)SCORE_EPI8_MIN;
        g[j] = (i8)SCORE_EPI8_MIN;
    }
    i64 eq0 = (i64)prev.es[0] > (i64)prev.qs[0] ? prev.es[0] : prev.qs[0];
    const i64 h0 = h0_init(rh, prev.ubegs[0], QPROW(0)[0],
                           (i64)prev.us[0] + eq0);
    memcpy(h, QPROW(0), WSZ);
    h[0] = wrap8(h0);
#if BSA_V16
    {
        const v16 vGapE = _mm_set1_epi8(GapE);
        const v16 vGapOE = _mm_set1_epi8(GapOE);
        const v16 vGapP = _mm_set1_epi8(GapP);
        const v16 vGapOQ = _mm_set1_epi8(GapOQ);
        v16 vf = vld16(f), vg = vld16(g), vh = vld16(h);
        for (int i = 0; i < W; i++) {
            const v16 vpu = vld16(prev.us + (size_t)i * WSZ);
            v16 ee = _mm_adds_epi8(vld16(prev.es + (size_t)i * WSZ), vpu);
            v16 qq = _mm_adds_epi8(vld16(prev.qs + (size_t)i * WSZ), vpu);
            v16 hh = _mm_max_epi8(ee, vh);
            hh = _mm_max_epi8(qq, hh);
            hh = _mm_max_epi8(vf, hh);
            hh = _mm_max_epi8(vg, hh);
            v16 ff = _mm_adds_epi8(vf, vGapE);
            hh = _mm_adds_epi8(hh, vGapOE);
            ff = _mm_max_epi8(ff, hh);
            vf = _mm_subs_epi8(ff, vpu);
            v16 gg = _mm_adds_epi8(vg, vGapP);
            hh = _mm_subs_epi8(hh, vGapOQ);
            gg = _mm_max_epi8(gg, hh);
            vg = _mm_subs_epi8(gg, vpu);
            vh = vld16(QPROW(i + 1));
        }
        vst16(f, vf);
        vst16(g, vg);
    }
#else
    for (int i = 0; i < W; i++) {
        const i8 *pu = prev.us + (size_t)i * WSZ;
        const i8 *pe = prev.es + (size_t)i * WSZ;
        const i8 *pq = prev.qs + (size_t)i * WSZ;
        for (int j = 0; j < WSZ; j++) {
            i8 ee = adds8(pe[j], pu[j]);
            i8 qq = adds8(pq[j], pu[j]);
            i8 hh = max8(ee, h[j]);
            hh = max8(qq, hh);
            hh = max8(f[j], hh);
            hh = max8(g[j], hh);
            i8 ff = adds8(f[j], GapE);
            hh = adds8(hh, GapOE);
            ff = max8(ff, hh);
            f[j] = subs8(ff, pu[j]);
            i8 gg = adds8(g[j], GapP);
            hh = subs8(hh, GapOQ);
            gg = max8(gg, hh);
            g[j] = subs8(gg, pu[j]);
        }
        memcpy(h, QPROW(i + 1), WSZ);
    }
#endif
    fpenetration(f, prev.ubegs, gape1, W);
    fpenetration(g, prev.ubegs, gape2, W);
    i8 z[WSZ];
    memcpy(z, QPROW(0), WSZ);
    z[0] = wrap8(h0);
    memset(v, 0, WSZ);
    memset(u, 0, WSZ);
#if BSA_V16
    {
        const v16 vGapE = _mm_set1_epi8(GapE);
        const v16 vGapOE = _mm_set1_epi8(GapOE);
        const v16 vGapP = _mm_set1_epi8(GapP);
        const v16 vGapOQ = _mm_set1_epi8(GapOQ);
        const v16 vGapQP = _mm_set1_epi8(GapQP);
        v16 vz = vld16(z), vf = vld16(f), vg = vld16(g);
        v16 vv = _mm_setzero_si128(), vu = _mm_setzero_si128();
        v16 vh = _mm_setzero_si128();
        for (int i = 0; i < W; i++) {
            vu = vld16(prev.us + (size_t)i * WSZ);
            v16 ee = _mm_adds_epi8(vld16(prev.es + (size_t)i * WSZ), vu);
            v16 hh = _mm_max_epi8(ee, vz);
            v16 qq = _mm_adds_epi8(vld16(prev.qs + (size_t)i * WSZ), vu);
            hh = _mm_max_epi8(qq, hh);
            hh = _mm_max_epi8(vf, hh);
            hh = _mm_max_epi8(vg, hh);
            vst16(cur.us + (size_t)i * WSZ, _mm_subs_epi8(hh, vv));
            vv = _mm_subs_epi8(hh, vu);
            ee = _mm_subs_epi8(_mm_adds_epi8(ee, vGapE), hh);
            vst16(cur.es + (size_t)i * WSZ, _mm_max_epi8(ee, vGapOE));
            qq = _mm_subs_epi8(_mm_adds_epi8(qq, vGapP), hh);
            vst16(cur.qs + (size_t)i * WSZ, _mm_max_epi8(qq, vGapQP));
            v16 ff = _mm_adds_epi8(vf, vGapE);
            v16 h2 = _mm_adds_epi8(hh, vGapOE);
            ff = _mm_max_epi8(ff, h2);
            vf = _mm_subs_epi8(ff, vu);
            v16 gg = _mm_adds_epi8(vg, vGapP);
            v16 h3 = _mm_subs_epi8(h2, vGapOQ);  // oracle: subs8(adds8(h,GapOE),GapOQ)
            gg = _mm_max_epi8(gg, h3);
            vg = _mm_subs_epi8(gg, vu);
            vh = h3;
            vz = vld16(QPROW(i + 1));
        }
        vst16(h, _mm_subs_epi8(vh, vGapQP));
        vst16(u, vu);
        vst16(v, vv);
    }
#else
    for (int i = 0; i < W; i++) {
        const i8 *pu = prev.us + (size_t)i * WSZ;
        const i8 *pe = prev.es + (size_t)i * WSZ;
        const i8 *pq = prev.qs + (size_t)i * WSZ;
        i8 *cu = cur.us + (size_t)i * WSZ;
        i8 *ce = cur.es + (size_t)i * WSZ;
        i8 *cq = cur.qs + (size_t)i * WSZ;
        for (int j = 0; j < WSZ; j++) {
            u[j] = pu[j];
            i8 ee = adds8(pe[j], u[j]);
            i8 hh = max8(ee, z[j]);
            i8 qq = adds8(pq[j], u[j]);
            hh = max8(qq, hh);
            hh = max8(f[j], hh);
            hh = max8(g[j], hh);
            cu[j] = subs8(hh, v[j]);
            v[j] = subs8(hh, u[j]);
            ee = adds8(ee, GapE);
            ee = subs8(ee, hh);
            ce[j] = max8(ee, GapOE);
            qq = adds8(qq, GapP);
            qq = subs8(qq, hh);
            cq[j] = max8(qq, GapQP);
            i8 ff = adds8(f[j], GapE);
            i8 h2 = adds8(hh, GapOE);
            ff = max8(ff, h2);
            f[j] = subs8(ff, u[j]);
            i8 gg = adds8(g[j], GapP);
            i8 h3 = subs8(h2, GapOQ);  // oracle: h = subs8(adds8(h,GapOE),GapOQ)
            gg = max8(gg, h3);
            g[j] = subs8(gg, u[j]);
            h[j] = h3;
        }
        memcpy(z, QPROW(i + 1), WSZ);
    }
    for (int j = 0; j < WSZ; j++) h[j] = subs8(h[j], GapQP);
#endif
    row_cal_tail(h, u, v, cur, prev.ubegs);
}

static i64 getscore_row(const Row &st, int W, int pos) {
    const int x = pos % W;
    const int y = pos / W;
    i64 s = st.ubegs[y];
    for (int i = 0; i <= x; i++) s += st.us[(size_t)i * WSZ + y];
    return s;
}

extern "C" {

// rh_mode: 0 = rh_val as given; 1 = shifted.ubegs[0] (POA row chain);
//          2 = getscore(prev, rh_val) BEFORE movx (pairwise row loop)
void bsa8_row_update(const i8 *pus, const i8 *pes, const i8 *pqs,
                     const i64 *pub, i8 *cus, i8 *ces, i8 *cqs, i64 *cub,
                     const i8 *qprof, int rbeg, int tbase, int W, int movx,
                     int piecewise, int nt_max, int nt_min, int gapo1,
                     int gape1, int gapo2, int gape2, int rh_mode,
                     i64 rh_val) {
    Row prev{const_cast<i8 *>(pus), const_cast<i8 *>(pes),
             const_cast<i8 *>(pqs), const_cast<i64 *>(pub)};
    thread_local std::vector<i8> sbuf;
    thread_local std::vector<i64> subuf;
    sbuf.resize((size_t)W * WSZ * 3);
    subuf.resize(WSZ + 1);
    Row shifted{sbuf.data(), piecewise ? sbuf.data() + (size_t)W * WSZ : nullptr,
                piecewise == 2 ? sbuf.data() + (size_t)2 * W * WSZ : nullptr,
                subuf.data()};
    i64 rh = rh_val;
    if (rh_mode == 2) rh = getscore_row(prev, W, (int)rh_val);
    row_movx(prev, shifted, W, movx, piecewise, nt_max, nt_min, gapo1, gape1,
             gapo2, gape2);
    if (rh_mode == 1) rh = shifted.ubegs[0];
    Row cur{cus, ces, cqs, cub};
    if (piecewise == 0)
        piece0_row_cal(rbeg, tbase, shifted, cur, qprof, gape1, W, rh);
    else if (piecewise == 1)
        piece1_row_cal(rbeg, tbase, shifted, cur, qprof, gapo1, gape1, W, rh);
    else
        piece2_row_cal(rbeg, tbase, shifted, cur, qprof, gapo1, gape1, gapo2,
                       gape2, W, rh);
}

// Elementwise max-merge of two rows (bsalign.h:2474-2616, int32-exact form)
void bsa8_row_merge(const i8 *us0, const i8 *es0, const i8 *qs0,
                    const i64 *ub0, const i8 *us1, const i8 *es1,
                    const i8 *qs1, const i64 *ub1, i8 *uso, i8 *eso, i8 *qso,
                    i64 *ubo, int W, int piecewise) {
    i64 r0[WSZ], r1[WSZ], r2[WSZ];
    for (int j = 0; j < WSZ; j++) {
        r0[j] = ub0[j];
        r1[j] = ub1[j];
        r2[j] = r0[j] > r1[j] ? r0[j] : r1[j];
        ubo[j] = r2[j];
    }
    ubo[WSZ] = ub0[WSZ] > ub1[WSZ] ? ub0[WSZ] : ub1[WSZ];
    for (int i = 0; i < W; i++) {
        const size_t o = (size_t)i * WSZ;
        for (int j = 0; j < WSZ; j++) {
            r0[j] += us0[o + j];
            r1[j] += us1[o + j];
            i64 rm = r0[j] > r1[j] ? r0[j] : r1[j];
            i64 du = rm - r2[j];
            if (du > 127) du = 127;
            if (du < -128) du = -128;
            uso[o + j] = (i8)du;
            r2[j] = rm;
            if (piecewise) {
                i64 e0 = r0[j] + es0[o + j];
                i64 e1 = r1[j] + es1[o + j];
                i64 em = (e0 > e1 ? e0 : e1) - rm;
                if (em > 127) em = 127;
                if (em < -128) em = -128;
                eso[o + j] = (i8)em;
            }
            if (piecewise == 2) {
                i64 q0 = r0[j] + qs0[o + j];
                i64 q1 = r1[j] + qs1[o + j];
                i64 qm = (q0 > q1 ? q0 : q1) - rm;
                if (qm > 127) qm = 127;
                if (qm < -128) qm = -128;
                qso[o + j] = (i8)qm;
            }
        }
    }
}

i64 bsa8_getscore(const i8 *us, const i64 *ubegs, int W, int pos) {
    Row st{const_cast<i8 *>(us), nullptr, nullptr, const_cast<i64 *>(ubegs)};
    return getscore_row(st, W, pos);
}

}  // extern "C"

// ---- remsa pedit forward pass (bspoa.h:3735-3960 / poa/core._pedit_rd) ----
// Anti-diagonal max-match DP of one read vs the MSA column-count profile,
// unsigned-8-bit saturating. Fills matrix0/matrix1 diagonals; the Python
// caller walks the traceback (it mutates the POA graph).
extern "C" void bsa_pedit_forward(uint8_t *matrix0, uint8_t *matrix1,
                                  const uint8_t *seqs0, const uint8_t *seqs1,
                                  const uint8_t *mats0, const uint8_t *mats1,
                                  int mlen, int mbeg, int mend, int bw,
                                  int HW, int rowlen, long pad) {
    const size_t idx0 = (size_t)(mbeg + mbeg) * rowlen;
    memset(matrix0 + idx0, 0, rowlen);
    memset(matrix1 + idx0, 0, rowlen);
    matrix0[idx0 + 1 + HW - 1] = 255;
    matrix1[idx0 + 1 + HW] = 255;
    int x = mbeg, y = mbeg;
    for (;;) {
        const int moff = x + y;
        const int mdir = moff & 1;
        const int midx = (x - y - mdir) / 2 + HW;
        const int xb = x - midx;
        const int yb = mlen - 1 - (y + midx);
        const int dirn = (x + y) & 1;
        const uint8_t *p0 = matrix0 + (size_t)rowlen * moff;
        const uint8_t *p1 = matrix1 + (size_t)rowlen * moff;
        uint8_t *c0 = matrix0 + (size_t)rowlen * (moff + 1);
        uint8_t *c1 = matrix1 + (size_t)rowlen * (moff + 1);
        const uint8_t *sc = seqs1 + HW + yb;   // cns-side bases
        const uint8_t *sr = seqs0 + HW + xb;   // read-side bases
        const uint8_t *pu = dirn ? p0 + 2 : p0 + 1;
        const uint8_t *pv = dirn ? p1 + 1 : p1;
        int i = 0;
#if BSA_V16
        // vector body: per-base count via 4 cmpeq+and selects (the same
        // trick as the reference's blendv kernel, bspoa.h:3856-3896);
        // cells with base>=4 select nothing and contribute 0
        for (; i + 16 <= bw; i += 16) {
            const __m128i vcb =
                _mm_loadu_si128(reinterpret_cast<const __m128i *>(sc + i));
            const __m128i vrb =
                _mm_loadu_si128(reinterpret_cast<const __m128i *>(sr + i));
            __m128i xs = _mm_setzero_si128(), ys = _mm_setzero_si128();
            for (int b = 0; b < 4; b++) {
                const __m128i vb = _mm_set1_epi8((char)b);
                const __m128i m0 = _mm_loadu_si128(
                    reinterpret_cast<const __m128i *>(
                        mats0 + (size_t)b * pad + HW + xb + i));
                const __m128i m1 = _mm_loadu_si128(
                    reinterpret_cast<const __m128i *>(
                        mats1 + (size_t)b * pad + HW + yb + i));
                xs = _mm_or_si128(
                    xs, _mm_and_si128(_mm_cmpeq_epi8(vcb, vb), m0));
                ys = _mm_or_si128(
                    ys, _mm_and_si128(_mm_cmpeq_epi8(vrb, vb), m1));
            }
            __m128i h = _mm_adds_epu8(xs, ys);
            const __m128i u =
                _mm_loadu_si128(reinterpret_cast<const __m128i *>(pu + i));
            const __m128i v =
                _mm_loadu_si128(reinterpret_cast<const __m128i *>(pv + i));
            h = _mm_max_epu8(h, u);
            h = _mm_max_epu8(h, v);
            _mm_storeu_si128(reinterpret_cast<__m128i *>(c0 + 1 + i),
                             _mm_sub_epi8(h, v));
            _mm_storeu_si128(reinterpret_cast<__m128i *>(c1 + 1 + i),
                             _mm_sub_epi8(h, u));
        }
#endif
        for (; i < bw; i++) {
            const uint8_t cb = sc[i];
            const uint8_t rb = sr[i];
            int xs = (cb < 4) ? mats0[(size_t)cb * pad + HW + xb + i] : 0;
            int ys = (rb < 4) ? mats1[(size_t)rb * pad + HW + yb + i] : 0;
            int h = xs + ys;
            if (h > 255) h = 255;
            const int u = pu[i];
            const int v = pv[i];
            if (u > h) h = u;
            if (v > h) h = v;
            c0[1 + i] = (uint8_t)(h - v);
            c1[1 + i] = (uint8_t)(h - u);
        }
        if (dirn) {
            c0[0] = 255; c1[0] = 0; c0[1 + bw] = 0; c1[1 + bw] = 0;
            y++;
        } else {
            c0[0] = 0; c1[0] = 0; c0[1 + bw] = 0; c1[1 + bw] = 255;
            x++;
        }
        if (x >= mend) break;
    }
}

// ---- HMM consensus forward scan (cns_bspoa, bspoa.h:3457-3733) ----
// Per-column 5-state DP over all reads: sc[a][pos][e] transition scores,
// sc[a][pos][5] log-sum-exp marginal, btm/lbm backtrace + last-cns-base.
// The Python caller does the Viterbi backtrace and QLT/ALT qualities.
static inline double sum_log2(double s, double v) {
    const double MINLOG = -1000000000.0;
    if (v == MINLOG) return s;
    if (s == MINLOG) { s = v; return s; }
    double delta;
    if (v > s) {
        if (v >= s + 40) return v;
        delta = s - v;
        s = v;
    } else {
        if (s >= v + 40) return s;
        delta = v - s;
    }
    return s + log(1 + exp(delta));
}

extern "C" void bsa_cns_forward(const uint8_t *colmat, long mlen, int mrow,
                                int nseq, const uint8_t *dptable,
                                const double *dpvals, double min_freq,
                                double *sc, uint8_t *btm, uint8_t *lbm) {
    const double MINLOG = -1000000000.0;
    const long SP = mlen + 1;                 // sc stride: [5][SP][6]
    std::vector<uint8_t> bs((size_t)10 * nseq, 0);
    std::vector<int> rid_l(nseq), b_l(nseq);
    for (int a = 0; a < 5; a++) {
        double *s0 = sc + ((size_t)a * SP) * 6;
        for (int k = 0; k < 5; k++) s0[k] = 0.0;
        s0[5] = (a == 4) ? 0.0 : MINLOG;
        btm[(size_t)a * SP] = 4;
        lbm[(size_t)a * SP] = 4;
    }
    for (long pos = 0; pos < mlen; pos++) {
        const uint8_t *qs = colmat + (size_t)pos * mrow;
        long cnts[6] = {0, 0, 0, 0, 0, 0};
        int nrb = 0;
        for (int rid = 0; rid < nseq; rid++) {
            int b = qs[rid];
            if (b > 4) continue;
            cnts[5]++;
            cnts[b]++;
            rid_l[nrb] = rid;
            b_l[nrb] = b;
            nrb++;
        }
        for (int i = 0; i < 5; i++)
            if (cnts[i] < (long)(min_freq * cnts[5])) cnts[i] = 0;
        const long dpos = pos + 1;
        double errs[10];
        for (int a = 0; a < 5; a++) {
            double *sa = sc + ((size_t)a * SP + dpos) * 6;
            if (cnts[5] && cnts[a] == 0) {
                for (int k = 0; k < 6; k++) sa[k] = MINLOG;
                btm[(size_t)a * SP + dpos] = 4;
                lbm[(size_t)a * SP + dpos] = 4;
                memset(&bs[(size_t)(a + 5) * nseq], 0, nseq);
                continue;
            }
            for (int e = 0; e < 5; e++) {
                const double *se = sc + ((size_t)e * SP + dpos - 1) * 6;
                int c = lbm[(size_t)e * SP + dpos - 1];
                if (cnts[5] && se[5] == MINLOG) {
                    sa[e] = MINLOG;
                    errs[e] = MINLOG;
                } else {
                    double tot = 0.0;
                    const int base_i = a + c * 25;
                    const uint8_t *bse = &bs[(size_t)e * nseq];
                    for (int k = 0; k < nrb; k++) {
                        int d = bse[rid_l[k]];
                        tot += dpvals[dptable[base_i + b_l[k] * 5 + d * 125]
                                      >> 3];
                    }
                    sa[e] = tot;
                    errs[e] = tot + se[5];
                }
                errs[e + 5] = errs[e];
            }
            double s5 = MINLOG;
            for (int e = 5; e < 10; e++) s5 = sum_log2(s5, errs[e]);
            sa[5] = s5;
            int bt = 4;
            for (int e = 0; e < 4; e++)
                if (errs[e] > errs[bt]) bt = e;
            btm[(size_t)a * SP + dpos] = (uint8_t)bt;
            int lb_prev = lbm[(size_t)bt * SP + dpos - 1];
            lbm[(size_t)a * SP + dpos] = (uint8_t)(a < 4 ? a : lb_prev);
            uint8_t *bsa = &bs[(size_t)(a + 5) * nseq];
            const uint8_t *bsbt = &bs[(size_t)bt * nseq];
            for (int rid = 0; rid < nseq; rid++) {
                int b = qs[rid];
                if (b > 4) {
                    bsa[rid] = 4;
                    continue;
                }
                int f = dptable[a + b * 5 + lb_prev * 25 + bsbt[rid] * 125];
                bsa[rid] = (uint8_t)(f & 0x7);
            }
        }
        memcpy(&bs[0], &bs[(size_t)5 * nseq], (size_t)5 * nseq);
    }
}

// ---- edit-distance delta row (striped_seqedit truth tables,
// bsalign.h:723-765; oracle/edit._row_trans) ----
extern "C" void bsa_edit_row(const i8 *u_prev, const uint8_t *match, int n,
                             int v_in, i8 *u_new) {
    int v = v_in;
    for (int x = 0; x < n; x++) {
        const int up = u_prev[x];
        const int h = (match[x] || up == -1 || v == -1) ? 0 : 1;
        u_new[x] = (i8)(h - v);
        v = h - up;
    }
}

// ---- backcal traceback (bsalign.h:3704-3852 / oracle/banded8.backcal) ----
// Re-derives the alignment path from stored u/e/q difference planes +
// stripe anchors by score identities, emitting a SAM-coded CIGAR. Planes
// are passed as batch-strided pointers ([T, BW, B] laid out row-major with
// per-pair stride B) so no per-pair repacking is needed.
struct BackcalRS {
    i64 score, qb, qe, tb, te, mat, mis, ins, del_, aln;
};

extern "C" long bsa8_backcal(
    const uint8_t *qseq, long qlen, const uint8_t *tseq, long tlen,
    const i8 *init_us, const i64 *init_ub,               // [W*16], [17]
    const i8 *us_p, const i8 *es_p, const i8 *qs_p,      // [T,BW,B] strided
    const i32 *ub_p, int ubr,                            // [T,ubr,B] strided
    const i32 *begs_p,                                   // [T,B] strided
    long B, long b,                                      // batch stride+index
    int is_overlap, int bandwidth, const i8 *mtx,        // [16]
    int gapo1, int gape1, int gapo2, int gape2, int piecewise,
    BackcalRS *rs, uint32_t *cg_out, long cg_cap) {
    const int W = bandwidth / WSZ;
    const long BW = bandwidth;

    auto getscore_row = [&](long i, long pos) -> i64 {
        // absolute H at natural band pos of row i (i==-1 -> init row)
        const int x = (int)(pos % W);
        const int y = (int)(pos / W);
        i64 s;
        if (i < 0) {
            s = init_ub[y];
            for (int k = 0; k <= x; k++) s += init_us[(size_t)k * WSZ + y];
        } else {
            s = ub_p[((size_t)i * ubr + y) * B + b];
            const i8 *us = us_p + (size_t)i * BW * B + b;
            for (int k = 0; k <= x; k++) s += us[((size_t)k * WSZ + y) * B];
        }
        return s;
    };
    auto beg_of = [&](long i) -> long {
        return i < 0 ? 0 : (long)begs_p[(size_t)i * B + b];
    };
    auto score_at = [&](long row, long col) -> i64 {
        return getscore_row(row, col - beg_of(row));
    };

    // back-to-front cigar accumulator (_push_cigar_bsalign)
    std::vector<uint32_t> acc;
    uint32_t cg = 0;
    auto push = [&](uint32_t op, uint32_t sz) {
        if (op == (cg & 0xF)) {
            cg += sz << 4;
        } else {
            if (cg) acc.push_back(cg);
            cg = (sz << 4) | op;
        }
    };

    rs->qb = rs->qe;
    rs->qe += 1;
    rs->tb = rs->te;
    rs->te += 1;
    rs->mat = rs->mis = rs->ins = rs->del_ = rs->aln = 0;
    i64 Hs0 = 0, Hs1 = score_at(rs->tb, rs->qb), Hs2 = 0;
    int prior_match = 0;
    for (;;) {
        if ((Hs2 & 0xF) == 2) {
            Hs0 = score_at(rs->tb, rs->qb);
            i64 t = gapo1 + (Hs2 >> 4) * (i64)gape1;
            if (Hs0 + t == Hs1) {
                push(2, (uint32_t)(Hs2 >> 4));
                rs->del_ += Hs2 >> 4;
                rs->aln += Hs2 >> 4;
                Hs1 = Hs0;
                Hs2 = 0;
            } else {
                Hs2 += 1 << 4;
                rs->tb -= 1;
                continue;
            }
        } else if ((Hs2 & 0xF) == 4) {
            Hs0 = score_at(rs->tb, rs->qb);
            i64 t = gapo2 + (Hs2 >> 4) * (i64)gape2;
            if (Hs0 + t == Hs1) {
                push(2, (uint32_t)(Hs2 >> 4));
                rs->del_ += Hs2 >> 4;
                rs->aln += Hs2 >> 4;
                Hs1 = Hs0;
                Hs2 = 0;
            } else {
                Hs2 += 1 << 4;
                rs->tb -= 1;
                continue;
            }
        }
        if (rs->qb < 0 || rs->tb < 0) break;
        if (rs->qb == beg_of(rs->tb - 1)) {
            if (rs->qb) {
                Hs0 = (rs->tb - 1 < 0) ? init_ub[0]
                      : ub_p[((size_t)(rs->tb - 1) * ubr + 0) * B + b];
                prior_match = 0;
            } else {
                if (is_overlap || rs->tb == 0) {
                    Hs0 = 0;
                } else if (piecewise < 2) {
                    Hs0 = gapo1 + (i64)gape1 * rs->tb;
                } else {
                    i64 t1 = gapo1 + (i64)gape1 * rs->tb;
                    i64 t2 = gapo2 + (i64)gape2 * rs->tb;
                    Hs0 = t1 > t2 ? t1 : t2;
                }
            }
        } else {
            Hs0 = score_at(rs->tb - 1, rs->qb - 1);
        }
        const long x = rs->qb - beg_of(rs->tb - 1);
        int uval = 0, eval_ = gapo1 + gape1, qval = 0;
        if (x >= 0 && x < BW) {
            const int si = (int)(x % W), sj = (int)(x / W);
            const size_t off = ((size_t)si * WSZ + sj) * B + b;
            if (rs->tb - 1 < 0) {
                uval = init_us[(size_t)si * WSZ + sj];
                eval_ = piecewise ? SCORE_EPI8_MIN : gapo1 + gape1;
                // oracle: init row es is SCORE_EPI8_MIN when piecewise
                if (!piecewise) eval_ = gapo1 + gape1;
                qval = piecewise == 2 ? SCORE_EPI8_MIN : 0;
            } else {
                const size_t rowo = (size_t)(rs->tb - 1) * BW * B;
                uval = us_p[rowo + off];
                eval_ = es_p ? es_p[rowo + off] : gapo1 + gape1;
                qval = qs_p ? qs_p[rowo + off] : 0;
            }
        }
        // cell rule (bsalign.h:3667-3702)
        const int s = mtx[qseq[rs->qb] * 4 + tseq[rs->tb]];
        const i64 h = Hs1 - Hs0;
        int bt;
        if (x > BW) {
            bt = 1;
        } else if (x == BW) {
            bt = (h == s) ? 0 : 1;
        } else if (prior_match) {
            if (h == s) bt = 0;
            else if (h == (i64)uval + eval_) bt = 2;
            else if (piecewise == 2 && h == (i64)uval + qval) bt = 4;
            else bt = 1;
        } else {
            if (h == (i64)uval + eval_) bt = 2;
            else if (piecewise == 2 && h == (i64)uval + qval) bt = 4;
            else if (h == s) bt = 0;
            else bt = 1;
        }
        prior_match = 1;
        if (bt == 0) {
            if (qseq[rs->qb] == tseq[rs->tb]) rs->mat += 1;
            else rs->mis += 1;
            rs->qb -= 1;
            rs->tb -= 1;
            rs->aln += 1;
            push(0, 1);
            Hs1 = Hs0;
        } else if (bt == 1) {
            if (rs->qb <= 0) {
                push(1, 1);
                Hs1 = Hs0;
                rs->qb -= 1;
                rs->ins += 1;
                rs->aln += 1;
            } else {
                long sz = 1;
                while (sz + beg_of(rs->tb) <= rs->qb) {
                    i64 t;
                    if (piecewise == 2) {
                        i64 t1 = gapo1 + sz * (i64)gape1;
                        i64 t2 = gapo2 + sz * (i64)gape2;
                        t = t1 > t2 ? t1 : t2;
                    } else {
                        t = gapo1 + sz * (i64)gape1;
                    }
                    Hs0 = score_at(rs->tb, rs->qb - sz);
                    if (Hs0 + t == Hs1) {
                        push(1, (uint32_t)sz);
                        Hs1 = Hs0;
                        rs->qb -= sz;
                        rs->ins += sz;
                        rs->aln += sz;
                        break;
                    }
                    sz += 1;
                }
            }
        } else {
            Hs2 = (1 << 4) | bt;
            rs->tb -= 1;
            continue;
        }
    }
    if (!is_overlap) {
        uint32_t op = 0;
        long sz = 0;
        if (rs->qb >= 0) {
            op = 1;
            sz = rs->qb + 1;
            rs->ins += sz;
            rs->qb = -1;
        } else if (rs->tb >= 0) {
            op = 2;
            sz = rs->tb + 1;
            rs->del_ += sz;
            rs->tb = -1;
        }
        rs->aln += sz;
        if (sz) push(op, (uint32_t)sz);
    }
    if (cg) acc.push_back(cg);
    rs->qb += 1;
    rs->tb += 1;
    const long n = (long)acc.size() < cg_cap ? (long)acc.size() : cg_cap;
    for (long k = 0; k < n; k++) cg_out[k] = acc[acc.size() - 1 - k];
    return (long)acc.size();
}

// Walk packed 4-bit traceback codes into a CIGAR — the C twin of
// btcodes.decode_codes (itself bit-exact vs backcal, bsalign.h:3704-3852).
// codes is the device kernel's raw [T, CPW, WS, B] int32 output: 8 cells
// packed per word along x of the natural band pos p = y*W + x. O(path)
// nibble reads — no unpacking pass.
extern "C" long bsa_decode_codes(
    const uint8_t *qseq, const uint8_t *tseq,
    const i32 *codes, int CPW,                           // [T,CPW,16,B]
    const i32 *begs_p,                                   // [T,B] strided
    const uint8_t *init_eo,                              // [BW]
    long B, long b, int is_overlap, int bandwidth,
    BackcalRS *rs, uint32_t *cg_out, long cg_cap) {
    const int W = bandwidth / WSZ;
    const long BW = bandwidth;

    auto beg_of = [&](long i) -> long {
        return i < 0 ? 0 : (long)begs_p[(size_t)i * B + b];
    };
    auto code_at = [&](long t, long p) -> int {          // p: band index
        const int x = (int)(p % W), y = (int)(p / W);
        const i32 w =
            codes[(((size_t)t * CPW + (x >> 3)) * WSZ + y) * B + b];
        return (w >> (4 * (x & 7))) & 15;
    };
    auto eo_bit = [&](long j, long p) -> bool {
        if (j <= -2) return true;
        if (j == -1) return (p >= 0 && p < BW) ? (init_eo[p] != 0) : true;
        const long xi = p - beg_of(j);
        if (xi >= 0 && xi < BW) return (code_at(j, xi) & 4) != 0;
        return true;   // out-of-band: open (backcal default e' = GapOE)
    };
    auto fo_bit = [&](long j, long p) -> bool {
        const long xi = p - beg_of(j);
        if (xi >= 0 && xi < BW) return (code_at(j, xi) & 8) != 0;
        return true;
    };

    std::vector<uint32_t> acc;
    uint32_t cg = 0;
    auto push = [&](uint32_t op, uint32_t sz) {
        if (op == (cg & 0xF)) {
            cg += sz << 4;
        } else {
            if (cg) acc.push_back(cg);
            cg = (sz << 4) | op;
        }
    };

    rs->qb = rs->qe;
    rs->qe += 1;
    rs->tb = rs->te;
    rs->te += 1;
    rs->mat = rs->mis = rs->ins = rs->del_ = rs->aln = 0;
    long qb = rs->qb, tb = rs->tb;
    int prior_match = 0;
    while (qb >= 0 && tb >= 0) {
        const long bprev = tb >= 1 ? beg_of(tb - 1) : 0;
        const long x = qb - bprev;
        if (qb == bprev && qb > 0) prior_match = 0;
        const long xi = qb - beg_of(tb);
        const int ci = (xi >= 0 && xi < BW) ? code_at(tb, xi) : 0;
        const int m = ci & 1, d = (ci >> 1) & 1;
        int bt;
        if (x > BW) bt = 1;
        else if (x == BW) bt = m ? 0 : 1;
        else if (prior_match) bt = m ? 0 : (d ? 2 : 1);
        else bt = d ? 2 : (m ? 0 : 1);
        prior_match = 1;
        if (bt == 0) {            // M
            if (qseq[qb] == tseq[tb]) rs->mat += 1;
            else rs->mis += 1;
            push(0, 1);
            rs->aln += 1;
            qb -= 1;
            tb -= 1;
        } else if (bt == 2) {     // D run: walk up until the E chain opens
            long sz = 1, j = tb - 1;
            while (!eo_bit(j, qb) && j >= 0) {
                sz += 1;
                j -= 1;
            }
            push(2, (uint32_t)sz);
            rs->del_ += sz;
            rs->aln += sz;
            tb -= sz;
        } else {                  // I run: walk left until the F chain opens
            if (qb <= 0) {
                push(1, 1);
                rs->ins += 1;
                rs->aln += 1;
                qb -= 1;
            } else {
                long sz = 1, p = qb;
                while (!fo_bit(tb, p) && sz + beg_of(tb) <= qb) {
                    sz += 1;
                    p -= 1;
                }
                push(1, (uint32_t)sz);
                rs->ins += sz;
                rs->aln += sz;
                qb -= sz;
            }
        }
    }
    rs->qb = qb;
    rs->tb = tb;
    if (!is_overlap) {
        uint32_t op = 0;
        long sz = 0;
        if (rs->qb >= 0) {
            op = 1;
            sz = rs->qb + 1;
            rs->ins += sz;
            rs->qb = -1;
        } else if (rs->tb >= 0) {
            op = 2;
            sz = rs->tb + 1;
            rs->del_ += sz;
            rs->tb = -1;
        }
        rs->aln += sz;
        if (sz) push(op, (uint32_t)sz);
    }
    if (cg) acc.push_back(cg);
    rs->qb += 1;
    rs->tb += 1;
    const long n = (long)acc.size() < cg_cap ? (long)acc.size() : cg_cap;
    for (long k = 0; k < n; k++) cg_out[k] = acc[acc.size() - 1 - k];
    return (long)acc.size();
}

// Resumable chunked walk of packed traceback codes: advances all B pairs'
// tracebacks through band rows [t0, t1). The two-pass long-read driver
// (align/pairwise.py) runs a scores-only forward first, then re-forwards
// row chunks in REVERSE order (from checkpointed chunk-entry states) and
// calls this per chunk — so 100 kb targets never hold full-T code buffers.
// Per-pair walk state persists in st[] (int64 x WK_NST) between calls;
// completed CIGAR words are appended to cg_out per call in WALK order
// (reverse of final order — the driver reverses once at the end).
// Walk semantics are identical to bsa_decode_codes above.
enum { WK_QB, WK_TB, WK_PM, WK_DJ, WK_CG, WK_NCG, WK_MAT, WK_MIS,
       WK_INS, WK_DEL, WK_ALN, WK_DONE, WK_NST };
static const long long WK_NOJ = -(1LL << 60);

extern "C" long bsa_walk_codes_chunk(
    const uint8_t *qflat, const i64 *qoffs,              // [sum qlen], [B+1]
    const uint8_t *tflat, const i64 *toffs,
    const i32 *codes, int CPW,                           // [t1-t0,CPW,16,B]
    const i32 *begs_c,                                   // [t1-t0, B]
    const i32 *beg_prev,                                 // [B]: beg(t0-1)
    const uint8_t *init_eo,                              // [BW]
    long B, long t0, long t1, int is_overlap, int bandwidth,
    long long *st,                                       // [B, WK_NST]
    uint32_t *cg_out, long cg_cap) {                     // [B, cg_cap]
    const int W = bandwidth / WSZ;
    const long BW = bandwidth;
    long err = 0;
    for (long b = 0; b < B; b++) {
        long long *s = st + b * WK_NST;
        s[WK_NCG] = 0;
        if (s[WK_DONE]) continue;
        const uint8_t *qseq = qflat + qoffs[b];
        const uint8_t *tseq = tflat + toffs[b];
        long qb = s[WK_QB], tb = s[WK_TB];
        if (tb < t0 && s[WK_DJ] == WK_NOJ) continue;     // earlier chunk
        uint32_t cg = (uint32_t)s[WK_CG];
        long ncg = 0;
        uint32_t *out = cg_out + b * cg_cap;
        bool full = false;
        auto push = [&](uint32_t op, uint32_t sz) {
            if (op == (cg & 0xF)) {
                cg += sz << 4;
            } else {
                if (cg) {
                    if (ncg >= cg_cap) { full = true; return; }
                    out[ncg++] = cg;
                }
                cg = (sz << 4) | op;
            }
        };
        auto beg_of = [&](long j) -> long {
            if (j < 0) return 0;
            if (j < t0) return (long)beg_prev[b];        // j == t0-1 only
            return (long)begs_c[(size_t)(j - t0) * B + b];
        };
        auto code_at = [&](long j, long p) -> int {      // j in [t0, t1)
            const int x = (int)(p % W), y = (int)(p / W);
            const i32 w = codes[
                (((size_t)(j - t0) * CPW + (x >> 3)) * WSZ + y) * B + b];
            return (w >> (4 * (x & 7))) & 15;
        };
        auto eo_bit = [&](long j, long p) -> bool {      // j >= t0 or j < 0
            if (j <= -2) return true;
            if (j == -1) return (p >= 0 && p < BW) ? (init_eo[p] != 0)
                                                   : true;
            const long xi = p - beg_of(j);
            if (xi >= 0 && xi < BW) return (code_at(j, xi) & 4) != 0;
            return true;
        };
        auto fo_bit = [&](long j, long p) -> bool {
            const long xi = p - beg_of(j);
            if (xi >= 0 && xi < BW) return (code_at(j, xi) & 8) != 0;
            return true;
        };
        int prior_match = (int)s[WK_PM];
        // resume a D-run that paused at this chunk's lower edge
        if (s[WK_DJ] != WK_NOJ) {
            long j = (long)s[WK_DJ];
            long sz = tb - j;
            bool paused = false;
            while (true) {
                if (j >= 0 && j < t0) {                  // pause again
                    s[WK_DJ] = j;
                    paused = true;
                    break;
                }
                if (!(j >= 0) || eo_bit(j, qb)) break;
                sz += 1;
                j -= 1;
            }
            if (paused) { s[WK_QB] = qb; s[WK_TB] = tb; s[WK_PM] = prior_match;
                          s[WK_CG] = cg; s[WK_NCG] = ncg; continue; }
            s[WK_DJ] = WK_NOJ;
            push(2, (uint32_t)sz);
            s[WK_DEL] += sz;
            s[WK_ALN] += sz;
            tb -= sz;
        }
        while (!full && qb >= 0 && tb >= 0) {
            if (tb < t0) break;                          // next (earlier) chunk
            const long bprev = tb >= 1 ? beg_of(tb - 1) : 0;
            const long x = qb - bprev;
            if (qb == bprev && qb > 0) prior_match = 0;
            const long xi = qb - beg_of(tb);
            const int ci = (xi >= 0 && xi < BW) ? code_at(tb, xi) : 0;
            const int m = ci & 1, d = (ci >> 1) & 1;
            int bt;
            if (x > BW) bt = 1;
            else if (x == BW) bt = m ? 0 : 1;
            else if (prior_match) bt = m ? 0 : (d ? 2 : 1);
            else bt = d ? 2 : (m ? 0 : 1);
            prior_match = 1;
            if (bt == 0) {            // M
                if (qseq[qb] == tseq[tb]) s[WK_MAT] += 1;
                else s[WK_MIS] += 1;
                push(0, 1);
                s[WK_ALN] += 1;
                qb -= 1;
                tb -= 1;
            } else if (bt == 2) {     // D run: walk up until the E chain opens
                long sz = 1, j = tb - 1;
                bool paused = false;
                while (true) {
                    if (j >= 0 && j < t0) {
                        s[WK_DJ] = j;
                        paused = true;
                        break;
                    }
                    if (!(j >= 0) || eo_bit(j, qb)) break;
                    sz += 1;
                    j -= 1;
                }
                if (paused) break;
                push(2, (uint32_t)sz);
                s[WK_DEL] += sz;
                s[WK_ALN] += sz;
                tb -= sz;
            } else {                  // I run: walk left until F chain opens
                if (qb <= 0) {
                    push(1, 1);
                    s[WK_INS] += 1;
                    s[WK_ALN] += 1;
                    qb -= 1;
                } else {
                    long sz = 1, p = qb;
                    while (!fo_bit(tb, p) && sz + beg_of(tb) <= qb) {
                        sz += 1;
                        p -= 1;
                    }
                    push(1, (uint32_t)sz);
                    s[WK_INS] += sz;
                    s[WK_ALN] += sz;
                    qb -= sz;
                }
            }
        }
        if (full) { s[WK_DONE] = 2; err = -1; }
        else if (qb < 0 || tb < 0) {                     // finalize this pair
            if (!is_overlap) {
                uint32_t op = 0;
                long sz = 0;
                if (qb >= 0) {
                    op = 1;
                    sz = qb + 1;
                    s[WK_INS] += sz;
                    qb = -1;
                } else if (tb >= 0) {
                    op = 2;
                    sz = tb + 1;
                    s[WK_DEL] += sz;
                    tb = -1;
                }
                s[WK_ALN] += sz;
                if (sz) push(op, (uint32_t)sz);
            }
            if (cg) {
                if (ncg >= cg_cap) { s[WK_DONE] = 2; err = -1; }
                else out[ncg++] = cg;
            }
            cg = 0;
            if (s[WK_DONE] != 2) s[WK_DONE] = 1;
        }
        s[WK_QB] = qb;
        s[WK_TB] = tb;
        s[WK_PM] = prior_match;
        s[WK_CG] = cg;
        s[WK_NCG] = ncg;
    }
    return err;
}

// ---- POA graph edge ops over SoA arrays (bspoa.h:430-736) ----
// Arrays are the same memory the Python Graph exposes; estate =
// [edge_count, recycle_count, capacity, error].
struct GEdges {
    i32 *nd_cov, *nd_nin, *nd_nou, *nd_edge, *nd_erev;
    const i32 *nd_header;
    i32 *ed_node, *ed_cov, *ed_vst, *ed_next;
    i64 *estate;
    i32 *ecyc;
};

static long g_get_edge(GEdges &G, long u, long v) {
    long eidx = G.nd_edge[u];
    while (eidx) {
        if (G.ed_node[eidx] == v) return eidx;
        eidx = G.ed_next[eidx];
    }
    return 0;
}

static long g_new_edge(GEdges &G, long u, long v, long cov) {
    long eidx;
    if (G.estate[1] > 0) {
        G.estate[1] -= 1;
        eidx = G.ecyc[G.estate[1]];
    } else {
        if (G.estate[0] + 2 > G.estate[2]) {
            G.estate[3] = 1;  // capacity exhausted (caller pre-encaps)
            return -1;
        }
        eidx = G.estate[0];
        G.estate[0] += 2;
    }
    G.ed_vst[eidx] = G.ed_vst[eidx + 1] = 0;
    G.ed_next[eidx] = G.ed_next[eidx + 1] = 0;
    G.ed_node[eidx] = (i32)v;
    G.ed_node[eidx + 1] = (i32)u;
    G.ed_cov[eidx] = (i32)cov;
    G.ed_cov[eidx + 1] = (i32)cov;
    return eidx;
}

static void g_add_edge_core(GEdges &G, long v, long eidx) {
    i32 *headp;
    if (eidx & 1) {
        G.nd_nin[v] += 1;
        headp = &G.nd_erev[v];
    } else {
        G.nd_nou[v] += 1;
        headp = &G.nd_edge[v];
    }
    const i32 ecov = G.ed_cov[eidx];
    long head = *headp;
    if (head == 0) {
        *headp = (i32)eidx;
        return;
    }
    if (ecov > G.ed_cov[head]) {
        G.ed_next[eidx] = (i32)head;
        *headp = (i32)eidx;
        return;
    }
    long p = head;
    while (G.ed_next[p]) {
        long f = G.ed_next[p];
        if (ecov > G.ed_cov[f]) break;
        p = f;
    }
    G.ed_next[eidx] = G.ed_next[p];
    G.ed_next[p] = (i32)eidx;
}

static void g_del_edge_core(GEdges &G, long v, long eidx) {
    i32 *headp = (eidx & 1) ? &G.nd_erev[v] : &G.nd_edge[v];
    long cur = *headp, prev = -1;
    while (cur) {
        if (cur == eidx) {
            if (prev < 0) *headp = G.ed_next[eidx];
            else G.ed_next[prev] = G.ed_next[eidx];
            G.ed_next[eidx] = 0;
            break;
        }
        prev = cur;
        cur = G.ed_next[cur];
    }
    if (!cur) { G.estate[3] = 2; return; }   // edge not found
    if (eidx & 1) {
        G.nd_nin[v] -= 1;
    } else {
        G.nd_nou[v] -= 1;
        G.ecyc[G.estate[1]] = (i32)eidx;
        G.estate[1] += 1;
    }
}

static long g_chg_edge(GEdges &G, long _u, long _v, long cov) {
    if (cov == 0) return 0;
    long u = G.nd_header[_u];
    long v = G.nd_header[_v];
    if (u == v) return 0;
    long eidx = g_get_edge(G, u, v);
    long existed = 0;
    long ncov = cov;
    if (eidx) {
        existed = 1;
        ncov = G.ed_cov[eidx] + cov;
        g_del_edge_core(G, u, eidx);
        g_del_edge_core(G, v, eidx + 1);
    }
    if (ncov > 0) {
        eidx = g_new_edge(G, u, v, ncov);
        if (eidx < 0) return -1;
        g_add_edge_core(G, u, eidx);
        g_add_edge_core(G, v, eidx + 1);
        return (eidx << 1) | existed;
    }
    return existed ? 1 : 0;
}

#define GEDGE_ARGS                                                     \
    i32 *nd_cov, i32 *nd_nin, i32 *nd_nou, i32 *nd_edge, i32 *nd_erev, \
    const i32 *nd_header, i32 *ed_node, i32 *ed_cov, i32 *ed_vst,      \
    i32 *ed_next, i64 *estate, i32 *ecyc
#define GEDGE_PACK                                                        \
    GEdges G{nd_cov, nd_nin, nd_nou, nd_edge, nd_erev, nd_header,         \
             ed_node, ed_cov, ed_vst, ed_next, estate, ecyc}

extern "C" long bsa_g_chg_edge(GEDGE_ARGS, long u, long v, long cov) {
    GEDGE_PACK;
    return g_chg_edge(G, u, v, cov);
}

// Move u's edges (dirn 0=out, 1=in) to v per movtype (bspoa.h:689-736).
extern "C" long bsa_g_mov_node_edges(GEDGE_ARGS, long u, long v, long spec,
                                     long dirn, long movtype) {
    GEDGE_PACK;
    // collect first: chg_edge mutates the list being walked
    thread_local std::vector<long> chg_a, chg_b, chg_c;
    chg_a.clear(); chg_b.clear(); chg_c.clear();
    long eidx = dirn ? G.nd_erev[u] : G.nd_edge[u];
    while (eidx) {
        const long ecov = G.ed_cov[eidx];
        const long w = G.ed_node[eidx];
        eidx = G.ed_next[eidx];
        long covs[4] = {0, 0, 0, 0};
        if (w == spec) covs[1] = ecov;
        else covs[0] = ecov;
        for (int i = 0; i < 2; i++) {
            for (int j = 0; j < 2; j++) {
                const long t = (movtype >> (4 * (i * 2 + j))) & 0xF;
                if (t == 0xF) covs[3 - j] += covs[i];
                else if (t == 0xE) covs[3 - j] += covs[i] > 1 ? covs[i] - 1 : 0;
                else if (t == 0x1) covs[3 - j] += covs[i] < 1 ? covs[i] : 1;
            }
        }
        if (dirn) {
            chg_a.push_back(w); chg_b.push_back(u); chg_c.push_back(covs[2] - ecov);
            chg_a.push_back(w); chg_b.push_back(v); chg_c.push_back(covs[3]);
        } else {
            chg_a.push_back(u); chg_b.push_back(w); chg_c.push_back(covs[2] - ecov);
            chg_a.push_back(v); chg_b.push_back(w); chg_c.push_back(covs[3]);
        }
    }
    for (size_t k = 0; k < chg_a.size(); k++) {
        if (chg_c[k] == 0) continue;
        if (g_chg_edge(G, chg_a[k], chg_b[k], chg_c[k]) < 0) return -1;
    }
    return 0;
}

// ---- whole-op POA graph mutators (cut/merge/connect, bspoa.h:622-894) ----
// Full SoA view: all 11 node arrays + 4 edge arrays + state.
struct GFull {
    i32 *rid, *cov, *rdc, *rdd, *nin, *nou, *edge, *erev, *nxt, *prv, *hdr;
    GEdges E;
};

static inline void g_connect_idx(GFull &G, long u, long v) {
    if (G.rdc[v]) return;
    g_chg_edge(G.E, u, v, 1);
    G.rdd[u] = 1;
    G.rdc[v] = 1;
}

static inline void g_disconnect_idx(GFull &G, long u, long v) {
    if (G.rdd[u] == 0) return;
    g_chg_edge(G.E, u, v, -1);
    G.rdd[u] = 0;
    G.rdc[v] = 0;
}

static long g_mov(GFull &G, long u, long v, long spec, long dirn,
                  long movtype);

#define MOVALL_C 0x0F0F
#define KPTONE_C 0x1E0F
#define MOVONE_C 0xE1F0

static long g_mov(GFull &G, long u, long v, long spec, long dirn,
                  long movtype) {
    thread_local std::vector<long> a_, b_, c_;
    a_.clear(); b_.clear(); c_.clear();
    long eidx = dirn ? G.erev[u] : G.edge[u];
    while (eidx) {
        const long ecov = G.E.ed_cov[eidx];
        const long w = G.E.ed_node[eidx];
        eidx = G.E.ed_next[eidx];
        long covs[4] = {0, 0, 0, 0};
        if (w == spec) covs[1] = ecov;
        else covs[0] = ecov;
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 2; j++) {
                const long t = (movtype >> (4 * (i * 2 + j))) & 0xF;
                if (t == 0xF) covs[3 - j] += covs[i];
                else if (t == 0xE) covs[3 - j] += covs[i] > 1 ? covs[i] - 1 : 0;
                else if (t == 0x1) covs[3 - j] += covs[i] < 1 ? covs[i] : 1;
            }
        if (dirn) {
            a_.push_back(w); b_.push_back(u); c_.push_back(covs[2] - ecov);
            a_.push_back(w); b_.push_back(v); c_.push_back(covs[3]);
        } else {
            a_.push_back(u); b_.push_back(w); c_.push_back(covs[2] - ecov);
            a_.push_back(v); b_.push_back(w); c_.push_back(covs[3]);
        }
    }
    for (size_t k = 0; k < a_.size(); k++) {
        if (c_[k] == 0) continue;
        if (g_chg_edge(G.E, a_[k], b_[k], c_[k]) < 0) return -1;
    }
    return 0;
}


static int g_merge_rings(GFull &G, long un, long vn) {
    long h0 = G.hdr[un], h1 = G.hdr[vn];
    if (h0 == h1) return 0;
    const long ncov = (long)G.cov[h0] + G.cov[h1];
    if (G.cov[h0] < G.cov[h1]) { long t = h0; h0 = h1; h1 = t; }
    else if (G.cov[h0] > G.cov[h1]) {}
    else if (G.rid[h0] > G.rid[h1]) { long t = h0; h0 = h1; h1 = t; }
    if (g_mov(G, h1, h0, -1, 0, MOVALL_C) < 0) return -1;
    if (g_mov(G, h1, h0, -1, 1, MOVALL_C) < 0) return -1;
    G.cov[h0] = (i32)ncov;
    long x = h1;
    for (;;) {
        G.hdr[x] = (i32)h0;
        if (G.nxt[x] == h1) break;
        x = G.nxt[x];
    }
    const long p0 = G.prv[h0], p1 = G.prv[h1];
    G.prv[h0] = (i32)p1;
    G.prv[h1] = (i32)p0;
    G.nxt[p1] = (i32)h0;
    G.nxt[p0] = (i32)h1;
    return 0;
}

#define GFULL_ARGS \
    i32 *nd_rid, i32 *nd_cov, i32 *nd_rdc, i32 *nd_rdd, i32 *nd_nin,      \
    i32 *nd_nou, i32 *nd_edge, i32 *nd_erev, i32 *nd_next, i32 *nd_prev,  \
    i32 *nd_header, i32 *ed_node, i32 *ed_cov, i32 *ed_vst, i32 *ed_next, \
    i64 *estate, i32 *ecyc
#define GFULL_PACK                                                         \
    GFull G{nd_rid, nd_cov, nd_rdc, nd_rdd, nd_nin, nd_nou, nd_edge,       \
            nd_erev, nd_next, nd_prev, nd_header,                          \
            GEdges{nd_cov, nd_nin, nd_nou, nd_edge, nd_erev, nd_header,    \
                   ed_node, ed_cov, ed_vst, ed_next, estate, ecyc}}

extern "C" long bsa_g_connect(GFULL_ARGS, long u, long v) {
    GFULL_PACK;
    g_connect_idx(G, u, v);
    return estate[3] ? -1 : 0;
}

extern "C" long bsa_g_disconnect(GFULL_ARGS, long u, long v) {
    GFULL_PACK;
    g_disconnect_idx(G, u, v);
    return estate[3] ? -1 : 0;
}

extern "C" long bsa_g_cut_rdnode(GFULL_ARGS, long nnodes, long nidx,
                                 long cut) {
    GFULL_PACK;
    const long node_after = nidx + 1, node_before = nidx - 1;
    // spec headers resolved with the Python guard (idx < len(nodes))
    auto spec_of = [&](long idx) -> long {
        return (idx >= 0 && idx < nnodes) ? (long)G.hdr[idx] : -1;
    };
    const long header0 = G.hdr[nidx], header1 = G.prv[nidx];
    const long nodecov = G.cov[G.hdr[nidx]];
    const long u_rdd = G.rdd[nidx], u_rdc = G.rdc[nidx];
    if ((cut & 2) && G.nxt[nidx] != nidx) {
        G.nxt[G.prv[nidx]] = G.nxt[nidx];
        G.prv[G.nxt[nidx]] = G.prv[nidx];
        G.nxt[nidx] = (i32)nidx;
        G.prv[nidx] = (i32)nidx;
        G.hdr[nidx] = (i32)nidx;
        long xref;
        if (header0 == nidx) {
            long x = header1;
            for (;;) {
                G.hdr[x] = (i32)header1;
                if (G.nxt[x] == header1) break;
                x = G.nxt[x];
            }
            g_mov(G, nidx, header1, spec_of(node_after), 0,
                  u_rdd ? KPTONE_C : MOVALL_C);
            g_mov(G, nidx, header1, spec_of(node_before), 1,
                  u_rdc ? KPTONE_C : MOVALL_C);
            xref = header1;
        } else {
            xref = header0;
            if (u_rdd)
                g_mov(G, xref, nidx, spec_of(node_after), 0, MOVONE_C);
            if (u_rdc)
                g_mov(G, xref, nidx, spec_of(node_before), 1, MOVONE_C);
        }
        G.cov[G.hdr[xref]] = (i32)(nodecov - 1);
        G.cov[G.hdr[nidx]] = 1;
    }
    if (cut & 1) {
        g_disconnect_idx(G, nidx - 1, nidx);
        g_disconnect_idx(G, nidx, nidx + 1);
    }
    return estate[3] ? -1 : nidx;
}

extern "C" long bsa_g_merge_nodes(GFULL_ARGS, long n1, long n2) {
    GFULL_PACK;
    if (g_merge_rings(G, n1, n2) < 0) return -1;
    return estate[3] ? -1 : G.hdr[n1];
}

extern "C" long bsa_gf_chg_edge(GFULL_ARGS, long u, long v, long cov) {
    GFULL_PACK;
    long r = g_chg_edge(G.E, u, v, cov);
    return estate[3] ? -1 : r;
}

extern "C" long bsa_gf_mov_node_edges(GFULL_ARGS, long u, long v, long spec,
                                      long dirn, long movtype) {
    GFULL_PACK;
    if (g_mov(G, u, v, spec, dirn, movtype) < 0) return -1;
    return estate[3] ? -1 : 0;
}

// ---- arena-slot variants of the POA row ops ----
// Rows live in one arena indexed by mmidx: us [nslot, W, 16] i8 (+es/qs),
// ubegs [nslot, 17] i64. One native call per row with 2 slot ints replaces
// per-call NumPy allocation + 8 pointer lookups.
extern "C" void bsa8_row_update_slot(
    i8 *aus, i8 *aes, i8 *aqs, i64 *aub, const i8 *qprof, int rbeg,
    int tbase, int W, int movx, int piecewise, int nt_max, int nt_min,
    int gapo1, int gape1, int gapo2, int gape2, int rh_mode, i64 rh_val,
    long src, long dst) {
    const size_t ps = (size_t)W * WSZ;
    bsa8_row_update(
        aus + src * ps, aes ? aes + src * ps : nullptr,
        aqs ? aqs + src * ps : nullptr, aub + src * (WSZ + 1),
        aus + dst * ps, aes ? aes + dst * ps : nullptr,
        aqs ? aqs + dst * ps : nullptr, aub + dst * (WSZ + 1),
        qprof, rbeg, tbase, W, movx, piecewise, nt_max, nt_min, gapo1,
        gape1, gapo2, gape2, rh_mode, rh_val);
}

extern "C" void bsa8_row_merge_slot(i8 *aus, i8 *aes, i8 *aqs, i64 *aub,
                                    int W, int piecewise, long src,
                                    long dst) {
    // in-place safe: every output element is written after its inputs at
    // the same index are consumed
    const size_t ps = (size_t)W * WSZ;
    bsa8_row_merge(
        aus + src * ps, aes ? aes + src * ps : nullptr,
        aqs ? aqs + src * ps : nullptr, aub + src * (WSZ + 1),
        aus + dst * ps, aes ? aes + dst * ps : nullptr,
        aqs ? aqs + dst * ps : nullptr, aub + dst * (WSZ + 1),
        aus + dst * ps, aes ? aes + dst * ps : nullptr,
        aqs ? aqs + dst * ps : nullptr, aub + dst * (WSZ + 1),
        W, piecewise);
}

// ---- whole-read POA forward DP (align_rd_bspoacore, bspoa.h:2515-2618) ----
// Kahn walk over the selected subgraph with per-edge row updates/merges in
// the slot arena; end-score candidates tracked with the reference's exact
// getscore/row_max arithmetic.
static i64 arena_getscore(const i8 *aus, const i64 *aub, long W, long slot,
                          long pos) {
    const long x = pos % W, y = pos / W;
    i64 s = aub[slot * (WSZ + 1) + y];
    const i8 *us = aus + slot * W * WSZ;
    for (long i = 0; i <= x; i++) s += us[i * WSZ + y];
    return s;
}

static void arena_row_max(const i8 *aus, const i64 *aub, long W, long slot,
                          i64 *score_out, long *pos_out) {
    // bsalign.h:3213-3329 tie-break tree, scalar port of oracle row_max
    const i8 *usp = aus + slot * W * WSZ;
    const i64 *ub = aub + slot * (WSZ + 1);
    const long STEP = 32;
    i64 Scr[WSZ], Max[WSZ], Idx[WSZ], Pos[WSZ];
    for (int j = 0; j < WSZ; j++) {
        Scr[j] = ub[j];
        Max[j] = SCORE_MIN_I;
        Idx[j] = j;
        Pos[j] = j;
    }
    long i = 0;
    while (i < W) {
        const long x = (i + STEP < W ? i + STEP : W) - i;
        i64 scr[WSZ], mx[WSZ];
        for (int j = 0; j < WSZ; j++) { scr[j] = 0; mx[j] = -0x7FFF; }
        for (long jj = 0; jj < x; jj++)
            for (int j = 0; j < WSZ; j++) {
                scr[j] += usp[(i + jj) * WSZ + j];
                if (scr[j] > mx[j]) mx[j] = scr[j];
            }
        for (int j = 0; j < WSZ; j++) {
            const i64 h = Scr[j] + mx[j];
            if (h > Max[j]) { Idx[j] = Pos[j]; Max[j] = h; }
            Scr[j] += scr[j];
            Pos[j] += 1 << 8;
        }
        i += x;
    }
    i64 M0[4], I0[4];
    for (int k = 0; k < 4; k++) { M0[k] = Max[k]; I0[k] = Idx[k]; }
    for (int k = 0; k < 4; k++) {
        if (Max[4 + k] > M0[k]) { I0[k] = Idx[4 + k]; M0[k] = Max[4 + k]; }
    }
    i64 M1[4], I1[4];
    for (int k = 0; k < 4; k++) { M1[k] = Max[8 + k]; I1[k] = Idx[8 + k]; }
    for (int k = 0; k < 4; k++) {
        if (Max[12 + k] > M1[k]) { I1[k] = Idx[12 + k]; M1[k] = Max[12 + k]; }
    }
    for (int k = 0; k < 4; k++) {
        if (M1[k] > M0[k]) { I0[k] = I1[k]; M0[k] = M1[k]; }
    }
    i64 max_score = M0[0];
    int xk = 0;
    for (int k = 1; k < 4; k++) {
        if (M0[k] > max_score) { max_score = M0[k]; xk = k; }
    }
    const long enc = I0[xk];
    const long lane = enc & 0xFF;
    const long chunk = enc >> 8;
    const long yl = (chunk + 1) * STEP < W ? (chunk + 1) * STEP : W;
    long j_best = chunk * STEP;
    i64 umax = SCORE_MIN_I, uscr = 0;
    for (long j = chunk * STEP; j < yl; j++) {
        uscr += usp[j * WSZ + lane];
        if (uscr > umax) { j_best = j; umax = uscr; }
    }
    *pos_out = lane * W + j_best;
    *score_out = max_score;
}

// row_max over a batch of final rows laid out as slots: us [B, W, WSZ]
// int8, ubegs [B, WSZ + 1] int64; pair b's natural position and score
// land in pos_out[b] and score_out[b]
extern "C" void bsa_row_max_batch(const i8 *us, const i64 *ub, long W,
                                  long B, i64 *score_out, long *pos_out) {
    for (long b = 0; b < B; b++)
        arena_row_max(us, ub, W, b, score_out + b, pos_out + b);
}

extern "C" long bsa_align_rd_core(
    // node arrays
    i32 *nd_mpos, i32 *nd_vst, i32 *nd_nct, i32 *nd_mmidx,
    const i32 *nd_base, const i32 *nd_bonus, const i32 *nd_rpos,
    const i32 *nd_edge, const i32 *ed_node, const i32 *ed_next,
    const uint8_t *states,                 // bitmap over nodes
    const i32 *sels, long nsel,
    // arena + profiles
    i8 *aus, i8 *aes, i8 *aqs, i64 *aub,
    const i8 *qp0, const i8 *qp1, const i8 *qp2, const i8 *qp3,
    // scalars
    long W, long bandwidth, long slen, long piecewise, long nt_max,
    long nt_min, long gapo1, long gape1, long gapo2, long gape2, long parT,
    long is_overlap, long is_global, long nhead, long ntail,
    // in/out best: [score, idx, off]
    i64 *best, i32 *stack_buf, long stack_cap) {
    const i8 *qps[4] = {qp0, qp1, qp2, qp3};
    for (long k = 0; k < nsel; k++) nd_mpos[sels[k]] = 0x7FFFFFFF - 1;
    nd_mpos[nhead] = -1;
    long sp = 0;
    stack_buf[sp++] = (i32)nhead;
    i64 maxscr = best[0];
    long maxidx = best[1], maxoff = best[2];
    while (sp > 0) {
        const long nidx = stack_buf[--sp];
        const long u_mpos = nd_mpos[nidx];
        const long u_mm = nd_mmidx[nidx];
        const long u_rpos = nd_rpos[nidx];
        const long u_base = nd_base[nidx];
        long eidx = nd_edge[nidx];
        while (eidx) {
            const long vn = ed_node[eidx];
            eidx = ed_next[eidx];
            if (!states[vn]) continue;
            if (u_mpos + 1 < nd_mpos[vn]) nd_mpos[vn] = (i32)(u_mpos + 1);
            if (vn == ntail) {
                const long maxo =
                    (slen < u_rpos + bandwidth ? slen : u_rpos + bandwidth)
                    - 1;
                i64 smax = arena_getscore(aus, aub, W, u_mm, maxo - u_rpos);
                if (slen > maxo + 1) {
                    const i64 t1 = gapo1 + gape1 * (slen - maxo - 1);
                    if (piecewise < 2) smax += t1;
                    else {
                        const i64 t2 = gapo2 + gape2 * (slen - maxo - 1);
                        smax += t1 > t2 ? t1 : t2;
                    }
                }
                smax += parT;
                if (smax > maxscr) {
                    maxscr = smax;
                    maxidx = nidx;
                    maxoff = maxo;
                }
                if (is_overlap) {
                    i64 rs;
                    long rp;
                    arena_row_max(aus, aub, W, u_mm, &rs, &rp);
                    if (rs > maxscr) {
                        maxscr = rs;
                        maxidx = nidx;
                        maxoff = rp + u_rpos;
                    }
                }
                nd_vst[vn] += 1;
            } else {
                const long mm2 = nd_vst[vn] ? 1 : nd_mmidx[vn];
                const long v_rpos = nd_rpos[vn];
                const long toff = nd_mpos[vn];
                // rh selection (dpalign_row_update_bspoa, bspoa.h:2232)
                int rh_mode = 0;
                i64 rh = SCORE_MIN_I;
                if (u_rpos == v_rpos) {
                    if (u_rpos == 0) {
                        if (is_overlap || toff == 0) rh = 0;
                        else if (piecewise < 2) rh = gapo1 + gape1 * toff;
                        else {
                            const i64 t1 = gapo1 + gape1 * toff;
                            const i64 t2 = gapo2 + gape2 * toff;
                            rh = t1 > t2 ? t1 : t2;
                        }
                    }
                } else if (u_rpos + W * WSZ >= v_rpos) {
                    rh_mode = 1;
                }
                const long qpi =
                    (nd_base[vn] == u_base ? 2 : 0) + nd_bonus[vn];
                bsa8_row_update_slot(aus, aes, aqs, aub, qps[qpi],
                                     (int)v_rpos, (int)nd_base[vn], (int)W,
                                     (int)(v_rpos - u_rpos), (int)piecewise,
                                     (int)nt_max, (int)nt_min, (int)gapo1,
                                     (int)gape1, (int)gapo2, (int)gape2,
                                     rh_mode, rh, u_mm, mm2);
                if (nd_vst[vn])
                    bsa8_row_merge_slot(aus, aes, aqs, aub, (int)W,
                                        (int)piecewise, 1, nd_mmidx[vn]);
                nd_vst[vn] += 1;
                if (nd_vst[vn] == nd_nct[vn]) {
                    if (!is_global && v_rpos + bandwidth >= slen) {
                        i64 smax = arena_getscore(aus, aub, W, nd_mmidx[vn],
                                                  slen - 1 - v_rpos) + parT;
                        if (smax > maxscr) {
                            maxscr = smax;
                            maxidx = vn;
                            maxoff = slen - 1;
                        }
                    }
                    if (sp >= stack_cap) return -1;
                    stack_buf[sp++] = (i32)vn;
                }
            }
        }
    }
    best[0] = maxscr;
    best[1] = maxidx;
    best[2] = maxoff;
    return 0;
}

// ---- pedit traceback (bspoa.h:3962-4037) with in-C ring merges ----
extern "C" long bsa_pedit_traceback(
    GFULL_ARGS,
    const uint8_t *matrix0, const uint8_t *matrix1, const uint8_t *seqs0,
    const uint8_t *seqs1, const uint8_t *mats0, const uint8_t *mats1,
    const i64 *ndoffs,
    long mlen, long mbeg, long mend, long HW, long rowlen,
    long pad, long rid, long nseq_plus1, long qe) {
    GFULL_PACK;
    long scr = 0;
    long xi = mend - 1, yi = mend - 1;
    long roff = qe;
    while (xi >= 0 && yi >= 0) {
        const long i = xi + yi;
        if (i < mbeg + mbeg) break;
        const long dirn = i & 1;
        const long moff = xi + yi;
        const long mdir = moff & 1;
        const long midx = (xi - yi - mdir) / 2 + HW;
        const long xb = xi - midx;
        const long yb = mlen - 1 - (yi + midx);
        const long xx = midx;
        const uint8_t *p0 = matrix0 + rowlen * moff;
        const uint8_t *p1 = matrix1 + rowlen * moff;
        const uint8_t *c0 = matrix0 + rowlen * (moff + 1);
        const long sread_b = seqs0[HW + xb + xx];
        const long scns_b = seqs1[HW + yb + xx];
        long h = (scns_b < 4 ? mats0[scns_b * pad + HW + xb + xx] : 0)
                 + (sread_b < 4 ? mats1[sread_b * pad + HW + yb + xx] : 0);
        if (h > 255) h = 255;
        long e, f;
        if (dirn) {
            e = p0[1 + xx + 1];
            f = p1[1 + xx];
        } else {
            e = p0[1 + xx];
            f = p1[1 + xx - 1];
        }
        const long s = f + c0[1 + xx];
        if (s == f && !(xx == 0 && dirn == 0)) {
            if (sread_b < 4) roff -= 1;
            xi -= 1;
        } else if (s == e) {
            yi -= 1;
        } else if (s == h) {
            if (sread_b < 4) {
                roff -= 1;
                const long un = ndoffs[nseq_plus1 + sread_b] + yi;
                const long vn = ndoffs[rid] + roff;
                if (g_merge_rings(G, un, vn) < 0) return -2;
            }
            scr += s;
            xi -= 1;
            yi -= 1;
        } else {
            return -1;  // traceback lost
        }
    }
    return estate[3] ? -2 : scr;
}

// ---- topological MSA extraction (sort_nodes_bspoa, bspoa.h:2695-2946) ----
extern "C" long bsa_sort_nodes(
    i32 *mpos, i32 *vst, i32 *nct, i32 *inuse, const i32 *nin,
    const i32 *nou, const i32 *nxt, const i32 *edge, const i32 *erev,
    const i32 *ed_node, const i32 *ed_next, long n, long head, long tail,
    i32 *stack_buf, long stack_cap) {
    for (long i = 0; i < n; i++) {
        vst[i] = 0;
        nct[i] = nou[i];
        inuse[i] = 0;
        mpos[i] = 0;
    }
    long sp = 0;
    stack_buf[sp++] = (i32)tail;
    long nidx = tail;
    while (sp > 0) {
        nidx = stack_buf[--sp];
        const long up1 = mpos[nidx] + 1;
        long eidx = erev[nidx];
        while (eidx) {
            const long vi = ed_node[eidx];
            eidx = ed_next[eidx];
            if (up1 > mpos[vi]) mpos[vi] = (i32)up1;
            vst[vi] += 1;
            if (vst[vi] > nct[vi]) return -1;   // overflow
        }
        eidx = erev[nidx];
        while (eidx) {
            const long vi = ed_node[eidx];
            eidx = ed_next[eidx];
            if (inuse[vi]) continue;
            if (vst[vi] == nct[vi]) {
                bool ready = true;
                long moff = mpos[vi];
                long xidx = nxt[vi];
                while (xidx != vi) {
                    if (nct[xidx] > vst[xidx]) { ready = false; break; }
                    if (mpos[xidx] > moff) moff = mpos[xidx];
                    xidx = nxt[xidx];
                }
                if (ready) {
                    mpos[vi] = (i32)moff;
                    inuse[vi] = 1;
                    if (sp >= stack_cap) return -3;
                    stack_buf[sp++] = (i32)vi;
                    xidx = nxt[vi];
                    while (xidx != vi) {
                        mpos[xidx] = (i32)moff;
                        if (edge[xidx]) {
                            if (sp >= stack_cap) return -3;
                            stack_buf[sp++] = (i32)xidx;
                            inuse[xidx] = 1;
                        }
                        xidx = nxt[xidx];
                    }
                }
            }
        }
    }
    if (nidx != head) return -2;               // did not reach HEAD
    // tail-chain compaction (bspoa.h:2861-2917)
    long teidx = erev[tail];
    while (teidx) {
        const long enode = ed_node[teidx];
        teidx = ed_next[teidx];
        if (enode == head) continue;
        long x_idx = tail, v_idx = enode;
        for (;;) {
            long cnou = 0;
            long xidx = edge[v_idx];
            while (xidx) {
                const long en = ed_node[xidx];
                if (en != x_idx && en != tail) cnou++;
                xidx = ed_next[xidx];
            }
            if (cnou) break;
            if (nin[v_idx] != 1) break;
            x_idx = v_idx;
            v_idx = ed_node[erev[v_idx]];
        }
        if (x_idx == tail) continue;
        long moff = mpos[v_idx] - 1;
        v_idx = x_idx;
        if (mpos[v_idx] == moff) continue;
        while (v_idx != tail) {
            long xidx = nxt[v_idx];
            for (;;) {
                mpos[xidx] = (i32)moff;
                if (xidx == v_idx) break;
                xidx = nxt[xidx];
            }
            moff -= 1;
            long nxt_v = -1;
            xidx = edge[v_idx];
            while (xidx) {
                const long en = ed_node[xidx];
                if (en != tail) {
                    if (nxt_v >= 0) return -4;  // tail chain fork
                    nxt_v = en;
                }
                xidx = ed_next[xidx];
            }
            if (nxt_v < 0) break;
            v_idx = nxt_v;
        }
    }
    const long mlen = mpos[head];
    for (long i = 0; i < n; i++) {
        vst[i] = 0;
        mpos[i] = (i32)(mlen - 1 - mpos[i]);
    }
    return mlen;
}

// ---- MSA column fill walk (msa_bspoa, bspoa.h:3156-3248) ----
extern "C" long bsa_msa_fill(
    const i32 *mpos, i32 *vst, i32 *nct, const i32 *nin, const i32 *nxt,
    const i32 *edge, const i32 *erev, const i32 *nd_rid,
    const i32 *nd_base, const i32 *ed_node, const i32 *ed_next, long n,
    long head, long tail, uint8_t *msacols, const i64 *msaidxs, long mlen,
    long mrow, i32 *stack_buf, long stack_cap) {
    for (long i = 0; i < n; i++) {
        vst[i] = 0;
        nct[i] = nin[i];
    }
    long sp = 0;
    stack_buf[sp++] = (i32)head;
    long nidx = head;
    while (sp > 0) {
        nidx = stack_buf[--sp];
        long eidx = edge[nidx];
        while (eidx) {
            const long vi = ed_node[eidx];
            eidx = ed_next[eidx];
            vst[vi] += 1;
            if (vst[vi] == nct[vi]) {
                bool ready = true;
                long xidx = nxt[vi];
                while (xidx != vi) {
                    if (vst[xidx] < nct[xidx]) { ready = false; break; }
                    xidx = nxt[xidx];
                }
                if (ready) {
                    xidx = vi;
                    for (;;) {
                        const long mp = mpos[xidx];
                        const long rid = nd_rid[xidx];
                        if (mp >= 0 && mp < mlen && rid < mrow)
                            msacols[msaidxs[mp] * mrow + rid] =
                                (uint8_t)nd_base[xidx];
                        if (erev[xidx]) {
                            if (sp >= stack_cap) return -3;
                            stack_buf[sp++] = (i32)xidx;
                        }
                        xidx = nxt[xidx];
                        if (xidx == vi) break;
                    }
                }
            } else if (vst[vi] > nct[vi]) {
                return -1;
            }
        }
    }
    return nidx == tail ? 0 : -2;
}

// ---- batched read-chain ops (loop bodies of remsa/align_rd) ----
extern "C" long bsa_g_cut_range(GFULL_ARGS, long nnodes, long base_idx,
                                long lo, long hi, long cut) {
    // cut positions hi-1 .. lo (descending, like the remsa loops)
    for (long pos = hi - 1; pos >= lo; pos--) {
        const long nidx = base_idx + pos;
        const long r = bsa_g_cut_rdnode(
            nd_rid, nd_cov, nd_rdc, nd_rdd, nd_nin, nd_nou, nd_edge,
            nd_erev, nd_next, nd_prev, nd_header, ed_node, ed_cov, ed_vst,
            ed_next, estate, ecyc, nnodes, nidx, cut);
        if (r < 0) return -1;
    }
    return 0;
}

extern "C" long bsa_g_cut_range_asc(GFULL_ARGS, long nnodes, long base_idx,
                                    long lo, long hi, long cut) {
    // cut positions lo .. hi-1 (ascending, like del_msanodes, bspoa.h:2708)
    for (long pos = lo; pos < hi; pos++) {
        const long nidx = base_idx + pos;
        const long r = bsa_g_cut_rdnode(
            nd_rid, nd_cov, nd_rdc, nd_rdd, nd_nin, nd_nou, nd_edge,
            nd_erev, nd_next, nd_prev, nd_header, ed_node, ed_cov, ed_vst,
            ed_next, estate, ecyc, nnodes, nidx, cut);
        if (r < 0) return -1;
    }
    return 0;
}

extern "C" long bsa_g_connect_range(GFULL_ARGS, long base_idx, long lo,
                                    long hi) {
    GFULL_PACK;
    for (long pos = lo; pos <= hi; pos++) {
        g_connect_idx(G, base_idx + pos - 1, base_idx + pos);
        if (estate[3]) return -1;
    }
    return 0;
}

// ---- graph traceback + fusion (alignment2graph_bspoa, bspoa.h:2274-2513) --
// Walks predecessors by score identity (max-edge-cov tie-break), merges
// matched read bases into rings, reconnects the read chain, and fills rs.
extern "C" long bsa_alignment2graph(
    GFULL_ARGS,
    i32 *nd_mpos, const i32 *nd_rpos, const i32 *nd_mmidx,
    const i32 *nd_base, const i32 *nd_bonus, i32 *nd_cpos,
    const uint8_t *states, const i64 *ndoffs,
    const i8 *aus, const i8 *aes, const i8 *aqs, const i64 *aub,
    const i8 *qp0, const i8 *qp1, const i8 *qp2, const i8 *qp3,
    long W, long bandwidth, long qlen, long qb, long piecewise,
    long parO, long parE, long parQ, long parP, long is_overlap,
    long nhead, long ntail, long midx, long xe, long rid, long rbeg,
    i64 *rs /*[score,qb,qe,tb,te,mat,mis,ins,del,aln]*/) {
    GFULL_PACK;
    (void)nd_mpos;
    const i8 *qps[4] = {qp0, qp1, qp2, qp3};
    enum { BT_M = 0, BT_I = 1, BT_D = 2, BT_D2 = 4, BT_NONE = -1 };
    const long rdbase = ndoffs[rid];
    for (long i = 0; i < qlen; i++) nd_cpos[rdbase + i] = 0;
    long x = xe;
    rs[2] = xe + 1;                         // qe
    rs[1] = x;                              // qb
    long nidx = midx;
    int bt = BT_NONE;
    rs[4] = nd_cpos[nidx] + 1;              // te
    const long cpos0 = nd_cpos[nidx];
    i64 Hs1 = arena_getscore(aus, aub, W, nd_mmidx[nidx],
                             x - nd_rpos[nidx]);
    i64 Hs0 = 0, Hs2 = 0;
    long cur_n = nidx;
    auto slot_es = [&](long slot, long xi) -> long {
        return aes ? aes[slot * W * WSZ + (xi % W) * WSZ + xi / W]
                   : parO + parE;
    };
    auto slot_qs = [&](long slot, long xi) -> long {
        return aqs ? aqs[slot * W * WSZ + (xi % W) * WSZ + xi / W] : 0;
    };
    auto slot_us = [&](long slot, long xi) -> long {
        return aus[slot * W * WSZ + (xi % W) * WSZ + xi / W];
    };
    auto merge_rings = [&](long un, long vn) -> int {
        return g_merge_rings(G, un, vn);
    };
    for (;;) {
        const long n_i = cur_n;
        if (G.hdr[n_i] == nhead || x < 0) {
            rs[1] = x;                      // qb
            rs[3] = nd_cpos[n_i];           // tb
            break;
        }
        if (bt == BT_D || bt == BT_D2) {
            rs[8] += 1;                     // del
            bool found = false;
            long eidx = G.erev[n_i];
            while (eidx) {
                const long wn = G.E.ed_node[eidx];
                eidx = G.E.ed_next[eidx];
                if (!states[wn]) continue;
                const long wr = nd_rpos[wn];
                if (x < wr || x >= wr + bandwidth) continue;
                const long wslot = nd_mmidx[wn];
                Hs0 = arena_getscore(aus, aub, W, wslot, x - wr);
                const long xi = x - wr;
                long q;
                if (bt == BT_D)
                    q = piecewise ? slot_es(wslot, xi) : parO + parE;
                else
                    q = slot_qs(wslot, xi);
                if (Hs0 + q != Hs1) continue;
                cur_n = wn;
                if (q == (bt == BT_D ? parO + parE : parQ + parP)) {
                    bt = BT_NONE;
                    Hs1 = Hs0;
                    Hs2 = 0;
                } else {
                    Hs1 -= bt == BT_D ? parE : parP;
                    Hs2 += 1;
                }
                found = true;
                break;
            }
            if (!found) return -10;         // D-traceback lost
            continue;
        } else if (bt == BT_I) {
            rs[7] += 1;                     // ins
            i64 t;
            if (piecewise == 2) {
                const i64 t1 = parO + parE * Hs2;
                const i64 t2 = parQ + parP * Hs2;
                t = t1 > t2 ? t1 : t2;
            } else {
                t = parO + parE * Hs2;
            }
            x -= 1;
            if (Hs0 + t == Hs1) {
                bt = BT_NONE;
                Hs1 = Hs0;
                Hs2 = 0;
            } else if (x >= 0) {
                const long xi = x - nd_rpos[n_i];
                Hs0 -= slot_us(nd_mmidx[n_i], xi);
                Hs2 += 1;
            }
            continue;
        } else if (bt == BT_M) {
            const long u_idx = rdbase + rbeg + qb + x;
            nd_cpos[u_idx] = nd_cpos[n_i];
            x -= 1;
            if (cur_n != nhead && cur_n != ntail
                    && nd_base[u_idx] == nd_base[n_i]) {
                if (merge_rings(cur_n, u_idx) < 0) return -11;
                rs[5] += 1;                 // mat
            } else {
                rs[6] += 1;                 // mis
            }
            cur_n = nidx;
            bt = BT_NONE;
        } else {
            long btc = 0;
            long best_node = -1;
            int best_i3 = -1;
            i64 best_h0 = 0;
            long eidx = G.erev[n_i];
            while (eidx) {
                const long wn = G.E.ed_node[eidx];
                const long ecov = G.E.ed_cov[eidx];
                eidx = G.E.ed_next[eidx];
                if (!states[wn]) continue;
                const long wr = nd_rpos[wn];
                const long wslot = nd_mmidx[wn];
                long ft = 0;
                if (x < wr || x > bandwidth + wr) continue;
                else if (x == bandwidth + wr) {
                    Hs0 = arena_getscore(aus, aub, W, wslot, x - wr - 1);
                    ft |= (1 << BT_D) | (1 << BT_D2);
                } else if (x == wr) {
                    Hs0 = aub[wslot * (WSZ + 1)];
                    if (wr == 0 && (is_overlap || wn == nhead)) ft |= 1 << 15;
                    else ft |= 1 << BT_M;
                } else {
                    Hs0 = arena_getscore(aus, aub, W, wslot, x - wr - 1);
                }
                const long qpi =
                    (nd_base[wn] == nd_base[n_i] ? 2 : 0) + nd_bonus[n_i];
                long s = qps[qpi][(x * 4 + nd_base[n_i]) * WSZ];
                if (ft & (1 << 15)) s -= aub[wslot * (WSZ + 1)];
                const long xi = x - wr;
                long uval = 0, eval_ = parE, qval = -1;
                bool has_q = false;
                if (xi >= 0 && xi < bandwidth) {
                    uval = slot_us(wslot, xi);
                    eval_ = aes ? slot_es(wslot, xi) : parE;
                    if (aqs) { qval = slot_qs(wslot, xi); has_q = true; }
                } else {
                    uval = 0;
                    eval_ = parE;
                }
                const i64 scr[3] = {
                    (ft & (1 << BT_M)) ? SCORE_MIN_I : (i64)s,
                    (ft & (1 << BT_D)) ? SCORE_MIN_I : (i64)(uval + eval_),
                    (ft & (1 << BT_D2)) ? SCORE_MIN_I
                        : (has_q ? (i64)(uval + qval) : (i64)0x1FFFFFFF)};
                for (int i3 = 0; i3 < 3; i3++) {
                    if (Hs0 + scr[i3] == Hs1) {
                        if (ecov > btc) {
                            best_node = wn;
                            best_i3 = i3;
                            best_h0 = Hs0;
                            btc = ecov;
                        } else if (ecov == btc && i3 == 0 && best_i3 > 0) {
                            best_node = wn;
                            best_i3 = i3;
                            best_h0 = Hs0;
                            btc = ecov;
                        }
                    }
                }
            }
            if (best_i3 < 0) {
                bt = BT_I;
                Hs2 = 1;
                const long xi = x - nd_rpos[n_i];
                Hs0 = Hs1 - slot_us(nd_mmidx[n_i], xi);
            } else if (best_i3 == 0) {
                bt = BT_M;
                nidx = best_node;
                Hs1 = best_h0;
                Hs2 = 0;
            } else if (best_i3 == 1) {
                bt = BT_D;
                Hs2 = 1;
            } else {
                bt = BT_D2;
                Hs2 = 1;
            }
        }
    }
    rs[1] += qb;                            // qb += self.qb
    rs[2] += qb;                            // qe += self.qb
    g_connect_idx(G, rdbase + rbeg + qlen - 1, rdbase + rbeg + qlen);
    long cpos_run = cpos0;
    for (long xx = qlen - 1; xx >= 0; xx--) {
        g_connect_idx(G, rdbase + rbeg + xx - 1, rdbase + rbeg + xx);
        const long vi = rdbase + xx + rbeg;
        if (nd_cpos[vi]) cpos_run = nd_cpos[vi];
        else nd_cpos[vi] = (i32)cpos_run;
    }
    return estate[3] ? -12 : 0;
}

// ---- scalar edit-distance forward (striped_seqedit driver loop,
// bsalign.h:1046-1206 / oracle/edit.edit_pairwise) ----
extern "C" long bsa_edit_forward(
    const uint8_t *qseq, long qlen, const uint8_t *tseq, long tlen,
    long bandwidth, long is_overlap, long is_extend,
    i8 *uts /*[(tlen+1) * bandwidth]*/, i64 *begs /*[tlen+1]*/,
    i64 *out /*[smin, rx, ry, sbeg]*/) {
    const long qro = ((qlen + 63) / 64) * 64;
    for (long j = 0; j < bandwidth; j++) uts[j] = 1;   // row_init u=+1
    begs[0] = 0;
    long rx = qlen - 1, ry = tlen - 1;
    i64 smin = 0x7FFFFFFF, sbeg = 0;
    long rbeg0 = 0;
    thread_local std::vector<i8> ushift_v;
    ushift_v.resize(bandwidth);
    i8 *u_shift = ushift_v.data();
    for (long i = 0; i < tlen; i++) {
        long rbeg1;
        if (is_overlap || is_extend) {
            rbeg1 = 0;
        } else {
            rbeg1 = (i * qlen) / tlen;
            rbeg1 = rbeg1 < bandwidth / 2 ? 0 : rbeg1 - bandwidth / 2;
            if (rbeg1 + bandwidth > qro) rbeg1 = qro - bandwidth;
        }
        begs[i + 1] = rbeg1;
        const long movx = rbeg1 - rbeg0;
        const i8 *u_old = uts + i * bandwidth;
        const i8 *usrc;
        if (is_overlap) {
            sbeg = 0;
            usrc = u_old;
        } else {
            if (movx) {
                const long mv = movx < bandwidth ? movx : bandwidth;
                for (long k = 0; k < mv; k++) sbeg += u_old[k];
            }
            sbeg += 1;
            if (movx == 0) {
                usrc = u_old;
            } else if (movx >= bandwidth) {
                for (long k = 0; k < bandwidth; k++) u_shift[k] = 1;
                usrc = u_shift;
            } else {
                for (long k = 0; k < bandwidth - movx; k++)
                    u_shift[k] = u_old[movx + k];
                for (long k = bandwidth - movx; k < bandwidth; k++)
                    u_shift[k] = 1;
                usrc = u_shift;
            }
        }
        const long tbase = tseq[i];
        i8 *u_new = uts + (i + 1) * bandwidth;
        int v = is_overlap ? 0 : 1;
        for (long k = 0; k < bandwidth; k++) {
            const long pos = rbeg1 + k;
            const int match = pos < qlen && qseq[pos] == tbase;
            const int up = usrc[k];
            const int h = (match || up == -1 || v == -1) ? 0 : 1;
            u_new[k] = (i8)(h - v);
            v = h - up;
        }
        if (is_overlap || is_extend) {
            i64 srow = sbeg;
            for (long k = 0; k < bandwidth; k++) srow += u_new[k];
            for (long k = rbeg1 + bandwidth; k > qlen; k--)
                srow -= u_new[k - 1 - rbeg1];
            if (srow < smin) {
                smin = srow;
                rx = qlen - 1;
                ry = i;
            }
        }
        rbeg0 = rbeg1;
    }
    if (is_extend && tlen > 0) {
        const i8 *u_last = uts + tlen * bandwidth;
        i64 pref = sbeg;
        i64 best = 0x7FFFFFFFFFFFFFFFLL;
        long kbest = 0;
        for (long k = 0; k < bandwidth; k++) {
            pref += u_last[k];
            if (pref < best) { best = pref; kbest = k; }
        }
        if (best < smin) {
            smin = best;
            rx = kbest;
            ry = tlen - 1;
        }
    }
    out[0] = smin;
    out[1] = rx;
    out[2] = ry;
    out[3] = sbeg;
    return 0;
}

// ---- add_msanodes column-merge loops (bspoa.h:3068-3154 inner loops) ----
// Loop A: merge each cns node (rail row `nall`) with the first read whose
// base matches in its column; loop B: merge every read base into its
// per-base rail ring.
static int merge_rings_g(GFull &G, long un, long vn) {
    return g_merge_rings(G, un, vn);
}

extern "C" long bsa_msanode_cns_merges(
    GFULL_ARGS, i32 *nd_mpos, const uint8_t *msacols, const i64 *msaidxs,
    long mlen, long mrow, long nall, long nseq, const i64 *ndoffs,
    long cnsnode0) {
    GFULL_PACK;
    thread_local std::vector<long> rps_v;
    rps_v.assign(nseq, 0);
    long *rps = rps_v.data();
    long clen = 0;
    for (long pos = 0; pos < mlen; pos++) {
        const uint8_t *col = msacols + msaidxs[pos] * mrow;
        if (col[nall] < 4) {
            const long u = cnsnode0 + clen;
            clen += 1;
            long rid = 0;
            for (; rid < nseq; rid++) {
                if (col[rid] == col[nall]) {
                    if (merge_rings_g(G, u, ndoffs[rid] + rps[rid]) < 0)
                        return -1;
                    nd_mpos[u] = (i32)pos;
                    break;
                }
            }
            if (rid == nseq) return -2;     // cns base unmatched
        }
        for (long rid = 0; rid < nseq; rid++)
            if (col[rid] < 4) rps[rid] += 1;
    }
    return estate[3] ? -1 : clen;
}

extern "C" long bsa_msanode_rail_merges(
    GFULL_ARGS, const i32 *nd_base, const uint8_t *msacols,
    const i64 *msaidxs, long mlen, long mrow, long nall, long nseq,
    const i64 *ndoffs) {
    GFULL_PACK;
    thread_local std::vector<long> rps_v;
    rps_v.assign(nseq, 0);
    long *rps = rps_v.data();
    for (long pos = 0; pos < mlen; pos++) {
        const uint8_t *col = msacols + msaidxs[pos] * mrow;
        for (long rid = 0; rid < nseq; rid++) {
            if (col[rid] < 4) {
                const long u = ndoffs[rid] + rps[rid];
                const long v = ndoffs[nall + 1 + nd_base[u]] + pos;
                if (G.hdr[u] != G.hdr[v]) {
                    if (merge_rings_g(G, u, v) < 0) return -1;
                }
                rps[rid] += 1;
            }
        }
    }
    return estate[3] ? -1 : 0;
}

// ---- node-subset selection (sel_nodes_bspoa, bspoa.h:1887-2020) ----
extern "C" long bsa_sel_nodes(
    GFULL_ARGS, i32 *nd_vst, i32 *nd_nct, i32 *nd_bonus,
    const i32 *nd_bless, const i64 *ndoffs, long nnodes,
    long nhead, long ntail, long ridxbeg, long ridxend, long nseq,
    uint8_t *states, i32 *sels, long sels_cap,
    i64 *todels /*pairs*/, long todels_cap, i64 *out /*[nsel, ntodel]*/) {
    GFULL_PACK;
    nhead = G.hdr[nhead];
    ntail = G.hdr[ntail];
    out[0] = out[1] = 0;
    if (nhead == ntail) return 0;
    thread_local std::vector<long> rb_v, re_v;
    rb_v.assign(nseq, 0x7FFFFFFF);
    re_v.assign(nseq, -1);
    for (int which = 0; which < 2; which++) {
        const long start = which == 0 ? nhead : ntail;
        long x = start;
        for (;;) {
            const long rid = G.rid[x];
            if (rid >= ridxbeg && rid < ridxend && rid < nseq) {
                const long pos = x - ndoffs[rid];
                if (which == 0) rb_v[rid] = pos;
                else re_v[rid] = pos;
            }
            x = G.nxt[x];
            if (x == start) break;
        }
    }
    long nsel = 0;
    for (long i = 0; i < nseq; i++) {
        const long rb = rb_v[i], re = re_v[i];
        if (rb >= re) continue;
        const long base = ndoffs[i];
        for (long j = rb; j <= re; j++) {
            const long h = G.hdr[base + j];
            if (states[h]) continue;
            if (nsel >= sels_cap) return -3;
            sels[nsel++] = (i32)h;
            states[h] = 1;
            nd_nct[h] = 0;
            nd_vst[h] = 0;
        }
    }
    long ntd = 0;
    for (long k = 0; k < nsel; k++) {
        const long nidx = sels[k];
        if (nidx == nhead) continue;
        int j = 0;
        long eidx = G.edge[nidx];
        while (eidx) {
            if (states[G.E.ed_node[eidx]]) { j |= 1; break; }
            eidx = G.E.ed_next[eidx];
        }
        eidx = G.erev[nidx];
        while (eidx) {
            if (states[G.E.ed_node[eidx]]) { j |= 2; break; }
            eidx = G.E.ed_next[eidx];
        }
        if (j == 3) {
        } else if (j == 1 || nidx == ntail) {
            if (g_chg_edge(G.E, nhead, nidx, 1) < 0) return -1;
            if (ntd + 2 > todels_cap) return -4;
            todels[ntd++] = nhead;
            todels[ntd++] = nidx;
        } else if (j == 2) {
            if (g_chg_edge(G.E, nidx, ntail, 1) < 0) return -1;
            if (ntd + 2 > todels_cap) return -4;
            todels[ntd++] = nidx;
            todels[ntd++] = ntail;
        }
    }
    for (long k = 0; k < nsel; k++) {
        const long nidx = sels[k];
        long bonus = 0;
        long x = nidx;
        for (;;) {
            bonus |= nd_bless[x];
            if (bonus) break;
            x = G.nxt[x];
            if (x == nidx) break;
        }
        nd_bonus[nidx] = (i32)bonus;
        long eidx = G.edge[nidx];
        while (eidx) {
            const long en = G.E.ed_node[eidx];
            if (states[en]) nd_nct[en] += 1;
            eidx = G.E.ed_next[eidx];
        }
    }
    out[0] = nsel;
    out[1] = ntd;
    return estate[3] ? -1 : nsel;
}

// ---- consensus QLT/ALT tail (cns_bspoa tail, bspoa.h:3594-3692) ----
// Viterbi backtrace of the 5-state HMM plus per-column base quality (QLT,
// log-sum-exp marginal) and alternative-allele quality (ALT, binomial /
// normal-approx tail). Bit-identical to the Python tail: the permutation
// log-cache is built incrementally exactly like cal_permutation_bspoa
// (bspoa.h:3394-3402) so float association matches.
static double _bsa_logc[1001];
static long _bsa_logc_n = 1;

static inline double bsa_cal_permutation(long n, long m) {
    if (n > 1000) return 1.0;
    _bsa_logc[0] = 0.0;
    while (_bsa_logc_n <= n) {
        _bsa_logc[_bsa_logc_n] =
            _bsa_logc[_bsa_logc_n - 1] + log((double)_bsa_logc_n);
        _bsa_logc_n++;
    }
    return _bsa_logc[n] - _bsa_logc[m] - _bsa_logc[n - m];
}

static inline double bsa_cal_binomial(long n, long m, double p) {
    return log(p) * m + log(1.0 - p) * (n - m) + bsa_cal_permutation(n, m);
}

static inline double bsa_normal_cdf(double value) {
    return erfc(-value / 1.4142135623731) / 2;
}

static inline double bsa_clog(double x) {
    if (x > 0) return log(x);
    return x == 0 ? -HUGE_VAL : NAN;
}

extern "C" long bsa_cns_tail(const double *sc, const uint8_t *btm,
                             uint8_t *msacols, long mrow,
                             const long *msaidxs, long mlen, long nall,
                             long nmax, double psub, long qlt_max,
                             uint8_t *cns_out, uint8_t *qlt_out,
                             uint8_t *alt_out, double *ret_out) {
    const long P1 = mlen + 1;
    const double LOG10 = log(10.0);
#define SC5(a, pos) sc[((long)(a) * P1 + (pos)) * 6 + 5]
    long c = 4;
    for (long a = 0; a < 4; a++)
        if (SC5(a, mlen) > SC5(c, mlen)) c = a;
    *ret_out = SC5(c, mlen);
    long pos = mlen - 1;
    for (;;) {
        msacols[msaidxs[pos] * mrow + nall] = (uint8_t)c;
        c = btm[c * P1 + pos + 1];
        if (pos == 0) break;
        pos--;
    }
    long ncns = 0;
    for (pos = 0; pos < mlen; pos++) {
        uint8_t *qs = msacols + msaidxs[pos] * mrow;
        const long cb = qs[nall];
        double erre = -1000000000.0;
        for (long a = 0; a < 5; a++) erre = sum_log2(erre, SC5(a, pos + 1));
        const double errd = SC5(cb, pos + 1);
        erre = bsa_clog(1.0 - exp(errd - erre));
        erre = -(10.0 * erre / LOG10);
        {
            double m = (qlt_max < erre) ? (double)qlt_max : erre;
            qs[nall + 1] = (uint8_t)(long)m;
        }
        long cnts[6] = {0, 0, 0, 0, 0, 0};
        for (long rid = 0; rid < nmax; rid++) {
            const long b = qs[rid];
            if (b > 4) continue;
            cnts[5]++;
            cnts[b]++;
        }
        long a = (cb + 1) % 5;
        for (long e = 0; e < 5; e++) {
            if (e == cb) continue;
            if (cnts[e] > cnts[a]) a = e;
        }
        const double p = psub;
        double erre2 = 0.0;
        if (cnts[5] > 50 && cnts[5] * p > 5 && cnts[5] * (1.0 - p) > 5) {
            erre2 = bsa_normal_cdf((cnts[a] - cnts[5] * p) /
                                   sqrt(cnts[5] * p * (1.0 - p)));
        } else {
            for (long e = 0; e < cnts[a]; e++)
                erre2 += exp(bsa_cal_binomial(cnts[5], e, p));
        }
        double errd2;
        if (erre2 == 0) {
            errd2 = 0.0;
        } else {
            errd2 = -(10.0 * bsa_clog(1.0 - erre2) / LOG10);
        }
        {
            double m = (qlt_max < errd2) ? (double)qlt_max : errd2;
            qs[nall + 2] = (uint8_t)(long)m;
        }
        if (qs[nall] < 4) {
            cns_out[ncns] = qs[nall];
            qlt_out[ncns] = qs[nall + 1];
            alt_out[ncns] = qs[nall + 2];
            ncns++;
        }
    }
#undef SC5
    return ncns;
}

// ---- homopolymer count re-attribution (bspoa.h:4239-4319 / 4588-4671) ----
// Operates on a dense [mlen][4] int64 count matrix; the python callers copy
// their storage (u8 profile rows / i64 bcnts) in and out. Tie order matters,
// so the reference's exact median-of-3 quicksort with >5-run skip + bubble
// finish (sort.h:137-198, mirrored in poa/csort.py) is reproduced.
typedef int (*hp_gt_fn)(int64_t, int64_t);

static int hp_gt_base(int64_t a, int64_t b) { return (a & 7) > (b & 7); }

static int hp_gt_flagpos(int64_t a, int64_t b) {
    const long b1 = (b >> 3) & 1, a1 = (a >> 3) & 1;
    if (b1 != a1) return b1 > a1;
    return -((b >> 4) & 0xFFF) > -((a >> 4) & 0xFFF);
}

static int hp_gt_ci(int64_t a, int64_t b) { return (b >> 16) > (a >> 16); }

static void hp_sort(int64_t *rs, long n, hp_gt_fn gt) {
    if (n < 2) return;
    std::vector<std::pair<long, long> > stk;
    stk.push_back(std::make_pair(0L, n - 1));
    while (!stk.empty()) {
        const long s = stk.back().first, e = stk.back().second;
        stk.pop_back();
        long m = s + (e - s) / 2;
        int64_t t;
        if (gt(rs[s], rs[m])) { t = rs[s]; rs[s] = rs[m]; rs[m] = t; }
        if (gt(rs[m], rs[e])) {
            t = rs[e]; rs[e] = rs[m]; rs[m] = t;
            if (gt(rs[s], rs[m])) { t = rs[s]; rs[s] = rs[m]; rs[m] = t; }
        }
        const int64_t p = rs[m];
        long i = s + 1, j = e - 1;
        for (;;) {
            while (gt(p, rs[i])) i++;
            while (gt(rs[j], p)) j--;
            if (i < j) {
                t = rs[i]; rs[i] = rs[j]; rs[j] = t;
                i++; j--;
            } else {
                break;
            }
        }
        if (i == j) { i++; j--; }
        if (j - s > e - i) {
            if (s + 4 < j) stk.push_back(std::make_pair(s, j));
            if (i + 4 < e) stk.push_back(std::make_pair(i, e));
        } else {
            if (i + 4 < e) stk.push_back(std::make_pair(i, e));
            if (s + 4 < j) stk.push_back(std::make_pair(s, j));
        }
    }
    for (long i = 0; i < n; i++) {
        int moved = 0;
        for (long j = n - 1; j > i; j--) {
            if (gt(rs[j - 1], rs[j])) {
                int64_t t = rs[j - 1]; rs[j - 1] = rs[j]; rs[j] = t;
                moved = 1;
            }
        }
        if (!moved) break;
    }
}

extern "C" void bsa_hp_adjust(long mlen, const uint8_t *cnsrow, int64_t *cnt,
                              long cap255) {
    // phase 1: move [cns=4] minor-base counts right to the next cns column
    for (long pos = 0; pos < mlen; pos++) {
        const long lc = cnsrow[pos];
        if (lc >= 4) continue;
        for (long i = pos; i > 0; i--) {
            if (cnsrow[i - 1] < 4) break;
            const long ci = cnt[(i - 1) * 4 + lc];
            if (ci && (!cap255 || ci + cnt[pos * 4 + lc] <= 255)) {
                cnt[pos * 4 + lc] += ci;
                cnt[(i - 1) * 4 + lc] = 0;
            }
        }
    }
    // phase 2: redistribute within each cns homopolymer run
    long lc = 4, mc = 0, lpos = 0;
    long cnts[4] = {0, 0, 0, 0};
    std::vector<int64_t> stk;
    for (long pos = 0; pos <= mlen; pos++) {
        int flush = 0;
        if (pos == mlen) {
            flush = 1;
        } else {
            const long col = cnsrow[pos];
            if (col < 4 && col != lc) flush = 1;
        }
        if (flush && !stk.empty()) {
            hp_sort(stk.data(), (long)stk.size(), hp_gt_base);
            const long n = (long)stk.size();
            long i = 0, p = 0;
            while (i <= n) {
                if (i < n && (stk[i] & 7) == (stk[p] & 7)) { i++; continue; }
                const long pb_base = stk[p] & 7;
                long cc = pb_base < 4 ? cnts[pb_base] : 0;
                long j;
                if (pb_base == lc) {
                    hp_sort(stk.data() + p, i - p, hp_gt_flagpos);
                    j = p;
                    while (cc && j < i) {
                        const int64_t pb = stk[j];
                        if (((pb >> 3) & 1) == 0) break;
                        const long bc = cc < mc ? cc : mc;
                        cnt[(lpos + ((pb >> 4) & 0xFFF)) * 4 + (pb & 7)] = bc;
                        cc -= bc;
                        j++;
                    }
                    while (p < j) {
                        const int64_t pb = stk[p];
                        const size_t idx =
                            (size_t)(lpos + ((pb >> 4) & 0xFFF)) * 4 + (pb & 7);
                        const long d = j - p;
                        if (!cap255 || d + cnt[idx] <= 255) cnt[idx] += d;
                        p++;
                    }
                    p = j;
                    hp_sort(stk.data() + p, i - p, hp_gt_ci);
                    j = p;
                    while (cc && j < i) {
                        const int64_t pb = stk[j];
                        const long bc = cc < mc ? cc : mc;
                        cnt[(lpos + ((pb >> 4) & 0xFFF)) * 4 + (pb & 7)] = bc;
                        cc -= bc;
                        j++;
                    }
                } else {
                    hp_sort(stk.data() + p, i - p, hp_gt_ci);
                    j = p;
                    while (cc && j < i) {
                        const int64_t pb = stk[j];
                        const long bc = cc < mc ? cc : mc;
                        cnt[(lpos + ((pb >> 4) & 0xFFF)) * 4 + (pb & 7)] = bc;
                        cc -= bc;
                        j++;
                    }
                }
                p = i;
                i++;
            }
        }
        if (pos == mlen) break;
        if (cnsrow[pos] < 4 && cnsrow[pos] != lc) {
            lc = cnsrow[pos];
            mc = 0;
            cnts[0] = cnts[1] = cnts[2] = cnts[3] = 0;
            lpos = pos;
            stk.clear();
        }
        for (long b = 0; b < 4; b++) {
            const long ci = cnt[pos * 4 + b];
            if (ci) {
                if (ci > mc) mc = ci;
                cnts[b] += ci;
                const int64_t pb =
                    (int64_t)((b & 7) | ((b == (long)cnsrow[pos] ? 1 : 0) << 3) |
                              (((pos - lpos) & 0xFFF) << 4)) |
                    ((int64_t)(ci & 0xFFFF) << 16);
                stk.push_back(pb);
                cnt[pos * 4 + b] = 0;
            }
        }
    }
}

// ---- full 2-bit edit alignment + kmer-guided driver ----
// C++ port of oracle/edit.py edit_pairwise + kmer_edit_pairwise (themselves
// byte-exact vs the reference bsalign.h:1046-1536). One native call replaces
// the Python segment loop + per-cell backtrace, which dominates POA's
// prepare_rd_align band placement (read<->cns alignment, bspoa.h:2087-2097).
typedef uint32_t u4;

struct EditRS {
    i64 qb, qe, tb, te, mat, mis, ins, del_, aln, score;
};

static inline void cig_push(std::vector<u4> &cg, int op, i64 sz) {
    if (sz <= 0) return;
    if (!cg.empty() && (int)(cg.back() & 0xF) == op)
        cg.back() += (u4)(sz << 4);
    else
        cg.push_back((u4)((sz << 4) | op));
}

static long select_bandwidth_c(long qlen, long tlen, int modetype,
                               long bandwidth) {
    const long qro = ((qlen + 63) / 64) * 64;
    if (modetype == 1 || modetype == 2) return qro;   // overlap/extend
    bandwidth = ((bandwidth + 63) / 64) * 64;
    if (bandwidth == 0 || bandwidth > qlen) bandwidth = qro;
    if (bandwidth < qlen) {
        const long k = (qlen + tlen - 1) / tlen + 1;
        if (bandwidth < k) bandwidth = ((k + 63) / 64) * 64;
    }
    return bandwidth;
}

// Walks uts rows backward from (x, y); priority match > I > D > mismatch
// (oracle/edit.edit_backtrace, bsalign.h:965-1044). Cigars are appended in
// walk order then reversed by the caller.
static void edit_backtrace_c(const i8 *uts, const i64 *begs, long bandwidth,
                             const uint8_t *qseq, long x,
                             const uint8_t *tseq, long y, int modetype,
                             std::vector<u4> &cg, EditRS &rs) {
    rs.qe = x + 1;
    rs.te = y + 1;
    rs.mat = rs.mis = rs.ins = rs.del_ = 0;
    while (x >= 0 && y >= 0) {
        int op;
        if (qseq[x] == tseq[y]) {
            rs.mat++; op = 0; x--; y--;
        } else {
            const int u_cur = uts[(y + 1) * bandwidth + (x - begs[y + 1])];
            if (u_cur == 1) {
                rs.ins++; op = 1; x--;
            } else {
                const int u_prev = uts[y * bandwidth + (x - begs[y])];
                if (u_prev == -1) {
                    rs.del_++; op = 2; y--;
                } else {
                    rs.mis++; op = 0; x--; y--;
                }
            }
        }
        cig_push(cg, op, 1);
    }
    rs.qb = x + 1;
    rs.tb = y + 1;
    if (rs.qb) {
        cig_push(cg, 1, rs.qb);
        rs.ins += rs.qb;
        rs.qb = 0;
    }
    if ((modetype == 0 || modetype == 2) && rs.tb) {
        cig_push(cg, 2, rs.tb);
        rs.del_ += rs.tb;
        rs.tb = 0;
    }
    rs.aln = rs.mat + rs.mis + rs.ins + rs.del_;
}

// edit_pairwise: forward rows + backtrace + mode scoring; cigars appended
// to cg already-reversed (i.e. in alignment order).
static void edit_align_c(const uint8_t *qseq, long qlen, const uint8_t *tseq,
                         long tlen, int modetype, long bandwidth,
                         std::vector<u4> &cg, EditRS &rs) {
    memset(&rs, 0, sizeof(rs));
    if (qlen == 0 || tlen == 0) return;
    bandwidth = select_bandwidth_c(qlen, tlen, modetype, bandwidth);
    const int is_overlap = modetype == 1, is_extend = modetype == 2;
    thread_local std::vector<i8> uts_v;
    thread_local std::vector<i64> begs_v;
    uts_v.resize((tlen + 1) * bandwidth);
    begs_v.resize(tlen + 1);
    i64 out[4];
    bsa_edit_forward(qseq, qlen, tseq, tlen, bandwidth, is_overlap,
                     is_extend, uts_v.data(), begs_v.data(), out);
    const i64 smin = out[0], sbeg = out[3];
    const long rx = out[1], ry = out[2];
    std::vector<u4> rev;
    edit_backtrace_c(uts_v.data(), begs_v.data(), bandwidth, qseq, rx, tseq,
                     ry, modetype, rev, rs);
    for (size_t k = rev.size(); k-- > 0;) {
        cig_push(cg, rev[k] & 0xF, rev[k] >> 4);
    }
    if (is_overlap) {
        rs.score = smin + rs.te - rs.tb;
    } else if (is_extend) {
        rs.score = smin;
    } else {
        const i8 *u_last = uts_v.data() + tlen * bandwidth;
        const long rbeg0 = begs_v[tlen];
        i64 score = sbeg;
        for (long k = 0; k < bandwidth; k++) score += u_last[k];
        for (long k = rbeg0 + bandwidth; k > qlen; k--)
            score -= u_last[k - 1 - rbeg0];
        rs.score = score;
    }
}

// Unique-kmer 1:1 matching + LIS chaining + outlier filter
// (oracle/edit._kmer_chain, bsalign.h:1219-1434). Returns false when the
// chain coverage is too small to trust.
static bool kmer_chain_c(const uint8_t *qseq, long qlen, const uint8_t *tseq,
                         long tlen, int ksz,
                         std::vector<std::pair<i64, i64>> &chain) {
    const long lmin = qlen < tlen ? qlen : tlen;
    long cmin = (long)(lmin * 0.05 + 1);
    if (cmin > 2 * ksz) cmin = 2 * ksz;
    const i64 kmk = ((i64)1 << (2 * ksz)) - 1;
    const int sft = (ksz - 1) * 2;
    struct KEnt { i64 val; i64 off; int dir; int flg; };
    std::vector<KEnt> ents;
    const long mq = qlen - ksz + 1, mt = tlen - ksz + 1;
    ents.reserve((mq > 0 ? mq : 0) + (mt > 0 ? mt : 0));
    for (int which = 0; which < 2; which++) {
        const uint8_t *seq = which ? tseq : qseq;
        const long len = which ? tlen : qlen;
        i64 kf = 0, kr = 0;
        for (long i = 0; i < len; i++) {
            const i64 b = seq[i];
            kf = ((kf << 2) | b) & kmk;
            kr = (kr >> 2) | ((3 - b) << sft);
            if (i + 1 < ksz) continue;
            const int dir = kr < kf;
            ents.push_back({dir ? kr : kf, i - ksz + 1, dir, which});
        }
    }
    // stable sort by kmer value (q entries precede t entries on ties,
    // matching the combined-array stable sort in the oracle)
    std::stable_sort(ents.begin(), ents.end(),
                     [](const KEnt &a, const KEnt &b) { return a.val < b.val; });
    const long n = (long)ents.size();
    std::vector<std::pair<i64, i64>> khits;
    for (long i = 0; i + 1 < n;) {
        long j = i + 1;
        while (j < n && ents[j].val == ents[i].val) j++;
        if (j - i == 2 && ents[i].flg != ents[i + 1].flg &&
            ents[i].dir == ents[i + 1].dir) {
            khits.push_back({ents[i].off, ents[i + 1].off});
        }
        i = j;
    }
    if ((long)khits.size() * ksz < cmin) return false;
    std::stable_sort(khits.begin(), khits.end(),
                     [](const std::pair<i64, i64> &a,
                        const std::pair<i64, i64> &b) {
                         return a.first < b.first;
                     });
    const long kcnt = (long)khits.size();
    // LIS over target offsets, exact linking rule incl.
    // predecessor-of-predecessor (bsalign.h:1285-1330)
    std::vector<long> lis0(kcnt, 0), lis1(kcnt, -1);
    long xlen = 1;
    for (long i = 1; i < kcnt; i++) {
        const i64 t_i = khits[i].second;
        const long e = xlen - 1;
        if (t_i > khits[lis0[e]].second) {
            lis1[i] = lis0[e];
            lis0[xlen] = i;
            xlen++;
        } else if (t_i <= khits[lis0[0]].second) {
            lis1[i] = -1;
            lis0[0] = i;
        } else {
            long lo = 0, hi = xlen;
            while (lo < hi) {
                const long mid = lo + ((hi - lo) >> 1);
                if (t_i > khits[lis0[mid]].second) {
                    lo = mid + 1;
                } else if (t_i < khits[lis0[mid]].second) {
                    hi = mid;
                } else {
                    lo = mid;
                    break;
                }
            }
            lis1[i] = lis1[lis0[lo - 1]];
            lis0[lo] = i;
        }
    }
    std::vector<char> flags(kcnt, 0);
    i64 cov = 0;
    i64 e_off = -1;
    int have_e = 0;
    long m = lis0[xlen - 1];
    while (m >= 0) {
        flags[m] = 1;
        const i64 toff = khits[m].second;
        if (!have_e || toff + ksz <= e_off) cov += ksz;
        else cov += e_off - toff;
        e_off = toff;
        have_e = 1;
        m = lis1[m];
    }
    if (cov < cmin) return false;
    // iterative mean/median outlier filter (bsalign.h:1346-1393)
    thread_local std::vector<i64> deltas;
    while (true) {
        deltas.clear();
        for (long i = 0; i < kcnt; i++)
            if (flags[i]) deltas.push_back(khits[i].first - khits[i].second);
        const long e = (long)deltas.size();
        if (e * ksz < cmin) break;
        i64 tot = 0;
        for (i64 d : deltas) tot += d;
        const i64 mean = tot / e;   // C trunc division == oracle c_div
        std::nth_element(deltas.begin(), deltas.begin() + e / 2,
                         deltas.end());
        const i64 median = deltas[e / 2];
        i64 var = (median > mean ? median - mean : mean - median) * 3;
        if (var < 50) var = 50;
        long removed = 0;
        for (long i = 0; i < kcnt; i++) {
            if (!flags[i]) continue;
            const i64 delta = khits[i].first - khits[i].second;
            const i64 ad = delta > mean ? delta - mean : mean - delta;
            if (ad > var) {
                flags[i] = 0;
                removed++;
            }
        }
        if (removed == 0) break;
    }
    chain.clear();
    for (long i = 0; i < kcnt; i++)
        if (flags[i]) chain.push_back(khits[i]);
    // coverage over target offsets with overlap dedup (bsalign.h:1402-1415)
    i64 mcov = 0, e2 = 0;
    for (auto &p : chain) {
        const i64 toff = p.second;
        if (toff >= e2 + ksz) mcov += ksz;
        else mcov += toff + ksz - e2;
        e2 = toff + ksz;
    }
    if (mcov < cmin) return false;
    return true;
}

extern "C" long bsa_edit_align(const uint8_t *qseq, long qlen,
                               const uint8_t *tseq, long tlen, long modetype,
                               long bandwidth, u4 *cigars, long cap,
                               i64 *rs_out) {
    std::vector<u4> cg;
    EditRS rs;
    edit_align_c(qseq, qlen, tseq, tlen, (int)modetype, bandwidth, cg, rs);
    if ((long)cg.size() > cap) return -1;
    memcpy(cigars, cg.data(), cg.size() * sizeof(u4));
    memcpy(rs_out, &rs, sizeof(rs));
    return (long)cg.size();
}

// kmer_striped_seqedit_pairwise (oracle/edit.kmer_edit_pairwise,
// bsalign.h:1209-1536): segmented edit alignment guided by kmer synteny.
extern "C" long bsa_kmer_edit(const uint8_t *qseq, long qlen,
                              const uint8_t *tseq, long tlen, long ksz,
                              u4 *cigars, long cap, i64 *rs_out) {
    if (ksz > 15) ksz = 15;
    std::vector<std::pair<i64, i64>> chain;
    if (!kmer_chain_c(qseq, qlen, tseq, tlen, (int)ksz, chain)) {
        return bsa_edit_align(qseq, qlen, tseq, tlen, 0, 0, cigars, cap,
                              rs_out);
    }
    EditRS RS;
    memset(&RS, 0, sizeof(RS));
    std::vector<u4> cg;
    i64 qb = 0, tb = 0, ml = 0;
    int mode = 3;   // KMER sentinel for the first segment
    const long kmap = (long)chain.size();
    thread_local std::vector<uint8_t> rq_v, rt_v;
    for (long i = 0; i <= kmap; i++) {
        i64 qe, te;
        if (i == kmap) {
            qe = qlen; te = tlen; mode = 2;   // EXTEND tail
        } else {
            qe = chain[i].first + ksz / 2;
            te = chain[i].second + ksz / 2;
            ml++;
        }
        if (!(qb == qe && tb == te)) {
            if (ml) {
                cig_push(cg, 0, ml);
                RS.mat += ml;
                RS.aln += ml;
                ml = 0;
            }
            EditRS rs2;
            if (mode == 3) {
                // first segment: reversed prefixes, EXTEND. The oracle
                // appends cg2 then reverses the WHOLE list (no run
                // merging): [M_ml, cg2...] -> [rev(cg2)..., M_ml]
                rq_v.resize(qe); rt_v.resize(te);
                for (long k = 0; k < qe; k++) rq_v[k] = qseq[qe - 1 - k];
                for (long k = 0; k < te; k++) rt_v[k] = tseq[te - 1 - k];
                std::vector<u4> cg2;
                edit_align_c(rq_v.data() + qb, qe - qb, rt_v.data() + tb,
                             te - tb, 2, 0, cg2, rs2);
                cg.insert(cg.end(), cg2.begin(), cg2.end());
                std::reverse(cg.begin(), cg.end());
                RS.qb = qe - rs2.qe;
                RS.tb = te - rs2.te;
                RS.qe = qe;
                RS.te = te;
            } else {
                std::vector<u4> cg2;
                edit_align_c(qseq + qb, qe - qb, tseq + tb, te - tb, mode, 0,
                             cg2, rs2);
                for (u4 c : cg2) cig_push(cg, c & 0xF, c >> 4);
                RS.qe = qb + rs2.qe;
                RS.te = tb + rs2.te;
            }
            RS.mat += rs2.mat;
            RS.mis += rs2.mis;
            RS.ins += rs2.ins;
            RS.del_ += rs2.del_;
            RS.aln += rs2.aln;
            RS.score += rs2.score;
        }
        qb = qe + 1;
        tb = te + 1;
        mode = 0;   // GLOBAL for middle segments
    }
    if ((long)cg.size() > cap) return -1;
    memcpy(cigars, cg.data(), cg.size() * sizeof(u4));
    memcpy(rs_out, &RS, sizeof(RS));
    return (long)cg.size();
}

// ---- query-profile builds (bsalign.h:2166-2221 / oracle/banded8.py) ----
// All four POA profiles ({M, M+refbonus} x {hpc, plain}) in one call.
// Layout per profile: [xlen+1, 4(tbase), WSZ] int8.
extern "C" void bsa_qprof4(const uint8_t *qsub, long slen, long bandwidth,
                           long M, long X, long refbonus,
                           i8 *hpc0, i8 *hpc1, i8 *pl0, i8 *pl1) {
    const long W = bandwidth / WSZ;
    const long xlen = slen > bandwidth ? slen : bandwidth;
    i8 m0[5][4], m1[5][4];
    for (int q = 0; q < 5; q++)
        for (int t = 0; t < 4; t++) {
            if (q >= 4) {
                m0[q][t] = m1[q][t] = (i8)SCORE_EPI8_MIN;
            } else {
                m0[q][t] = (i8)(q == t ? M : X);
                m1[q][t] = (i8)(q == t ? M + refbonus : X);
            }
        }
    for (long x = 0; x <= xlen; x++) {
        for (long j = 0; j < WSZ; j++) {
            const long pos = x + j * W;
            const long o = (x * 4) * WSZ + j;
            if (pos >= slen) {
                for (int t = 0; t < 4; t++)
                    hpc0[o + t * WSZ] = hpc1[o + t * WSZ] =
                        pl0[o + t * WSZ] = pl1[o + t * WSZ] =
                            (i8)SCORE_EPI8_MIN;
                continue;
            }
            const int qv = qsub[pos];
            const int bon =
                (pos + 1 < slen && qsub[pos] != qsub[pos + 1]) ? 1 : 0;
            for (int t = 0; t < 4; t++) {
                // hpc values wrap like the C b1i store
                hpc0[o + t * WSZ] = (i8)(m0[qv][t] + bon);
                hpc1[o + t * WSZ] = (i8)(m1[qv][t] + bon);
                pl0[o + t * WSZ] = m0[qv][t];
                pl1[o + t * WSZ] = m1[qv][t];
            }
        }
    }
}

// ---- simple consensus (bspoa.h:3312-3388 / poa/core.simple_cns) ----
// Lead/tail gap masking + majority vote with first-seen-rank tie-break +
// per-read cpos writeback. Returns cns length; writes bsel per column.
extern "C" long bsa_simple_cns(
    uint8_t *msacols /*[ncols, mrow]*/, const i64 *msaidxs, long mlen,
    long mrow, long nseq, long nall, i32 *cpos /*node CPOS array*/,
    const i64 *ndoffs, uint8_t *cns_out /*[mlen]*/) {
    // mask leading/trailing gaps (cols 0 / >=1) to 5 per read
    for (long r = 0; r < nseq; r++) {
        long first = mlen, last = -1;
        for (long p = 0; p < mlen; p++) {
            if (msacols[msaidxs[p] * mrow + r] < 4) { first = p; break; }
        }
        for (long p = mlen - 1; p >= 0; p--) {
            if (msacols[msaidxs[p] * mrow + r] < 4) { last = p; break; }
        }
        for (long p = 0; p < first && p < mlen; p++) {
            uint8_t &c = msacols[msaidxs[p] * mrow + r];
            if (c == 4) c = 5;
        }
        if (last >= 0)
            for (long p = last + 1; p < mlen; p++) {
                if (p < 1) continue;
                uint8_t &c = msacols[msaidxs[p] * mrow + r];
                if (c == 4) c = 5;
            }
        else
            for (long p = 1; p < mlen; p++) {
                uint8_t &c = msacols[msaidxs[p] * mrow + r];
                if (c == 4) c = 5;
            }
    }
    long clen = 0;
    for (long p = 0; p < mlen; p++) {
        uint8_t *col = msacols + msaidxs[p] * mrow;
        long cnt[5] = {0, 0, 0, 0, 0};
        long rank[5] = {0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF, 0xFFFF};
        for (long r = 0; r < nseq; r++) {
            const int b = col[r];
            if (b <= 4) {
                if (cnt[b] == 0) rank[b] = r;
                cnt[b]++;
            }
        }
        int bsel = 4;
        for (int i = 0; i < 4; i++) {
            if (cnt[i] > cnt[bsel]) bsel = i;
            else if (cnt[i] && cnt[i] == cnt[bsel] &&
                     (rank[i] < rank[bsel] || bsel == 4)) bsel = i;
        }
        col[nall] = (uint8_t)bsel;
        col[nall + 1] = 0;
        cns_out[p] = (uint8_t)bsel;
        if (bsel < 4) clen++;
    }
    // per-read cpos: cns position before the read base's column
    for (long r = 0; r < nseq; r++) {
        long cp = 0, k = 0;
        const long off = ndoffs[r];
        for (long p = 0; p < mlen; p++) {
            const uint8_t *col = msacols + msaidxs[p] * mrow;
            const int b = col[r];
            if (b != 4 && b != 5) cpos[off + k++] = (i32)cp;
            if (col[nall] < 4) cp++;
        }
    }
    return clen;
}

// ---- lead/tail gap masking (bspoa.h:3215-3234, the msa_bspoa 4->5 edge
// trim; shared by msa and simple_cns) ----
extern "C" void bsa_mask_lead_tail(uint8_t *msacols, const i64 *msaidxs,
                                   long mlen, long mrow, long nseq) {
    for (long r = 0; r < nseq; r++) {
        long first = mlen, last = -1;
        for (long p = 0; p < mlen; p++)
            if (msacols[msaidxs[p] * mrow + r] < 4) { first = p; break; }
        for (long p = mlen - 1; p >= 0; p--)
            if (msacols[msaidxs[p] * mrow + r] < 4) { last = p; break; }
        for (long p = 0; p < first && p < mlen; p++) {
            uint8_t &c = msacols[msaidxs[p] * mrow + r];
            if (c == 4) c = 5;
        }
        const long tail0 = (last >= 0 ? last + 1 : 1);
        for (long p = tail0 < 1 ? 1 : tail0; p < mlen; p++) {
            uint8_t &c = msacols[msaidxs[p] * mrow + r];
            if (c == 4) c = 5;
        }
    }
}

// ---- whole remsa round in one call (bspoa.h:4178-4457 core-read loop) ----
// For each core read: cut the chain out of the rings, rebuild the read-side
// profile operands from mpos/base, run the pedit forward + traceback
// (ring merges), reconnect the chain. Capacity-checked per read: returns
// the first unprocessed rid when edge headroom runs low (caller encaps and
// resumes), nrds when done, negative on hard errors.
extern "C" long bsa_remsa_round(
    GFULL_ARGS, long nnodes,
    const i32 *nd_mpos, const i32 *nd_base,
    const i64 *ndoffs, const i64 *rdlens, long nrds, long start_rid,
    uint8_t *seqs0, uint8_t *mats0,
    const uint8_t *seqs1, const uint8_t *mats1,
    uint8_t *matrix0, uint8_t *matrix1,
    long mlen, long bw, long HW, long rowlen, long pad,
    long nseq_plus1) {
    for (long rid = start_rid; rid < nrds; rid++) {
        const long rdlen = rdlens[rid];
        if (rdlen == 0) continue;
        // per-read headroom: cuts/merges move bounded-degree edge lists;
        // 12 slots per base + slack covers the worst observed growth
        if (estate[0] + 12 * rdlen + 4096 >= estate[2]) return rid;
        const long qb = 0, qe = rdlen;
        const long base_idx = ndoffs[rid];
        const long mbeg = nd_mpos[base_idx + qb];
        const long mend = nd_mpos[base_idx + qe - 1] + 1;
        memset(seqs0, 4, pad);
        // the reference clears 4*(mlen+bw) bytes over count planes spaced
        // roundup16(mlen+bw) apart (bspoa.h:4348): when pad % 16 != 0 the
        // T-plane tail keeps the previous read's homopolymer counts and
        // the DP reads them — replicate the carry-over byte-for-byte
        {
            const long pad16 = (pad + 15) & ~15L;
            long clr = 4 * pad - 3 * pad16;
            if (clr < 0) clr = 0;
            if (clr > pad) clr = pad;
            memset(mats0, 0, 3 * pad + clr);
        }
        long lc = 4, cc = 0;
        {
            const long r = bsa_g_cut_range(
                nd_rid, nd_cov, nd_rdc, nd_rdd, nd_nin, nd_nou, nd_edge,
                nd_erev, nd_next, nd_prev, nd_header, ed_node, ed_cov,
                ed_vst, ed_next, estate, ecyc, nnodes, base_idx, qb, qe, 3);
            if (r < 0) return -1;
        }
        for (long i = qe; i > qb; i--) {
            const long ni = base_idx + i - 1;
            const long mp = nd_mpos[ni];
            const long b = nd_base[ni];
            seqs0[HW + mp] = (uint8_t)b;
            if (b == lc) {
                if (cc < 255) cc++;
                mats0[b * pad + HW + mp] = (uint8_t)cc;
            } else {
                lc = b;
                cc = 0;
            }
        }
        bsa_pedit_forward(matrix0, matrix1, seqs0, seqs1, mats0, mats1,
                          (int)mlen, (int)mbeg, (int)mend, (int)bw, (int)HW,
                          (int)rowlen, pad);
        {
            const long r = bsa_pedit_traceback(
                nd_rid, nd_cov, nd_rdc, nd_rdd, nd_nin, nd_nou, nd_edge,
                nd_erev, nd_next, nd_prev, nd_header, ed_node, ed_cov,
                ed_vst, ed_next, estate, ecyc,
                matrix0, matrix1, seqs0, seqs1, mats0, mats1, ndoffs,
                mlen, mbeg, mend, HW, rowlen, pad, rid, nseq_plus1, qe);
            if (r < 0) return -3;
        }
        {
            const long r = bsa_g_connect_range(
                nd_rid, nd_cov, nd_rdc, nd_rdd, nd_nin, nd_nou, nd_edge,
                nd_erev, nd_next, nd_prev, nd_header, ed_node, ed_cov,
                ed_vst, ed_next, estate, ecyc, base_idx, 0, rdlen);
            if (r < 0) return -4;
        }
    }
    return nrds;
}

// ---- per-read mega-call: sel + band placement + row DP + graph merge ----
// One C call per read replacing the Python orchestration of BSPOA.align_rd
// (poa/core.py:996-1027, reference bspoa.h:2064-2272): sel_nodes ->
// prepare_rd_align (kmer-chained consensus band placement, bspoa.h:1878-
// 1950) -> align_rd_core -> alignment2graph -> bridge-edge reverts.
// Returns 0 on success; -9 means "config not handled here" (refmode CIGAR
// placement, ksz==0 band trigger) and the caller must run the Python path.
#define GFULL_FWD                                                          \
    nd_rid, nd_cov, nd_rdc, nd_rdd, nd_nin, nd_nou, nd_edge, nd_erev,      \
    nd_next, nd_prev, nd_header, ed_node, ed_cov, ed_vst, ed_next,         \
    estate, ecyc

static void row_init_c(long mode, long bandwidth, long nt_max, long nt_min,
                       long gapo1, long gape1, long gapo2, long gape2,
                       i8 *us, i8 *es, i8 *qs, i64 *ubegs) {
    // port of oracle/banded8.row_init (bsalign.h:2094-2140)
    const long W = bandwidth / WSZ;
    const bool pw2 =
        (gapo2 < gapo1 && gape2 > gape1 && gapo2 + gape2 < gapo1 + gape1
         && (gapo1 - gapo2) / (gape1 - gape2) < bandwidth);
    const long mt = mode & 0x3;
    if (mt == 0 || mt == 2) {              // GLOBAL or EXTEND
        if (pw2) {
            const long xp = (gapo2 - gapo1) / (gape1 - gape2);
            memset(us, (uint8_t)(i8)gape2, (size_t)W * WSZ);
            for (int k = 0; k < WSZ; k++) ubegs[k] = gape2 * W;
            us[0] = wrap8(gapo1 + gape1 + nt_min - nt_max);
            ubegs[0] += (i64)us[0] - gape2;
            for (long k = 1; k < xp; k++) {
                // striped coord: us[(k%W)*WSZ + k/W]
                us[(k % W) * WSZ + k / W] = (i8)gape1;
                ubegs[k / W] += gape1 - gape2;
            }
        } else {
            memset(us, (uint8_t)(i8)gape1, (size_t)W * WSZ);
            us[0] = wrap8(gapo1 + gape1 + nt_min - nt_max);
            for (int k = 0; k < WSZ; k++) ubegs[k] = gape1 * W;
            ubegs[0] += (i64)us[0] - gape1;
        }
        i64 s = nt_max - nt_min;
        for (int k = 0; k < WSZ; k++) {
            const i64 t = ubegs[k];
            ubegs[k] = s;
            s += t;
        }
        ubegs[WSZ] = s;
    } else {
        memset(us, 0, (size_t)W * WSZ);
        for (int k = 0; k <= WSZ; k++) ubegs[k] = 0;
    }
    if (pw2) {
        memset(es, (uint8_t)(i8)SCORE_EPI8_MIN, (size_t)W * WSZ);
        memset(qs, (uint8_t)(i8)SCORE_EPI8_MIN, (size_t)W * WSZ);
    } else if (gapo1) {
        memset(es, (uint8_t)(i8)SCORE_EPI8_MIN, (size_t)W * WSZ);
    }
}

extern "C" long bsa_align_rd_full(
    GFULL_ARGS,
    i32 *nd_mpos, i32 *nd_vst, i32 *nd_nct, i32 *nd_mmidx,
    const i32 *nd_base, i32 *nd_bonus, const i32 *nd_bless,
    i32 *nd_rpos, i32 *nd_cpos,
    const i64 *ndoffs, long nnodes, long HEADi, long TAILi,
    const uint8_t *rdseq, const uint8_t *cns, long cnslen,
    long alnmode, long par_bw, long bwtrigger, long ksz, long nrec,
    long M, long X, long refbonus, long O_, long E_, long Q_, long P_,
    long T_,
    long nseq, long rid, long rbeg, long rend, long realn,
    i64 *rs_out /*[score,qb,qe,tb,te,mat,mis,ins,del,aln]*/) {
    const long mt = alnmode & 0x3;
    const long is_overlap = mt == 1, is_global = mt == 0;
    if (realn && rid) {
        for (long pos = rbeg; pos < rend; pos++) {
            if (bsa_g_cut_rdnode(GFULL_FWD, nnodes, ndoffs[rid] + pos,
                                 3) < 0)
                return -1;
        }
    }
    for (int k = 0; k < 10; k++) rs_out[k] = 0;
    const long rlen = rend - rbeg;
    if (rlen == 0) return 0;
    long nhead = nd_header[ndoffs[rid] + rbeg - 1];
    long ntail = nd_header[ndoffs[rid] + rend];
    long ridxbeg = 0, ridxend = 0xFFFF;
    if (!realn && nrec) {
        ridxbeg = rid - nrec - 1 > 0 ? rid - nrec - 1 : 0;
        ridxend = rid;
    }
    // --- sel_nodes (native body reused) ---
    thread_local std::vector<uint8_t> states_v;
    thread_local std::vector<i32> sels_v, stack_v;
    thread_local std::vector<i64> td_v;
    states_v.assign(nnodes, 0);
    sels_v.resize(nnodes + 8);
    td_v.resize(2 * nnodes + 8);
    i64 selout[2];
    if (bsa_sel_nodes(GFULL_FWD, nd_vst, nd_nct, nd_bonus, nd_bless, ndoffs,
                      nnodes, nhead, ntail, ridxbeg, ridxend, nseq,
                      states_v.data(), sels_v.data(), (long)sels_v.size(),
                      td_v.data(), (long)td_v.size(), selout) < 0)
        return -1;
    const long nsel = selout[0];
    thread_local std::vector<i64> todels;
    todels.assign(td_v.begin(), td_v.begin() + selout[1]);
    GFULL_PACK;
    // --- prepare_rd_align (poa/core.py:488-673, non-refmode paths) ---
    nhead = nd_header[nhead];
    ntail = nd_header[ntail];
    const long seqlen = rlen;
    long qb = 0, qe = seqlen, slen = seqlen;
    const uint8_t *qseq = rdseq + rbeg;
    const long reflen = cnslen;
    long tb = 0, te = reflen;
    long bandwidth;
    if (par_bw == 0)
        bandwidth = (seqlen + WSZ - 1) / WSZ * WSZ;
    else {
        const long b0 = par_bw < seqlen ? par_bw : seqlen;
        bandwidth = (b0 + WSZ - 1) / WSZ * WSZ;
    }
    thread_local std::vector<u4> cg_v;
    long ncg = 0;
    long x = 0, y = 0;
    if (bwtrigger && nhead == HEADi && ntail == TAILi && cnslen
            && (seqlen + WSZ - 1) / WSZ * WSZ > par_bw) {
        if (ksz <= 0) return -9;           // edit-band path stays in Python
        cg_v.resize(seqlen + cnslen + 16);
        i64 ers[10];
        ncg = bsa_kmer_edit(qseq, seqlen, cns, cnslen, ksz, cg_v.data(),
                            (long)cg_v.size(), ers);
        if (ncg < 0) return -1;
        qb = ers[0];
        qe = ers[1];
        slen = qe - qb;
        const long rtb = ers[2], rte = ers[3];
        tb = rtb >= bandwidth / 2 ? rtb - bandwidth / 4 : 0;
        te = (cnslen - rte >= bandwidth / 2) ? rte + bandwidth / 4 : cnslen;
        x = 0;
        y = rtb;
    } else if (bwtrigger && nhead == HEADi && ntail == TAILi) {
        bandwidth = (seqlen + WSZ - 1) / WSZ * WSZ;
    } else {
        bandwidth = (seqlen + WSZ - 1) / WSZ * WSZ;
    }
    if (ncg > 0) {
        // rmap + band placement (vectorized python twin, core.py:574-613)
        thread_local std::vector<i64> rmap;
        rmap.assign(reflen + 1, 0);
        if (y > 1)
            for (long i = 1; i < y; i++) rmap[i] = i * qb / (y + 1);
        long xx = x, yy = y;
        for (long i = 0; i < ncg; i++) {
            const long op = cg_v[i] & 0xF;
            const long sz = cg_v[i] >> 4;
            const bool is_m = op == 0 || op == 7 || op == 8;
            const bool is_d = op == 2 || op == 3 || op == 5;
            if (is_m)
                for (long k = 0; k < sz; k++) rmap[yy + k] = xx + k;
            else if (is_d)
                for (long k = 0; k < sz; k++) rmap[yy + k] = xx;
            if (is_m || op == 1 || op == 4) xx += sz;
            if (is_m || is_d) yy += sz;
        }
        if (reflen > yy)
            for (long j = yy; j < reflen; j++)
                rmap[j] = xx + (j - yy + 1) * (slen - xx)
                          / (reflen - yy + 1);
        rmap[reflen] = slen;
        if (bandwidth >= slen) {
            for (long k = 0; k < nsel; k++) nd_rpos[sels_v[k]] = 0;
        } else {
            for (long k = 0; k < nsel; k++) {
                const long s = sels_v[k];
                i64 v = rmap[nd_cpos[s]] - bandwidth / 2;
                if (v < 0) v = 0;
                if (v > slen - bandwidth) v = slen - bandwidth;
                nd_rpos[s] = (i32)v;
            }
        }
        // bridge the first selected node at the band ends to HEAD/TAIL
        // (bspoa.h:1910-1940)
        if (tb) {
            for (long k = 0; k < nsel; k++) {
                const long s = sels_v[k];
                if (nd_cpos[s] != tb) continue;
                const long r = g_chg_edge(G.E, nhead, s, 1);
                if (estate[3]) return -2;
                todels.push_back(nhead);
                todels.push_back(s);
                if ((r & 1) == 0 && states_v[nhead] && states_v[s])
                    nd_nct[s] += 1;
                break;
            }
        }
        if (te != reflen) {
            for (long k = 0; k < nsel; k++) {
                const long s = sels_v[k];
                if (nd_cpos[s] != te) continue;
                const long r = g_chg_edge(G.E, s, ntail, 1);
                if (estate[3]) return -2;
                todels.push_back(nd_header[s]);
                todels.push_back(ntail);
                if ((r & 1) == 0 && states_v[ntail] && states_v[s])
                    nd_nct[ntail] += 1;
                break;
            }
        }
    } else {
        for (long k = 0; k < nsel; k++) nd_rpos[sels_v[k]] = 0;
    }
    // --- profiles, arena, init row (core.py:636-673) ---
    const long mmcnt = 2 + nsel;
    for (long k = 0; k < nsel; k++) nd_mmidx[sels_v[k]] = (i32)(2 + k);
    const bool pw2 =
        (Q_ < O_ && P_ > E_ && Q_ + P_ < O_ + E_
         && (O_ - Q_) / (E_ - P_) < bandwidth);
    const long piecewise = pw2 ? 2 : (O_ ? 1 : 0);
    const long W = bandwidth / WSZ;
    const long xlen = slen > bandwidth ? slen : bandwidth;
    thread_local std::vector<i8> qp_v[4];
    for (int k = 0; k < 4; k++) qp_v[k].resize((xlen + 1) * 4 * WSZ);
    bsa_qprof4(qseq + qb, slen, bandwidth, M, X, refbonus, qp_v[0].data(),
               qp_v[1].data(), qp_v[2].data(), qp_v[3].data());
    thread_local std::vector<i8> aus_v, aes_v, aqs_v;
    thread_local std::vector<i64> aub_v;
    const size_t rowsz = (size_t)W * WSZ;
    aus_v.assign(mmcnt * rowsz, 0);
    i8 *aes = nullptr, *aqs = nullptr;
    if (piecewise >= 1) {
        aes_v.assign(mmcnt * rowsz, 0);
        aes = aes_v.data();
    }
    if (piecewise == 2) {
        aqs_v.assign(mmcnt * rowsz, 0);
        aqs = aqs_v.data();
    }
    aub_v.assign(mmcnt * (WSZ + 1), 0);
    const long slot = nd_mmidx[nhead];
    row_init_c(alnmode, bandwidth, M + refbonus + 1, X, O_, E_, Q_, P_,
               aus_v.data() + slot * rowsz,
               aes ? aes + slot * rowsz : nullptr,
               aqs ? aqs + slot * rowsz : nullptr,
               aub_v.data() + slot * (WSZ + 1));
    // --- row DP + graph merge ---
    i64 best[3] = {SCORE_MIN_I, -1, -1};
    stack_v.resize(nsel + 8);
    if (bsa_align_rd_core(nd_mpos, nd_vst, nd_nct, nd_mmidx, nd_base,
                          nd_bonus, nd_rpos, nd_edge, ed_node, ed_next,
                          states_v.data(), sels_v.data(), nsel,
                          aus_v.data(), aes, aqs, aub_v.data(),
                          qp_v[0].data(), qp_v[1].data(), qp_v[2].data(),
                          qp_v[3].data(), W, bandwidth, slen, piecewise,
                          M + refbonus + 1, X, O_, E_, Q_, P_, T_,
                          is_overlap, is_global, nhead, ntail, best,
                          stack_v.data(), (long)stack_v.size()) < 0)
        return -1;
    if (bsa_alignment2graph(GFULL_FWD, nd_mpos, nd_rpos, nd_mmidx, nd_base,
                            nd_bonus, nd_cpos, states_v.data(), ndoffs,
                            aus_v.data(), aes, aqs, aub_v.data(),
                            qp_v[0].data(), qp_v[1].data(), qp_v[2].data(),
                            qp_v[3].data(), W, bandwidth, seqlen, qb,
                            piecewise, O_, E_, Q_, P_, is_overlap, nhead,
                            ntail, best[1], best[2], rid, rbeg,
                            rs_out) < 0)
        return -2;
    rs_out[1] += qb;                       // rs.qb/qe are read-window
    rs_out[2] += qb;                       // relative (core.py:1021-1022)
    rs_out[0] = best[0];                   // rs.score = align_rd_core max
    for (size_t k = 0; k + 1 < todels.size(); k += 2) {
        g_chg_edge(G.E, todels[k], todels[k + 1], -1);
        if (estate[3]) return -2;
    }
    return 0;
}

// ---- native incremental-alignment loop of end_bspoa (bspoa.h:4745-4760;
// python twin poa/core.py BSPOA.end_begin) ----
// Per read rid in [rid_start, nmsa): when bwtrigger, recompute the running
// MSA + majority consensus (sort_nodes -> msa_fill -> mask -> simple_cns,
// all in-process), then run the per-read mega-call bsa_align_rd_full.
// The per-read Python glue (two bindings + list(range(mlen)) + buffer
// allocs + ~60-arg ctypes marshals) was a measurable slice of POA window
// latency; this turns a whole window's incremental build into O(1) calls.
// Capacity contract mirrors bsa_remsa_round: returns the first unprocessed
// rid with out[2] = 0 (edge headroom low: caller encaps and resumes),
// 1 (read needs the Python align path: ksz==0 band trigger), or
// 2 (msacols/cns buffers too small for mlen: caller regrows and resumes);
// returns nmsa when done (out[2] = 3). out[0]/out[1] carry the current
// mlen/clen across resumes so the caller can reconstruct msa state.
extern "C" long bsa_end_begin_loop(
    GFULL_ARGS,
    i32 *nd_mpos, i32 *nd_vst, i32 *nd_nct, i32 *nd_inuse,
    i32 *nd_mmidx, const i32 *nd_base, i32 *nd_bonus, const i32 *nd_bless,
    i32 *nd_rpos, i32 *nd_cpos,
    const i64 *ndoffs, const i64 *rdlens,
    const uint8_t *seqcat, const i64 *seqoffs,
    long nnodes, long HEADi, long TAILi,
    long alnmode, long par_bw, long bwtrigger, long ksz, long nrec,
    long M, long X, long refbonus, long O_, long E_, long Q_, long P_,
    long T_,
    long nmsa, long nall, long rid_start,
    uint8_t *msacols, long mrow, long msacols_cap,
    uint8_t *cns_buf, long cns_cap,
    i32 *stack_buf, long stack_cap,
    i64 *out /*[mlen, clen, flag]*/) {
    thread_local std::vector<i64> idx_v;
    long mlen = out[0], clen = out[1];
    for (long rid = rid_start; rid < nmsa; rid++) {
        const long rlen = rdlens[rid];
        // same per-call headroom the Python caller grants align_rd_full
        if (estate[0] + 4 * nnodes + 24 * (rlen + 4) + 2048 >= estate[2]) {
            out[0] = mlen; out[1] = clen; out[2] = 0;
            return rid;
        }
        if (bwtrigger) {
            mlen = bsa_sort_nodes(nd_mpos, nd_vst, nd_nct, nd_inuse,
                                  nd_nin, nd_nou, nd_next, nd_edge,
                                  nd_erev, ed_node, ed_next, nnodes, HEADi,
                                  TAILi, stack_buf, stack_cap);
            if (mlen < 0) return -1;
            if (mlen * mrow > msacols_cap || mlen > cns_cap) {
                out[0] = mlen; out[1] = clen; out[2] = 2;
                return rid;
            }
            if ((long)idx_v.size() < mlen) {
                long old = (long)idx_v.size();
                idx_v.resize(mlen);
                for (long i = old; i < mlen; i++) idx_v[i] = i;
            }
            memset(msacols, 4, (size_t)(mlen * mrow));
            if (bsa_msa_fill(nd_mpos, nd_vst, nd_nct, nd_nin, nd_next,
                             nd_edge, nd_erev, nd_rid, nd_base, ed_node,
                             ed_next, nnodes, HEADi, TAILi, msacols,
                             idx_v.data(), mlen, mrow, stack_buf,
                             stack_cap) < 0)
                return -2;
            // msa() masks lead/tail gaps after the fill; nrds == rid here
            bsa_mask_lead_tail(msacols, idx_v.data(), mlen, mrow, rid);
            clen = bsa_simple_cns(msacols, idx_v.data(), mlen, mrow, rid,
                                  nall, nd_cpos, ndoffs, cns_buf);
            if (clen < 0) return -3;
            long w = 0;                     // compact gap columns away
            for (long p = 0; p < mlen; p++)
                if (cns_buf[p] < 4) cns_buf[w++] = cns_buf[p];
            nd_cpos[HEADi] = 0;
            nd_cpos[TAILi] = (i32)clen;
        }
        i64 rs_tmp[10];
        const long r = bsa_align_rd_full(
            GFULL_FWD, nd_mpos, nd_vst, nd_nct, nd_mmidx, nd_base,
            nd_bonus, nd_bless, nd_rpos, nd_cpos, ndoffs, nnodes, HEADi,
            TAILi, seqcat + seqoffs[rid], cns_buf, clen, alnmode, par_bw,
            bwtrigger, ksz, nrec, M, X, refbonus, O_, E_, Q_, P_, T_,
            nmsa, rid, 0, rlen, 0, rs_tmp);
        if (r == -9) {                      // config the C path skips
            out[0] = mlen; out[1] = clen; out[2] = 1;
            return rid;
        }
        if (r < 0) return -10 + r;
    }
    out[0] = mlen;
    out[1] = clen;
    out[2] = 3;
    return nmsa;
}
