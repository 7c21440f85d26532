// Types and int8 helpers shared by kernel A's two designs, the narrow
// row (banded8.cu) and the wide row (banded8_wide.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WS = 16;
constexpr int G = 8;   // stripes per group: one 8-byte word per lane and plane
constexpr int MIN8 = -63;
constexpr int MAX8 = 63;
constexpr unsigned MIN8X4 = 0xC1C1C1C1u;   // MIN8 in each byte
constexpr int SCORE_MIN = -(0x7FFFFFFF >> 2);
constexpr int NEGK = -(1 << 30);
// every shuffle runs with the whole warp: its two pairs take the same path
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int EMIT_CODES = 0, EMIT_PLANES = 1, EMIT_NONE = 2;
// phases of the optional cycle split: band move (with getscore), row head,
// pass 1, F-loop(s), pass 2 with its tail, steering with best end, emit
constexpr int NPHASE = 7;

typedef unsigned long long u64;

struct Params {
    const uint8_t *qb;
    const int *tseq, *qlen, *tlen, *rbz, *rby, *mtx5;
    const int *init_us, *init_es, *init_qs, *init_ub, *init_reg;
    int *codes;
    int8_t *us_o, *es_o, *qs_o;
    int *ubegs, *begs, *fin_us, *fin_es, *fin_qs, *fin_ub, *fin_reg;
    long long *cycles;   // [NPHASE, B] cycle split, or null
    int *replays;        // wide kernel: [B] rows replayed, or null
    int8_t *gs;          // GS: the planes' scratch, 2 * BUF bytes per slot
    int B, QPU, T, row0, W, gapo1, gape1, gapo2, gape2, d_oh, c_oh, ppb;
    int K, R;            // wide kernel: threads a lane, stripes a run
};

// sat8(a + b) = min(max(a + b, -128), 127): one DPX add-min, one max
__device__ __forceinline__ int adds8(int a, int b) {
    return max(__viaddmin_s32(a, b, 127), -128);
}
__device__ __forceinline__ int max3(int a, int b, int c) {
    return __vimax3_s32(a, b, c);
}
__device__ __forceinline__ int wrap8(int v) { return (int)(int8_t)v; }
// signed byte k of a plane word
__device__ __forceinline__ int sbyte(u64 w, int k) {
    return (int)(int8_t)(w >> (8 * k));
}
__device__ __forceinline__ u64 put_byte(int v, int k) {
    return (u64)(uint8_t)v << (8 * k);
}
__device__ __forceinline__ u64 lds64(const int8_t *a) {
    return *reinterpret_cast<const u64 *>(a);
}
__device__ __forceinline__ void sts64(int8_t *a, u64 w) {
    *reinterpret_cast<u64 *>(a) = w;
}
// sum of the signed bytes 0..k of w (k in 0..7)
__device__ __forceinline__ int bytesum(u64 w, int k) {
    const u64 ones = 0x0101010101010101ull;
    const u64 m = k >= 7 ? ones : ones & ((1ull << (8 * (k + 1))) - 1);
    return __dp4a((int)(unsigned)(w >> 32), (int)(unsigned)(m >> 32),
                  __dp4a((int)(unsigned)w, (int)(unsigned)m, 0));
}
// n / W for 0 <= n < 2^32 / W, with mw = 0xFFFFFFFF / W + 1 (0 for W = 1)
__device__ __forceinline__ int div_w(int n, unsigned mw) {
    return mw ? (int)__umulhi((unsigned)n, mw) : n;
}

// A lane's query window of 9 codes at byte offset a: bytes a..a+3 in lo,
// a+4..a+7 in mid, a+8 in the low byte of top (three aligned word loads
// through the read-only path).
struct QWin {
    unsigned lo, mid, top;
};
__device__ __forceinline__ QWin qwin(const uint8_t *__restrict__ qrow, int a) {
    const unsigned *w = reinterpret_cast<const unsigned *>(qrow + (a & ~3));
    const unsigned w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
    const unsigned sh = (unsigned)(a & 3) * 8;
    return {__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
            w2 >> sh};
}
// score of window code k (0..8): S holds the row's scores of codes 0..3
// as bytes; codes of 4 and above select MIN8
__device__ __forceinline__ int qscore(const QWin &q, unsigned S, int k) {
    const unsigned w = k < 4 ? q.lo : (k < 8 ? q.mid : q.top);
    return (int)(int8_t)__byte_perm(S, MIN8X4, w >> (8 * (k & 3)));
}

// nibbles 0..n-1 of a word set (n <= 0: none; n >= 8: all)
__device__ __forceinline__ unsigned nibbles_below(int n) {
    return n <= 0 ? 0u : (n >= G ? ~0u : (1u << (4 * n)) - 1);
}

// bytes k >= n of a word set (n <= 0: all; n >= 8: none)
__device__ __forceinline__ u64 bytes_from(int n) {
    return n <= 0 ? ~0ull : (n >= G ? 0ull : ~0ull << (8 * n));
}

}  // namespace
