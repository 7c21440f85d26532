// Batched bit-parallel edit-distance rows (Myers' bit-vector step over +-1
// difference planes), for Hopper (sm_90a).
//
// Replaces the TPU kernel bsalign_tpu/ops/edit_pallas.py::_get_call.kernel
// (:88-197): for each pair and each target row below its tlen, the band
// shift by the host's movx with the u=+1 overhang and the popcount rebase of
// sbeg, the Eq window of the row's target base at rbeg, the Myers step with
// a carry across all NW words, and for overlap/extend the row score at
// H(qlen-1, i) with its strict minimum (smin, ry); bsalign.h:612-1206. The
// plain PyTorch version of the same function is
// bsalign_tpu_torch/ops/edit.py::forward_plain; the two agree bit for bit.
//
// What bounds it on this card: the latency of each pair's serial chain of
// tlen dependent rows. The bytes are small beside it: a 2 kb pair at band
// 2048 writes 512 bytes of planes per row, and 256 such pairs write
// 268 MB in all, about 80 us at 3.35 TB/s, while 2048 dependent rows of a
// few hundred cycles each take milliseconds.
//
// What the design does about it: one warp per pair, lane l owning the
// contiguous words [l*K, (l+1)*K) of both planes in registers (K =
// ceil(NW/32), a template parameter). A row is then a short chain: the
// binary addition ripples K words per lane and takes its carry into each
// lane from two ballots and one 32-bit addition (carry lookahead over the
// lanes' generate/propagate bits); the one-bit left shift of HP/HN takes
// the lower lane's top bit by one shuffle; popcounts are __popc plus a
// warp reduction. The band shift by whole words crosses lanes through a
// small shared buffer. A pair's per-row scalars (target base, rbeg, movx)
// are loaded 32 rows at a time, one row per lane, and broadcast by shuffle.
// One warp per block, so 256 pairs spread over the SMs.
//
// Layouts (int32 holding uint32 bits where planes are concerned):
//   qeq [4, B, NWQ], qlen/tlen [B], tseq [B, T], rbegs/movxs [T, B];
//   pm/pp [B, T, NW], sbeg [B, T], fin_pm/fin_pp [B, NW],
//   scal [B, 4] = final sbeg, smin, ry, rbeg at the last row.
// Rows at and past a pair's tlen are not written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SMIN0 = 0x7FFFFFFF;

struct Params {
    const uint32_t *qeq;
    const int *qlen, *tseq, *tlen, *rbegs, *movxs;
    uint32_t *pm, *pp;
    int *sbeg, *scal;
    uint32_t *fin_pm, *fin_pp;
    int B, T, NW, NWQ, mode;
};

// Bits of word w whose band index is below n.
__device__ __forceinline__ uint32_t lowmask(int w, int n) {
    const int m = n - 32 * w;
    if (m <= 0) return 0u;
    if (m >= 32) return FULL;
    return (1u << m) - 1u;
}

template <int K>
__global__ void __launch_bounds__(32) edit_rows_kernel(Params p) {
    __shared__ uint32_t sh_pm[32 * K], sh_pp[32 * K];
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int NW = p.NW, bw = 32 * NW, T = p.T, B = p.B;
    const bool overlap = p.mode == 1;
    const bool track = p.mode == 1 || p.mode == 2;
    const int qlen = p.qlen[b];
    const int tlen = min(p.tlen[b], T);
    const int w0 = lane * K;

    uint32_t pm[K], pp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { pm[j] = 0u; pp[j] = FULL; }
    int sbeg = 0, smin = SMIN0, ry = 0, rbeg_f = 0;

    const int *tseq = p.tseq + (size_t)b * T;
    uint32_t *out_pm = p.pm + (size_t)b * T * NW;
    uint32_t *out_pp = p.pp + (size_t)b * T * NW;
    int t_c = 0, rb_c = 0, mv_c = 0;

    for (int i = 0; i < tlen; ++i) {
        const int r = i & 31;
        if (r == 0) {            // next 32 rows' scalars, one row per lane
            const int ii = i + lane;
            const bool ok = ii < tlen;
            t_c = ok ? tseq[ii] : 0;
            rb_c = ok ? p.rbegs[(size_t)ii * B + b] : 0;
            mv_c = ok ? p.movxs[(size_t)ii * B + b] : 0;
        }
        const int tb = __shfl_sync(FULL, t_c, r);
        const int rbeg = __shfl_sync(FULL, rb_c, r);
        const int movx = __shfl_sync(FULL, mv_c, r);

        // ---- band shift (striped_seqedit_row_movx, bsalign.h:658-721) ----
        if (overlap) {
            sbeg = 0;
        } else {
            if (movx > 0) {
                const int mv = min(movx, bw);
                int d = 0;
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    const uint32_t m = lowmask(w0 + j, mv);
                    d += __popc(pp[j] & m) - __popc(pm[j] & m);
                }
                sbeg += __reduce_add_sync(FULL, d);
                if (movx >= bw) {
#pragma unroll
                    for (int j = 0; j < K; ++j) { pm[j] = 0u; pp[j] = FULL; }
                } else {
                    const int ws = movx >> 5, bs = movx & 31;
#pragma unroll
                    for (int j = 0; j < K; ++j) {
                        sh_pm[w0 + j] = pm[j];
                        sh_pp[w0 + j] = pp[j];
                    }
                    __syncwarp();
#pragma unroll
                    for (int j = 0; j < K; ++j) {
                        const int s = w0 + j + ws;
                        const uint32_t lm = s < NW ? sh_pm[s] : 0u;
                        const uint32_t lp = s < NW ? sh_pp[s] : 0u;
                        const uint32_t hm = s + 1 < NW ? sh_pm[s + 1] : 0u;
                        const uint32_t hp = s + 1 < NW ? sh_pp[s + 1] : 0u;
                        const uint32_t vm = bs ? (lm >> bs) | (hm << (32 - bs))
                                               : lm;
                        const uint32_t vp = bs ? (lp >> bs) | (hp << (32 - bs))
                                               : lp;
                        const uint32_t keep = lowmask(w0 + j, bw - movx);
                        pm[j] = vm & keep;
                        pp[j] = (vp & keep) | ~keep;
                    }
                    __syncwarp();
                }
            }
            sbeg += 1;
        }

        // ---- Eq: the base's query bits from band position rbeg on ----
        const int v = (tb >= 1 && tb <= 3) ? tb : 0;
        const uint32_t *q = p.qeq + ((size_t)v * B + b) * p.NWQ;
        const int ws = rbeg >> 5, bs = rbeg & 31;
        uint32_t e[K + 1];
#pragma unroll
        for (int j = 0; j <= K; ++j) {
            const int idx = ws + w0 + j;
            e[j] = (idx >= 0 && idx < p.NWQ) ? __ldg(q + idx) : 0u;
        }

        // ---- Myers step ----
        uint32_t X[K], s0[K];
        bool gen[K], prop[K];
        bool G = false, P = true;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const uint32_t eq = bs ? (e[j] >> bs) | (e[j + 1] << (32 - bs))
                                   : e[j];
            X[j] = eq | pm[j];
            const uint32_t ad = X[j] & pp[j];
            s0[j] = ad + pp[j];
            gen[j] = s0[j] < ad;
            prop[j] = s0[j] == FULL;
            G = gen[j] || (prop[j] && G);
            P = P && prop[j];
        }
        // carry into each lane: lookahead over the lanes' (G, P) bits
        const uint32_t gm = __ballot_sync(FULL, G);
        const uint32_t pmask = __ballot_sync(FULL, P) | gm;
        bool c = (((pmask + gm) ^ pmask ^ gm) >> lane) & 1u;
        uint32_t HP[K], HN[K], D0[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const uint32_t A = s0[j] + (c ? 1u : 0u);
            c = gen[j] || (prop[j] && c);
            D0[j] = (A ^ pp[j]) | X[j];
            HP[j] = pm[j] | ~(D0[j] | pp[j]);
            HN[j] = pp[j] & D0[j];
        }
        // one-bit left shift across words; bit 0 takes hp_in / 0
        uint32_t hp_lo = __shfl_up_sync(FULL, HP[K - 1] >> 31, 1);
        uint32_t hn_lo = __shfl_up_sync(FULL, HN[K - 1] >> 31, 1);
        if (lane == 0) { hp_lo = overlap ? 0u : 1u; hn_lo = 0u; }
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const uint32_t hps = (HP[j] << 1) | (j ? HP[j - 1] >> 31 : hp_lo);
            const uint32_t hns = (HN[j] << 1) | (j ? HN[j - 1] >> 31 : hn_lo);
            pp[j] = hns | ~(D0[j] | hps);
            pm[j] = hps & D0[j];
        }

        // ---- overlap/extend: row score at H(qlen-1, i) ----
        if (track) {
            const int n = min(max(qlen - rbeg, 0), bw);
            int d = 0;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t m = lowmask(w0 + j, n);
                d += __popc(pp[j] & m) - __popc(pm[j] & m);
            }
            const int srow = sbeg + __reduce_add_sync(FULL, d);
            if (srow < smin) { smin = srow; ry = i; }
        }

        const size_t row = (size_t)i * NW;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            if (w0 + j < NW) {
                out_pm[row + w0 + j] = pm[j];
                out_pp[row + w0 + j] = pp[j];
            }
        }
        if (lane == 0) p.sbeg[(size_t)b * T + i] = sbeg;
        rbeg_f = rbeg;
    }

#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (w0 + j < NW) {
            p.fin_pm[(size_t)b * NW + w0 + j] = pm[j];
            p.fin_pp[(size_t)b * NW + w0 + j] = pp[j];
        }
    }
    if (lane == 0) {
        int *s = p.scal + (size_t)b * 4;
        s[0] = sbeg; s[1] = smin; s[2] = ry; s[3] = rbeg_f;
    }
}

template <int K>
cudaError_t launch(const Params &p, cudaStream_t stream) {
    edit_rows_kernel<K><<<p.B, 32, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// NW above 32 * 16 = 512 words (band 16384) is refused; the wrapper raises
// first (ops/_cuda.py EDIT_MAX_NW).
extern "C" int bsa_edit_rows(const int *qeq, const int *qlen, const int *tseq,
                             const int *tlen, const int *rbegs,
                             const int *movxs, int *pm, int *pp, int *sbeg,
                             int *fin_pm, int *fin_pp, int *scal, int B, int T,
                             int NW, int NWQ, int mode, void *stream) {
    Params p{reinterpret_cast<const uint32_t *>(qeq), qlen, tseq, tlen, rbegs,
             movxs, reinterpret_cast<uint32_t *>(pm),
             reinterpret_cast<uint32_t *>(pp), sbeg, scal,
             reinterpret_cast<uint32_t *>(fin_pm),
             reinterpret_cast<uint32_t *>(fin_pp), B, T, NW, NWQ, mode};
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int k = (NW + 31) / 32;
    if (k <= 1) return launch<1>(p, s);
    if (k <= 2) return launch<2>(p, s);
    if (k <= 3) return launch<3>(p, s);
    if (k <= 4) return launch<4>(p, s);
    if (k <= 5) return launch<5>(p, s);
    if (k <= 6) return launch<6>(p, s);
    if (k <= 8) return launch<8>(p, s);
    if (k <= 12) return launch<12>(p, s);
    if (k <= 16) return launch<16>(p, s);
    return cudaErrorInvalidValue;
}
