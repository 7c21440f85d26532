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
// 268 MB in all, about 80 us at 3.35 TB/s. 256 pairs are 256 warps, one on
// an SM sub-partition, so a row costs the latency of its chain plus what
// the warp issues beside it that the compiler cannot interleave with it.
//
// What the design does about it: one warp per pair, lane l owning the
// contiguous words [l*K, (l+1)*K) of both planes in registers (K =
// ceil(NW/32)), and a row that is one block of straight-line code:
// - The mode, and whether every lane owns K words of the band (then its
//   stores are unconditional 8- or 16-byte vectors), are template
//   parameters.
// - A row's operands are ready before it starts. Each lane holds one row
//   of a 32-row block of scalars (the Eq plane's offset from the target
//   base, rbeg, movx; the next block is loaded a block ahead); a row's
//   scalars come by shuffle two rows ahead and its Eq words are read a row
//   ahead from a copy of the pair's four Eq planes in shared memory (device
//   memory for queries past 131,072 bases), so no row waits on a load.
// - The band shift (rows with movx > 0) runs between runs of rows, outside
//   the row loop, which leaves it the moment the next row needs one.
// - The binary addition ripples K words per lane and takes its carry into
//   each lane from two ballots and one 32-bit addition (carry lookahead
//   over the lanes' generate/propagate bits); the one-bit left shift of HP
//   and HN takes both top bits of the lower lane by one shuffle.
// - In overlap/extend the row score's popcount reduction is compared with
//   the minimum a row later, so nothing waits on it; sbeg leaves in one
//   store per 32 rows.
// The band shift by whole words crosses lanes through a small shared
// buffer. One warp per block, so the pairs spread over the SMs.
//
// Bands past 32 x 16 = 512 words (16,384 bits) take the segmented row
// (edit_seg_rows_kernel): the pair's row of pm/pp words lives in memory,
// two rows double-buffered (16 bytes a word): in shared memory beside the
// staged Eq planes while they fit the block's 227 KB (NW 3,200, a 100 kb
// band, takes 51 KB), else in device memory (p.seg, 4 * NW words a pair).
// The warp walks a row in segments of 32 x SEG_K words, in order; each
// segment passes its addition carry and the top bits of its HP/HN words on
// to the next, so the step is the same Myers step over the same words in
// the same order, bit for bit. The band shift reads the row before at its
// shifted offset (the other buffer, so no word is read after it is
// overwritten). NW <= 512 keeps the register kernel above.
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
enum { GLOBAL = 0, OVERLAP = 1, EXTEND = 2 };

struct Params {
    const uint32_t *qeq;
    const int *qlen, *tseq, *tlen, *rbegs, *movxs;
    uint32_t *pm, *pp;
    int *sbeg, *scal;
    uint32_t *fin_pm, *fin_pp;
    int B, T, NW, NWQ, mode;
    bool staged;             // the pair's four Eq planes copied to shared
    uint32_t *seg;           // segmented rows: the state rows in device
                             // memory (4 * NW words a pair), or null
};

// Eq planes up to this many bytes per pair are staged in shared memory
// (queries up to 131,072 bases); longer ones are read from device memory.
constexpr int EQ_SMEM_MAX = 64 * 1024;

// Bits of word w whose band index is below n.
__device__ __forceinline__ uint32_t lowmask(int w, int n) {
    const int m = n - 32 * w;
    if (m <= 0) return 0u;
    if (m >= 32) return FULL;
    return (1u << m) - 1u;
}

// The lane's K words of one row at dst (the row's word w0): with FULLW
// (NW == 32 * K, dst aligned to the vectors) unconditional 16- or 8-byte
// vector stores, else word by word, those below NW alone.
template <int K, bool FULLW>
__device__ __forceinline__ void store_words(uint32_t *dst,
                                            const uint32_t (&v)[K], int w0,
                                            int NW) {
    if constexpr (FULLW && K % 4 == 0) {
#pragma unroll
        for (int j = 0; j < K; j += 4)
            *reinterpret_cast<uint4 *>(dst + j) =
                make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else if constexpr (FULLW && K % 2 == 0) {
#pragma unroll
        for (int j = 0; j < K; j += 2)
            *reinterpret_cast<uint2 *>(dst + j) = make_uint2(v[j], v[j + 1]);
    } else {
#pragma unroll
        for (int j = 0; j < K; ++j)
            if (w0 + j < NW) dst[j] = v[j];
    }
}

// A row's scalars: the word offset of its Eq plane in qeq (the target
// base's plane, a code outside 1..3 taking plane 0), rbeg and movx.
struct Row {
    int plane, rbeg, movx;
};

// Row `row`'s scalars as the lane holding it loads them (tseq, rbegs and
// movxs at the pair's column, B pairs; plane v of the pair's Eq words at
// v * pstride + pbase); 0 at and past tlen.
__device__ __forceinline__ Row load_row(const int *tseq, const int *rbegs,
                                        const int *movxs, int B, int pstride,
                                        int pbase, int row, int tlen) {
    Row r{0, 0, 0};
    int t = 0;
    if (row < tlen) {
        t = __ldg(tseq + row);
        r.rbeg = __ldg(rbegs + (size_t)row * B);
        r.movx = __ldg(movxs + (size_t)row * B);
    }
    r.plane = ((t >= 1 && t <= 3) ? t : 0) * pstride + pbase;
    return r;
}

// Row src's scalars of the 32-row block blk (src < 32) or of the next one,
// nblk (src >= 32), from the lane holding them.
__device__ __forceinline__ Row shfl_row(const Row &blk, const Row &nblk,
                                        int src) {
    const bool in = src < 32;
    return Row{__shfl_sync(FULL, in ? blk.plane : nblk.plane, src & 31),
               __shfl_sync(FULL, in ? blk.rbeg : nblk.rbeg, src & 31),
               __shfl_sync(FULL, in ? blk.movx : nblk.movx, src & 31)};
}

// The K + 1 query words of a row's Eq window from word rbeg >> 5 + w0 of
// its plane on (in shared or device memory, by a generic pointer); words
// outside the query's NWQ read 0.
template <int K>
__device__ __forceinline__ void load_eq(const uint32_t *qeq, int NWQ,
                                        const Row &r, int w0,
                                        uint32_t (&e)[K + 1]) {
    const int ws = (r.rbeg >> 5) + w0;
    const uint32_t *q = qeq + r.plane + ws;
#pragma unroll
    for (int j = 0; j <= K; ++j)
        e[j] = (unsigned)(ws + j) < (unsigned)NWQ ? q[j] : 0u;
}

template <int K, int MODE, bool FULLW>
__global__ void __launch_bounds__(32) edit_rows_kernel(Params p) {
    constexpr bool TRACK = MODE != GLOBAL;
    __shared__ uint32_t sh_pm[32 * K], sh_pp[32 * K];
    extern __shared__ uint32_t eq_s[];   // staged: the pair's Eq planes
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int NW = p.NW, bw = 32 * NW, T = p.T, B = p.B, NWQ = p.NWQ;
    // the pair's Eq planes: plane v at qeq + v * pstride (+ pbase), staged
    // in shared memory when they fit, else read from device memory
    const uint32_t *qeq = p.qeq;
    int pstride = B * NWQ, pbase = b * NWQ;
    if (p.staged) {
        for (int w = lane; w < 4 * NWQ; w += 32)
            eq_s[w] = __ldg(p.qeq + ((size_t)(w / NWQ) * B + b) * NWQ
                            + w % NWQ);
        __syncwarp();
        qeq = eq_s;
        pstride = NWQ;
        pbase = 0;
    }
    const int qlen = p.qlen[b];
    const int tlen = min(p.tlen[b], T);
    const int w0 = lane * K;

    uint32_t pm[K], pp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { pm[j] = 0u; pp[j] = FULL; }
    int sbeg = 0, smin = SMIN0, ry = 0, rbeg_f = 0;
    int srow_prev = SMIN0, i_prev = 0;   // TRACK: last row's score, compared
                                         // with smin a row later

    uint32_t *out_pm = p.pm + (size_t)b * T * NW + w0;   // row i's words,
    uint32_t *out_pp = p.pp + (size_t)b * T * NW + w0;   // advanced by rows
    int *out_sbeg = p.sbeg + (size_t)b * T;
    int sb = 0;                      // lane r: sbeg of row r of a 32-row block

    // scalars of the 32-row block of row i and of the next block, one row
    // per lane, each loaded a block ahead
    const int *tseq = p.tseq + (size_t)b * T;
    const int *rbegs = p.rbegs + b, *movxs = p.movxs + b;
    Row blk = load_row(tseq, rbegs, movxs, B, pstride, pbase, lane, tlen);
    Row nblk = load_row(tseq, rbegs, movxs, B, pstride, pbase, 32 + lane,
                        tlen);
    Row cur = shfl_row(blk, nblk, 0), nxt = shfl_row(blk, nblk, 1);
    uint32_t e[K + 1];               // the Eq words of row i
    load_eq<K>(qeq, NWQ, cur, w0, e);

    int i = 0;
    while (i < tlen) {
        // ---- band shift (striped_seqedit_row_movx, bsalign.h:658-721) ----
        const int movx = cur.movx;
        if (MODE != OVERLAP && movx > 0) {
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
                    const uint32_t keep = lowmask(w0 + j, bw - movx);
                    pm[j] = __funnelshift_r(lm, hm, bs) & keep;
                    pp[j] = (__funnelshift_r(lp, hp, bs) & keep) | ~keep;
                }
                __syncwarp();
            }
        }

        // ---- rows i on, until one needs a band shift ----
        for (;;) {
            // the operands of rows i + 1 and i + 2, off this row's chain
            uint32_t e1[K + 1];
            load_eq<K>(qeq, NWQ, nxt, w0, e1);
            const Row nn = shfl_row(blk, nblk, (i & 31) + 2);
            if constexpr (MODE != OVERLAP) sbeg += 1;

            // Myers step, Eq from band position rbeg on
            const int bs = cur.rbeg & 31;
            uint32_t X[K], s0[K];
            bool gen[K], prop[K];
            bool G = false, P = true;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                X[j] = __funnelshift_r(e[j], e[j + 1], bs) | pm[j];
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
            // one-bit left shift across words: both top bits of the lower
            // lane in one shuffle; bit 0 of lane 0 takes hp_in / 0
            uint32_t lo = __shfl_up_sync(FULL, (HP[K - 1] >> 31)
                                                   | (HN[K - 1] >> 31 << 1),
                                         1);
            if (lane == 0) lo = MODE == OVERLAP ? 0u : 1u;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t hps =
                    (HP[j] << 1) | (j ? HP[j - 1] >> 31 : lo & 1u);
                const uint32_t hns =
                    (HN[j] << 1) | (j ? HN[j - 1] >> 31 : lo >> 1);
                pp[j] = hns | ~(D0[j] | hps);
                pm[j] = hps & D0[j];
            }

            // overlap/extend: row score at H(qlen-1, i)
            if constexpr (TRACK) {
                if (srow_prev < smin) { smin = srow_prev; ry = i_prev; }
                const int n = min(max(qlen - cur.rbeg, 0), bw);
                int d = 0;
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    const uint32_t m = lowmask(w0 + j, n);
                    d += __popc(pp[j] & m) - __popc(pm[j] & m);
                }
                srow_prev = sbeg + __reduce_add_sync(FULL, d);
                i_prev = i;
            }

            store_words<K, FULLW>(out_pm, pm, w0, NW);
            store_words<K, FULLW>(out_pp, pp, w0, NW);
            out_pm += NW;
            out_pp += NW;
            if (lane == (i & 31)) sb = sbeg;
            rbeg_f = cur.rbeg;
            cur = nxt;
            nxt = nn;
#pragma unroll
            for (int j = 0; j <= K; ++j) e[j] = e1[j];
            // at a block's end: its sbeg in one store, the next block's
            // scalars
            if ((i & 31) == 31) {
                out_sbeg[i - 31 + lane] = sb;
                blk = nblk;
                nblk = load_row(tseq, rbegs, movxs, B, pstride, pbase,
                                i + 33 + lane, tlen);
            }
            if (++i >= tlen || (MODE != OVERLAP && cur.movx > 0)) break;
        }
    }
    if (srow_prev < smin) { smin = srow_prev; ry = i_prev; }
    if (tlen & 31) {
        const int r = (tlen - 1) & 31;
        if (lane <= r) out_sbeg[tlen - 1 - r + lane] = sb;
    }

    store_words<K, FULLW>(p.fin_pm + (size_t)b * NW + w0, pm, w0, NW);
    store_words<K, FULLW>(p.fin_pp + (size_t)b * NW + w0, pp, w0, NW);
    if (lane == 0) {
        int *s = p.scal + (size_t)b * 4;
        s[0] = sbeg; s[1] = smin; s[2] = ry; s[3] = rbeg_f;
    }
}

constexpr int SEG_K = 8;   // words per lane of one segment (256 a segment)

template <int MODE>
__global__ void __launch_bounds__(32) edit_seg_rows_kernel(Params p) {
    constexpr int K = SEG_K;
    extern __shared__ uint32_t eq_s[];   // staged Eq planes, then the state
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int NW = p.NW, bw = 32 * NW, T = p.T, B = p.B, NWQ = p.NWQ;
    const uint32_t *qeq = p.qeq;
    int pstride = B * NWQ, pbase = b * NWQ;
    if (p.staged) {
        for (int w = lane; w < 4 * NWQ; w += 32)
            eq_s[w] = __ldg(p.qeq + ((size_t)(w / NWQ) * B + b) * NWQ
                            + w % NWQ);
        qeq = eq_s;
        pstride = NWQ;
        pbase = 0;
    }
    // state row c: pm at st + 2 * c * NW, pp NW words on
    uint32_t *const st = p.seg ? p.seg + (size_t)b * 4 * NW
                               : eq_s + (p.staged ? 4 * NWQ : 0);
    for (int w = lane; w < NW; w += 32) { st[w] = 0u; st[NW + w] = FULL; }
    __syncwarp();
    const int qlen = p.qlen[b];
    const int tlen = min(p.tlen[b], T);
    const int *tseq = p.tseq + (size_t)b * T;
    uint32_t *out_pm = p.pm + (size_t)b * T * NW;   // row i's words,
    uint32_t *out_pp = p.pp + (size_t)b * T * NW;   // advanced by rows
    const int nseg = (NW + 32 * K - 1) / (32 * K);
    int sbeg = 0, smin = SMIN0, ry = 0, rbeg_f = 0, cur = 0;
    for (int i = 0; i < tlen; ++i) {
        const Row r = load_row(tseq, p.rbegs + b, p.movxs + b, B, pstride,
                               pbase, i, tlen);
        const uint32_t *opm = st + 2 * cur * NW, *opp = opm + NW;
        uint32_t *npm = st + 2 * (1 - cur) * NW, *npp = npm + NW;
        // band shift (striped_seqedit_row_movx, bsalign.h:658-721), read
        // from the row before at the shifted offset
        const bool shift = MODE != OVERLAP && r.movx > 0;
        const int mv = min(r.movx, bw), ws = r.movx >> 5, bs = r.movx & 31;
        int dsh = 0, dtr = 0;   // lane's popcount sums: shift, row score
        const int ntr = min(max(qlen - r.rbeg, 0), bw);
        uint32_t cin = 0u;      // the addition's carry into the segment
        uint32_t lo_in = MODE == OVERLAP ? 0u : 1u;   // HP / HN bits into it
        for (int sg = 0; sg < nseg; ++sg) {
            const int w0 = sg * 32 * K + lane * K;
            uint32_t pm[K], pp[K], e[K + 1];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int w = w0 + j;
                if (w >= NW) { pm[j] = 0u; pp[j] = FULL; continue; }
                if (!shift) {
                    pm[j] = opm[w];
                    pp[j] = opp[w];
                    continue;
                }
                const uint32_t m = lowmask(w, mv);
                if (m) dsh += __popc(opp[w] & m) - __popc(opm[w] & m);
                if (r.movx >= bw) { pm[j] = 0u; pp[j] = FULL; continue; }
                const int s = w + ws;
                const uint32_t lm = s < NW ? opm[s] : 0u;
                const uint32_t lp = s < NW ? opp[s] : 0u;
                const uint32_t hm = s + 1 < NW ? opm[s + 1] : 0u;
                const uint32_t hp = s + 1 < NW ? opp[s + 1] : 0u;
                const uint32_t keep = lowmask(w, bw - r.movx);
                pm[j] = __funnelshift_r(lm, hm, bs) & keep;
                pp[j] = (__funnelshift_r(lp, hp, bs) & keep) | ~keep;
            }
            load_eq<K>(qeq, NWQ, r, w0, e);
            // Myers step, Eq from band position rbeg on
            const int eb = r.rbeg & 31;
            uint32_t X[K], s0[K];
            bool gen[K], prop[K];
            bool G = false, P = true;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                X[j] = __funnelshift_r(e[j], e[j + 1], eb) | pm[j];
                const uint32_t ad = X[j] & pp[j];
                s0[j] = ad + pp[j];
                gen[j] = s0[j] < ad;
                prop[j] = s0[j] == FULL;
                G = gen[j] || (prop[j] && G);
                P = P && prop[j];
            }
            // carry into each lane: lookahead over the lanes' (G, P) bits
            // with the segment's carry in; its carry out goes on
            const uint32_t gm = __ballot_sync(FULL, G);
            const uint32_t pmask = __ballot_sync(FULL, P) | gm;
            const unsigned long long sum =
                (unsigned long long)pmask + gm + cin;
            bool c = ((((uint32_t)sum) ^ pmask ^ gm) >> lane) & 1u;
            cin = (uint32_t)(sum >> 32);
            uint32_t HP[K], HN[K], D0[K];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t A = s0[j] + (c ? 1u : 0u);
                c = gen[j] || (prop[j] && c);
                D0[j] = (A ^ pp[j]) | X[j];
                HP[j] = pm[j] | ~(D0[j] | pp[j]);
                HN[j] = pp[j] & D0[j];
            }
            // one-bit left shift across words; lane 0 takes the top bits of
            // the segment before (hp_in / 0 in the first)
            const uint32_t top = (HP[K - 1] >> 31) | (HN[K - 1] >> 31 << 1);
            uint32_t lo = __shfl_up_sync(FULL, top, 1);
            if (lane == 0) lo = lo_in;
            lo_in = __shfl_sync(FULL, top, 31);
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t hps =
                    (HP[j] << 1) | (j ? HP[j - 1] >> 31 : lo & 1u);
                const uint32_t hns =
                    (HN[j] << 1) | (j ? HN[j - 1] >> 31 : lo >> 1);
                pp[j] = hns | ~(D0[j] | hps);
                pm[j] = hps & D0[j];
            }
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int w = w0 + j;
                if (w < NW) {
                    npm[w] = pm[j];
                    npp[w] = pp[j];
                    out_pm[w] = pm[j];
                    out_pp[w] = pp[j];
                    if (MODE != GLOBAL) {
                        const uint32_t m = lowmask(w, ntr);
                        dtr += __popc(pp[j] & m) - __popc(pm[j] & m);
                    }
                }
            }
        }
        if (shift) sbeg += __reduce_add_sync(FULL, dsh);
        if (MODE != OVERLAP) sbeg += 1;
        if (MODE != GLOBAL) {   // overlap/extend: row score at H(qlen-1, i)
            const int srow = sbeg + __reduce_add_sync(FULL, dtr);
            if (srow < smin) { smin = srow; ry = i; }
        }
        if (lane == 0) p.sbeg[(size_t)b * T + i] = sbeg;
        rbeg_f = r.rbeg;
        out_pm += NW;
        out_pp += NW;
        cur = 1 - cur;
        __syncwarp();
    }
    const uint32_t *fpm = st + 2 * cur * NW;
    for (int w = lane; w < NW; w += 32) {
        p.fin_pm[(size_t)b * NW + w] = fpm[w];
        p.fin_pp[(size_t)b * NW + w] = fpm[NW + w];
    }
    if (lane == 0) {
        int *s = p.scal + (size_t)b * 4;
        s[0] = sbeg; s[1] = smin; s[2] = ry; s[3] = rbeg_f;
    }
}

// Dynamic shared memory of the segmented kernel: the staged Eq planes and,
// unless p.seg holds them, the two state rows.
int seg_smem(const Params &p) {
    return (p.staged ? 16 * p.NWQ : 0) + (p.seg ? 0 : 16 * p.NW);
}

template <int MODE>
cudaError_t launch_seg(const Params &p, cudaStream_t stream) {
    const int smem = seg_smem(p);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            edit_seg_rows_kernel<MODE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    edit_seg_rows_kernel<MODE><<<p.B, 32, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int K, int MODE, bool FULLW>
cudaError_t launch_k(const Params &p, cudaStream_t stream) {
    const int smem = p.staged ? 16 * p.NWQ : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            edit_rows_kernel<K, MODE, FULLW>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    edit_rows_kernel<K, MODE, FULLW><<<p.B, 32, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int K, bool FULLW>
cudaError_t launch_mode(const Params &p, cudaStream_t stream) {
    if (p.mode == OVERLAP) return launch_k<K, OVERLAP, FULLW>(p, stream);
    if (p.mode == EXTEND) return launch_k<K, EXTEND, FULLW>(p, stream);
    return launch_k<K, GLOBAL, FULLW>(p, stream);
}

// vector stores where every lane owns K words of the band (K even) and the
// planes are 16-byte aligned
template <int K>
cudaError_t launch(const Params &p, bool aligned, cudaStream_t stream) {
    if (K % 2 == 0 && aligned && p.NW == 32 * K)
        return launch_mode<K, K % 2 == 0>(p, stream);
    return launch_mode<K, false>(p, stream);
}

}  // namespace

// NW above 32 * 16 = 512 words (band 16384) runs the segmented kernel;
// seg, when not null, holds its state rows (4 * NW words a pair), which
// the wrapper allocates when they do not fit shared memory beside the Eq
// planes (ops/_cuda.py edit_rows).
extern "C" int bsa_edit_rows(const int *qeq, const int *qlen, const int *tseq,
                             const int *tlen, const int *rbegs,
                             const int *movxs, int *pm, int *pp, int *sbeg,
                             int *fin_pm, int *fin_pp, int *scal, void *seg,
                             int B, int T, int NW, int NWQ, int mode,
                             void *stream) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(pm) | reinterpret_cast<uintptr_t>(pp)
          | reinterpret_cast<uintptr_t>(fin_pm)
          | reinterpret_cast<uintptr_t>(fin_pp)) & 15) == 0;
    Params p{reinterpret_cast<const uint32_t *>(qeq), qlen, tseq, tlen, rbegs,
             movxs, reinterpret_cast<uint32_t *>(pm),
             reinterpret_cast<uint32_t *>(pp), sbeg, scal,
             reinterpret_cast<uint32_t *>(fin_pm),
             reinterpret_cast<uint32_t *>(fin_pp), B, T, NW, NWQ, mode,
             16 * NWQ <= EQ_SMEM_MAX, static_cast<uint32_t *>(seg)};
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (NW > 512) {
        if (p.mode == OVERLAP) return launch_seg<OVERLAP>(p, s);
        if (p.mode == EXTEND) return launch_seg<EXTEND>(p, s);
        return launch_seg<GLOBAL>(p, s);
    }
    const int k = (NW + 31) / 32;
    if (k <= 1) return launch<1>(p, aligned, s);
    if (k <= 2) return launch<2>(p, aligned, s);
    if (k <= 3) return launch<3>(p, aligned, s);
    if (k <= 4) return launch<4>(p, aligned, s);
    if (k <= 5) return launch<5>(p, aligned, s);
    if (k <= 6) return launch<6>(p, aligned, s);
    if (k <= 8) return launch<8>(p, aligned, s);
    if (k <= 12) return launch<12>(p, aligned, s);
    if (k <= 16) return launch<16>(p, aligned, s);
    return cudaErrorInvalidValue;
}
