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
// Bands past 32 x 16 = 512 words (16,384 bits) take the block row
// (edit_blk_rows_kernel), one block of NWARP warps a pair, each thread
// owning K consecutive words of both planes in registers (K 4 to NW 2,048,
// K 8 to NW 4,096: ops/_cuda.py edit_block_geometry). What bounds it is the
// same chain of dependent rows, now with a carry across the warps in each
// row (about 0.42 us a row even at one warp, PERF.md §6). The design:
// - One block barrier a row. Before it each warp's lane 31 publishes one
//   word: the warp's carry out for a carry in of 0 and of 1 (its generate
//   and propagate bits), the top bits of its last HP/HN word for both
//   carries in, and (overlap/extend) the warp's popcount partial of the
//   row before. After it every warp reads all words, takes its carry in
//   from one lookahead over the warps' bits ((pmask + gm) ^ pmask ^ gm, as
//   over lanes), and lane 0 takes the HP/HN bits of the warp below by the
//   carry that warp received. The words alternate between two slots by the
//   row's parity, so no second barrier guards them.
// - The row score is that block reduction, compared with the minimum a
//   row later; sbeg leaves in one store per 32 rows.
// - Row scalars come by shuffle two rows ahead, as in the register row;
//   the Eq window is read a row ahead from the staged planes as aligned
//   16-byte vectors (a warp's loads are consecutive, so no bank conflict at
//   K 4) and shifted into place by selects. The block row stages the planes
//   wherever they fit beside the shift's copy in the block's 227 KB
//   (queries to about 200 kb at NW 4,096), past EQ_SMEM_MAX too: against
//   word-by-word loads from device memory that took 17-18% off a row at
//   NW 3,200 and 4,096 (PERF.md §6).
// - The band shift (rows with movx > 0) goes through a shared copy of the
//   row, on those rows only, with its popcount sum as a block reduction.
// - Outputs leave as 16-byte vector stores when NW is a multiple of 4.
// Past NW 4,096 the cluster row (edit_cl_rows_kernel): one thread-block
// cluster of C blocks a pair (C 2 to 8, 16 where the card takes that
// non-portable size; ops/_cuda.py edit_cluster_geometry), block r holding
// words [r * S, (r + 1) * S) in registers as the block row holds its band.
// What bounds it: each row's dependent chain (the ripple, the warps'
// barrier, the blocks' exchange, the carry) plus one cluster barrier, and
// the issue rate of about one SM cycle a word on each SM. The design:
// - The carry crosses the cluster once a row: after the block's barrier
//   every warp forms the block's lookahead for a carry into the block of 0
//   and of 1, and lanes of warp 0 store the block's word (its carry out and
//   the top HP/HN bits of its last word for both, its row-score partial of
//   the row before) into every block through distributed shared memory
//   (mapa + st.shared::cluster); after one cluster barrier each block takes
//   its carry in from one lookahead over the blocks' words, as over lanes
//   and warps, and its first thread the block below's top bits by the carry
//   that block received. Words alternate between two slots by the row's
//   parity, so one barrier a row guards them; the row score is the
//   cluster's sum, compared a row later.
// - Each block holds a slice of NW / C words, so the words a row issues on
//   each SM fall with C; the cluster barrier (about 0.4-0.8 us a row,
//   PERF.md §6) is the price.
// - The block stages its window of the four Eq planes (its slice and the
//   slack rbeg's moves reach, found from the pair's rbegs) in shared memory
//   where it fits, else reads device memory through the read-only path,
//   16-byte vectors where the words are aligned.
// - The band shift writes each block's slice to a shared copy; after a
//   cluster barrier each thread reads its source words from whichever block
//   holds them through distributed shared memory, and the popcount sum for
//   sbeg is reduced over the cluster.
// Past the cluster's registers (NW past C x 4,096 at the largest C) the
// same row sweeps: each thread owns `pieces` pieces of 8 words of the
// pair's two state rows in device memory (L2-resident at these sizes),
// and each row takes two passes over them: the generate / propagate bits
// and the top bits of the thread's last word, then, after the cluster's
// one carry exchange, the words with their carries, written back and out.
// Every row computes the same Myers step over the same words, bit for bit.

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
    uint32_t *seg;           // the cluster row's sweep: its state rows in
                             // device memory (4 * C * S words a pair)
};

// The cluster row's: C blocks a pair, pieces of K words a thread (1: the
// band in registers; more: the sweep), its dynamic shared words.
struct ClParams : Params {
    int C, pieces, smem_words;
};

// Eq planes up to this many bytes per pair are staged in shared memory
// (queries up to 131,072 bases); longer ones are read from device memory.
constexpr int EQ_SMEM_MAX = 64 * 1024;
constexpr int SMEM_MAX = 227 * 1024;   // shared memory a block may take

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

// ---- the block row: one block of NWARP warps a pair ----

// warps of the block row at most: ops/_cuda.py EDIT_BLOCK_MAXW, which the
// build passes as EDIT_BLK_MAXW
constexpr int BLK_MAXW = EDIT_BLK_MAXW;

// Words of one staged Eq plane in the block row: the query's NWQ words
// rounded up to 4, then K + 4 words of zeros that a thread's vector reads
// past the query may touch.
template <int K>
__host__ __device__ constexpr int blk_plane(int NWQ) {
    return ((NWQ + 3) & ~3) + K + 4;
}

// The K + 1 query words of a row's Eq window from word rbeg >> 5 + w0 of
// its plane on; words outside [0, NWQ) read 0. From the staged planes (PS
// words each, zero past NWQ) as (K + 4) / 4 aligned 16-byte vectors, the
// window then picked by its offset in the first vector; elsewhere word by
// word (device memory, or a window that reaches past the staged words).
template <int K>
__device__ __forceinline__ void load_eq_blk(const uint32_t *qeq, int NWQ,
                                            int PS, bool staged, const Row &r,
                                            int w0, uint32_t (&e)[K + 1]) {
    const int ws = (r.rbeg >> 5) + w0;
    const int a = ws & 3, base = ws - a;
    if (staged && base >= 0 && base + K + 4 <= PS) {
        uint32_t c[K + 4];
        const uint4 *v = reinterpret_cast<const uint4 *>(qeq + r.plane + base);
#pragma unroll
        for (int j = 0; j < (K + 4) / 4; ++j) {
            const uint4 x = v[j];
            c[4 * j] = x.x; c[4 * j + 1] = x.y;
            c[4 * j + 2] = x.z; c[4 * j + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < K + 2; ++j) c[j] = (a & 2) ? c[j + 2] : c[j];
#pragma unroll
        for (int j = 0; j <= K; ++j) e[j] = (a & 1) ? c[j + 1] : c[j];
        return;
    }
    const uint32_t *q = qeq + r.plane + ws;
#pragma unroll
    for (int j = 0; j <= K; ++j)
        e[j] = (unsigned)(ws + j) < (unsigned)NWQ ? q[j] : 0u;
}

// The thread's K words of one row at dst (the row's word w0): 16-byte
// vector stores when `vec` (NW a multiple of 4, the planes aligned), those
// below NW alone; else word by word.
template <int K>
__device__ __forceinline__ void store_blk(uint32_t *dst,
                                          const uint32_t (&v)[K], int w0,
                                          int NW, bool vec) {
    if (vec) {
#pragma unroll
        for (int j = 0; j < K; j += 4)
            if (w0 + j < NW)
                *reinterpret_cast<uint4 *>(dst + j) =
                    make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < K; ++j)
            if (w0 + j < NW) dst[j] = v[j];
    }
}

template <int K, int MODE>
__global__ void __launch_bounds__(32 * BLK_MAXW) edit_blk_rows_kernel(
    Params p) {
    constexpr bool TRACK = MODE != GLOBAL;
    extern __shared__ __align__(16) uint32_t blk_s[];   // Eq planes, shift row
    __shared__ uint32_t xch[2][BLK_MAXW];   // each warp's word, by row parity
    __shared__ int red[BLK_MAXW];           // the band shift's partial sums
    const int b = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int nwarp = blockDim.x >> 5;
    const int NW = p.NW, bw = 32 * NW, T = p.T, B = p.B, NWQ = p.NWQ;
    const int PS = blk_plane<K>(NWQ);
    // vector stores: NW a multiple of 4 and the planes 16-byte aligned
    const bool vec =
        NW % 4 == 0
        && ((reinterpret_cast<uintptr_t>(p.pm)
             | reinterpret_cast<uintptr_t>(p.pp)
             | reinterpret_cast<uintptr_t>(p.fin_pm)
             | reinterpret_cast<uintptr_t>(p.fin_pp)) & 15) == 0;
    // the pair's Eq planes: plane v at qeq + v * pstride (+ pbase), staged
    // in shared memory when they fit, else read from device memory
    const uint32_t *qeq = p.qeq;
    int pstride = B * NWQ, pbase = b * NWQ;
    uint32_t *sh_pm = blk_s + (p.staged ? 4 * PS : 0);   // the shift's copy
    uint32_t *sh_pp = sh_pm + blockDim.x * K;
    if (p.staged) {
        for (int w = t; w < 4 * PS; w += blockDim.x) {
            const int v = w / PS, x = w - v * PS;
            blk_s[w] = x < NWQ ? __ldg(p.qeq + ((size_t)v * B + b) * NWQ + x)
                               : 0u;
        }
        qeq = blk_s;
        pstride = PS;
        pbase = 0;
    }
    __syncthreads();
    const int qlen = p.qlen[b];
    const int tlen = min(p.tlen[b], T);
    const int w0 = t * K;

    uint32_t pm[K], pp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { pm[j] = 0u; pp[j] = FULL; }
    int sbeg = 0, smin = SMIN0, ry = 0, rbeg_f = 0;
    int part = 0, sbeg_prev = 0;     // TRACK: the row before's warp partial
                                     // and sbeg, reduced a row later

    uint32_t *out_pm = p.pm + (size_t)b * T * NW + w0;   // row i's words,
    uint32_t *out_pp = p.pp + (size_t)b * T * NW + w0;   // advanced by rows
    int *out_sbeg = p.sbeg + (size_t)b * T;
    int sb = 0;                      // warp 0, lane r: sbeg of row r of a
                                     // 32-row block

    // scalars of the 32-row block of row i and of the next block, one row
    // per lane (every warp holds them), each loaded a block ahead
    const int *tseq = p.tseq + (size_t)b * T;
    const int *rbegs = p.rbegs + b, *movxs = p.movxs + b;
    Row blk = load_row(tseq, rbegs, movxs, B, pstride, pbase, lane, tlen);
    Row nblk = load_row(tseq, rbegs, movxs, B, pstride, pbase, 32 + lane,
                        tlen);
    Row cur = shfl_row(blk, nblk, 0), nxt = shfl_row(blk, nblk, 1);
    uint32_t e[K + 1];               // the Eq words of row i
    load_eq_blk<K>(qeq, NWQ, PS, p.staged, cur, w0, e);

    // the row score of the row before from the warps' partials (bits 6 on
    // of each warp's word), compared with the minimum
    auto score_prev = [&](uint32_t xw, int i_prev) {
        const int tot = __reduce_add_sync(FULL, lane < nwarp
                                                    ? (int)xw >> 6 : 0);
        if (sbeg_prev + tot < smin) { smin = sbeg_prev + tot; ry = i_prev; }
    };

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
            d = __reduce_add_sync(FULL, d);
            if (lane == 0) red[warp] = d;
            if (movx < bw) {
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    sh_pm[w0 + j] = pm[j];
                    sh_pp[w0 + j] = pp[j];
                }
            }
            __syncthreads();
            sbeg += __reduce_add_sync(FULL, lane < nwarp ? red[lane] : 0);
            if (movx >= bw) {
#pragma unroll
                for (int j = 0; j < K; ++j) { pm[j] = 0u; pp[j] = FULL; }
            } else {
                const int ws = movx >> 5, bs = movx & 31;
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
            }
        }

        // ---- rows i on, until one needs a band shift ----
        for (;;) {
            // the operands of rows i + 1 and i + 2, off this row's chain
            uint32_t e1[K + 1];
            load_eq_blk<K>(qeq, NWQ, PS, p.staged, nxt, w0, e1);
            const Row nn = shfl_row(blk, nblk, (i & 31) + 2);
            if constexpr (MODE != OVERLAP) sbeg += 1;

            // Myers step, Eq from band position rbeg on: the lane's
            // generate / propagate over its K words, and over the first
            // K - 1 (the carry into its last word)
            const int bs = cur.rbeg & 31;
            uint32_t X[K], s0[K];
            bool gen[K], prop[K];
            bool G = false, P = true, Gl = false, Pl = true;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                X[j] = __funnelshift_r(e[j], e[j + 1], bs) | pm[j];
                const uint32_t ad = X[j] & pp[j];
                s0[j] = ad + pp[j];
                gen[j] = s0[j] < ad;
                prop[j] = s0[j] == FULL;
                if (j == K - 1) { Gl = G; Pl = P; }
                G = gen[j] || (prop[j] && G);
                P = P && prop[j];
            }
            // the warp's lookahead over its lanes, for a carry into the
            // warp of 0 (sum0) and of 1 (sum0 + 1)
            const uint32_t gm = __ballot_sync(FULL, G);
            const uint32_t pmask = __ballot_sync(FULL, P) | gm;
            const uint32_t sum0 = pmask + gm;
            const uint32_t co0 = sum0 < pmask;            // carry out, in 0
            const uint32_t co1 = co0 | (sum0 == FULL);    // carry out, in 1
            const bool cl0 = ((sum0 ^ pmask ^ gm) >> lane) & 1u;
            const bool cl1 = (((sum0 + 1u) ^ pmask ^ gm) >> lane) & 1u;
            // the top HP / HN bits of the lane's last word for each carry
            // into the warp (lane 31's go to the warp above)
            auto top = [&](bool c) {
                const bool ck = Gl || (Pl && c);
                const uint32_t A = s0[K - 1] + (ck ? 1u : 0u);
                const uint32_t D = (A ^ pp[K - 1]) | X[K - 1];
                const uint32_t hp = pm[K - 1] | ~(D | pp[K - 1]);
                const uint32_t hn = pp[K - 1] & D;
                return (hp >> 31) | (hn >> 31 << 1);
            };
            const uint32_t word = co0 | (co1 << 1) | (top(cl0) << 2)
                                  | (top(cl1) << 4) | ((uint32_t)part << 6);
            if (lane == 31) xch[i & 1][warp] = word;
            __syncthreads();
            // the carry into this warp: lookahead over the warps' bits
            const uint32_t xw = lane < nwarp ? xch[i & 1][lane] : 0u;
            const uint32_t gB = __ballot_sync(FULL, xw & 1u);
            const uint32_t pB = __ballot_sync(FULL, xw & 2u) | gB;
            const uint32_t cB = (pB + gB) ^ pB ^ gB;
            if constexpr (TRACK) {
                if (i > 0) score_prev(xw, i - 1);
            }
            const uint32_t below = __shfl_sync(FULL, xw, (warp + 31) & 31);
            bool c = (cB >> warp) & 1u ? cl1 : cl0;
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
            // lane in one shuffle; lane 0 takes the warp below's by the
            // carry that warp received, thread 0 hp_in / 0
            uint32_t lo = __shfl_up_sync(FULL, (HP[K - 1] >> 31)
                                                   | (HN[K - 1] >> 31 << 1),
                                         1);
            if (lane == 0)
                lo = warp ? (below >> (2 + 2 * ((cB >> (warp - 1)) & 1u))) & 3u
                          : (MODE == OVERLAP ? 0u : 1u);
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t hps =
                    (HP[j] << 1) | (j ? HP[j - 1] >> 31 : lo & 1u);
                const uint32_t hns =
                    (HN[j] << 1) | (j ? HN[j - 1] >> 31 : lo >> 1);
                pp[j] = hns | ~(D0[j] | hps);
                pm[j] = hps & D0[j];
            }

            // overlap/extend: the warp's part of the row score at
            // H(qlen-1, i), reduced over the block with the next row's word
            if constexpr (TRACK) {
                const int n = min(max(qlen - cur.rbeg, 0), bw);
                int d = 0;
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    const uint32_t m = lowmask(w0 + j, n);
                    d += __popc(pp[j] & m) - __popc(pm[j] & m);
                }
                part = __reduce_add_sync(FULL, d);
                sbeg_prev = sbeg;
            }

            store_blk<K>(out_pm, pm, w0, NW, vec);
            store_blk<K>(out_pp, pp, w0, NW, vec);
            out_pm += NW;
            out_pp += NW;
            if (lane == (i & 31)) sb = sbeg;
            rbeg_f = cur.rbeg;
            cur = nxt;
            nxt = nn;
#pragma unroll
            for (int j = 0; j <= K; ++j) e[j] = e1[j];
            // at a block's end: its sbeg in one store (warp 0), the next
            // block's scalars
            if ((i & 31) == 31) {
                if (warp == 0) out_sbeg[i - 31 + lane] = sb;
                blk = nblk;
                nblk = load_row(tseq, rbegs, movxs, B, pstride, pbase,
                                i + 33 + lane, tlen);
            }
            if (++i >= tlen || (MODE != OVERLAP && cur.movx > 0)) break;
        }
    }
    if constexpr (TRACK) {   // the last row's score
        if (tlen > 0) {
            if (lane == 31) xch[tlen & 1][warp] = (uint32_t)part << 6;
            __syncthreads();
            score_prev(lane < nwarp ? xch[tlen & 1][lane] : 0u, tlen - 1);
        }
    }
    if (warp == 0 && (tlen & 31)) {
        const int r = (tlen - 1) & 31;
        if (lane <= r) out_sbeg[tlen - 1 - r + lane] = sb;
    }

    store_blk<K>(p.fin_pm + (size_t)b * NW + w0, pm, w0, NW, vec);
    store_blk<K>(p.fin_pp + (size_t)b * NW + w0, pp, w0, NW, vec);
    if (t == 0) {
        int *s = p.scal + (size_t)b * 4;
        s[0] = sbeg; s[1] = smin; s[2] = ry; s[3] = rbeg_f;
    }
}

// ---- the cluster row: one thread-block cluster of C blocks a pair ----

constexpr int CL_MAX = 16;   // blocks of a cluster at most (past 8 the
                             // card's non-portable cluster sizes)

// Distributed shared memory: the word at p (a shared variable of this
// block) in block `rank` of the cluster, stored or loaded; one cluster
// barrier (every thread of every block arrives; each block's earlier
// stores, into its peers' memory too, are seen after it).
__device__ __forceinline__ uint32_t cl_addr(const void *p, int rank) {
    uint32_t a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(a)
                 : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
    return a;
}

__device__ __forceinline__ void cl_store(const void *p, int rank,
                                         uint32_t v) {
    asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(cl_addr(p, rank)),
                 "r"(v)
                 : "memory");
}

__device__ __forceinline__ uint32_t cl_load(const void *p, int rank) {
    uint32_t v;
    asm volatile("ld.shared::cluster.u32 %0, [%1];"
                 : "=r"(v)
                 : "r"(cl_addr(p, rank))
                 : "memory");
    return v;
}

__device__ __forceinline__ void cl_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::
                     : "memory");
}

// The K + 1 query words of a row's Eq window from query word rbeg >> 5 + w0
// on (the cluster row), the plane at qeq + r.plane holding query word
// `off` first and `lim` words (words outside them read 0): from the
// staged planes or window in shared memory (off its first word, a
// multiple of 4, lim its PS words, zero past the query) as aligned 16-byte
// vectors shifted into place by selects; from device memory (off 0, lim
// NWQ) through the read-only path, as vectors where the window's words are
// 16-byte aligned (qvec: the planes' base is), else word by word.
template <int K>
__device__ __forceinline__ void load_eq_cl(const uint32_t *qeq, int lim,
                                           int off, bool staged, bool qvec,
                                           const Row &r, int w0,
                                           uint32_t (&e)[K + 1]) {
    const int l = (r.rbeg >> 5) + w0 - off;
    const int a = l & 3, base = l - a;
    const uint32_t *q = qeq + r.plane;
    if (base >= 0 && base + K + 4 <= lim
        && (staged || (qvec && ((r.plane + base) & 3) == 0))) {
        uint32_t c[K + 4];
        const uint4 *v = reinterpret_cast<const uint4 *>(q + base);
#pragma unroll
        for (int j = 0; j < (K + 4) / 4; ++j) {
            const uint4 x = staged ? v[j] : __ldg(v + j);
            c[4 * j] = x.x; c[4 * j + 1] = x.y;
            c[4 * j + 2] = x.z; c[4 * j + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < K + 2; ++j) c[j] = (a & 2) ? c[j + 2] : c[j];
#pragma unroll
        for (int j = 0; j <= K; ++j) e[j] = (a & 1) ? c[j + 1] : c[j];
        return;
    }
#pragma unroll
    for (int j = 0; j <= K; ++j) {
        const bool in = (unsigned)(l + j) < (unsigned)lim;
        e[j] = !in ? 0u : staged ? q[l + j] : __ldg(q + l + j);
    }
}

// Where a block of the cluster row reads its Eq planes: the query words
// its slice of S words (from word r * S) reaches over the pair's rows,
// [wlo, wlo + PS) of each plane, staged at eqw in shared memory when 4 * PS
// words fit `room`, else the planes in device memory. Plane v of the
// block's window at q + v * pstride + pbase holds query word `off` first,
// `lim` words. Ends with the block's barrier.
struct EqWin {
    const uint32_t *q;
    int pstride, pbase, off, lim;
    bool staged;
};

__device__ __forceinline__ EqWin cl_window(const Params &p, int b, int r,
                                           int S, int tlen, uint32_t *eqw,
                                           int room,
                                           int (&span)[2][BLK_MAXW]) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int NT = blockDim.x, nwarp = NT >> 5, B = p.B, NWQ = p.NWQ;
    const int *rbegs = p.rbegs + b;
    int lo = 0x7FFFFFFF, hi = 0;
    for (int i = t; i < tlen; i += NT) {
        const int x = __ldg(rbegs + (size_t)i * B);
        lo = min(lo, x);
        hi = max(hi, x);
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if (lane == 0) { span[0][warp] = lo; span[1][warp] = hi; }
    __syncthreads();
    lo = __reduce_min_sync(FULL, lane < nwarp ? span[0][lane] : 0x7FFFFFFF);
    hi = __reduce_max_sync(FULL, lane < nwarp ? span[1][lane] : 0);
    if (tlen == 0) lo = hi = 0;
    const int wlo = ((lo >> 5) + r * S) & ~3;
    const int PS = ((hi >> 5) + r * S + S + 4 - wlo + 3) & ~3;
    if (4 * PS > room) {
        __syncthreads();
        return EqWin{p.qeq, B * NWQ, b * NWQ, 0, NWQ, false};
    }
    for (int w = t; w < 4 * PS; w += NT) {
        const int v = w / PS, x = wlo + w - v * PS;
        eqw[w] = x >= 0 && x < NWQ
                     ? __ldg(p.qeq + ((size_t)v * B + b) * NWQ + x)
                     : 0u;
    }
    __syncthreads();
    return EqWin{eqw, PS, 0, wlo, PS, true};
}

// The top HP / HN bits (bit 0, bit 1) of the last of K words for a carry
// into that word of c.
template <int K>
__device__ __forceinline__ uint32_t top_bits(bool c, const uint32_t (&s0)[K],
                                             const uint32_t (&X)[K],
                                             const uint32_t (&pm)[K],
                                             const uint32_t (&pp)[K]) {
    const uint32_t A = s0[K - 1] + (c ? 1u : 0u);
    const uint32_t D = (A ^ pp[K - 1]) | X[K - 1];
    const uint32_t hp = pm[K - 1] | ~(D | pp[K - 1]);
    const uint32_t hn = pp[K - 1] & D;
    return (hp >> 31) | (hn >> 31 << 1);
}

// One row's carry across the cluster. Each thread brings the generate and
// propagate bits of the addition over its words (G, P), the top HP / HN
// bits of its last word for a carry into the thread of 0 and of 1 (t0,
// t1) and (overlap/extend) its warp's partial of the row before's score.
// Each warp's lane 31 publishes one word: the warp's carry out for a carry
// in of 0 and of 1 (the lookahead over its lanes), the top bits of its
// last word for both, the partial. After the block's barrier every warp
// forms the block's lookahead over those words for a carry into the block
// of 0 and of 1, and lanes of warp 0 store the block's word (its carry out
// and top bits for both, its partial) into every block of the cluster.
// After one cluster barrier every warp takes its block's carry in from the
// lookahead over the blocks' words, the same (p + g) ^ p ^ g as over lanes
// and warps. The words alternate between two slots by the row's parity, so
// no second barrier guards them. Returns the carry into the thread; lo
// gets the HP / HN bits into its first word (the lane below's, the warp
// below's or the block below's top bits by the carry it received; hp_in /
// 0 at the band's first word), tot the cluster's sum of the partials.
template <int MODE>
__device__ __forceinline__ bool cl_carry(bool G, bool P, uint32_t t0,
                                         uint32_t t1, int part, int i, int C,
                                         int r, uint32_t (&xch)[2][BLK_MAXW],
                                         uint32_t (&xcl)[2][CL_MAX],
                                         uint32_t &lo, int &tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const uint32_t gm = __ballot_sync(FULL, G);
    const uint32_t pmask = __ballot_sync(FULL, P) | gm;
    const uint32_t sum0 = pmask + gm;
    const uint32_t co0 = sum0 < pmask;            // carry out, in 0
    const uint32_t co1 = co0 | (sum0 == FULL);    // carry out, in 1
    const bool cl0 = ((sum0 ^ pmask ^ gm) >> lane) & 1u;
    const bool cl1 = (((sum0 + 1u) ^ pmask ^ gm) >> lane) & 1u;
    if (lane == 31)
        xch[i & 1][warp] = co0 | (co1 << 1) | ((cl0 ? t1 : t0) << 2)
                           | ((cl1 ? t1 : t0) << 4) | ((uint32_t)part << 6);
    __syncthreads();
    const uint32_t xw = lane < nwarp ? xch[i & 1][lane] : 0u;
    const uint32_t gB = __ballot_sync(FULL, xw & 1u);
    const uint32_t pB = __ballot_sync(FULL, xw & 2u) | gB;
    const uint32_t sB = pB + gB;
    const uint32_t cB0 = sB ^ pB ^ gB, cB1 = (sB + 1u) ^ pB ^ gB;
    const uint32_t last = __shfl_sync(FULL, xw, nwarp - 1);
    const int bpart =
        MODE != GLOBAL
            ? __reduce_add_sync(FULL, lane < nwarp ? (int)xw >> 6 : 0)
            : 0;
    if (warp == 0 && lane < C) {
        const uint32_t h = nwarp - 1;
        cl_store(&xcl[i & 1][blockIdx.x % C], lane,
                 ((sB >> nwarp) & 1u) | (((sB + 1u) >> nwarp & 1u) << 1)
                     | (((last >> (2 + 2 * (cB0 >> h & 1u))) & 3u) << 2)
                     | (((last >> (2 + 2 * (cB1 >> h & 1u))) & 3u) << 4)
                     | ((uint32_t)bpart << 6));
    }
    cl_sync();
    const uint32_t xc = lane < C ? xcl[i & 1][lane] : 0u;
    const uint32_t gC = __ballot_sync(FULL, xc & 1u);
    const uint32_t pC = __ballot_sync(FULL, xc & 2u) | gC;
    const uint32_t cC = (pC + gC) ^ pC ^ gC;
    tot = MODE != GLOBAL ? __reduce_add_sync(FULL, lane < C ? (int)xc >> 6 : 0)
                         : 0;
    const uint32_t cB = (cC >> r) & 1u ? cB1 : cB0;
    const bool c = (cB >> warp) & 1u ? cl1 : cl0;
    const uint32_t below = __shfl_sync(FULL, xw, (warp + 31) & 31);
    const uint32_t belowC = __shfl_sync(FULL, xc, (r + 31) & 31);
    lo = __shfl_up_sync(FULL, c ? t1 : t0, 1);
    if (lane == 0)
        lo = warp ? (below >> (2 + 2 * ((cB >> (warp - 1)) & 1u))) & 3u
             : r  ? (belowC >> (2 + 2 * ((cC >> (r - 1)) & 1u))) & 3u
                  : (MODE == OVERLAP ? 0u : 1u);
    return c;
}

// The cluster's sum of the warps' partials of the last row's score: one
// more exchange.
__device__ __forceinline__ int cl_last_score(int part, int tlen, int C,
                                             uint32_t (&xch)[2][BLK_MAXW],
                                             uint32_t (&xcl)[2][CL_MAX]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    if (lane == 31) xch[tlen & 1][warp] = (uint32_t)part << 6;
    __syncthreads();
    const int bpart = __reduce_add_sync(
        FULL, lane < nwarp ? (int)xch[tlen & 1][lane] >> 6 : 0);
    if (warp == 0 && lane < C)
        cl_store(&xcl[tlen & 1][blockIdx.x % C], lane, (uint32_t)bpart << 6);
    cl_sync();
    return __reduce_add_sync(FULL,
                             lane < C ? (int)xcl[tlen & 1][lane] >> 6 : 0);
}

// The band in registers: block r of the cluster holds words [r * S,
// (r + 1) * S), S = 32 * nwarp * K, thread t of it K words from r * S +
// t * K, as the block row does.
template <int K, int MODE>
__global__ void __launch_bounds__(32 * BLK_MAXW) edit_cl_rows_kernel(
    ClParams p) {
    constexpr bool TRACK = MODE != GLOBAL;
    extern __shared__ __align__(16) uint32_t blk_s[];   // shift row, Eq window
    __shared__ uint32_t xch[2][BLK_MAXW];   // each warp's word, by row parity
    __shared__ uint32_t xcl[2][CL_MAX];     // each block's word, by parity,
                                            // stored here by that block
    __shared__ int red[BLK_MAXW];           // the band shift's partial sums
    __shared__ int span[2][BLK_MAXW];       // each warp's least / most rbeg
    const int C = p.C, r = blockIdx.x % C, b = blockIdx.x / C;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int NT = blockDim.x, nwarp = NT >> 5, S = NT * K;
    const int NW = p.NW, bw = 32 * NW, T = p.T, B = p.B;
    const int w0 = r * S + t * K;        // the thread's first word
    const int qlen = p.qlen[b];
    const int tlen = min(p.tlen[b], T);
    const bool vec =
        NW % 4 == 0
        && ((reinterpret_cast<uintptr_t>(p.pm)
             | reinterpret_cast<uintptr_t>(p.pp)
             | reinterpret_cast<uintptr_t>(p.fin_pm)
             | reinterpret_cast<uintptr_t>(p.fin_pp)) & 15) == 0;
    const bool qvec = (reinterpret_cast<uintptr_t>(p.qeq) & 15) == 0;
    const int *tseq = p.tseq + (size_t)b * T;
    const int *rbegs = p.rbegs + b, *movxs = p.movxs + b;
    uint32_t *sh_pm = blk_s, *sh_pp = blk_s + S;   // the shift's copy
    const EqWin q =
        cl_window(p, b, r, S, tlen, blk_s + 2 * S, p.smem_words - 2 * S, span);
    cl_sync();   // every block of the cluster has started

    uint32_t pm[K], pp[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { pm[j] = 0u; pp[j] = FULL; }
    int sbeg = 0, smin = SMIN0, ry = 0, rbeg_f = 0;
    int part = 0, sbeg_prev = 0;     // TRACK: the row before's warp partial
                                     // and sbeg, reduced a row later

    uint32_t *out_pm = p.pm + (size_t)b * T * NW + w0;   // row i's words,
    uint32_t *out_pp = p.pp + (size_t)b * T * NW + w0;   // advanced by rows
    int *out_sbeg = p.sbeg + (size_t)b * T;
    int sb = 0;                      // lane r: sbeg of row r of a 32-row
                                     // block (block 0's warp 0 stores it)

    Row blk = load_row(tseq, rbegs, movxs, B, q.pstride, q.pbase, lane, tlen);
    Row nblk = load_row(tseq, rbegs, movxs, B, q.pstride, q.pbase, 32 + lane,
                        tlen);
    Row cur = shfl_row(blk, nblk, 0), nxt = shfl_row(blk, nblk, 1);
    uint32_t e[K + 1];               // the Eq words of row i
    load_eq_cl<K>(q.q, q.lim, q.off, q.staged, qvec, cur, w0, e);

    int i = 0;
    while (i < tlen) {
        // ---- band shift (striped_seqedit_row_movx, bsalign.h:658-721):
        // the row's copy in each block's shared memory, read across the
        // cluster after one cluster barrier, the popcount sum over it ----
        const int movx = cur.movx;
        if (MODE != OVERLAP && movx > 0) {
            const int mv = min(movx, bw);
            int d = 0;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t m = lowmask(w0 + j, mv);
                d += __popc(pp[j] & m) - __popc(pm[j] & m);
            }
            d = __reduce_add_sync(FULL, d);
            if (lane == 0) red[warp] = d;
            if (movx < bw) {
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    sh_pm[t * K + j] = pm[j];
                    sh_pp[t * K + j] = pp[j];
                }
            }
            cl_sync();
            int s = 0;
            for (int u = lane; u < C * nwarp; u += 32)
                s += (int)cl_load(&red[u % nwarp], u / nwarp);
            sbeg += __reduce_add_sync(FULL, s);
            if (movx >= bw) {
#pragma unroll
                for (int j = 0; j < K; ++j) { pm[j] = 0u; pp[j] = FULL; }
            } else {
                const int ws = movx >> 5, bs = movx & 31;
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    const int s0 = w0 + j + ws, s1 = s0 + 1;
                    const uint32_t lm =
                        s0 < NW ? cl_load(sh_pm + s0 % S, s0 / S) : 0u;
                    const uint32_t lp =
                        s0 < NW ? cl_load(sh_pp + s0 % S, s0 / S) : 0u;
                    const uint32_t hm =
                        s1 < NW ? cl_load(sh_pm + s1 % S, s1 / S) : 0u;
                    const uint32_t hp =
                        s1 < NW ? cl_load(sh_pp + s1 % S, s1 / S) : 0u;
                    const uint32_t keep = lowmask(w0 + j, bw - movx);
                    pm[j] = __funnelshift_r(lm, hm, bs) & keep;
                    pp[j] = (__funnelshift_r(lp, hp, bs) & keep) | ~keep;
                }
            }
        }

        // ---- rows i on, until one needs a band shift ----
        for (;;) {
            // the operands of rows i + 1 and i + 2, off this row's chain
            uint32_t e1[K + 1];
            load_eq_cl<K>(q.q, q.lim, q.off, q.staged, qvec, nxt, w0, e1);
            const Row nn = shfl_row(blk, nblk, (i & 31) + 2);
            if constexpr (MODE != OVERLAP) sbeg += 1;

            // Myers step, Eq from band position rbeg on: the thread's
            // generate / propagate over its K words, and over the first
            // K - 1 (the carry into its last word)
            const int bs = cur.rbeg & 31;
            uint32_t X[K], s0[K];
            bool gen[K], prop[K];
            bool G = false, P = true, Gl = false, Pl = true;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                X[j] = __funnelshift_r(e[j], e[j + 1], bs) | pm[j];
                const uint32_t ad = X[j] & pp[j];
                s0[j] = ad + pp[j];
                gen[j] = s0[j] < ad;
                prop[j] = s0[j] == FULL;
                if (j == K - 1) { Gl = G; Pl = P; }
                G = gen[j] || (prop[j] && G);
                P = P && prop[j];
            }
            uint32_t lo;
            int tot;
            bool c = cl_carry<MODE>(G, P, top_bits<K>(Gl, s0, X, pm, pp),
                                    top_bits<K>(Gl || Pl, s0, X, pm, pp),
                                    part, i, C, r, xch, xcl, lo, tot);
            if constexpr (TRACK) {   // the row before's score
                if (i > 0 && sbeg_prev + tot < smin) {
                    smin = sbeg_prev + tot;
                    ry = i - 1;
                }
            }
            uint32_t HP[K], HN[K], D0[K];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t A = s0[j] + (c ? 1u : 0u);
                c = gen[j] || (prop[j] && c);
                D0[j] = (A ^ pp[j]) | X[j];
                HP[j] = pm[j] | ~(D0[j] | pp[j]);
                HN[j] = pp[j] & D0[j];
            }
            // one-bit left shift across words, lo into the first
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t hps =
                    (HP[j] << 1) | (j ? HP[j - 1] >> 31 : lo & 1u);
                const uint32_t hns =
                    (HN[j] << 1) | (j ? HN[j - 1] >> 31 : lo >> 1);
                pp[j] = hns | ~(D0[j] | hps);
                pm[j] = hps & D0[j];
            }

            // overlap/extend: the warp's part of the row score at
            // H(qlen-1, i), reduced over the cluster with the next row's
            // words
            if constexpr (TRACK) {
                const int n = min(max(qlen - cur.rbeg, 0), bw);
                int d = 0;
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    const uint32_t m = lowmask(w0 + j, n);
                    d += __popc(pp[j] & m) - __popc(pm[j] & m);
                }
                part = __reduce_add_sync(FULL, d);
                sbeg_prev = sbeg;
            }

            store_blk<K>(out_pm, pm, w0, NW, vec);
            store_blk<K>(out_pp, pp, w0, NW, vec);
            out_pm += NW;
            out_pp += NW;
            if (lane == (i & 31)) sb = sbeg;
            rbeg_f = cur.rbeg;
            cur = nxt;
            nxt = nn;
#pragma unroll
            for (int j = 0; j <= K; ++j) e[j] = e1[j];
            // at a block's end: its sbeg in one store (block 0's warp 0),
            // the next block's scalars
            if ((i & 31) == 31) {
                if (r == 0 && warp == 0) out_sbeg[i - 31 + lane] = sb;
                blk = nblk;
                nblk = load_row(tseq, rbegs, movxs, B, q.pstride, q.pbase,
                                i + 33 + lane, tlen);
            }
            if (++i >= tlen || (MODE != OVERLAP && cur.movx > 0)) break;
        }
    }
    if constexpr (TRACK) {   // the last row's score
        if (tlen > 0) {
            const int tot = cl_last_score(part, tlen, C, xch, xcl);
            if (sbeg_prev + tot < smin) {
                smin = sbeg_prev + tot;
                ry = tlen - 1;
            }
        }
    }
    if (r == 0 && warp == 0 && (tlen & 31)) {
        const int rr = (tlen - 1) & 31;
        if (lane <= rr) out_sbeg[tlen - 1 - rr + lane] = sb;
    }

    store_blk<K>(p.fin_pm + (size_t)b * NW + w0, pm, w0, NW, vec);
    store_blk<K>(p.fin_pp + (size_t)b * NW + w0, pp, w0, NW, vec);
    if (r == 0 && t == 0) {
        int *s = p.scal + (size_t)b * 4;
        s[0] = sbeg; s[1] = smin; s[2] = ry; s[3] = rbeg_f;
    }
    cl_sync();   // no block leaves while a peer may still read its memory
}

// K words of device memory at p (16-byte aligned), through L2: the sweep's
// state rows, which other blocks of the cluster write and read.
template <int K>
__device__ __forceinline__ void ld_words(const uint32_t *p,
                                         uint32_t (&v)[K]) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
        const uint4 x = __ldcg(reinterpret_cast<const uint4 *>(p + j));
        v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
}

template <int K>
__device__ __forceinline__ void st_words(uint32_t *p,
                                         const uint32_t (&v)[K]) {
#pragma unroll
    for (int j = 0; j < K; j += 4)
        __stcg(reinterpret_cast<uint4 *>(p + j),
               make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]));
}

// Past the cluster's registers, the sweep: block r of up to SWP_MAXW warps
// holds words [r * S, (r + 1) * S), S = 32 * nwarp * NP * K, thread t NP
// pieces of K words
// from r * S + t * NP * K, its words of the pair's two state rows in
// device memory (p.seg: 4 planes of NS = C * S words a pair, the row
// before's pm and pp and the new row's, alternating), L2-resident at
// these sizes. Each row takes two passes over the pieces: the generate /
// propagate bits and the top bits of the thread's last word, then, after
// the cluster's one carry exchange, the words with their carries, written
// back and out. A band shift reads the row before at its offset (across
// the cluster: a cluster barrier orders the row before's stores first).
// warps of the sweep's blocks at most: ops/_cuda.py EDIT_SWEEP_MAXW (its
// two passes hold more registers than 16 warps leave a thread), which the
// build passes as EDIT_SWP_MAXW
constexpr int SWP_MAXW = EDIT_SWP_MAXW;

template <int K, int MODE>
__global__ void __launch_bounds__(32 * SWP_MAXW) edit_cl_sweep_kernel(
    ClParams p) {
    constexpr bool TRACK = MODE != GLOBAL;
    extern __shared__ __align__(16) uint32_t blk_s[];   // the Eq window
    __shared__ uint32_t xch[2][BLK_MAXW];
    __shared__ uint32_t xcl[2][CL_MAX];
    __shared__ int red[BLK_MAXW];
    __shared__ int span[2][BLK_MAXW];
    const int C = p.C, r = blockIdx.x % C, b = blockIdx.x / C;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int NT = blockDim.x, nwarp = NT >> 5, NP = p.pieces;
    const int S = NT * NP * K, NS = C * S;
    const int NW = p.NW, bw = 32 * NW, T = p.T, B = p.B;
    const int w0 = r * S + t * NP * K;
    const int qlen = p.qlen[b];
    const int tlen = min(p.tlen[b], T);
    const bool vec =
        NW % 4 == 0
        && ((reinterpret_cast<uintptr_t>(p.pm)
             | reinterpret_cast<uintptr_t>(p.pp)
             | reinterpret_cast<uintptr_t>(p.fin_pm)
             | reinterpret_cast<uintptr_t>(p.fin_pp)) & 15) == 0;
    const bool qvec = (reinterpret_cast<uintptr_t>(p.qeq) & 15) == 0;
    const int *tseq = p.tseq + (size_t)b * T;
    const int *rbegs = p.rbegs + b, *movxs = p.movxs + b;
    const EqWin q = cl_window(p, b, r, S, tlen, blk_s, p.smem_words, span);
    uint32_t *const st = p.seg + (size_t)b * 4 * NS;
    {
        uint32_t z[K], f[K];
#pragma unroll
        for (int j = 0; j < K; ++j) { z[j] = 0u; f[j] = FULL; }
        for (int k = 0; k < NP; ++k) {
            st_words<K>(st + w0 + k * K, z);
            st_words<K>(st + NS + w0 + k * K, f);
        }
    }
    cl_sync();   // every block has started, the first state row is set

    int sbeg = 0, smin = SMIN0, ry = 0, rbeg_f = 0;
    int part = 0, sbeg_prev = 0;
    uint32_t *out_pm = p.pm + (size_t)b * T * NW + w0;
    uint32_t *out_pp = p.pp + (size_t)b * T * NW + w0;
    int *out_sbeg = p.sbeg + (size_t)b * T;
    int sb = 0;
    Row blk = load_row(tseq, rbegs, movxs, B, q.pstride, q.pbase, lane, tlen);
    Row nblk = load_row(tseq, rbegs, movxs, B, q.pstride, q.pbase, 32 + lane,
                        tlen);
    int cur = 0;
    for (int i = 0; i < tlen; ++i) {
        const Row rw = shfl_row(blk, nblk, i & 31);
        const uint32_t *opm = st + 2 * cur * NS, *opp = opm + NS;
        uint32_t *npm = st + 2 * (1 - cur) * NS, *npp = npm + NS;
        const int movx = rw.movx;
        const bool shift = MODE != OVERLAP && movx > 0;
        if (shift) {   // the popcount sum of the bits the shift drops
            const int mv = min(movx, bw);
            int d = 0;
            for (int w = w0; w < w0 + NP * K && w < (mv + 31) >> 5; ++w) {
                const uint32_t m = lowmask(w, mv);
                d += __popc(__ldcg(opp + w) & m) - __popc(__ldcg(opm + w) & m);
            }
            d = __reduce_add_sync(FULL, d);
            if (lane == 0) red[warp] = d;
            cl_sync();
            int s = 0;
            for (int u = lane; u < C * nwarp; u += 32)
                s += (int)cl_load(&red[u % nwarp], u / nwarp);
            sbeg += __reduce_add_sync(FULL, s);
        }
        if constexpr (MODE != OVERLAP) sbeg += 1;
        // piece wq of the row before, shifted where the row shifts
        auto load_piece = [&](int wq, uint32_t (&pm)[K], uint32_t (&pp)[K]) {
            if (!shift) {
                ld_words<K>(opm + wq, pm);
                ld_words<K>(opp + wq, pp);
                return;
            }
            const int ws = movx >> 5, bs = movx & 31;
            uint32_t lm[K + 1], lp[K + 1];
#pragma unroll
            for (int j = 0; j <= K; ++j) {
                const int s = wq + j + ws;
                const bool in = movx < bw && s < NW;
                lm[j] = in ? __ldcg(opm + s) : 0u;
                lp[j] = in ? __ldcg(opp + s) : 0u;
            }
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t keep =
                    movx < bw ? lowmask(wq + j, bw - movx) : 0u;
                pm[j] = __funnelshift_r(lm[j], lm[j + 1], bs) & keep;
                pp[j] = (__funnelshift_r(lp[j], lp[j + 1], bs) & keep) | ~keep;
            }
        };
        const int bs = rw.rbeg & 31;
        // pass 1: generate / propagate over the thread's words, the top
        // bits of its last word for a carry into the thread of 0 and of 1
        bool G = false, P = true;
        uint32_t t0 = 0, t1 = 0;
        for (int k = 0; k < NP; ++k) {
            const int wq = w0 + k * K;
            uint32_t pm[K], pp[K], e[K + 1], X[K], s0[K];
            load_piece(wq, pm, pp);
            load_eq_cl<K>(q.q, q.lim, q.off, q.staged, qvec, rw, wq, e);
            bool Gk = false, Pk = true, Gl = false, Pl = true;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                X[j] = __funnelshift_r(e[j], e[j + 1], bs) | pm[j];
                const uint32_t ad = X[j] & pp[j];
                s0[j] = ad + pp[j];
                if (j == K - 1) { Gl = Gk; Pl = Pk; }
                Gk = (s0[j] < ad) || ((s0[j] == FULL) && Gk);
                Pk = Pk && (s0[j] == FULL);
            }
            if (k == NP - 1) {   // the carry into this piece: G, or G || P
                t0 = top_bits<K>(Gl || (Pl && G), s0, X, pm, pp);
                t1 = top_bits<K>(Gl || (Pl && (G || P)), s0, X, pm, pp);
            }
            G = Gk || (Pk && G);
            P = P && Pk;
        }
        uint32_t lo;
        int tot;
        bool c =
            cl_carry<MODE>(G, P, t0, t1, part, i, C, r, xch, xcl, lo, tot);
        if constexpr (TRACK) {
            if (i > 0 && sbeg_prev + tot < smin) {
                smin = sbeg_prev + tot;
                ry = i - 1;
            }
        }
        // pass 2: the words with their carries, piece by piece
        const int n = TRACK ? min(max(qlen - rw.rbeg, 0), bw) : 0;
        int d = 0;
        for (int k = 0; k < NP; ++k) {
            const int wq = w0 + k * K;
            uint32_t pm[K], pp[K], e[K + 1];
            load_piece(wq, pm, pp);
            load_eq_cl<K>(q.q, q.lim, q.off, q.staged, qvec, rw, wq, e);
            uint32_t HP[K], HN[K], D0[K];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t X = __funnelshift_r(e[j], e[j + 1], bs) | pm[j];
                const uint32_t ad = X & pp[j];
                const uint32_t s0 = ad + pp[j];
                const uint32_t A = s0 + (c ? 1u : 0u);
                c = (s0 < ad) || ((s0 == FULL) && c);
                D0[j] = (A ^ pp[j]) | X;
                HP[j] = pm[j] | ~(D0[j] | pp[j]);
                HN[j] = pp[j] & D0[j];
            }
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const uint32_t hps =
                    (HP[j] << 1) | (j ? HP[j - 1] >> 31 : lo & 1u);
                const uint32_t hns =
                    (HN[j] << 1) | (j ? HN[j - 1] >> 31 : lo >> 1);
                pp[j] = hns | ~(D0[j] | hps);
                pm[j] = hps & D0[j];
            }
            lo = (HP[K - 1] >> 31) | (HN[K - 1] >> 31 << 1);
            st_words<K>(npm + wq, pm);
            st_words<K>(npp + wq, pp);
            store_blk<K>(out_pm + k * K, pm, wq, NW, vec);
            store_blk<K>(out_pp + k * K, pp, wq, NW, vec);
            if constexpr (TRACK) {
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    const uint32_t m = lowmask(wq + j, n);
                    d += __popc(pp[j] & m) - __popc(pm[j] & m);
                }
            }
        }
        if constexpr (TRACK) {
            part = __reduce_add_sync(FULL, d);
            sbeg_prev = sbeg;
        }
        out_pm += NW;
        out_pp += NW;
        if (lane == (i & 31)) sb = sbeg;
        rbeg_f = rw.rbeg;
        cur = 1 - cur;
        if ((i & 31) == 31) {
            if (r == 0 && warp == 0) out_sbeg[i - 31 + lane] = sb;
            blk = nblk;
            nblk = load_row(tseq, rbegs, movxs, B, q.pstride, q.pbase,
                            i + 33 + lane, tlen);
        }
    }
    if constexpr (TRACK) {
        if (tlen > 0) {
            const int tot = cl_last_score(part, tlen, C, xch, xcl);
            if (sbeg_prev + tot < smin) {
                smin = sbeg_prev + tot;
                ry = tlen - 1;
            }
        }
    }
    if (r == 0 && warp == 0 && (tlen & 31)) {
        const int rr = (tlen - 1) & 31;
        if (lane <= rr) out_sbeg[tlen - 1 - rr + lane] = sb;
    }
    for (int k = 0; k < NP; ++k) {   // the final state, the thread's own words
        uint32_t pm[K], pp[K];
        const int wq = w0 + k * K;
        ld_words<K>(st + 2 * cur * NS + wq, pm);
        ld_words<K>(st + 2 * cur * NS + NS + wq, pp);
        store_blk<K>(p.fin_pm + (size_t)b * NW + wq, pm, wq, NW, vec);
        store_blk<K>(p.fin_pp + (size_t)b * NW + wq, pp, wq, NW, vec);
    }
    if (r == 0 && t == 0) {
        int *s = p.scal + (size_t)b * 4;
        s[0] = sbeg; s[1] = smin; s[2] = ry; s[3] = rbeg_f;
    }
    cl_sync();
}

// The cluster exchange alone, for its floor (chip_smoke.py --kernels): per
// row, lanes of warp 0 store one word into each block of the cluster, one
// cluster barrier, every warp reads the C words, whose sum is the next
// row's word; one cluster of C blocks of nwarp warps per pair. Each block
// writes the rows it counted to out.
__global__ void __launch_bounds__(32 * BLK_MAXW) edit_cl_floor_kernel(
    int C, int rows, int *out) {
    __shared__ uint32_t xcl[2][CL_MAX];
    const int r = blockIdx.x % C, lane = threadIdx.x & 31,
              warp = threadIdx.x >> 5;
    cl_sync();
    uint32_t acc = 0;   // the rows so far, through every block's word
    for (int i = 0; i < rows; ++i) {
        if (warp == 0 && lane < C) cl_store(&xcl[i & 1][r], lane, acc + 1);
        cl_sync();
        acc = __reduce_add_sync(FULL, lane < C ? xcl[i & 1][lane] : 0u) / C;
    }
    cl_sync();
    if (threadIdx.x == 0) out[blockIdx.x] = (int)acc;
}

// Dynamic shared memory of the block row: the staged Eq planes (padded,
// blk_plane words each) and the band shift's copy of the row.
template <int K>
int blk_smem(const Params &p, int nwarp) {
    return (p.staged ? 16 * blk_plane<K>(p.NWQ) : 0) + 8 * 32 * nwarp * K;
}

template <int K, int MODE>
cudaError_t launch_blk(const Params &p, int nwarp, cudaStream_t stream) {
    const int smem = blk_smem<K>(p, nwarp);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            edit_blk_rows_kernel<K, MODE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    edit_blk_rows_kernel<K, MODE><<<p.B, 32 * nwarp, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int K>
cudaError_t launch_blk_mode(const Params &p, int nwarp, cudaStream_t stream) {
    if (p.mode == OVERLAP) return launch_blk<K, OVERLAP>(p, nwarp, stream);
    if (p.mode == EXTEND) return launch_blk<K, EXTEND>(p, nwarp, stream);
    return launch_blk<K, GLOBAL>(p, nwarp, stream);
}

// Dynamic shared words of the cluster row: in registers the shift's copy
// of the block's slice (S words each of pm and pp), and room for its window
// of the four Eq planes: the whole planes plus the slice (the most any span
// of rbeg can reach), within what a block may take beside its static
// arrays.
int cl_smem_words(const ClParams &p, int S, bool sweep) {
    const int want = (sweep ? 0 : 2 * S) + 4 * ((p.NWQ + S + 8 + 3) & ~3);
    return want < (SMEM_MAX - 1024) / 4 ? want : (SMEM_MAX - 1024) / 4;
}

// A launch of kern(args) as nblk blocks of nwarp warps in clusters of C
// blocks, or with occ the clusters of it the card holds at once.
template <typename F, typename... A>
cudaError_t launch_cluster(F kern, int nblk, int C, int nwarp, int smem,
                           cudaStream_t stream, int *occ, A... args) {
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && C > 8)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(nblk);
    cfg.blockDim = dim3(32 * nwarp);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (occ) return cudaOccupancyMaxActiveClusters(occ, kern, &cfg);
    e = cudaLaunchKernelEx(&cfg, kern, args...);
    return e != cudaSuccess ? e : cudaGetLastError();
}

template <int K, int MODE>
cudaError_t launch_cl(ClParams p, int nwarp, cudaStream_t stream, int *occ) {
    const bool sweep = p.pieces > 1;
    p.smem_words = cl_smem_words(p, 32 * nwarp * p.pieces * K, sweep);
    if constexpr (K == 8) {   // the sweep holds pieces of 8 words
        if (sweep)
            return launch_cluster(edit_cl_sweep_kernel<K, MODE>, p.C * p.B,
                                  p.C, nwarp, 4 * p.smem_words, stream, occ,
                                  p);
    }
    return launch_cluster(edit_cl_rows_kernel<K, MODE>, p.C * p.B, p.C, nwarp,
                          4 * p.smem_words, stream, occ, p);
}

template <int K>
cudaError_t launch_cl_mode(const ClParams &p, int nwarp,
                           cudaStream_t stream, int *occ = nullptr) {
    if (p.mode == OVERLAP) return launch_cl<K, OVERLAP>(p, nwarp, stream, occ);
    if (p.mode == EXTEND) return launch_cl<K, EXTEND>(p, nwarp, stream, occ);
    return launch_cl<K, GLOBAL>(p, nwarp, stream, occ);
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

// The row that runs is the caller's (ops/_cuda.py edit_rows): design 0
// the register row (NW <= 512), 1 the block row of nwarp warps of threads
// owning K words (K 4 or 8, nwarp <= 16, 32 * nwarp * K >= NW), 3 the
// cluster row of ncl blocks of nwarp warps of threads owning `pieces`
// pieces of K words (ncl <= 16, every block holding words of the band; K 8
// where pieces > 1, the sweep, whose state rows `state` holds: 4 * ncl *
// S words a pair, S = 32 * nwarp * pieces * K).
extern "C" int bsa_edit_rows(const int *qeq, const int *qlen, const int *tseq,
                             const int *tlen, const int *rbegs,
                             const int *movxs, int *pm, int *pp, int *sbeg,
                             int *fin_pm, int *fin_pp, int *scal, void *state,
                             int B, int T, int NW, int NWQ, int mode,
                             int design, int K, int nwarp, int ncl,
                             int pieces, void *stream) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(pm) | reinterpret_cast<uintptr_t>(pp)
          | reinterpret_cast<uintptr_t>(fin_pm)
          | reinterpret_cast<uintptr_t>(fin_pp)) & 15) == 0;
    Params p{reinterpret_cast<const uint32_t *>(qeq), qlen, tseq, tlen, rbegs,
             movxs, reinterpret_cast<uint32_t *>(pm),
             reinterpret_cast<uint32_t *>(pp), sbeg, scal,
             reinterpret_cast<uint32_t *>(fin_pm),
             reinterpret_cast<uint32_t *>(fin_pp), B, T, NW, NWQ, mode,
             16 * NWQ <= EQ_SMEM_MAX, static_cast<uint32_t *>(state)};
    if (B <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (design == 3) {
        const long S = 32L * nwarp * pieces * K;
        if ((K != 4 && K != 8) || nwarp < 1 || nwarp > BLK_MAXW || ncl < 1
            || ncl > CL_MAX || pieces < 1 || ncl * S < NW
            || (ncl - 1) * S >= NW
            || (pieces > 1 && (K != 8 || nwarp > SWP_MAXW || !state)))
            return cudaErrorInvalidValue;
        ClParams c{p, ncl, pieces, 0};
        return K == 4 ? launch_cl_mode<4>(c, nwarp, s)
                      : launch_cl_mode<8>(c, nwarp, s);
    }
    if (design == 1) {
        if (nwarp < 1 || nwarp > BLK_MAXW || 32 * nwarp * K < NW)
            return cudaErrorInvalidValue;
        // the block row stages its Eq planes wherever they fit
        p.staged = true;
        if ((K == 4 ? blk_smem<4>(p, nwarp) : blk_smem<8>(p, nwarp))
            > SMEM_MAX)
            p.staged = false;
        if (K == 4) return launch_blk_mode<4>(p, nwarp, s);
        if (K == 8) return launch_blk_mode<8>(p, nwarp, s);
        return cudaErrorInvalidValue;
    }
    if (design != 0 || NW > 512) return cudaErrorInvalidValue;
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

// Clusters of the cluster row (nwarp warps of K words a thread, ncl
// blocks, the band in registers, the dynamic shared memory of a pair of
// NW words and NWQ query words) that the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error with which it
// refuses that size.
extern "C" int bsa_edit_cluster_occupancy(int K, int nwarp, int ncl, int NW,
                                          int NWQ) {
    ClParams p{};
    p.B = 1;
    p.NW = NW;
    p.NWQ = NWQ;
    p.C = ncl;
    p.pieces = 1;
    int n = 0;
    const cudaError_t e = K == 4 ? launch_cl_mode<4>(p, nwarp, nullptr, &n)
                                 : launch_cl_mode<8>(p, nwarp, nullptr, &n);
    cudaGetLastError();   // a refused size leaves no error behind
    return e != cudaSuccess ? -(int)e : n;
}

// The cluster exchange's floor: B clusters of ncl blocks of nwarp warps,
// `rows` exchanges each (edit_cl_floor_kernel); out holds ncl * B ints.
extern "C" int bsa_edit_cluster_floor(int ncl, int nwarp, int B, int rows,
                                      int *out, void *stream) {
    if (ncl < 1 || ncl > CL_MAX || nwarp < 1 || nwarp > BLK_MAXW || B < 1)
        return cudaErrorInvalidValue;
    return launch_cluster(edit_cl_floor_kernel, ncl * B, ncl, nwarp, 0,
                          static_cast<cudaStream_t>(stream), nullptr, ncl,
                          rows, out);
}
