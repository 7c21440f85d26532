// Batched remsa pedit profile DP: the anti-diagonal, unsigned-8-bit
// max-match realignment of each read against its window's MSA column-count
// profile, for Hopper (sm_90a).
//
// Replaces the TPU kernel bsalign_tpu/ops/pedit_pallas.py::_get_call.kernel
// (:46-140), which computes what the host's bsa_pedit_forward does
// (native/rowops.cpp, after bspoa.h:3856-3896). One job is one (read,
// window) pair; per step s of its 2*(mend-mbeg)-1 steps (at least one) the
// x side (read) advances on odd steps and the y side (consensus) on even
// ones, x = mbeg + (s+1)/2, y = mbeg + s/2. Cell i of the band reads the
// read base rb = seqs0[x+i] and the consensus base cb = seqs1[mlen-1-y+i];
// xs = mats0[cb][x+i] and ys = mats1[rb][mlen-1-y+i] (0 for a base >= 4),
// h = max(min(xs+ys, 255), pu, pv) with pu/pv the previous row shifted by
// 2/1 cells on odd steps and 1/0 on even ones, and the row stores h-pv in
// matrix0 and h-pu in matrix1 at cell 1+i. Edge cells: matrix0[0] = 255 on
// odd steps, matrix1[bw+1] = 255 on even steps, else 0. Row 2*mbeg is the
// seed (matrix0[HW] = matrix1[HW+1] = 255); every other row of the job's
// (2*mlen+2) is zero. Indices at or past a job's pad read 4 for seqs0 and 0
// for seqs1 and the counts, as the TPU kernel's feed inserts (the host's
// jobs never reach them). The plain PyTorch version of the same function is
// bsalign_tpu_torch/ops/pedit.py::forward_plain; the two agree byte for
// byte.
//
// What bounds it on this card: the bytes are small (a band-32 job of an
// 800 bp window writes 2 x 34 bytes per row; 2,560 such jobs move about
// 0.44 GB, 0.13 ms at 3.35 TB/s). Each job is a chain of 2*mlen dependent
// rows, and with thousands of jobs on the card at once what holds a step is
// the instructions the SMs issue for it, so the design counts them.
//
// What the design does about it:
// - One warp per job, several jobs per block, no block barrier. Lane l
//   keeps band cells [l*K, (l+1)*K) of both matrices' previous row in
//   registers (K = the power of two at or above bw/32, a template
//   parameter). An even step takes pv from the lane below by one
//   __shfl_up_sync, an odd step pu from the lane above by one
//   __shfl_down_sync; the band's edge cells are constants of the step's
//   parity (the seed's, when HW puts a 255 there), so they need no lane.
//   A step is the shuffle, one three-way max (DPX) and two subtractions.
// - The operands are off the chain and cheap. None depends on the previous
//   row: a pair of steps (even, odd) reads one y position and, per cell,
//   one new x position (the odd step's x is the next pair's even step's).
//   A position is two loads: its base and its four counts packed in one
//   word (the packed layout interleaves them); the count is picked by the
//   other side's base with one byte permute, and the score is one DPX
//   add-and-min.
// - Whole outputs, wide stores. The warp streams every byte of its job's
//   two matrices, the zero rows included, through a ring in shared memory
//   that keeps both matrices' bytes of a position side by side: a row is
//   one 2-byte store per cell, and one more by lanes 0 and 1 for the two
//   edge cells (the other lanes aim theirs at junk bytes, so no store sits
//   behind a branch). Each 512 positions leave through a flush, out of
//   line (it runs once in 15 rows at band 32), that splits the matrices
//   with byte permutes into one 16-byte store per lane and matrix, bytewise
//   only in the 16-byte chunks a job shares with its neighbours. The
//   caller allocates the outputs without zeroing them.
//
// Bands past 32 x 32 - 2 = 1,022 cells take the block row
// (pedit_blk_rows_kernel): one block of NWARP warps (up to 32) a job, the
// band in registers across them, since one warp would sweep a wide step in
// turn. What bounds it: a step's instructions over the band on one SM
// (about 50 a cell at K 4, most of them the address arithmetic and
// predication of its loads; PERF.md §6), and the one barrier a step.
// - Thread t of NT holds band cells i = t + NT * k, k < K (K 2 to 32:
//   ops/_cuda.py pedit_block_geometry), two cells of both matrices' row
//   before in each 32-bit word (16 bits a cell), so a step is one DPX
//   three-way max (__vimax3_u16x2) and two subtractions per two cells, and
//   a neighbour is the same word of the next thread: one shuffle per word.
//   Across a warp boundary it comes from shared memory, where lane 31 (even
//   steps take matrix 1 of the cell below) or lane 0 (odd steps take matrix
//   0 of the cell above) leaves its words before the step's one block
//   barrier, in slots alternating by the step's parity. Thread 0 and the
//   last thread wrap around to each other's next k.
// - Consecutive lanes hold consecutive cells, so the operand loads
//   coalesce and the ring stores hit distinct banks. To K 8 the operands
//   come per pair of steps as in the register rows: one y position and one
//   new x position per cell a pair (the odd step's x is the next pair's
//   even x), each as its base and its four counts in one word, picked by a
//   byte permute; past K 8 (1,024 threads leave 64 registers a thread) each
//   step loads its own.
// - The block writes each row into a ring in shared memory (both matrices'
//   bytes of a position side by side, a power of two >= 2 rows + 32
//   positions: bw + 2 <= 32,512 fits the block's 227 KB); after the step's
//   barrier the threads flush every 16 finished positions in 16-byte stores
//   per matrix, bytewise only in the chunks a job shares with its
//   neighbours. Plain shared stores: the barrier orders them, and nothing
//   orders the operand loads. The zero rows before the seed and after the
//   last step go straight to the device.

// Layouts: rd / cn hold the bases, one plane of `pad` bytes per job (read
// side) or per window (consensus side); rdm / cnm the counts, one uint32 per
// position (byte c = count of base c), at the same offsets in words. jobs
// is int64 [J, 8] = (rd offset, cn offset, output offset, pad, mlen, mbeg,
// mend, unused); out0/out1 are flat uint8, 16-byte aligned, job j's matrix
// at its output offset with (2*mlen+2) rows of bw+2 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;     // jobs per block, one warp each
constexpr int WIN = 512;     // positions of one flush: 16 per lane
constexpr int MAX_K = 32;    // cells per lane at the widest band

struct Params {
    const uint8_t *rd, *cn;
    const uint32_t *rdm, *cnm;
    const int64_t *jobs;
    uint8_t *out0, *out1;
    int J, bw, HW;
};

// Positions of the ring per warp (2 bytes each, one per matrix): a power
// of two >= WIN + one row.
template <int K>
constexpr int RING = WIN + 32 * K + 2 <= 1024 ? 1024 : 2048;

// One side's operands at one position (base and counts at the pointers,
// read when `in` says the position is in [0, pad)): the byte-permute
// selector of its base (0x4440 | min(base, 4): byte `base` of a counts
// word, or a zero byte for base >= 4) and its four counts; out of range the
// defaults (base `none`, counts 0).
__device__ __forceinline__ void load_pos(const uint8_t *base,
                                         const uint32_t *counts, bool in,
                                         int none, int &sel, uint32_t &cnt) {
    int b = none;
    cnt = 0u;
    if (in) {
        b = __ldg(base);
        cnt = __ldg(counts);
    }
    sel = __viaddmin_s32(b, 0x4440, 0x4444);
}

// Byte permute of a and 0 by a selector whose nibbles are all below 8 (so
// no masking of the selector, which __byte_perm would add).
__device__ __forceinline__ int prmt(uint32_t a, int sel) {
    int r;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(0), "r"(sel));
    return r;
}

// min(xs + ys, 255) for a cell whose x side is (xsel, xc), y side (ysel, yc).
__device__ __forceinline__ int score(int xsel, uint32_t xc, int ysel,
                                     uint32_t yc) {
    return __viaddmin_s32(prmt(xc, ysel), prmt(yc, xsel), 255);
}

// One position of both matrices into the ring: bytes v0 (matrix 0) and
// v1 (matrix 1) as one 2-byte store at shared address a. Unconditional (a
// lane with nothing to write aims at its own junk bytes), so the compiler
// cannot put a branch around it.
__device__ __forceinline__ void st_ring(uint32_t a, int v0, int v1) {
    asm volatile("st.shared.u16 [%0], %1;"
                 :: "r"(a), "r"(__byte_perm(v0, v1, 0x0040)) : "memory");
}

// Write stream positions [lo, hi) (lo a multiple of 16, hi - lo <= WIN)
// from the ring (position x: byte 2 * (x & rm) of matrix 0, the next of
// matrix 1; rm = the ring's positions - 1) to device bytes g0/g1 (16-byte
// aligned), those in the job's [beg, end) alone: per lane, 16 positions as
// two 16-byte loads, split by byte permutes into one 16-byte store per
// matrix where the chunk lies inside the job, bytewise at the job's two
// ends.
__device__ __forceinline__ void flush_body(uint8_t *g0, uint8_t *g1,
                                           const uint8_t *ring, int rm,
                                           int lo, int hi, int beg, int end,
                                           int lane) {
    __syncwarp();
    const int q = lo + 16 * lane;
    if (q < hi) {
        const int a = max(q, beg), b = min(min(q + 16, hi), end);
        if (a == q && b == q + 16) {
            const uint4 *r = reinterpret_cast<const uint4 *>(
                ring + 2 * (q & rm));
            const uint4 u = r[0], v = r[1];
            *reinterpret_cast<uint4 *>(g0 + q) = make_uint4(
                __byte_perm(u.x, u.y, 0x6420), __byte_perm(u.z, u.w, 0x6420),
                __byte_perm(v.x, v.y, 0x6420), __byte_perm(v.z, v.w, 0x6420));
            *reinterpret_cast<uint4 *>(g1 + q) = make_uint4(
                __byte_perm(u.x, u.y, 0x7531), __byte_perm(u.z, u.w, 0x7531),
                __byte_perm(v.x, v.y, 0x7531), __byte_perm(v.z, v.w, 0x7531));
        } else {
            for (int x = a; x < b; ++x) {
                g0[x] = ring[2 * (x & rm)];
                g1[x] = ring[2 * (x & rm) + 1];
            }
        }
    }
    __syncwarp();
}

// the flush out of line, for a ring of RS positions
template <int RS>
__device__ __noinline__ void flush(uint8_t *g0, uint8_t *g1,
                                   const uint8_t *ring, int lo, int hi,
                                   int beg, int end, int lane) {
    flush_body(g0, g1, ring, RS - 1, lo, hi, beg, end, lane);
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS) pedit_rows_kernel(Params p) {
    constexpr int RS = RING<K>;
    extern __shared__ __align__(16) uint8_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x * WARPS + warp;
    if (j >= p.J) return;            // the whole warp
    const int64_t *jb = p.jobs + (size_t)j * 8;
    const uint8_t *rd = p.rd + jb[0], *cn = p.cn + jb[1];
    const uint32_t *rdm = p.rdm + jb[0], *cnm = p.cnm + jb[1];
    const int pad = (int)jb[3], mlen = (int)jb[4], mbeg = (int)jb[5],
              mend = (int)jb[6];
    const int bw = p.bw, HW = p.HW, rowlen = bw + 2;
    const int nrows = 2 * mlen + 2;

    // the output stream: position q of the job's rows is ring bytes
    // 2 * (q & (RS-1)) (matrix 0) and the next (matrix 1), and device byte
    // g0 + q / g1 + q, q counted from the 16-byte aligned address at or
    // below the job's start
    const int beg = (int)(jb[2] & 15), end = beg + nrows * rowlen;
    uint8_t *g0 = p.out0 + (jb[2] - beg), *g1 = p.out1 + (jb[2] - beg);
    uint8_t *ring = smem + warp * (2 * RS + 64);
    // shared addresses: the ring, and the lane's two junk bytes past it
    const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
    const uint32_t junk = ring_s + 2 * RS + 2 * lane;
    int q = beg, done = 0;           // next row's first position; flushed
                                     // below done
    const int cell0 = 1 + lane * K;  // the lane's first cell in a row
    const int edge = lane ? bw + 1 : 0;   // lanes 0 / 1: left / right edge

    // one row: the lane's K cells c0/c1 (those in the band) and edge bytes
    // e0/e1 (lanes 0 and 1); then every full window goes out
    auto put_row = [&](const int (&c0)[K], const int (&c1)[K], int e0,
                       int e1) {
#pragma unroll
        for (int k = 0; k < K; ++k)
            st_ring(cell0 + k <= bw ? ring_s + 2 * ((q + cell0 + k) & (RS - 1))
                                    : junk, c0[k], c1[k]);
        st_ring(lane < 2 ? ring_s + 2 * ((q + edge) & (RS - 1)) : junk, e0,
                e1);
        q += rowlen;
        while (q - done >= WIN) {
            flush<RS>(g0, g1, ring, done, done + WIN, beg, end, lane);
            done += WIN;
        }
    };
    int zero[K];
#pragma unroll
    for (int k = 0; k < K; ++k) zero[k] = 0;

    // rows before the seed
    for (int r = 0; r < 2 * mbeg; ++r) put_row(zero, zero, 0, 0);

    // the seed row: P0/P1 hold the previous row's band cells (t = 1 + i)
    int P0[K], P1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int t = cell0 + k;
        P0[k] = t <= bw && t == HW ? 255 : 0;
        P1[k] = t <= bw && t == HW + 1 ? 255 : 0;
    }
    put_row(P0, P1, lane ? (HW == bw + 1 ? 255 : 0) : (HW == 0 ? 255 : 0),
            lane ? (HW == bw ? 255 : 0) : (HW == -1 ? 255 : 0));
    int up_edge = HW == -1 ? 255 : 0;   // matrix1[0] of the previous row
    // the cell past the band (pu of the last cell on odd steps) reads 0;
    // with K > 1 a lane's cells past the band are held at 0 instead
    const bool dn_edge = (lane + 1) * K >= bw;
    const int e0_odd = lane ? 0 : 255, e1_even = lane ? 255 : 0;

    // pairs of steps: pair m runs step 2m (x at X0 + m, y at Y0 - m) and,
    // but in the last pair, step 2m + 1 (x at X0 + m + 1, same y)
    const int M = max(mend - mbeg, 1);
    int xi = mbeg + lane * K, yi = mlen - 1 - mbeg + lane * K;
    int xsel[K];                     // x side of the pair's even step
    uint32_t xc[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
        load_pos(rd + xi + k, rdm + xi + k, (unsigned)(xi + k) < (unsigned)pad,
                 4, xsel[k], xc[k]);
    // the loads' running positions: the odd step's x, the pair's y
    ++xi;
    const uint8_t *xb = rd + xi, *yb = cn + yi;
    const uint32_t *xw = rdm + xi, *yw = cnm + yi;

    for (int m = 0; m < M; ++m) {
        int ae[K], ao[K];            // min(xs + ys, 255) of the two steps
#pragma unroll
        for (int k = 0; k < K; ++k) {
            int ysel, nsel;
            uint32_t yc, nc;
            load_pos(yb + k, yw + k, (unsigned)(yi + k) < (unsigned)pad, 0,
                     ysel, yc);
            load_pos(xb + k, xw + k, (unsigned)(xi + k) < (unsigned)pad, 4,
                     nsel, nc);
            ae[k] = score(xsel[k], xc[k], ysel, yc);
            ao[k] = score(nsel, nc, ysel, yc);
            xsel[k] = nsel;
            xc[k] = nc;
        }
        ++xi, ++xb, ++xw;
        --yi, --yb, --yw;
        // even step: pu = P0[i], pv = P1[i-1]
        {
            int up = __shfl_up_sync(FULL, P1[K - 1], 1);
            if (lane == 0) up = up_edge;
            int c0[K], c1[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int pu = P0[k], pv = k ? P1[k - 1] : up;
                const int h = __vimax3_s32(ae[k], pu, pv);
                c0[k] = K > 1 && cell0 + k > bw ? 0 : h - pv;
                c1[k] = h - pu;
            }
#pragma unroll
            for (int k = 0; k < K; ++k) { P0[k] = c0[k]; P1[k] = c1[k]; }
            up_edge = 0;
            put_row(P0, P1, 0, e1_even);
        }
        if (m + 1 < M) {
            // odd step: pu = P0[i+1], pv = P1[i]
            int dn = __shfl_down_sync(FULL, P0[0], 1);
            if (dn_edge) dn = 0;
            int c0[K], c1[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int pu = k + 1 < K ? P0[k + 1] : dn, pv = P1[k];
                const int h = __vimax3_s32(ao[k], pu, pv);
                c0[k] = K > 1 && cell0 + k > bw ? 0 : h - pv;
                c1[k] = h - pu;
            }
#pragma unroll
            for (int k = 0; k < K; ++k) { P0[k] = c0[k]; P1[k] = c1[k]; }
            put_row(P0, P1, e0_odd, 0);
        }
    }

    // rows after the last step, then what is left in the ring
    for (int r = 2 * mbeg + 2 * M; r < nrows; ++r) put_row(zero, zero, 0, 0);
    if (q > done) flush<RS>(g0, g1, ring, done, q, beg, end, lane);
}

// ---- the block row: one block of NWARP warps a job ----

// warps of the block row at most: ops/_cuda.py PEDIT_BLOCK_MAXW, which the
// build passes as PEDIT_BLK_MAXW
constexpr int BLK_MAXW = PEDIT_BLK_MAXW;

// Positions of the block row's ring: the power of two >= 2 rows + 32.
int blk_ring(int bw) {
    int rs = 1024;
    while (rs < 2 * (bw + 2) + 32) rs *= 2;
    return rs;
}

// min(xs + ys, 255) of the cell whose x side is at position ix and y side
// at iy (x out of [0, pad) reads base 4, counts 0; y base 0, counts 0).
__device__ __forceinline__ int cell_score(const uint8_t *rd,
                                          const uint32_t *rdm,
                                          const uint8_t *cn,
                                          const uint32_t *cnm, int pad,
                                          int ix, int iy) {
    int xsel, ysel;
    uint32_t xc, yc;
    load_pos(rd + ix, rdm + ix, (unsigned)ix < (unsigned)pad, 4, xsel, xc);
    load_pos(cn + iy, cnm + iy, (unsigned)iy < (unsigned)pad, 0, ysel, yc);
    return score(xsel, xc, ysel, yc);
}

template <int K>
__global__ void __launch_bounds__(32 * BLK_MAXW) pedit_blk_rows_kernel(
    Params p, int RS) {
    constexpr int J = K / 2;          // words of 16x2: cells k = 2j, 2j + 1
    constexpr bool PAIR = K <= 8;     // operands per pair of steps
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ uint32_t ex[2][BLK_MAXW][J];   // boundary words, by parity
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int NT = blockDim.x, nwarp = NT >> 5;
    const int64_t *jb = p.jobs + (size_t)blockIdx.x * 8;
    const uint8_t *rd = p.rd + jb[0], *cn = p.cn + jb[1];
    const uint32_t *rdm = p.rdm + jb[0], *cnm = p.cnm + jb[1];
    const int pad = (int)jb[3], mlen = (int)jb[4], mbeg = (int)jb[5],
              mend = (int)jb[6];
    const int bw = p.bw, HW = p.HW, rowlen = bw + 2;
    const int nrows = 2 * mlen + 2;
    const int rm = RS - 1;
    // the output stream: position x of the job's rows is ring entry x & rm
    // (low byte matrix 0, high byte matrix 1) and device byte g0 + x / g1 +
    // x, x counted from the 16-byte aligned address at or below the job's
    // start; chunk c is positions [16c, 16c + 16)
    const int beg = (int)(jb[2] & 15), end = beg + nrows * rowlen;
    uint8_t *g0 = p.out0 + (jb[2] - beg), *g1 = p.out1 + (jb[2] - beg);
    uint16_t *ring = reinterpret_cast<uint16_t *>(smem);

    // chunks [c0, c1) from the ring (or zeros) to the device, one chunk a
    // thread in turn: 16-byte stores where the chunk lies inside the job,
    // bytewise at the job's two ends
    auto put = [&](int c0, int c1, bool zero) {
        for (int c = c0 + t; c < c1; c += NT) {
            const int q = 16 * c;
            const int a = max(q, beg), e = min(q + 16, end);
            if (a == q && e == q + 16) {
                uint4 m0 = make_uint4(0u, 0u, 0u, 0u), m1 = m0;
                if (!zero) {
                    const uint4 *r = reinterpret_cast<const uint4 *>(
                        ring + (q & rm));
                    const uint4 u = r[0], v = r[1];
                    m0 = make_uint4(__byte_perm(u.x, u.y, 0x6420),
                                    __byte_perm(u.z, u.w, 0x6420),
                                    __byte_perm(v.x, v.y, 0x6420),
                                    __byte_perm(v.z, v.w, 0x6420));
                    m1 = make_uint4(__byte_perm(u.x, u.y, 0x7531),
                                    __byte_perm(u.z, u.w, 0x7531),
                                    __byte_perm(v.x, v.y, 0x7531),
                                    __byte_perm(v.z, v.w, 0x7531));
                }
                *reinterpret_cast<uint4 *>(g0 + q) = m0;
                *reinterpret_cast<uint4 *>(g1 + q) = m1;
            } else {
                for (int x = a; x < e; ++x) {
                    const int v = zero ? 0 : ring[x & rm];
                    g0[x] = (uint8_t)v;
                    g1[x] = (uint8_t)(v >> 8);
                }
            }
        }
    };

    // rows before the seed: zeros, straight to the device but for the last
    // chunk, which the ring finishes
    const int zl = beg + 2 * mbeg * rowlen;        // the seed row's start
    const int nsteps = max(2 * (mend - mbeg) - 1, 1);
    const int zt = zl + (1 + nsteps) * rowlen;      // the rows after the last
    put(0, zl >> 4, true);
    int done = zl & ~15;                            // flushed below done
    if (t < 16 && done + t < zl) ring[(done + t) & rm] = 0;

    // the thread's cells: band index i = t + NT * k (cell 1 + i of a row),
    // k = 2j in the low half of word j, 2j + 1 in the high; the geometry
    // puts every cell past the band in the last word
    const bool in_lo = t + NT * (K - 2) < bw, in_hi = t + NT * (K - 1) < bw;
    const uint32_t keep = (in_lo ? 0xFFFFu : 0u) | (in_hi ? 0xFFFF0000u : 0u);
    // the seed row (255 at HW in matrix 0, HW + 1 in matrix 1)
    uint32_t P0[J], P1[J];
    int q = zl;
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int il = t + NT * 2 * j, ih = il + NT;
        P0[j] = (il < bw && il + 1 == HW ? 255u : 0u)
                | (ih < bw && ih + 1 == HW ? 255u << 16 : 0u);
        P1[j] = (il < bw && il + 1 == HW + 1 ? 255u : 0u)
                | (ih < bw && ih + 1 == HW + 1 ? 255u << 16 : 0u);
        const uint32_t v = __byte_perm(P0[j], P1[j], 0x6240);
        if (j < J - 1 || in_lo) ring[(q + 1 + il) & rm] = (uint16_t)v;
        if (j < J - 1 || in_hi) ring[(q + 1 + ih) & rm] = (uint16_t)(v >> 16);
    }
    if (t == 0)
        ring[q & rm] = (HW == 0 ? 255 : 0) | (HW == -1 ? 255 << 8 : 0);
    if (t == 1)
        ring[(q + bw + 1) & rm] =
            (HW == bw + 1 ? 255 : 0) | (HW == bw ? 255 << 8 : 0);
    // step 0 is even: it takes matrix 1 of the thread below
    if (lane == 31) {
#pragma unroll
        for (int j = 0; j < J; ++j) ex[0][warp][j] = P1[j];
    }
    q += rowlen;
    __syncthreads();

    // pair m of steps reads the y side at Y0 - m and the x side at X0 + m
    // (even step) and X0 + m + 1 (odd step, the next pair's even x); past
    // K 8 (no registers to spare at 1,024 threads) each step loads its own
    const int X0 = mbeg, Y0 = mlen - 1 - mbeg;
    int xsel[PAIR ? K : 1];
    uint32_t xc[PAIR ? K : 1];
    uint32_t ao[PAIR ? J : 1];       // the odd step's scores of the pair
    if constexpr (PAIR) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int ix = X0 + t + NT * k;
            load_pos(rd + ix, rdm + ix, (unsigned)ix < (unsigned)pad, 4,
                     xsel[k], xc[k]);
        }
    }

    for (int s = 0; s < nsteps; ++s) {
        const int odd = s & 1, m = s >> 1, par = s & 1;
        put(done >> 4, q >> 4, false);
        done = q & ~15;
        // the row, word by word: the word's two scores; then even steps
        // take pu = P0[i], pv = P1[i - 1] (from the thread below; thread 0
        // from the last thread's cell k - 1, or the left edge), odd steps
        // pu = P0[i + 1] (from the thread above; the last thread from thread
        // 0's cell k + 1, or 0 past the band), pv = P1[i]. No shared store
        // in this loop, so the compiler may overlap its words' loads
        const int src = odd ? (warp + 1 == nwarp ? 0 : warp + 1)
                            : (warp ? warp - 1 : nwarp - 1);
        const uint32_t upw = s == 0 && HW == -1 ? 255u << 16 : 0u;
        const int x0 = X0 + ((s + 1) >> 1), y0 = Y0 - m;
        // past K 8 the cells' band indices are worked out afresh each step
        // (and again for the ring) from a copy of NT the compiler cannot
        // carry over: kept across steps, 2 J of them spill at 64 registers
        int nt = NT;
        if constexpr (!PAIR) asm volatile("" : "+r"(nt));
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int il = t + nt * 2 * j, ih = il + nt;
            uint32_t a2;
            if constexpr (PAIR) {
                if (!odd) {   // both steps' scores: x at X0 + m and + m + 1
                    int ae[2], an[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int k = 2 * j + h, i = t + NT * k;
                        const int ix = x0 + 1 + i, iy = y0 + i;
                        int ysel, nsel;
                        uint32_t yc, nc;
                        load_pos(cn + iy, cnm + iy,
                                 (unsigned)iy < (unsigned)pad, 0, ysel, yc);
                        load_pos(rd + ix, rdm + ix,
                                 (unsigned)ix < (unsigned)pad, 4, nsel, nc);
                        ae[h] = score(xsel[k], xc[k], ysel, yc);
                        an[h] = score(nsel, nc, ysel, yc);
                        xsel[k] = nsel;
                        xc[k] = nc;
                    }
                    a2 = __byte_perm(ae[0], ae[1], 0x5410);
                    ao[j] = __byte_perm(an[0], an[1], 0x5410);
                } else {
                    a2 = ao[j];
                }
            } else {
                a2 = __byte_perm(
                    cell_score(rd, rdm, cn, cnm, pad, x0 + il, y0 + il),
                    cell_score(rd, rdm, cn, cnm, pad, x0 + ih, y0 + ih),
                    0x5410);
            }
            const uint32_t w = ex[par][src][j];
            uint32_t pu, pv;
            if (!odd) {
                pv = __shfl_up_sync(FULL, P1[j], 1);
                if (lane == 0)
                    pv = warp ? w
                              : __byte_perm(j ? ex[par][src][j - 1] : upw, w,
                                            0x5432);
                pu = P0[j];
            } else {
                pu = __shfl_down_sync(FULL, P0[j], 1);
                if (lane == 31)
                    pu = warp + 1 < nwarp
                             ? w
                             : __byte_perm(w, j + 1 < J ? ex[par][src][j + 1]
                                                        : 0u, 0x5432);
                pv = P1[j];
            }
            const uint32_t h = __vimax3_u16x2(a2, pu, pv);
            P0[j] = h - pv;                 // no borrow: h >= pv per half
            P1[j] = h - pu;
            if (j == J - 1) P0[j] &= keep;  // cells past the band stay 0
        }
        // the row into the ring
        if constexpr (!PAIR) asm volatile("" : "+r"(nt));
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int il = t + nt * 2 * j, ih = il + nt;
            const uint32_t v = __byte_perm(P0[j], P1[j], 0x6240);
            if (j < J - 1 || in_lo) ring[(q + 1 + il) & rm] = (uint16_t)v;
            if (j < J - 1 || in_hi)
                ring[(q + 1 + ih) & rm] = (uint16_t)(v >> 16);
        }
        // edges: matrix 0 cell 0 is 255 on odd steps, matrix 1 cell bw + 1
        // on even ones, the other two 0
        if (t == 0) ring[q & rm] = odd ? 255 : 0;
        if (t == 1) ring[(q + bw + 1) & rm] = odd ? 0 : 255 << 8;
        // what the next step takes across threads: matrix 1 of lane 31
        // (even) or matrix 0 of lane 0 (odd)
        if (odd ? lane == 31 : lane == 0) {
#pragma unroll
            for (int j = 0; j < J; ++j)
                ex[par ^ 1][warp][j] = odd ? P1[j] : P0[j];
        }
        q += rowlen;
        __syncthreads();
    }

    // rows after the last step: zeros; the ring finishes the chunk at zt
    if (t < 16 && zt + t < ((zt + 15) & ~15)) ring[(zt + t) & rm] = 0;
    put(done >> 4, zt >> 4, false);
    __syncthreads();
    put(zt >> 4, (zt + 15) >> 4, false);
    put((zt + 15) >> 4, (end + 15) >> 4, true);
}

template <int K>
cudaError_t launch_blk(const Params &p, int nwarp, cudaStream_t stream) {
    const int smem = 2 * blk_ring(p.bw);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pedit_blk_rows_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    pedit_blk_rows_kernel<K><<<p.J, 32 * nwarp, smem, stream>>>(
        p, blk_ring(p.bw));
    return cudaGetLastError();
}

template <int K>
cudaError_t launch(const Params &p, cudaStream_t stream) {
    const int blocks = (p.J + WARPS - 1) / WARPS;
    const int smem = WARPS * (2 * RING<K> + 64);
    pedit_rows_kernel<K><<<blocks, 32 * WARPS, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// The row that runs is the caller's (ops/_cuda.py pedit_rows): design 0
// the register rows (bw + 2 <= 32 * MAX_K), 1 the block row of nwarp warps
// of threads holding K cells (K 2 to 32, every cell past the band in a
// thread's last two, bw + 2 <= 32,512 for its ring); outputs that are not
// 16-byte aligned are refused.
extern "C" int bsa_pedit_rows(const uint8_t *rd, const uint8_t *cn,
                              const uint32_t *rdm, const uint32_t *cnm,
                              const int64_t *jobs, uint8_t *out0,
                              uint8_t *out1, int J, int bw, int HW,
                              int design, int K, int nwarp, void *stream) {
    if (J <= 0) return 0;
    if (bw < 1) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(out0) | reinterpret_cast<uintptr_t>(out1))
        & 15)
        return cudaErrorMisalignedAddress;
    const Params p{rd, cn, rdm, cnm, jobs, out0, out1, J, bw, HW};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (design == 1) {
        const int NT = 32 * nwarp;
        if (nwarp < 1 || nwarp > BLK_MAXW || NT * K < bw
            || NT * (K - 2) > bw || 2 * (bw + 2) + 32 > 65536)
            return cudaErrorInvalidValue;
        if (K == 2) return launch_blk<2>(p, nwarp, s);
        if (K == 4) return launch_blk<4>(p, nwarp, s);
        if (K == 8) return launch_blk<8>(p, nwarp, s);
        if (K == 16) return launch_blk<16>(p, nwarp, s);
        if (K == 32) return launch_blk<32>(p, nwarp, s);
        return cudaErrorInvalidValue;
    }
    if (design != 0 || bw + 2 > 32 * MAX_K) return cudaErrorInvalidValue;
    const int k = (bw + 31) / 32;
    if (k <= 1) return launch<1>(p, s);
    if (k <= 2) return launch<2>(p, s);
    if (k <= 4) return launch<4>(p, s);
    if (k <= 8) return launch<8>(p, s);
    if (k <= 16) return launch<16>(p, s);
    return launch<32>(p, s);
}
