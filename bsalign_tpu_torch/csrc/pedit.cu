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
// Bands past 32 x 32 - 2 = 1,022 cells take the wide row
// (pedit_wide_rows_kernel): one warp a job and a block. A step depends only
// on the row before, which the ring still holds, so the warp reads it back
// from the ring and sweeps the step in slices of 32 cells, one cell a
// lane, writing each cell through the ring as the narrow rows do; the ring
// (a power of two >= 2 rows + 512 positions) holds the row before, the row
// being written and what waits to be flushed. bw + 2 <= 32,512 fits the
// block's 227 KB.
//
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

// the flush out of line: a ring of RS positions, or (the wide row) of any
template <int RS>
__device__ __noinline__ void flush(uint8_t *g0, uint8_t *g1,
                                   const uint8_t *ring, int lo, int hi,
                                   int beg, int end, int lane) {
    flush_body(g0, g1, ring, RS - 1, lo, hi, beg, end, lane);
}
__device__ __noinline__ void flush_wide(uint8_t *g0, uint8_t *g1,
                                        const uint8_t *ring, int rm, int lo,
                                        int hi, int beg, int end, int lane) {
    flush_body(g0, g1, ring, rm, lo, hi, beg, end, lane);
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

// Positions of the wide row's ring: the power of two >= 2 rows + WIN.
int wide_ring(int bw) {
    int rs = 1024;
    while (rs < 2 * (bw + 2) + WIN) rs *= 2;
    return rs;
}

__global__ void __launch_bounds__(32) pedit_wide_rows_kernel(Params p,
                                                              int RS) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x;
    const int j = blockIdx.x;
    const int64_t *jb = p.jobs + (size_t)j * 8;
    const uint8_t *rd = p.rd + jb[0], *cn = p.cn + jb[1];
    const uint32_t *rdm = p.rdm + jb[0], *cnm = p.cnm + jb[1];
    const int pad = (int)jb[3], mlen = (int)jb[4], mbeg = (int)jb[5],
              mend = (int)jb[6];
    const int bw = p.bw, HW = p.HW, rowlen = bw + 2;
    const int nrows = 2 * mlen + 2;
    const int rm = RS - 1;
    const int beg = (int)(jb[2] & 15), end = beg + nrows * rowlen;
    uint8_t *g0 = p.out0 + (jb[2] - beg), *g1 = p.out1 + (jb[2] - beg);
    const uint8_t *ring = smem;
    const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(smem);
    int q = beg, done = 0;
    auto at = [&](int x) { return ring_s + 2 * (x & rm); };
    // after a row: the row is visible to every lane, full windows go out
    auto next_row = [&]() {
        q += rowlen;
        while (q - done >= WIN) {
            flush_wide(g0, g1, ring, rm, done, done + WIN, beg, end, lane);
            done += WIN;
        }
        __syncwarp();
    };
    auto zero_row = [&]() {
        for (int t = lane; t < rowlen; t += 32) st_ring(at(q + t), 0, 0);
        next_row();
    };

    // rows before the seed
    for (int r = 0; r < 2 * mbeg; ++r) zero_row();
    // the seed row (bytes 255 at HW in matrix 0, HW + 1 in matrix 1)
    for (int t = lane; t < rowlen; t += 32)
        st_ring(at(q + t), t == HW ? 255 : 0, t == HW + 1 ? 255 : 0);
    next_row();
    // step s writes row 2 * mbeg + 1 + s from the row before it (at q -
    // rowlen): x side at X = mbeg + (s + 1) / 2, y side at Y = mbeg + s / 2
    const int nsteps = max(2 * (mend - mbeg) - 1, 1);
    for (int s = 0; s < nsteps; ++s) {
        const int odd = s & 1;
        const int x0 = mbeg + (s + 1) / 2, y0 = mlen - 1 - (mbeg + s / 2);
        const int pr = q - rowlen;
        for (int i = lane; i < bw; i += 32) {
            int xsel, ysel;
            uint32_t xc, yc;
            const int ix = x0 + i, iy = y0 + i;
            load_pos(rd + ix, rdm + ix, (unsigned)ix < (unsigned)pad, 4, xsel,
                     xc);
            load_pos(cn + iy, cnm + iy, (unsigned)iy < (unsigned)pad, 0, ysel,
                     yc);
            // even: pu = matrix 0 at cell 1 + i, pv = matrix 1 at cell i;
            // odd: one cell further
            const int pu = ring[2 * ((pr + 1 + odd + i) & rm)];
            const int pv = ring[2 * ((pr + odd + i) & rm) + 1];
            const int h = __vimax3_s32(score(xsel, xc, ysel, yc), pu, pv);
            st_ring(at(q + 1 + i), h - pv, h - pu);
        }
        // edges: matrix 0 cell 0 is 255 on odd steps, matrix 1 cell bw + 1
        // on even ones; the other two edge bytes are 0
        if (lane == 0) st_ring(at(q), odd ? 255 : 0, 0);
        if (lane == 1) st_ring(at(q + bw + 1), 0, odd ? 0 : 255);
        next_row();
    }
    // rows after the last step, then what is left in the ring
    for (int r = 2 * mbeg + 1 + nsteps; r < nrows; ++r) zero_row();
    if (q > done) flush_wide(g0, g1, ring, rm, done, q, beg, end, lane);
}

cudaError_t launch_wide(const Params &p, cudaStream_t stream) {
    const int rs = wide_ring(p.bw);
    const int smem = 2 * rs;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pedit_wide_rows_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    pedit_wide_rows_kernel<<<p.J, 32, smem, stream>>>(p, rs);
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

// bw above 32 * MAX_K - 2 = 1022 cells runs the wide row, whose ring
// takes bw + 2 <= 32,512 (the wrapper raises past it, ops/_cuda.py
// PEDIT_MAX_BW); outputs that are not 16-byte aligned are refused.
extern "C" int bsa_pedit_rows(const uint8_t *rd, const uint8_t *cn,
                              const uint32_t *rdm, const uint32_t *cnm,
                              const int64_t *jobs, uint8_t *out0,
                              uint8_t *out1, int J, int bw, int HW,
                              void *stream) {
    if (J <= 0) return 0;
    if (bw < 1) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(out0) | reinterpret_cast<uintptr_t>(out1))
        & 15)
        return cudaErrorMisalignedAddress;
    const Params p{rd, cn, rdm, cnm, jobs, out0, out1, J, bw, HW};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bw + 2 > 32 * MAX_K) return launch_wide(p, s);
    const int k = (bw + 31) / 32;
    if (k <= 1) return launch<1>(p, s);
    if (k <= 2) return launch<2>(p, s);
    if (k <= 4) return launch<4>(p, s);
    if (k <= 8) return launch<8>(p, s);
    if (k <= 16) return launch<16>(p, s);
    return launch<32>(p, s);
}
