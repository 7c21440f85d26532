// Batched remsa pedit profile DP: the anti-diagonal, unsigned-8-bit
// max-match realignment of each read against its window's MSA column-count
// profile, for Hopper (sm_90a).
//
// Replaces the TPU kernel bsalign_tpu/ops/pedit_pallas.py::_get_call.kernel
// (:46-140), which computes what the host's bsa_pedit_forward does
// (native/rowops.cpp, after bspoa.h:3856-3896). One job is one (read,
// window) pair; per step s of its 2*(mend-mbeg)-1 steps (at least one) the
// x side (read) advances on even steps and the y side (consensus) on odd
// ones, x = mbeg + (s+1)/2, y = mbeg + s/2. Cell i of the band reads the
// read base rb = seqs0[x+i] and the consensus base cb = seqs1[mlen-1-y+i];
// xs = mats0[cb][x+i] and ys = mats1[rb][mlen-1-y+i] (0 for a base >= 4),
// h = max(min(xs+ys, 255), pu, pv) with pu/pv the previous row shifted by
// 2/1 cells on odd steps and 1/0 on even ones, and the row stores h-pv in
// matrix0 and h-pu in matrix1 at cell 1+i. Edge cells: matrix0[0] = 255 on
// odd steps, matrix1[bw+1] = 255 on even steps, else 0. Row 2*mbeg is the
// seed (matrix0[HW] = matrix1[HW+1] = 255). Indices at or past a job's pad
// read 4 for seqs0 and 0 for seqs1 and the counts, as the TPU kernel's feed
// inserts (the host's jobs never reach them). The plain PyTorch version of
// the same function is bsalign_tpu_torch/ops/pedit.py::forward_plain; the
// two agree byte for byte.
//
// What bounds it on this card: the latency of each job's chain of 2*mlen
// dependent rows. The bytes are small beside it: a band-32 job of an
// 800 bp window writes 2 x 34 bytes per row, and 2,560 such jobs write
// under 0.3 GB, about 0.09 ms at 3.35 TB/s, while 1,700 dependent rows of a
// few hundred cycles each take about a millisecond.
//
// What the design does about it: one block per job, one thread per band
// cell (bw+2 cells, rounded up to whole warps, at most 1024 threads). The
// previous row lives in shared memory, double-buffered, so a step costs one
// barrier. Each thread reads its cell's operands straight from device
// memory at the job's offsets: the read side per job, the consensus side
// once per window and shared by that window's jobs (the TPU kernel's
// duplicated per-job init and feed arrays are gone). Thousands of jobs
// make as many blocks, enough to keep every SM full while each waits on
// its chain.
//
// Layouts: rd and cn are flat uint8 buffers of 5-plane blocks [seqs; 4
// count planes], each plane `pad` bytes; jobs is int64 [J, 8] = (rd offset,
// cn offset, output offset, pad, mlen, mbeg, mend, unused); out0/out1 are
// flat uint8, job j's matrix at its output offset with (2*mlen+2) rows of
// bw+2 bytes. Only rows [2*mbeg, 2*mbeg + steps] are written; the caller
// zeroes the rest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CELLS = 1024;

struct Params {
    const uint8_t *rd, *cn;
    const int64_t *jobs;
    uint8_t *out0, *out1;
    int bw, HW;
};

__global__ void __launch_bounds__(MAX_CELLS) pedit_rows_kernel(Params p) {
    __shared__ uint8_t prev[2][2][MAX_CELLS];
    const int64_t *jb = p.jobs + (size_t)blockIdx.x * 8;
    const uint8_t *rd = p.rd + jb[0];
    const uint8_t *cn = p.cn + jb[1];
    const int64_t pad = jb[3];
    const int mlen = (int)jb[4], mbeg = (int)jb[5], mend = (int)jb[6];
    const int bw = p.bw, rowlen = bw + 2, t = threadIdx.x;
    const bool live = t < rowlen;
    uint8_t *o0 = p.out0 + jb[2] + (size_t)(2 * mbeg) * rowlen;
    uint8_t *o1 = p.out1 + jb[2] + (size_t)(2 * mbeg) * rowlen;

    if (live) {
        const uint8_t v0 = t == p.HW ? 255 : 0;
        const uint8_t v1 = t == p.HW + 1 ? 255 : 0;
        prev[0][0][t] = v0;
        prev[0][1][t] = v1;
        o0[t] = v0;
        o1[t] = v1;
    }
    __syncthreads();

    int nsteps = 2 * (mend - mbeg) - 1;
    if (nsteps < 1) nsteps = 1;
    for (int s = 0; s < nsteps; ++s) {
        const int dirn = s & 1;
        const uint8_t *p0 = prev[dirn][0], *p1 = prev[dirn][1];
        if (live) {
            int c0, c1;
            if (t == 0) {
                c0 = dirn ? 255 : 0;
                c1 = 0;
            } else if (t == bw + 1) {
                c0 = 0;
                c1 = dirn ? 0 : 255;
            } else {
                const int i = t - 1;
                const int64_t ix = mbeg + (s + 1) / 2 + i;
                const int64_t iy = mlen - 1 - (mbeg + s / 2) + i;
                const bool okx = ix < pad, oky = iy >= 0 && iy < pad;
                const int rb = okx ? rd[ix] : 4;
                const int cb = oky ? cn[iy] : 0;
                const int xs = (cb < 4 && okx) ? rd[(1 + cb) * pad + ix] : 0;
                const int ys = (rb < 4 && oky) ? cn[(1 + rb) * pad + iy] : 0;
                const int pu = dirn ? p0[t + 1] : p0[t];
                const int pv = dirn ? p1[t] : p1[t - 1];
                const int h = max(max(min(xs + ys, 255), pu), pv);
                c0 = h - pv;
                c1 = h - pu;
            }
            const size_t row = (size_t)(s + 1) * rowlen;
            o0[row + t] = (uint8_t)c0;
            o1[row + t] = (uint8_t)c1;
            prev[dirn ^ 1][0][t] = (uint8_t)c0;
            prev[dirn ^ 1][1][t] = (uint8_t)c1;
        }
        __syncthreads();
    }
}

}  // namespace

// bw + 2 above 1024 cells is refused; the wrapper raises first
// (ops/_cuda.py PEDIT_MAX_BW).
extern "C" int bsa_pedit_rows(const uint8_t *rd, const uint8_t *cn,
                              const int64_t *jobs, uint8_t *out0,
                              uint8_t *out1, int J, int bw, int HW,
                              void *stream) {
    if (J <= 0) return 0;
    if (bw < 1 || bw + 2 > MAX_CELLS) return cudaErrorInvalidValue;
    Params p{rd, cn, jobs, out0, out1, bw, HW};
    const int threads = (bw + 2 + 31) / 32 * 32;
    pedit_rows_kernel<<<J, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}
