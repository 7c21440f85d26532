#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsalign_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, as below
    python3 chip_smoke.py --split    # phase 1, then kernel A's row step
                                     # alone at the three shapes below,
                                     # and both of its rows at W 64, 128
                                     # and 2,000
    python3 chip_smoke.py --kernels  # phase 1, then kernels B and C alone:
                                     # phase 5, the edit kernel at its
                                     # main-path shape (phase 6's first
                                     # part) and phase 7, each kernel's
                                     # time beside its plain version's;
                                     # then both block rows and B's
                                     # cluster row (phase 16 (e), (f),
                                     # (h)'s kernel checks and times), the
                                     # cluster exchange's floor and the
                                     # crossovers of each kernel's rows
    python3 chip_smoke.py --wide     # phase 1, then phases 16 and 17

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit, then the build of the
   CUDA kernels (csrc/*.cu: banded-8's narrow and wide rows, edit and
   pedit, one nvcc per source started together, sm_90a, linked into one
   library) and of the host library (g++: the codes walker and the POA
   engine), with their build seconds. Beside it, nvcc -Xptxas -v on each
   source: the registers, stack and spills of the main paths'
   instantiations (banded-8 codes, none and planes in both rows; edit at
   K 2, global, and every instantiation of its block and cluster rows and
   of the cluster row's sweep; pedit at K 1 and every instantiation of its
   block row) and the range over every instantiation are
   printed at the end, and a spill in a main path's instantiation fails
   the run. Kernel A runs its wide row (csrc/banded8_wide.cu) from
   WIDE_W = 32 stripes (band 512) on and its narrow row below, so phase
   2's band 640 case, phase 4, 12 and 16 run the wide row.
2. Banded-8 kernel against its plain PyTorch version, both on the card, on
   seeded pairs at 10% error (64 x 1 kb at band 128, 8 x 600 bp at band
   640, a full reset at band 16): codes, begs, score/qe/te and the final
   state must agree bit for bit (tolerance 0: the arithmetic is integer).
   Then bands 16, 48 and 144 (W = 1, 3, 9: a partial last group of 8
   stripes) in every emit, with a short query in the batch's last pair.
3. The align main path: `align_batch` on 512 pairs x 2 kb, global, band
   128, -M 2 -X 6 -O 3 -E 2. The banded-8 kernel's launch count over that
   run must be at least 2 (two DEVICE_CHUNKs), and the TSV of the first 32
   pairs must equal the port's CPU path byte for byte. Prints kernel time,
   cells/s and end-to-end pairs/s, and the kernel's cycle split at the
   launch shape (see below).
4. Band 2048: 16 pairs x 2 kb at the CLI defaults (overlap, band
   roundup(qlen, 128)), checked against the CPU path on 2 pairs; the wide
   row must launch, and both rows are timed at the band-2048 launch.
5. Edit kernel against its plain PyTorch version, both on the card, on
   seeded pairs at 10% error: pm, pp and sbeg on rows below each pair's
   tlen, and the final planes, smin, ry, final sbeg and global score, with
   tolerance 0. Cases: 64 x 2 kb global full band (NW 64), global band 128
   with target lengths spread over 0.5-1.5 x 2 kb, overlap, extend; 4 x
   5 kb global full band (NW 160); a hand-made trajectory whose band jumps
   past its width (full reset).
6. The edit main path. First the kernel against the plain version at the
   main path's launch shape (256 pairs x 2 kb at NW 64) and its time over
   20 launches. Then `edit_batch` on 512 pairs x 2 kb, global, -W 0. The
   edit kernel's launch count over that run must be at least 2, and the TSV
   of the first 32 pairs must equal the CPU path. Then the same pairs at
   -W 128 and `kmer_edit_batch` (k 13) on 64 pairs x 10 kb, each checked
   against the CPU path on 4 pairs.
7. Pedit kernel against its plain PyTorch version, both on the card, with
   tolerance 0 (uint8 outputs), the kernel writing into buffers filled
   with 0xA5 so that a byte it leaves unwritten shows: the first
   realignment round's jobs of 128 seeded POA windows (20 reads x 800 bp
   at 12% error, band 32; the main path's shape, timed over 20 launches of
   the whole launcher, allocations included), those of the first 16
   windows also against the host's bsa_pedit_forward; random jobs at bw
   34, 64, 96 and 128; the widest band of the register rows (1022); the
   shortest jobs (mend = mbeg + 1, + 2).
8. The poa main path: `run_windows_lockstep` on the 128 windows with the
   default BSPOAPar on the card. The pedit kernel's launch count over that
   run must be at least 3 (one per realignment round), and cns, qlt, alt,
   SNV lines and MSA of the first 2 windows must equal the port's CPU
   path. Prints windows/s and the per-window build / pack / kernel / fetch
   / apply seconds. Then the `poa` CLI on one window prints the same bytes
   with --device cuda and --device cpu.

9. The banded-8 kernel's planes and scores-only (none) emits against the
   plain version, both on the card, tolerance 0: planes at piecewise
   0/1/2 x global/overlap/extend on 16 x 500 bp at band 128 (every plane,
   anchor and begs row, score/qe/te and the final state); none at
   piecewise 0/1/2, whose score and final state also equal the codes and
   planes runs'; piecewise 2 at band 16 with qlen >> tlen (full reset);
   each emit run in resumed chunks of 256 rows over T = 1,024 against its
   one-shot run, and the plain version in the same chunks against it.
10. The 2-piece main path: `align_batch` on 512 x 2 kb, global, band 128,
   map-ont costs (-M 2 -X 4 -O 4 -E 2 -Q 24 -P 1) through the planes emit
   and backcal. At least 2 planes launches, the TSV of the first 32 pairs
   equal to the CPU path; the planes kernel against the plain version at
   the main path's launch shape, its time, cells/s, pairs/s and the fetch.
11. Long reads: `align_batch` on 256 pairs x 50 kb, global, band 128,
   -M 2 -X 6 -O 3 -E 2: T = 50,048 rows, so the two-pass mode, with
   ceil(T / T_CHUNK) scores-only launches and as many codes re-forwards.
   Every AlnResult and CIGAR equals the one-shot run (T_CHUNK and
   REALIGN_T raised: one codes launch of all rows). The none kernel
   against the plain version at the first chunk's shape. Then 16 pairs x
   20 kb with the map-ont costs through the chunked planes path, equal to
   its one-shot planes run. Prints each pass's time, the walk, pairs/s
   and the peak device memory of both runs.

12. `cat`: a seeded contig of about 1 Mb cut into 250 windows of 5 kb
   overlapping by 1,024 bp, each with 2% independent errors (what a
   polisher's per-window consensus looks like); window 3 states half its
   real overlap (the 4x retry), window 100 shares nothing with window 99
   (fresh random bases in its place: 6 N inserted). `cat --device cuda`
   joins them all; kernel A must launch at least once per join (each
   launch timed with CUDA events), and the consensus must hold one run of
   6 N and the expected length within 0.5%, less what the failed join
   cuts (it cuts the consensus where its junk alignment starts, up to
   4 x 1,024 bases, as the reference does). The first 8 windows must
   print the same bytes with --device cuda and with --device cpu; the CPU
   run (minutes of the plain forward at band 1,024) starts after phase 1
   in a process of its own, one thread, beside the card's phases. Prints
   joins/s, the kernel's ms per join and its share of the wall time.
13. `--dist`: `align --dist` on 512 x 2 kb pairs (global, -W 128) and
   `edit --dist` on 128 x 2 kb (global, -W 0), two processes on the one
   card in a gloo group (bsalign_tpu_torch/parallel/loopback.py): the
   gathered output must equal one process's byte for byte. Prints each
   process's wall time and the gather's seconds.
14. The batch split (parallel/mesh.py) over make_mesh() and over
   [cuda:0] * 2: kernel A codes at phase 3's launch shape, B at phase 6's,
   C on phase 7's round-1 jobs, each equal to the unsplit launch (edit:
   rows below tlen), with the split's and the unsplit time; then
   dryrun_multichip(device count).
15. poa extras: merge_msas of 4 finished windows of one locus (10 reads
   x 500 bp each) and remsa_lsps on 2 of them, on the card and on the
   CPU: MSAs, merged consensus and re-POAed windows equal; the pedit
   kernel launches at least once on the card.

16. Wide bands, every check with tolerance 0 (the CPU reference of (e),
   `edit --device cpu` on one pair, runs in a process of its own from the
   end of phase 1 on):
   (a) kernel A with its planes in device memory against shared memory
   (the store forced both ways), in the narrow and the wide row, at bands
   128, 2,048 and 16,384 on 8 pairs at 10% error, every emit at piecewise
   0/1/2 (codes at 0/1), each output and the final state, at band 2,048
   also resumed in chunks of 1,024 rows; (b) kernel A's wide row against
   its plain version and against the narrow row (planes in device
   memory) at band 32,768 (W 2,048), piecewise 1 and 2, 2 pairs of 32 kb,
   the first 64 rows: planes and none emits and the final state, with
   the times;
   (c) `align_batch` as the CLI calls it at its defaults (overlap, band
   roundup(qlen, 128) = 32,000, -M 2 -X 6 -O 3 -E 2) on 8 pairs of 33 kb
   targets at 10% error (the two-pass route): each CIGAR consumes exactly
   its [qb, qe) x [tb, te) and re-scores to the reported score, and a
   one-shot scores-only forward over all rows gives each score and end;
   prints pass 1, the re-forwards, the walk, pairs/s and peak memory;
   (d) the same on 4 pairs of 24.7 kb with -M 2 -X 4 -O 4 -E 2 -Q 24 -P 1
   (band 24,064, planes and backcal), split by LAUNCH_BYTES into at least
   2 launch groups; (e) kernel B's block row and its cluster row (forced)
   against the plain version at NW 640, 752, 1,024 and 3,200 in every
   mode (4 queries of 20-102 kb against 500 bp); the cluster row against
   the plain version at NW 4,097, 4,192 and 8,192 in every mode, banded
   (shifts) and on a trajectory whose shifts cross blocks and reset the
   band, at NW 32,768 (8 blocks) and 65,537 (past the registers: the
   sweep) on few rows; then `edit_batch` -W 0 global on 16 pairs (NW 752)
   in at least 2 launches, all of the block row, pair 0's TSV equal to the
   CPU process's; then `edit -m kmer` on 3 reads of 3 kb whose first 2 kb
   start contigs of 136 kb, 136 kb and 2.3 Mb: the tails after the last
   anchor run the cluster row (NW 4,192) and its sweep (NW past 65,536),
   every TSV equals that of `edit --device cpu -m kmer` (a process of its
   own from the end of phase 1 on), and each launch equals the plain
   version, with its time and bound; (f) kernel C's block row against
   its plain version on random jobs at bw 1,024, 1,534, 4,094 and 32,510
   into buffers of 0xA5, with us a step (at bw 4,094 also in every other
   geometry), then `poa -G editbw=4096` on one window: --device
   cuda == cpu, the block row launched;
   (g) `cat` of two 40 kb pieces overlapping by 16,384 whose second states
   overlap=8192: the join runs at band 8,192, then its 4x retry at band
   32,768 on the card; the consensus has the expected length within 0.5%
   and the retried join's CIGAR passes (c)'s checks; (h) kernel A's wide
   and narrow rows at (c)'s and (d)'s launch shapes (4,096 rows), kernel
   B's block row at (e)'s against the cluster row forced (outputs equal,
   us a row of each), with their bounds and launches.
17. Kernel A's two rows, tolerance 0 (also run by --wide): (a) the wide
   row against the narrow row at bands 512, 2,048, 16,384 and 32,000 on 3
   pairs (the last short: it freezes early), every emit at piecewise
   0/1/2; (b) against the plain version at band 512 in every emit and
   piecewise; (c) an adversarial state (random planes that drive f and g
   to the clamp at 127): rows replay in the kernel, and the outputs still
   equal the narrow row's and the plain version's; (d) the crossover:
   microseconds per row of both rows at W 8, 16, 32, 64, 128, 256, 1,024
   and 2,000, 8 and 256 pairs, and the chosen WIDE_W; the replayed rows.

The cycle split (phases 3, 10 and 11, and --split): one launch with the
kernel's optional per-phase clock64() counters on, against one with them
off (outputs must be equal), printed as SM cycles per row below tlen,
mean over pairs, for band move, row head, pass 1, F-loop, pass 2 with its
tail, steering and emit, beside the time per row and nvidia-smi's
clocks.sm.

Each phase prints the seconds since the start when it ends. The line
before the last is a JSON object with each kernel's launches on its main
path, error, times and bound; the last line is {"ok": true,
"device": {...}}. Without a CUDA device, or without the repository beside
it, the script fails and prints no result. It imports neither jax nor
bsalign_tpu.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
# Bounds: the least time for a kernel's work on one H100 SXM, the larger of
# its bytes (each input read once, each output written once) over the
# memory rate and its operations over the float32 rate outside the tensor
# cores (the data sheet's 67 TFLOP/s, counting an FMA as two). The kernels
# do 32-bit integer and bitwise work, which the card issues no faster, so
# the operation bound is a lower bound. Operations are counted from the
# kernels' source per unit of work this run's data needs:
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# banded-8, per DP cell (saturating int8 arithmetic as add + min + max):
# piecewise 1 with codes about 15 ops in pass 1, 28 in pass 2, 20 in the
# code pass and 2 for the query score; without the code pass (none) 45;
# piecewise 2 (planes) 30 in pass 1, 50 in pass 2 and 2 for the query
BANDED8_OPS_PER_CELL = 65
BANDED8_NONE_OPS_PER_CELL = 45
BANDED8_PLANES_OPS_PER_CELL = 82
# edit: per plane word and row, 3 for the Eq window, 21 for the Myers step
# with the carry, 3 for the one-bit shifts
EDIT_OPS_PER_WORD_ROW = 27
# pedit: per band cell and step, 4 for the two indices and their bounds, 6
# for the base loads and count selects, 4 for the count addresses, 2 for
# the saturating add, 2 for the max with the predecessors, 2 for the
# differences
PEDIT_OPS_PER_CELL = 20


def fail(msg: str) -> int:
    sys.stderr.write(f"chip_smoke: FAIL: {msg}\n")
    return 1


def gen_pairs(n, length, err=0.10, seed=0):
    """Seeded (query, target) pairs: the target is uniform random, the
    query carries substitutions, insertions and deletions at rate err."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(n):
        t = rng.integers(0, 4, length).astype(np.uint8)
        q = []
        i = 0
        while i < length:
            r = rng.random()
            if r < err * 0.23:
                q.append((int(t[i]) + rng.integers(1, 4)) & 3)
                i += 1
            elif r < err * 0.54:
                q.append(rng.integers(0, 4))
            elif r < err:
                i += 1
            else:
                q.append(int(t[i]))
                i += 1
        qs.append(np.array(q, np.uint8))
        ts.append(t)
    return qs, ts


def gen_pairs_fast(n, length, err=0.10, seed=0):
    """gen_pairs' error model, vectorised for long reads: before each
    target base a geometric run of random inserted bases, then the base
    is substituted, deleted or kept with gen_pairs' odds."""
    rng = np.random.default_rng(seed)
    p_sub, p_ins, p_del = err * 0.23, err * 0.31, err * 0.46
    qs, ts = [], []
    for _ in range(n):
        t = rng.integers(0, 4, length).astype(np.uint8)
        k = rng.geometric(1 - p_ins, length) - 1          # insertions
        r = rng.random(length) * (1 - p_ins)
        keep = (r >= p_sub + p_del) | (r < p_sub)
        val = np.where(r < p_sub, (t + rng.integers(1, 4, length)) & 3, t)
        cnt = k + keep
        owner = np.repeat(np.arange(length), cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        ins = np.arange(len(owner)) - first < k[owner]
        q = np.where(ins, rng.integers(0, 4, len(owner)), val[owner])
        qs.append(q.astype(np.uint8))
        ts.append(t)
    return qs, ts


def gen_poa_window(rng, nreads=20, reflen=800, err=0.12):
    """Seeded window: reads of one random reference with substitutions,
    insertions and deletions at rate err (the JAX bench's generator)."""
    ref = rng.integers(0, 4, reflen)
    reads = []
    for _ in range(nreads):
        out, i = [], 0
        while i < reflen:
            r = rng.random()
            if r < err * 0.3:
                out.append((int(ref[i]) + int(rng.integers(1, 4))) & 3)
                i += 1
            elif r < err * 0.6:
                out.append(int(rng.integers(0, 4)))
            elif r < err:
                i += 1
            else:
                out.append(int(ref[i]))
                i += 1
        reads.append("".join("ACGT"[c] for c in out))
    return reads


CAT_WINDOWS, CAT_WIN, CAT_OV = 250, 5000, 1024
# the retry window, the window that shares nothing with the one before
# it, and the windows the CPU checks (the first CAT_CPU)
CAT_HALF, CAT_GAP, CAT_CPU = 3, 100, 8


def gen_cat_windows(seed):
    """Phase 12's input: a seeded contig of about 1 Mb cut into CAT_WINDOWS
    windows of CAT_WIN bp overlapping by CAT_OV, each with 2% independent
    errors (a third each substitutions, insertions, deletions), as FASTA
    text. Window CAT_HALF states half its real overlap (overlap=512: the
    4x retry); window CAT_GAP has fresh random bases where it would share
    bases with the window before it (its last CAT_OV still overlap the
    next window), so that join fails and 6 N are inserted: the window is
    longer than 4 x CAT_OV, so the retry's alignment cannot reach its end.
    Returns (fasta of all windows, fasta of the first CAT_CPU, the length
    the consensus should have)."""
    rng = np.random.default_rng(seed)
    stride = CAT_WIN - CAT_OV
    length = stride * (CAT_WINDOWS - 1) + CAT_WIN
    ref = rng.integers(0, 4, length).astype(np.uint8)
    recs = []
    for k in range(CAT_WINDOWS):
        lo = k * stride
        hi = lo + CAT_WIN
        s = ref[lo:hi]
        if k == CAT_GAP:
            s = np.concatenate([rng.integers(0, 4, stride).astype(np.uint8),
                                s[stride:]])
        r = rng.random(len(s))
        ins = (r >= 0.02 / 3) & (r < 0.04 / 3)
        base = np.where(r < 0.02 / 3, (s + rng.integers(1, 4, len(s))) & 3,
                        s)
        rep = np.where((r >= 0.04 / 3) & (r < 0.02), 0, 1 + ins)
        out = np.repeat(base, rep)       # an inserted base before its own
        out[(np.cumsum(rep) - rep)[ins]] = rng.integers(0, 4, int(ins.sum()))
        desc = " overlap=512" if k == CAT_HALF else ""
        seq = "".join("ACGT"[c] for c in out.tolist())
        recs.append(f">w{k}{desc}\n{seq}\n")
    return "".join(recs), "".join(recs[:CAT_CPU]), length + CAT_OV + 6


# phase 16: align at the CLI defaults on long reads (query cut so that the
# batch shares the band roundup(qlen, 128)), edit at -W 0, cat's retry
# (queries of gen_pairs_fast come out about 1.5% shorter than the target)
WIDE_ALIGN = (8, 33000, 31950)        # pairs, target length, query length
WIDE_ONT = (4, 24700, 24000)          # the same with map-ont costs
WIDE_EDIT = (16, 24700, 24000)        # edit -W 0: band 24,064 (NW 752)
# edit -m kmer of reads that start contigs: the tail after the last anchor
# aligns at a band of about the contig's length: NW 4,192 (the cluster row
# in registers) and about 71,800 (past them: the sweep)
WIDE_EDIT_KMER = (2000, 1000, (136000, 136000, 2300000))   # read length in
                                       # the contig, the read's tail, contigs
WIDE_CAT = (40000, 16384, 8192)       # piece length, real overlap, stated


def wide_pairs(n, tlen, qlen, seed):
    """gen_pairs_fast's pairs with each query cut to qlen bases."""
    qs, ts = gen_pairs_fast(n, tlen, 0.10, seed)
    if min(len(q) for q in qs) < qlen:
        raise RuntimeError(f"a query of {tlen} bp is shorter than {qlen}")
    return [q[:qlen] for q in qs], ts


def contig_pairs(tlen, junk, clens, seed):
    """gen_pairs_fast's pairs, one per contig length in clens, with each
    query at the start of a random contig of that length, which takes its
    place, and each target followed by `junk` random bases."""
    qs, ts = gen_pairs_fast(len(clens), tlen, 0.10, seed)
    rng = np.random.default_rng(seed + 1)
    return ([np.concatenate([q, rng.integers(0, 4, c - len(q))]).astype(
        np.uint8) for q, c in zip(qs, clens)], [np.concatenate(
            [t, rng.integers(0, 4, junk)]).astype(np.uint8) for t in ts])


def gen_wide_cat(seed):
    """Phase 16's cat input: two pieces of WIDE_CAT[0] bp of a seeded
    contig that overlap by WIDE_CAT[1], each with 2% independent errors;
    the second states overlap=WIDE_CAT[2], so its first alignment (the
    pieces' last and first WIDE_CAT[2] bases) misses and the 4x retry
    (band 4 x WIDE_CAT[2]) finds the join. Returns (fasta, the length the
    consensus should have)."""
    L, ov, stated = WIDE_CAT
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 2 * L - ov).astype(np.uint8)
    recs = []
    for k, s in enumerate((ref[:L], ref[L - ov:])):
        r = rng.random(len(s))
        ins = (r >= 0.02 / 3) & (r < 0.04 / 3)
        base = np.where(r < 0.02 / 3, (s + rng.integers(1, 4, len(s))) & 3,
                        s)
        rep = np.where((r >= 0.04 / 3) & (r < 0.02), 0, 1 + ins)
        out = np.repeat(base, rep)
        out[(np.cumsum(rep) - rep)[ins]] = rng.integers(0, 4, int(ins.sum()))
        desc = f" overlap={stated}" if k else ""
        recs.append(f">p{k}{desc}\n{''.join('ACGT'[c] for c in out)}\n")
    return "".join(recs), len(ref)


def check_alignment(q, t, rs, cigars, mtx, gaps, piecewise):
    """What is wrong with one alignment: its CIGAR must consume exactly
    [qb, qe) of q and [tb, te) of t, and its score recomputed from the
    CIGAR and the costs (a gap of n: gapo1 + n * gape1, with 2-piece gaps
    the larger of that and gapo2 + n * gape2) must equal rs.score."""
    go1, ge1, go2, ge2 = gaps
    x, y, score = rs.qb, rs.tb, 0
    q = np.asarray(q, np.int64)
    t = np.asarray(t, np.int64)
    m = np.asarray(mtx, np.int64)
    for cg in cigars:
        op, n = cg & 0xF, cg >> 4
        if op == 0:
            score += int(m[q[x:x + n] * 4 + t[y:y + n]].sum())
            x += n
            y += n
            continue
        cost = go1 + ge1 * n
        if piecewise == 2:
            cost = max(cost, go2 + ge2 * n)
        score += cost
        if op == 1:
            x += n
        else:
            y += n
    bad = []
    if (x, y) != (rs.qe, rs.te):
        bad.append(f"CIGAR ends at ({x}, {y}), not ({rs.qe}, {rs.te})")
    if score != rs.score:
        bad.append(f"CIGAR scores {score}, the result {rs.score}")
    return bad


def pedit_work(jobs):
    """(bytes, cells) one pedit launch must move and compute for these
    jobs: of the inputs, 5 planes of pad bytes per job (read side) and per
    window (consensus side, stored once); of the outputs, the rows each job
    writes (its seed and one per step) in both matrices."""
    wins = {id(j.seqs1): len(j.seqs1) for j in jobs}
    rows = sum(1 + max(2 * (j.mend - j.mbeg) - 1, 1) for j in jobs)
    rowlen = jobs[0].bw + 2
    nb = 5 * sum(len(j.seqs0) for j in jobs) + 5 * sum(wins.values()) \
        + 2 * rows * rowlen
    return nb, (rows - len(jobs)) * rowlen


def bound(nbytes, ops):
    """(bound_ms, bound_by, text) for nbytes moved and ops operations."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / OPS_PER_S * 1e3
    text = (f"bytes {nbytes / 1e6:.4g} MB in {t_b:.4f} ms, operations "
            f"{ops / 1e9:.4g} G in {t_o:.4f} ms")
    return (t_b, "bytes", text) if t_b >= t_o else (t_o, "operations", text)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def banded8_work(g, st, out):
    """(bytes, cells) one banded-8 launch must move and compute: of the
    inputs, each pair's query window that its band reaches in this call
    (from its first band offset to its last plus the band and one stripe)
    and the other operands whole; of the outputs, every tensor the launch
    writes; cells are the rows below each pair's tlen times the band."""
    import torch
    qp = st.qpad.shape[1]
    reach = (out["fin_reg"][0] - st.reg[0] + g.BW + g.W + 1).clamp(max=qp)
    ins = 4 * int(reach.sum()) + nbytes(*[t for t in st[1:]
                                          if isinstance(t, torch.Tensor)])
    outs = nbytes(*[t for k, v in out.items() if k != "fin_planes"
                    for t in [v] if t is not None], *out["fin_planes"])
    rows = (st.tlen - st.row0).clamp(0, g.T)
    return ins + outs, float(rows.sum()) * g.BW


def edit_bytes(g, ops):
    """Bytes one edit launch must move for this data: of the inputs, qlen
    and tlen, tseq on rows below each pair's tlen, the query words that
    those rows' windows reach (the target base's plane, from word
    rbeg // 32 on, NW words plus one when rbeg % 32 is not 0), and rbegs
    and movxs on those rows unless they are all 0 (the full band, which
    needs no trajectory); of the outputs, pm, pp and sbeg on rows below
    tlen, and the final planes and scal of every pair."""
    tlen = ops.tlen.cpu().numpy()
    B, T = ops.tseq.shape
    NW, NWQ = g.NW, ops.qeq.shape[2]
    live = np.arange(T)[:, None] < tlen[None, :]             # [T, B]
    rows = int(live.sum())
    tb = ops.tseq.cpu().numpy().T
    plane = np.where((tb >= 1) & (tb <= 3), tb, 0)[live]
    rb = ops.rbegs.cpu().numpy()
    lo = np.clip(rb >> 5, 0, NWQ)[live]
    hi = np.clip((rb >> 5) + NW + ((rb & 31) != 0), 0, NWQ)[live]
    pair = np.broadcast_to(np.arange(B), (T, B))[live]
    cover = np.zeros((4, B, NWQ + 1), np.int64)
    np.add.at(cover, (plane, pair, lo), 1)
    np.add.at(cover, (plane, pair, hi), -1)
    qeq_words = int((np.cumsum(cover, 2)[..., :NWQ] > 0).sum())
    traj = rb[live].any() or ops.movxs.cpu().numpy()[live].any()
    ins = 4 * (qeq_words + rows + 2 * B) + (8 * rows if traj else 0)
    return ins + rows * (8 * NW + 4) + B * (8 * NW + 16)


# the main paths' instantiations of each kernel, by template arguments:
# banded-8's narrow and wide rows (piecewise, mode, emit, planes in device
# memory), edit (K words
# per lane, mode, vector stores; NW 64 is K 2), pedit (K cells per lane;
# band 32 is K 1); the wide bands' kernels of phase 16: banded-8 with its
# planes in device memory (align's defaults, overlap), edit's block row and
# cluster row (K words a thread, mode) and the cluster row's sweep (K,
# mode), pedit's block row (K cells a thread)
PTXAS_MAIN = {
    "banded8": (((1, 0, 0, 0), "pw1 global codes"),
                ((1, 0, 2, 0), "pw1 global none"),
                ((2, 0, 1, 0), "pw2 global planes"),
                ((1, 1, 0, 1), "pw1 overlap codes, planes in device memory"),
                ((1, 1, 2, 1), "pw1 overlap none, planes in device memory"),
                ((2, 1, 1, 1), "pw2 overlap planes, planes in device "
                 "memory")),
    "banded8_wide": (((1, 1, 0, 0), "pw1 overlap codes (align's defaults, "
                      "cat)"),
                     ((1, 1, 2, 0), "pw1 overlap none (the two-pass "
                      "mode's first pass)"),
                     ((2, 1, 1, 0), "pw2 overlap planes (map-ont)")),
    "edit": (((2, 0, 1), "K 2 global (NW 64)"),),
    "edit_blk": (((4, 0), "block row K 4 global (NW 752, edit -W 0 on "
                  "24.7 kb)"),
                 ((4, 1), "block row K 4 overlap"),
                 ((4, 2), "block row K 4 extend"),
                 ((8, 0), "block row K 8 global (NW 2,049-4,096)"),
                 ((8, 1), "block row K 8 overlap"),
                 ((8, 2), "block row K 8 extend")),
    "edit_cl": (((4, 0), "cluster row K 4 global"),
                ((4, 1), "cluster row K 4 overlap"),
                ((4, 2), "cluster row K 4 extend"),
                ((8, 0), "cluster row K 8 global"),
                ((8, 1), "cluster row K 8 overlap"),
                ((8, 2), "cluster row K 8 extend (edit -m kmer's tails)")),
    "edit_cl_sweep": (((8, 0), "cluster row's sweep global"),
                      ((8, 1), "cluster row's sweep overlap"),
                      ((8, 2), "cluster row's sweep extend (edit -m kmer's "
                       "tails past 65,536 words)")),
    "pedit": (((1,), "K 1 (band 32)"),),
    "pedit_blk": (((2,), "block row K 2 (bw 64 and below, forced)"),
                  ((4,), "block row K 4 (bw 1,023-2,048; poa -G "
                   "editbw=4096)"),
                  ((8,), "block row K 8 (bw 2,049-8,192)"),
                  ((16,), "block row K 16 (bw 8,193-16,384)"),
                  ((32,), "block row K 32 (bw 16,385-32,510)")),
}


def ptxas_report(srcs, flags):
    """Start nvcc -Xptxas -v on each source in srcs in the background, all
    together (killed at exit if still running); returns a function that
    waits for them and returns {(kernel, template arguments): (registers,
    stack bytes, spill store bytes, spill load bytes)} for each
    instantiation of banded8_rows_kernel, banded8_wide_kernel,
    edit_rows_kernel, edit_blk_rows_kernel, edit_cl_rows_kernel,
    edit_cl_sweep_kernel, pedit_rows_kernel and pedit_blk_rows_kernel."""
    tmp = tempfile.mkdtemp()
    procs = []
    for k, src in enumerate(srcs):
        proc = subprocess.Popen(
            flags + ["-Xptxas", "-v", "-c", src, "-o",
                     os.path.join(tmp, f"{k}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(proc.kill)
        procs.append(proc)

    def wait():
        texts = [proc.communicate()[0] for proc in procs]
        shutil.rmtree(tmp, ignore_errors=True)
        out = {}
        for proc, text in zip(procs, texts):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v failed:\n{text}")
            key = None
            for line in text.splitlines():
                m = re.search(r"(?:Compiling entry function|Function "
                              r"properties for) '?(\S+?)'?( for|$)", line)
                if m:
                    k = re.search(r"\d(banded8_wide|banded8|pedit_blk|"
                                  r"pedit|edit_blk|edit_cl_sweep|edit_cl|"
                                  r"edit)(?:_rows)?_kernel"
                                  r"(?:I((?:L[ib]\d+E)+)E)?", m.group(1))
                    key = (k.group(1), tuple(int(x) for x in re.findall(
                        r"L[ib](\d+)E", k.group(2) or ""))) if k else None
                    continue
                if key is None:
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m:
                    out[key] = out.get(key, (0,))[:1] + tuple(
                        int(x) for x in m.groups())
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    out[key] = (int(m.group(1)),) + out.get(
                        key, (0, 0, 0, 0))[1:]
        return out
    return wait


def ptxas_check(ptxas_wait):
    """Print the registers, stack and spills of each kernel's main-path
    instantiations (PTXAS_MAIN) and the range over all of its
    instantiations; returns an error message when one is missing or a
    main-path one spills, else None."""
    ptxas = ptxas_wait()
    for kern, mains in PTXAS_MAIN.items():
        for args, nm in mains:
            kname = kern + ("_kernel" if kern in ("banded8_wide",
                                                  "edit_cl_sweep")
                            else "_rows_kernel")
            if (kern, args) not in ptxas:
                return f"ptxas -v names no {kname} {args}"
            regs, stack, sst, sld = ptxas[(kern, args)]
            print(f"ptxas {kname} {nm}: {regs} registers, {stack} "
                  f"bytes stack frame, {sst} bytes spill stores, {sld} bytes "
                  "spill loads")
            if sst or sld:
                return f"{kname} {nm} spills"
        alls = [v for (k, _), v in ptxas.items() if k == kern]
        print(f"ptxas all {len(alls)} {kern} instantiations: registers "
              f"{min(v[0] for v in alls)}-{max(v[0] for v in alls)}, spills "
              f"in {sum(1 for v in alls if v[2] or v[3])}")
    return None


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(HERE, "bsalign_tpu_torch")):
        return fail("bsalign_tpu_torch is not beside this script")
    sys.path.insert(0, HERE)
    from bsalign_tpu_torch import cli as CLI
    from bsalign_tpu_torch import native
    from bsalign_tpu_torch.align import editdist as D
    from bsalign_tpu_torch.align import pairwise as P
    from bsalign_tpu_torch.constants import (MODE_GLOBAL, MODE_OVERLAP,
                                             MODE_EXTEND, roundup)
    from bsalign_tpu_torch.ops import _cuda
    from bsalign_tpu_torch.ops import banded8 as K
    from bsalign_tpu_torch.ops import edit as KE
    from bsalign_tpu_torch.oracle import banded8 as O
    from bsalign_tpu_torch.utils import metrics

    dev = torch.device("cuda", 0)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t_start = time.time()

    def stamp(phase):
        print(f"phase{phase} done at {time.time() - t_start:.1f}s")

    def reset_counts():
        _cuda.launches_codes = _cuda.launches_planes = 0
        _cuda.launches_none = _cuda.edit_launches = _cuda.pedit_launches = 0
        _cuda.launches_wide_codes = _cuda.launches_wide_planes = 0
        _cuda.launches_wide_none = 0
        _cuda.edit_block_launches = _cuda.edit_cluster_launches = 0
        _cuda.edit_sweep_launches = 0
        _cuda.pedit_block_launches = 0

    def a_counts():
        """Kernel A's launches since reset_counts, by emit (both rows) and
        by emit of the wide row."""
        return (dict(codes=_cuda.launches_codes + _cuda.launches_wide_codes,
                     planes=_cuda.launches_planes
                     + _cuda.launches_wide_planes,
                     none=_cuda.launches_none + _cuda.launches_wide_none),
                dict(codes=_cuda.launches_wide_codes,
                     planes=_cuda.launches_wide_planes,
                     none=_cuda.launches_wide_none))

    # ---- phase 1: environment and builds ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"device: {name}")
    print(smi_line)   # the card's name and power limit, as nvidia-smi says
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    ptxas_wait = ptxas_report(
        [os.path.join(_cuda.CSRC, f"{n}.cu")
         for n in ("banded8", "banded8_wide", "edit", "pedit")],
        [_cuda._nvcc()] + _cuda.NVCC_FLAGS)
    _cuda.lib()
    native.rowops_lib()
    print(f"build: kernels {_cuda.build_seconds:.1f}s (nvcc sm_90a), "
          f"walker {native.build_seconds:.1f}s (g++)")
    stamp(1)

    def start_cat_cpu():
        """Phase 12's CPU reference, started now in a process of its own
        (one thread, lowest priority) so that it runs beside the card's
        phases: `cat --device cpu` on the first CAT_CPU windows, whose
        plain forward takes minutes at band 1,024."""
        tmp = tempfile.mkdtemp(prefix="bsa_cat_")
        atexit.register(shutil.rmtree, tmp, True)
        all_fa, first_fa, expect = gen_cat_windows(SEED + 120)
        paths = [os.path.join(tmp, n) for n in ("all.fa", "first.fa")]
        for path, text in zip(paths, (all_fa, first_fa)):
            with open(path, "w") as f:
                f.write(text)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=HERE + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        proc = subprocess.Popen(
            [sys.executable, "-m", "bsalign_tpu_torch", "cat", "--device",
             "cpu", paths[1]], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, preexec_fn=lambda: os.nice(19))
        atexit.register(lambda: proc.poll() is None and proc.kill())
        return proc, paths, expect, time.time()

    def start_edit_cpu():
        """Phase 16's CPU reference, started now in a process of its own
        (one thread, lowest priority): `edit --device cpu -m global -W 0` on
        the first pair of phase 16's edit batch."""
        tmp = tempfile.mkdtemp(prefix="bsa_edit_")
        atexit.register(shutil.rmtree, tmp, True)
        qs, ts = wide_pairs(*WIDE_EDIT, SEED + 165)
        path = os.path.join(tmp, "pair0.fa")
        with open(path, "w") as f:
            f.write(f">q0\n{''.join('ACGT'[b] for b in qs[0])}\n"
                    f">t0\n{''.join('ACGT'[b] for b in ts[0])}\n")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=HERE + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        proc = subprocess.Popen(
            [sys.executable, "-m", "bsalign_tpu_torch", "edit", "--device",
             "cpu", "-m", "global", "-W", "0", path], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            preexec_fn=lambda: os.nice(19))
        atexit.register(lambda: proc.poll() is None and proc.kill())
        return proc, time.time()

    def start_kmer_cpu():
        """Phase 16's CPU reference of `edit -m kmer` on its reads against
        contigs, started now in a process of its own (one thread, lowest
        priority): the plain forward at the 2.3 Mb contig's band takes
        minutes."""
        tmp = tempfile.mkdtemp(prefix="bsa_kmer_")
        atexit.register(shutil.rmtree, tmp, True)
        qs, ts = contig_pairs(*WIDE_EDIT_KMER, SEED + 168)
        path = os.path.join(tmp, "kmer.fa")
        with open(path, "w") as f:
            for b, (q, t) in enumerate(zip(qs, ts)):
                f.write(f">q{b}\n{''.join('ACGT'[x] for x in q)}\n"
                        f">t{b}\n{''.join('ACGT'[x] for x in t)}\n")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=HERE + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        proc = subprocess.Popen(
            [sys.executable, "-m", "bsalign_tpu_torch", "edit", "--device",
             "cpu", "-m", "kmer", "-k", "13", path], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            preexec_fn=lambda: os.nice(19))
        atexit.register(lambda: proc.poll() is None and proc.kill())
        return proc, time.time()

    cat_cpu = edit_cpu = None
    if not sys.argv[1:]:
        cat_cpu = start_cat_cpu()
    if not sys.argv[1:] or "--wide" in sys.argv[1:]:
        edit_cpu = start_edit_cpu(), start_kmer_cpu()

    mtx = O.set_score_matrix(2, -6)
    smax, smin = int(mtx.max()), int(mtx.min())

    def operands(qs, ts, mode, bw, gaps, emit="codes", mtx=mtx):
        pw = O.get_piecewise(*gaps, bw)
        smax, smin = int(mtx.max()), int(mtx.min())
        qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, bw)
        us, es, qs0, ub, _ = P._init_state(mode, bw, pw, smax, smin, *gaps,
                                           len(qs))
        g = K.Geometry(T, bw // 16, mode, pw, *gaps, smax, smin, emit)
        st = K.state_from_numpy(qpad, qlens, tpad, tlens, P._mtx5(mtx), rby,
                                us, es, qs0, ub, T=T, device=dev)
        return g, st

    def timed_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def diff_raw(g, st, ra, rb):
        """Max |diff| over every output word of two raw results of one
        geometry (0 when bit-exact) and the disagreements: the per-row
        outputs of the emit, the final planes, anchors and registers, and
        score/qe/te."""
        if sorted(ra) != sorted(rb):
            return 1 << 30, [f"keys {sorted(ra)} vs {sorted(rb)}"]
        pairs = [(k, ra[k], rb[k]) for k in sorted(ra)
                 if k != "fin_planes" and ra[k] is not None]
        pairs += [(f"fin_plane{k}", a, b) for k, (a, b) in
                  enumerate(zip(ra["fin_planes"], rb["fin_planes"]))]
        fa = K.finish(g, ra, st.qlen, st.tlen)
        fb = K.finish(g, rb, st.qlen, st.tlen)
        pairs += [("score", fa.score, fb.score), ("qe", fa.qe, fb.qe),
                  ("te", fa.te, fb.te)]
        worst, bad = 0, []
        for nm, a, b in pairs:
            if a.shape != b.shape:
                bad.append(f"{nm} shape {tuple(a.shape)} vs {tuple(b.shape)}")
                worst = 1 << 30
                continue
            d = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            worst = max(worst, d)
            if d:
                bad.append(f"{nm} max|diff| {d}")
        return worst, bad

    def compare(g, st):
        """Kernel vs plain on the same device tensors; returns max |diff|
        over every output word (0 when bit-exact), the disagreements, and
        the plain version's milliseconds."""
        rk = _cuda.banded8_rows(g, st)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rp = K.forward_plain(g, st)
        e1.record()
        torch.cuda.synchronize()
        worst, bad = diff_raw(g, st, rk, rp)
        return worst, bad, e0.elapsed_time(e1)

    def sm_clock():
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or "not read"

    def split_line(label, g, st, ms, design=None):
        """The kernel's cycle split at this shape: SM clock cycles per phase
        per row below tlen (mean over pairs; the wide row's counted by
        thread 0 of each block), and the launch with the split on against
        one with it off (their outputs must be equal)."""
        on = _cuda.banded8_rows(g, st, cycle_split=True, design=design)
        off = _cuda.banded8_rows(g, st, design=design)
        torch.cuda.synchronize()
        cyc = on.pop("cycles").cpu().double()
        err, bad = diff_raw(g, st, on, off)
        if bad:
            raise RuntimeError(f"{label}: the split changed the outputs: "
                               + "; ".join(bad[:8]))
        rows = float((st.tlen - st.row0).clamp(0, g.T).sum())
        per = cyc.sum(1) / rows
        print(f"split {label} (cycles per row): " + ", ".join(
            f"{nm} {v:.1f}" for nm, v in zip(_cuda.SPLIT_PHASES,
                                             per.tolist()))
              + f"; total {float(per.sum()):.1f}; kernel {ms:.3f} ms over "
              f"T={g.T} rows = {ms * 1e3 / g.T:.3f} us per row; clocks.sm "
              f"{sm_clock()}; split on == off (max_abs_err={err})")

    if "--split" in sys.argv[1:]:
        # kernel A's row step alone, at its three main-path shapes: kernel
        # against plain (tolerance 0), its time and cycle split
        AFF, ONT = (-3, -2, 0, 0), (-4, -2, -24, -1)
        m_ont = O.set_score_matrix(2, -4)
        qs, ts = gen_pairs(P.DEVICE_CHUNK, 2000, 0.10, SEED)
        shapes = [("codes", "codes", qs, ts, AFF, mtx, None)]
        qs, ts = gen_pairs(P.DEVICE_CHUNK, 2000, 0.10, SEED + 70)
        shapes.append(("planes", "planes", qs, ts, ONT, m_ont, None))
        qs, ts = gen_pairs_fast(256, 50000, 0.10, SEED + 80)
        shapes.append(("none", "none", qs, ts, AFF, mtx, P.T_CHUNK))
        for emit, label, qs, ts, gaps, m_, t_cut in shapes:
            g, st = operands(qs, ts, MODE_GLOBAL, 128, gaps, emit, m_)
            if t_cut:
                g = g._replace(T=t_cut)
                st = st._replace(tseq=st.tseq[:, :t_cut].contiguous(),
                                 rby=st.rby[:t_cut].contiguous())
            err, bad, p_ms = compare(g, st)
            if bad:
                return fail(f"--split {label}: kernel disagrees with plain: "
                            + "; ".join(bad[:8]))
            ms = timed_ms(lambda: _cuda.banded8_rows(g, st), 5)
            print(f"row step {label} {len(qs)} pairs x {g.T} rows "
                  f"pw{g.piecewise}: kernel {ms:.3f} ms, max_abs_err={err}, "
                  f"plain on the card {p_ms:.1f} ms")
            try:
                split_line(f"{label} {len(qs)} pairs x {g.T} rows", g, st,
                           ms)
            except RuntimeError as e:
                return fail(f"--split {e}")
        # both rows of kernel A at W 64 (cat's joins), 128 (align's
        # defaults on 2 kb) and 2,000 (on 33 kb): codes, overlap, 512 rows
        for W, n in ((64, 1), (128, 16), (2000, 8)):
            qs, ts = gen_pairs_fast(n, 16 * W + 1000, 0.10, SEED + 90 + W)
            g, st = operands(qs, ts, MODE_OVERLAP, 16 * W, AFF, "codes")
            g = g._replace(T=512)
            st = st._replace(tseq=st.tseq[:, :512].contiguous(),
                             rby=st.rby[:512].contiguous())
            for design in ("narrow", "wide"):
                ms = timed_ms(lambda: _cuda.banded8_rows(g, st,
                                                         design=design), 3)
                try:
                    split_line(f"{design} row, codes {n} pairs x 512 rows at "
                               f"W={W}", g, st, ms, design)
                except RuntimeError as e:
                    return fail(f"--split {e}")
        err = ptxas_check(ptxas_wait)
        return fail(err) if err else 0

    # ---- phases 5, 6 (its kernel part) and 7, also run by --kernels ----
    def edit_operands(qs, ts, mode, bw, banded, traj=None):
        T, _, (qeq, qlens, tpad, tlens, rbegs, movxs) = D._pack_bucket(
            qs, ts, bw, banded)
        if traj is not None:
            rbegs, movxs = traj(rbegs, tlens, qlens, T)
        g = KE.Geometry(T, bw // 32, mode)
        ops = KE.operands_from_numpy(qeq, qlens, tpad, tlens, rbegs, movxs,
                                     T=T, device=dev)
        return g, ops

    def edit_compare(g, ops, design=None, rp=None):
        """Kernel (the row `design` forces, else the main path's) vs plain
        on the same device tensors: rows < tlen of pm, pp and sbeg, the
        final planes and scal whole, and the global score. Returns max
        |diff|, the disagreements, the plain version's milliseconds and its
        outputs; rp, the plain outputs of an earlier call on the same
        operands, is used instead of running it again (0.0 ms)."""
        rk = _cuda.edit_rows(g, ops, design=design)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        if rp is None:
            rp = KE.forward_plain(g, ops)
        e1.record()
        torch.cuda.synchronize()
        pairs = []
        for b, n in enumerate(ops.tlen.tolist()):
            pairs += [(f"{f}[{b}]", rk[f][b, :n], rp[f][b, :n])
                      for f in ("pm", "pp", "sbeg")]
        pairs += [(f, rk[f], rp[f]) for f in ("fin_pm", "fin_pp", "scal")]
        pairs.append(("final_score", KE.final_score(g, rk, ops.qlen),
                      KE.final_score(g, rp, ops.qlen)))
        worst, bad = 0, []
        for nm, a, b in pairs:
            d = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            worst = max(worst, d)
            if d:
                bad.append(f"{nm} max|diff| {d}")
        return worst, bad, e0.elapsed_time(e1), rp

    def edit_same(ops, ra, rb):
        """Whether two launches on ops agree: rows < tlen of pm, pp and
        sbeg, the final planes and scal whole."""
        return all(torch.equal(ra[f][b, :n], rb[f][b, :n])
                   for b, n in enumerate(ops.tlen.tolist())
                   for f in ("pm", "pp", "sbeg")) and all(
            torch.equal(ra[f], rb[f]) for f in ("fin_pm", "fin_pp", "scal"))

    def spread_targets(n, seed):
        """2 kb queries with targets cut or extended to 0.5-1.5 x 2 kb."""
        qs, ts = gen_pairs(n, 2000, 0.10, seed)
        rng = np.random.default_rng(seed)
        out = []
        for t in ts:
            tl = int(2000 * (0.5 + rng.random()))
            out.append(t[:tl] if tl <= len(t) else np.concatenate(
                [t, rng.integers(0, 4, tl - len(t)).astype(np.uint8)]))
        return qs, out

    def jumpy(rbegs, tlens, qlens, T):
        """Band starts that jump past the band's width every 37 rows."""
        r = np.zeros_like(rbegs)
        for b, tl in enumerate(tlens):
            cur = 0
            for i in range(int(tl)):
                cur += 64 + 7 * (i % 3) if i % 37 == 5 else (i % 11 == 3) * 13
                r[i, b] = min(cur, int(qlens[b]) - 8)
        m = np.diff(r, axis=0, prepend=0).astype(np.int32)
        for b, tl in enumerate(tlens):
            m[int(tl):, b] = 0
        return r, m

    def phase5():
        """The edit kernel against its plain version on phase 5's cases;
        returns the largest error."""
        rng = np.random.default_rng(SEED + 16)
        cases5 = [
            ("(a) 64x2kb global full band",
             gen_pairs(64, 2000, 0.10, SEED + 11), MODE_GLOBAL, 2048, False,
             None),
            ("(b) 64x2kb global -W 128, targets 0.5-1.5x",
             spread_targets(64, SEED + 12), MODE_GLOBAL, 128, True, None),
            ("(c) 64x2kb overlap", gen_pairs(64, 2000, 0.10, SEED + 13),
             MODE_OVERLAP, 2048, False, None),
            ("(d) 64x2kb extend", gen_pairs(64, 2000, 0.10, SEED + 14),
             MODE_EXTEND, 2048, False, None),
            ("(e) 4x5kb global full band", gen_pairs(4, 5000, 0.10, SEED + 15),
             MODE_GLOBAL, 5120, False, None),
            ("(f) 2 pairs, band 64, movx >= band",
             ([rng.integers(0, 4, L).astype(np.uint8) for L in (1500, 1200)],
              [rng.integers(0, 4, L).astype(np.uint8) for L in (200, 150)]),
             MODE_GLOBAL, 64, True, jumpy),
        ]
        edit_err = 0
        for label, (qs5, ts5), mode, bw5, banded, traj in cases5:
            g, ops = edit_operands(qs5, ts5, mode, bw5, banded, traj)
            err, bad, p_ms, _ = edit_compare(g, ops)
            edit_err = max(edit_err, err)
            k_ms = timed_ms(lambda: _cuda.edit_rows(g, ops), 5)
            extra = ""
            if traj is not None:
                extra = f", max movx {int(ops.movxs.max())}"
                if int(ops.movxs.max()) < bw5:
                    raise RuntimeError(f"phase 5 {label}: no row moves past "
                                       "the band")
            print(f"phase5 {label}: NW={g.NW} T={g.T}{extra} "
                  f"max_abs_err={err}; kernel {k_ms:.3f} ms, plain on the "
                  f"card {p_ms:.1f} ms")
            if bad:
                raise RuntimeError(f"phase 5 {label}: kernel disagrees with "
                                   "plain: " + "; ".join(bad[:8]))
        stamp(5)
        return edit_err

    def edit_main_kernel(qs, ts):
        """The edit kernel at the main path's launch shape (the first
        DEVICE_CHUNK of the pairs at band 2048) against the plain version,
        its time and bound, and its time at -W 128. Returns (main_idx,
        err, ms, plain_ms, bound_ms, bound_by)."""
        main_idx = [i for i, (q, t) in enumerate(zip(qs, ts))
                    if roundup(roundup(len(q), 64), 256) == 2048
                    ][:D.DEVICE_CHUNK]
        g_e, ops_e = edit_operands([qs[i] for i in main_idx],
                                   [ts[i] for i in main_idx], MODE_GLOBAL,
                                   2048, False)
        err, bad, edit_plain_ms, _ = edit_compare(g_e, ops_e)
        if bad:
            raise RuntimeError("phase 6 chunk: kernel disagrees with plain: "
                               + "; ".join(bad[:8]))
        edit_ms = timed_ms(lambda: _cuda.edit_rows(g_e, ops_e), 20)
        rows = int(ops_e.tlen.sum())
        e_cells = float(rows) * g_e.bw
        edit_bound_ms, edit_bound_by, edit_bound_text = bound(
            edit_bytes(g_e, ops_e), rows * g_e.NW * EDIT_OPS_PER_WORD_ROW)
        print(f"phase6 kernel: {edit_ms:.3f} ms per launch of "
              f"{len(main_idx)} pairs (T={g_e.T}, NW={g_e.NW}), "
              f"{e_cells / (edit_ms / 1e3):.4g} cells/s; plain on the card "
              f"{edit_plain_ms:.1f} ms; bound "
              f"{edit_bound_ms:.4f} ms by {edit_bound_by} ({edit_bound_text})")
        del ops_e
        g_w, ops_w = edit_operands([qs[i] for i in main_idx],
                                   [ts[i] for i in main_idx], MODE_GLOBAL,
                                   128, True)
        print(f"phase6 kernel at -W 128 on the same pairs (NW={g_w.NW}): "
              f"{timed_ms(lambda: _cuda.edit_rows(g_w, ops_w), 5):.3f} ms")
        del ops_w
        return (main_idx, err, edit_ms, edit_plain_ms, edit_bound_ms,
                edit_bound_by)

    # phase 7's modules
    from bsalign_tpu_torch.native import rowops as NR
    from bsalign_tpu_torch.ops import pedit as PE
    from bsalign_tpu_torch.poa import batch as PB
    from bsalign_tpu_torch.poa.core import BSPOA, BSPOAPar

    def rand_job(rng, mlen, bw, span=None):
        """A random pedit job of mlen positions at band bw."""
        HW = bw // 2
        pad = mlen + bw
        seqs0 = np.full(pad, 4, np.uint8)
        pos = np.sort(rng.choice(mlen, int(rng.integers(mlen // 2, mlen)),
                                 replace=False))
        seqs0[HW + pos] = rng.integers(0, 4, len(pos))
        seqs1 = np.zeros(pad, np.uint8)
        seqs1[HW:HW + mlen] = rng.integers(0, 5, mlen)
        mats0 = np.zeros((4, pad), np.uint8)
        mats1 = np.zeros((4, pad), np.uint8)
        mats0[:, HW:HW + mlen] = rng.integers(0, 6, (4, mlen))
        mats1[:, HW:HW + mlen] = rng.integers(0, 251, (4, mlen))
        if span is None:
            mbeg = int(rng.integers(0, mlen // 4))
            mend = int(rng.integers(mbeg + 2, mlen + 1))
        else:
            mbeg = int(rng.integers(0, mlen - span + 1))
            mend = mbeg + span
        return PE.PeditJob(seqs0, seqs1, mats0, mats1, mlen, mbeg, mend, bw,
                           HW)

    def pedit_compare(jobs):
        """Kernel vs plain on the same device buffers: max |diff| over
        both whole output matrices (the kernel's written over bytes of
        0xA5, so a byte it leaves unwritten shows), the plain version's ms
        and the kernel's matrices on the host."""
        pk = PE.pack_jobs(jobs, dev)
        k0, k1 = _cuda.pedit_rows(pk, out=tuple(
            torch.full((pk.total,), 0xA5, dtype=torch.uint8, device=dev)
            for _ in range(2)))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        p0, p1 = PE.forward_plain(pk)
        e1.record()
        torch.cuda.synchronize()
        err = max(int((k0.int() - p0.int()).abs().max()),
                  int((k1.int() - p1.int()).abs().max()))
        return pk, err, e0.elapsed_time(e1), (k0.cpu().numpy(),
                                              k1.cpu().numpy())

    def phase7():
        """The pedit kernel against its plain version (and the host's
        bsa_pedit_forward) on phase 7's cases and the main path's
        first round, timed. Returns (windows, err, ms, plain_ms, bound_ms,
        bound_by, the main round's jobs)."""
        rng = np.random.default_rng(SEED + 30)
        windows = [gen_poa_window(rng) for _ in range(128)]
        t0 = time.time()
        round_jobs = []
        for w in windows:
            g = BSPOA(BSPOAPar(), device=dev)
            g.beg()
            for s in w:
                g.push(s)
            g.end_begin()
            g.msa()
            g.cns_call()
            ctx = g._remsa_prepare(g.par.editbw // 2, 1)
            round_jobs.append(g._remsa_dev_build(ctx, 0)[0])
        print(f"phase7 first-round jobs of 128 windows built on the host in "
              f"{time.time() - t0:.2f}s")

        def native_err(jobs, pk, host):
            """Max |diff| of the kernel's rows against bsa_pedit_forward."""
            worst = 0
            for j, o in zip(jobs, pk.offs.tolist()):
                rowlen = j.bw + 2
                n = (2 * j.mlen + 2) * rowlen
                n0 = np.zeros(n, np.uint8)
                n1 = np.zeros(n, np.uint8)
                NR.pedit_forward(n0, n1, j.seqs0, j.seqs1, j.mats0, j.mats1,
                                 j.mlen, j.mbeg, j.mend, j.bw, j.HW, rowlen)
                lo, hi = 2 * j.mbeg * rowlen, 2 * j.mend * rowlen
                for h, ref in zip(host, (n0, n1)):
                    worst = max(worst, int(np.abs(
                        h[o + lo:o + hi].astype(np.int32)
                        - ref[lo:hi].astype(np.int32)).max()))
            return worst

        jobs16 = [j for js in round_jobs[:16] for j in js]
        main_jobs = [j for js in round_jobs for j in js]
        cases7 = [
            ("(a) round 1 of 16 windows, bw 32", jobs16, True),
            ("(b) 32 random jobs, bw 64",
             [rand_job(rng, int(rng.integers(200, 900)), 64)
              for _ in range(32)], False),
            ("(c) 32 random jobs, bw 128",
             [rand_job(rng, int(rng.integers(200, 900)), 128)
              for _ in range(32)], False),
            (f"(d) 8 random jobs, bw {_cuda.PEDIT_REG_BW} (the widest of "
             "the register rows)",
             [rand_job(rng, int(rng.integers(200, 600)), _cuda.PEDIT_REG_BW)
              for _ in range(8)], True),
            ("(e) shortest jobs, mend = mbeg + 2 and + 1",
             [rand_job(rng, 60, 32, span=s) for s in (2, 1, 2, 1)], True),
            ("(f) 32 random jobs, bw 34 (17 lanes of 2 cells)",
             [rand_job(rng, int(rng.integers(200, 900)), 34)
              for _ in range(32)], True),
            ("(g) 32 random jobs, bw 96 (24 lanes of 4 cells)",
             [rand_job(rng, int(rng.integers(200, 900)), 96)
              for _ in range(32)], False),
        ]
        pedit_err = 0
        for label, jobs, vs_native in cases7:
            pk, err, p_ms, host = pedit_compare(jobs)
            pedit_err = max(pedit_err, err)
            extra = ""
            if vs_native:
                nerr = native_err(jobs, pk, host)
                pedit_err = max(pedit_err, nerr)
                extra = f", against bsa_pedit_forward {nerr}"
                err = max(err, nerr)
            k_ms = timed_ms(lambda: _cuda.pedit_rows(pk), 5)
            print(f"phase7 {label}: {len(jobs)} jobs, "
                  f"max_abs_err={err}{extra}; kernel {k_ms:.3f} ms, plain on "
                  f"the card {p_ms:.1f} ms")
            if err:
                raise RuntimeError(f"phase 7 {label}: kernel disagrees "
                                   f"(max|diff| {err})")
        pk_main, err, pedit_plain_ms, _ = pedit_compare(main_jobs)
        pedit_err = max(pedit_err, err)
        if err:
            raise RuntimeError(f"phase 7 main round: kernel disagrees "
                               f"(max|diff| {err})")
        pedit_ms = timed_ms(lambda: _cuda.pedit_rows(pk_main), 20)
        p_bytes, p_cells = pedit_work(main_jobs)
        pedit_bound_ms, pedit_bound_by, pedit_bound_text = bound(
            p_bytes, p_cells * PEDIT_OPS_PER_CELL)
        print(f"phase7 main round: {len(main_jobs)} jobs of 128 windows, "
              f"max_abs_err={err}; kernel {pedit_ms:.3f} ms, "
              f"{p_cells / (pedit_ms / 1e3):.4g} cells/s; plain on the card "
              f"{pedit_plain_ms:.1f} ms; bound {pedit_bound_ms:.4f} ms by "
              f"{pedit_bound_by} ({pedit_bound_text})")
        stamp(7)
        return (windows, pedit_err, pedit_ms, pedit_plain_ms,
                pedit_bound_ms, pedit_bound_by, main_jobs)

    def edit_block_rows(label):
        """Kernel B's block row (NW past EDIT_REG_NW, the default there)
        and its cluster row (forced) against the plain version at NW 640,
        752, 1,024 (K 4) and 3,200 (K 8) in every mode (4 queries of
        20-102 kb against 500 bp, full band), tolerance 0. Returns (the
        block row's max error, the plain version's ms at NW 1,024, the
        cluster row's max error)."""
        worst, plain_ms, worst_c = 0, 0.0, 0
        for nw, L in ((640, 20000), (752, 23500), (1024, 32000),
                      (3200, 102000)):
            for mode in (MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND):
                rng = np.random.default_rng(SEED + 164 + nw % 7 + mode)
                qs = [rng.integers(0, 4, L - 13 * k).astype(np.uint8)
                      for k in range(4)]
                ts = [q[5000:5500 + 11 * k].copy() for k, q in enumerate(qs)]
                g, ops = edit_operands(qs, ts, mode, 32 * nw, False)
                before = (_cuda.edit_block_launches,
                          _cuda.edit_cluster_launches)
                err, bad, p_ms, rp = edit_compare(g, ops)
                err_c, bad_c, _, _ = edit_compare(g, ops, "cluster", rp)
                del rp
                if (_cuda.edit_block_launches, _cuda.edit_cluster_launches) \
                        != (before[0] + 1, before[1] + 1):
                    bad.append("the block and cluster rows did not launch "
                               "once each")
                bad += [f"cluster row: {b}" for b in bad_c]
                worst, worst_c = max(worst, err), max(worst_c, err_c)
                if nw == 1024:
                    plain_ms = p_ms
                print(f"{label} kernel B block and cluster rows NW {nw} "
                      f"{['global', 'overlap', 'extend'][mode]}: 4 x {L} bp "
                      f"against 500 bp, T={g.T}: max_abs_err={err} / "
                      f"{err_c}; plain on the card {p_ms:.1f} ms")
                if bad:
                    raise RuntimeError(f"{label} B NW {nw} mode {mode}: "
                                       + "; ".join(bad[:8]))
        return worst, plain_ms, worst_c

    def edit_cluster_rows(label):
        """Kernel B's cluster row (past EDIT_BLOCK_MAX_NW, the default
        there) against the plain version, tolerance 0: at NW 4,097, 4,192
        and 8,192 in every mode, banded (rows that shift) on 2 queries a
        little longer than the band, and (not in overlap, which never
        shifts) on a trajectory whose shifts cross blocks and reset the
        band; at NW 32,768 (8 blocks) and 65,537 (past the registers: the
        sweep) on 48 rows. Returns the max error."""
        def crossing(rbegs, tlens, qlens, T):
            r = np.zeros_like(rbegs)
            for b, tl in enumerate(tlens):
                cur = 0
                for i in range(int(tl)):
                    cur += 400000 if i % 29 == 13 else (i % 7 == 3) * (
                        80097 + 32 * b)
                    r[i, b] = min(cur, int(qlens[b]) - 8)
            m = np.diff(r, axis=0, prepend=0).astype(np.int32)
            for b, tl in enumerate(tlens):
                m[int(tl):, b] = 0
            return r, m
        occ = {C: _cuda.edit_cluster_occupancy(8, _cuda.EDIT_BLOCK_MAXW, C)
               for C in (2, 4, 8, 16)}
        print(f"{label} kernel B cluster row: clusters of 16 warps of 8 "
              f"words the card holds at once, by blocks a cluster: {occ}; "
              f"the largest cluster taken: {_cuda.edit_cluster_max(dev)}")
        rng = np.random.default_rng(SEED + 169)
        worst = 0
        cases = [(nw, mode, kind) for nw in (4097, 4192, 8192)
                 for mode in (MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND)
                 for kind in ("banded", "crossing")
                 if not (kind == "crossing" and mode == MODE_OVERLAP)]
        cases += [(32768, MODE_EXTEND, "full"), (65537, MODE_GLOBAL,
                                                 "banded")]
        for nw, mode, kind in cases:
            bw = 32 * nw
            if kind == "crossing":
                qs = [rng.integers(0, 4, 3 * bw + 1500000).astype(np.uint8)
                      for _ in range(2)]
                ts = [rng.integers(0, 4, 90 - 11 * k).astype(np.uint8)
                      for k in range(2)]
                g, ops = edit_operands(qs, ts, mode, bw, True, crossing)
            elif kind == "banded":
                n = 1 if nw > 8192 else 2
                qs = [rng.integers(0, 4, bw + 5000 + 17 * k).astype(np.uint8)
                      for k in range(n)]
                ts = [rng.integers(0, 4, (48 if nw > 8192 else 120) - 11 * k)
                      .astype(np.uint8) for k in range(n)]
                g, ops = edit_operands(qs, ts, mode, bw, True)
            else:
                qs = [rng.integers(0, 4, bw - 100).astype(np.uint8)]
                ts = [qs[0][5000:5048].copy()]
                g, ops = edit_operands(qs, ts, mode, bw, False)
            before = (_cuda.edit_cluster_launches, _cuda.edit_sweep_launches)
            err, bad, p_ms, _ = edit_compare(g, ops)
            geo = _cuda.edit_cluster_default(nw, len(qs), dev)
            sweep = geo[3] > 1
            if (_cuda.edit_cluster_launches - before[0],
                    _cuda.edit_sweep_launches - before[1]) != (1, sweep):
                bad.append("the cluster row did not launch once")
            live = np.arange(g.T)[:, None] < ops.tlen.cpu().numpy()[None]
            mv = ops.movxs.cpu().numpy()[live]
            if kind == "crossing" and not (mv.max() >= bw and (
                    (mv >= 32) & (mv < bw)).any()):
                bad.append("no full reset or no shift of whole words")
            worst = max(worst, err)
            print(f"{label} kernel B cluster row NW {nw} "
                  f"{['global', 'overlap', 'extend'][mode]} {kind}: "
                  f"{len(qs)} pairs, T={g.T}, geometry {geo}"
                  f"{' (the sweep)' if sweep else ''}, max movx "
                  f"{int(mv.max())}: max_abs_err={err}; plain on the card "
                  f"{p_ms:.1f} ms")
            if bad:
                raise RuntimeError(f"{label} B cluster NW {nw} mode {mode} "
                                   f"{kind}: " + "; ".join(bad[:8]))
            del ops
        return worst

    def pedit_block_rows(label):
        """Kernel C's block row (bw past PEDIT_REG_BW) against its plain
        version on 6 random jobs at bw 1,024, 1,534, 4,094 and 32,510 into
        buffers of 0xA5, tolerance 0, with its time, us a step of the
        longest job and bound, and at bw 4,094 the same launch in every other
        geometry. Returns a dict of the bw 4,094 row (the shape PERF.md §6
        ranks the block row at; poa -G editbw=4096 runs bw 2,048)."""
        rng = np.random.default_rng(SEED + 166)
        row = dict(err=0)
        for bw in (1024, 1534, 4094, 32510):
            jobs = [rand_job(rng, int(rng.integers(200, 600)), bw)
                    for _ in range(6)]
            before = _cuda.pedit_block_launches
            pk, err, p_ms, _ = pedit_compare(jobs)
            if err or _cuda.pedit_block_launches != before + 1:
                raise RuntimeError(f"{label} C bw {bw}: max|diff| {err}, "
                                   f"block launches "
                                   f"{_cuda.pedit_block_launches - before}")
            k_ms = timed_ms(lambda: _cuda.pedit_rows(pk), 3)
            steps = max(max(2 * (j.mend - j.mbeg) - 1, 1) for j in jobs)
            p_bytes, p_cells = pedit_work(jobs)
            b_ms, b_by, b_text = bound(p_bytes, p_cells * PEDIT_OPS_PER_CELL)
            ck, cnw = _cuda.pedit_block_geometry(bw)
            print(f"{label} kernel C block row bw {bw} (K {ck}, {cnw} "
                  f"warps): 6 random jobs, max_abs_err=0; kernel {k_ms:.3f} "
                  f"ms = {k_ms * 1e3 / steps:.4f} us a step of the longest "
                  f"job ({steps} steps); plain on the card {p_ms:.1f} ms; "
                  f"bound {b_ms:.4f} ms by {b_by} ({b_text})")
            if bw == 4094:
                row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, err=0)
                pedit_geometries(label, pk, steps)
        return row

    def pedit_geometries(label, pk, steps):
        """Kernel C's block row on pk in every geometry it can take (each
        K with its least warps): outputs equal to the default's, byte for
        byte, and the time of each."""
        ref = _cuda.pedit_rows(pk)
        line = []
        for K in (2, 4, 8, 16, 32):
            geo = (K, -(-pk.bw // (32 * K)))
            if not _cuda.pedit_geometry_ok(pk.bw, *geo):
                continue
            out = _cuda.pedit_rows(pk, design="block", geometry=geo)
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise RuntimeError(f"{label} C bw {pk.bw}: geometry {geo} "
                                   "differs from the default")
            del out
            g_ms = timed_ms(lambda: _cuda.pedit_rows(
                pk, design="block", geometry=geo), 3)
            line.append(f"K {K} x {geo[1]} warps {g_ms:.3f} ms = "
                        f"{g_ms * 1e3 / steps:.4f} us a step")
        print(f"{label} kernel C block row bw {pk.bw}, {pk.jobs.shape[0]} "
              f"jobs, every geometry (outputs equal; default "
              f"{_cuda.pedit_block_geometry(pk.bw)}): " + "; ".join(line))

    def crossovers():
        """us a row of kernel B's register and block rows (NW 128, 256,
        384, 512; NW 128 is one warp of the block row) and of its block and
        cluster rows (NW 752) at 8 and 256 pairs of 2,048 rows; the cluster
        exchange alone (its floor, us a row at C 2, 4, 8 and 16 blocks of 1,
        9 and 16 warps) with the clusters the card holds at once; the block
        row in each geometry against the cluster row in its default and
        other geometries at NW 1,536, 2,049, 3,200 and 4,096 (outputs
        equal) at 8 and 256 pairs of 1,024 rows; the cluster row in each
        geometry at NW 4,192, 8,192, 16,384 and 32,768 at 2 and 64 pairs of
        256 rows and the sweep against the registers at NW 32,768; ms a
        launch of kernel C's register and block rows at bw 128, 512 and
        1,022 (6 and 64 random jobs), and of the block row in every
        geometry at bw 1,024 to 32,510."""
        rng = np.random.default_rng(SEED + 171)
        for n in (8, 256):
            qs, ts = gen_pairs_fast(n, 2000, 0.10, SEED + 170)
            line = []
            for nw, designs in ((128, ("register", "block")),
                                (256, ("register", "block")),
                                (384, ("register", "block")),
                                (512, ("register", "block")),
                                (752, ("block", "cluster"))):
                g, ops = edit_operands(qs, ts, MODE_GLOBAL, 32 * nw, False)
                us = {d: timed_ms(lambda: _cuda.edit_rows(g, ops, design=d),
                                  3) * 1e3 / g.T for d in designs}
                line.append(f"NW {nw} " + " / ".join(
                    f"{d} {v:.3f}" for d, v in us.items()))
                del ops
            print(f"kernels kernel B crossover, us a row, {n} pairs x 2 kb "
                  f"(T=2048): " + "; ".join(line))
        for C in (2, 4, 8, 16):
            occ = _cuda.edit_cluster_occupancy(8, _cuda.EDIT_BLOCK_MAXW, C)
            line = [f"{occ} clusters of 16 warps of 8 words at once"]
            if occ > 0:
                for w in (1, 9, 16):
                    ms = timed_ms(lambda: _cuda.edit_cluster_floor(
                        C, w, 1, 8192, dev), 3)
                    line.append(f"{w} warps {ms * 1e3 / 8192:.4f} us a row")
            print(f"kernels kernel B cluster exchange alone (stage 0), C "
                  f"{C}: " + "; ".join(line))

        def geos(nw, n):   # the cluster row's default, other geometries
            out = [_cuda.edit_cluster_default(nw, n, dev)]
            for K, C in ((4, 2), (4, 3), (4, 4), (4, 8), (8, 2), (8, 4),
                         (8, 8), (8, 16)):
                geo = (K, -(-nw // (C * 32 * K)), C, 1)
                if geo not in out and _cuda.edit_cluster_geometry_ok(nw, *geo)\
                        and _cuda.edit_cluster_occupancy(*geo[:3]) > 0:
                    out.append(geo)
            return out
        for n in (8, 256):
            line = []
            for nw in (1536, 2049, 3200, 4096):
                rb_ = np.random.default_rng(SEED + 172 + nw)
                qs = [rb_.integers(0, 4, 32 * nw - 64).astype(np.uint8)
                      for _ in range(n)]
                ts = [q[1000:2000].copy() for q in qs]
                g, ops = edit_operands(qs, ts, MODE_GLOBAL, 32 * nw, False)
                ref = _cuda.edit_rows(g, ops)
                us = {}
                for K in (4, 8):
                    geo = (K, -(-nw // (32 * K)))
                    if _cuda.edit_geometry_ok(nw, *geo):
                        us[f"block K {K} x {geo[1]}"] = (
                            "block", geo)
                for geo in geos(nw, n)[:4]:
                    us[f"cluster {geo[:3]}"] = ("cluster", geo)
                for k, (d, geo) in list(us.items()):
                    if not edit_same(ops, ref, _cuda.edit_rows(
                            g, ops, design=d, geometry=geo)):
                        raise RuntimeError(f"kernels: B's {k} row differs "
                                           f"from the default at NW {nw}")
                    us[k] = timed_ms(lambda: _cuda.edit_rows(
                        g, ops, design=d, geometry=geo), 3) * 1e3 / g.T
                del ref, ops
                line.append(f"NW {nw} " + " / ".join(
                    f"{d} {v:.3f}" for d, v in us.items()))
            print(f"kernels kernel B block and cluster rows, us a row, {n} "
                  f"pairs of queries filling the band x 1 kb (T=1024, "
                  f"outputs equal): " + "; ".join(line))
        for n in (2, 64):
            line = []
            for nw in (4192, 8192, 16384, 32768):
                if n * nw > 64 * 8192:
                    continue
                rb_ = np.random.default_rng(SEED + 173 + nw)
                qs = [rb_.integers(0, 4, 32 * nw - 64).astype(np.uint8)
                      for _ in range(n)]
                ts = [q[1000:1256].copy() for q in qs]
                g, ops = edit_operands(qs, ts, MODE_EXTEND, 32 * nw, False)
                ref = _cuda.edit_rows(g, ops)
                cand = geos(nw, n)
                if nw == 32768:   # the sweep against the registers
                    cand.append((8, 8, 8, 2))
                us = {}
                for geo in cand:
                    if not edit_same(ops, ref, _cuda.edit_rows(
                            g, ops, design="cluster", geometry=geo)):
                        raise RuntimeError(f"kernels: B's cluster row "
                                           f"{geo} differs from the default "
                                           f"at NW {nw}")
                    us[geo] = timed_ms(lambda: _cuda.edit_rows(
                        g, ops, design="cluster", geometry=geo), 3) \
                        * 1e3 / g.T
                del ref, ops
                line.append(f"NW {nw} " + " / ".join(
                    f"{geo} {v:.3f}" for geo, v in us.items()))
            print(f"kernels kernel B cluster row, us a row, {n} pairs x 256 "
                  f"rows, extend, each geometry (the first the default; "
                  f"outputs equal): " + "; ".join(line))
        for n in (6, 64):
            line = []
            for bw in (128, 512, _cuda.PEDIT_REG_BW):
                jobs = [rand_job(rng, int(rng.integers(200, 600)), bw)
                        for _ in range(n)]
                pk = PE.pack_jobs(jobs, dev)
                ms = {d: timed_ms(lambda: _cuda.pedit_rows(pk, design=d), 3)
                      for d in ("register", "block")}
                line.append(f"bw {bw} register {ms['register']:.3f} / block "
                            f"{ms['block']:.3f}")
            print(f"kernels kernel C crossover, ms a launch of {n} random "
                  f"jobs: " + "; ".join(line))
        for n in (6, 64):
            for bw in (1024, 1534, 2046, 4094, 8190, 16382, 32510):
                jobs = [rand_job(rng, int(rng.integers(200, 600)), bw)
                        for _ in range(n)]
                pedit_geometries("kernels", PE.pack_jobs(jobs, dev), max(
                    max(2 * (j.mend - j.mbeg) - 1, 1) for j in jobs))

    def phase16(edit_cpu):
        """Wide bands, every check with tolerance 0: kernel A's planes in
        device memory against shared memory (a) and against the plain
        version at band 32,768 (b); align at the CLI defaults on 32 kb
        reads (c) and with map-ont costs on 24 kb (d); kernel B past NW
        512, edit -W 0 on 24 kb and edit -m kmer's tails on the cluster
        row (e); kernel C past bw 1,022 and poa -G editbw=4096 (f); cat's
        4x retry at band 32,768 (g)."""
        import contextlib
        import dataclasses
        import io
        t16 = time.time()
        LIN, AFF = (0, -4, 0, 0), (-3, -2, 0, 0)
        ONT = (-4, -2, -24, -1)
        m_ont = O.set_score_matrix(2, -4)
        worst = 0

        def stamp16(part):
            print(f"phase16 ({part}) done at {time.time() - t_start:.1f}s "
                  f"({time.time() - t16:.1f}s into phase 16)")

        def need(label, err, bad):
            nonlocal worst
            worst = max(worst, err)
            if bad:
                raise RuntimeError(f"phase 16 {label}: " + "; ".join(bad[:8]))

        # (a) the planes in device memory against shared memory
        for bw, L, mode in ((128, 1500, MODE_GLOBAL),
                            (2048, 3000, MODE_OVERLAP),
                            (16384, 1200, MODE_EXTEND)):
            qs, ts = gen_pairs_fast(8, L, 0.10, SEED + 160 + bw % 97)
            for pw, gaps, m_ in ((0, LIN, mtx), (1, AFF, mtx),
                                 (2, ONT, m_ont)):
                for emit in ("codes", "planes", "none"):
                    if emit == "codes" and pw == 2:
                        continue
                    g, st = operands(qs, ts, mode, bw, gaps, emit, m_)
                    for design in ("narrow", "wide"):
                        sh = _cuda.banded8_rows(g, st, store="shared",
                                                design=design)
                        gl = _cuda.banded8_rows(g, st, store="global",
                                                design=design)
                        torch.cuda.synchronize()
                        err, bad = diff_raw(g, st, gl, sh)
                        if g.piecewise != pw:
                            bad.append(f"piecewise {g.piecewise}, not {pw}")
                        need(f"(a) band {bw} {emit} pw{pw} {design}", err,
                             bad)
                        if bw != 2048:
                            continue
                        # the global store resumed in chunks of 1,024 rows
                        reg, state, parts = None, [st.us, st.es, st.qs,
                                                   st.ub], []
                        for c0 in range(0, g.T, 1024):
                            n = min(1024, g.T - c0)
                            r = _cuda.banded8_rows(g._replace(T=n), st._replace(
                                tseq=st.tseq[:, c0:c0 + n].contiguous(),
                                rby=st.rby[c0:c0 + n].contiguous(),
                                us=state[0], es=state[1], qs=state[2],
                                ub=state[3], reg=st.reg if reg is None else reg,
                                row0=c0), store="global", design=design)
                            parts.append(r)
                            state = (r["fin_planes"] + [None, None])[:3] \
                                + [r["fin_ub"]]
                            reg = r["fin_reg"]
                        torch.cuda.synchronize()
                        last = parts[-1]
                        joined = {k: (last[k] if k.startswith("fin")
                                      or last[k] is None else
                                      torch.cat([x[k] for x in parts], 0))
                                  for k in last}
                        err, bad = diff_raw(g, st, joined, sh)
                        need(f"(a) band {bw} {emit} pw{pw} {design} resumed",
                             err, bad)
            print(f"phase16 (a) band {bw}: 8 x {L} bp "
                  f"{['global', 'overlap', 'extend'][mode]}, every emit at "
                  f"piecewise 0/1/2, the narrow and the wide row: planes in "
                  f"device memory == shared memory"
                  f"{' (and resumed in chunks of 1,024 rows)' if bw == 2048 else ''}, "
                  f"max_abs_err=0")
        stamp16("a")

        # (b) the kernel against its plain version at band 32,768
        qs, ts = gen_pairs_fast(2, 32000, 0.10, SEED + 161)
        for pw, gaps, m_ in ((1, AFF, mtx), (2, ONT, m_ont)):
            g, st = operands(qs, ts, MODE_OVERLAP, 32768, gaps, "planes", m_)
            g = g._replace(T=64)
            st = st._replace(tseq=st.tseq[:, :64].contiguous(),
                             rby=st.rby[:64].contiguous())
            smem = _cuda.banded8_store_bytes(g.W, g.piecewise)
            err, bad, p_ms = compare(g, st)   # the wide row
            if g.piecewise != pw or smem <= _cuda.SMEM_MAX:
                bad.append(f"piecewise {g.piecewise}, narrow planes {smem} "
                           "bytes a block")
            need(f"(b) planes pw{pw}", err, bad)
            rk = _cuda.banded8_rows(g, st)
            rw = _cuda.banded8_rows(g, st, design="narrow")
            rn = _cuda.banded8_rows(g._replace(emit="none"), st)
            torch.cuda.synchronize()
            err, bad = diff_raw(g, st, rw, rk)
            need(f"(b) planes pw{pw}: the narrow row, planes in device "
                 "memory", err, bad)
            err, bad = diff_raw(g, st, rn, {k: rk[k] for k in (
                "fin_planes", "fin_ub", "fin_reg")})
            need(f"(b) none pw{pw} final state", err, bad)
            k_ms = timed_ms(lambda: _cuda.banded8_rows(g, st), 2)
            n_ms = timed_ms(lambda: _cuda.banded8_rows(
                g, st, design="narrow"), 2)
            print(f"phase16 (b) band 32768 (W=2048) pw{pw}, 2 x 32 kb, "
                  f"first {g.T} rows: planes and none == plain and the "
                  f"narrow row == the wide row, max_abs_err=0; planes "
                  f"kernel, wide row {k_ms:.3f} ms = {k_ms / g.T:.4f} ms per "
                  f"row, narrow row {n_ms:.3f} ms = {n_ms / g.T:.4f} ms per "
                  f"row; plain on "
                  f"the card {p_ms:.1f} ms")
        stamp16("b")

        def wide_align(label, n_t_q, seed, m_, gaps):
            """align_batch as the CLI calls it at its defaults (overlap,
            band roundup(qlen, 128)), with each result checked, and a
            one-shot scores-only forward over all rows holding the score
            and the end."""
            n, tl, ql = n_t_q
            qs, ts = wide_pairs(n, tl, ql, seed)
            bw = roundup(ql, 128)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics.reset()
            reset_counts()
            t0 = time.time()
            res = P.align_batch(qs, ts, MODE_OVERLAP, bw, m_, *gaps,
                                device=dev)
            torch.cuda.synchronize()
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            cnt, wcnt = a_counts()
            ctr = metrics.counters()
            pw = O.get_piecewise(*gaps, bw)
            T = roundup(tl, 128)
            per, Tc = P._launch_plan(n, T, bw // 16, pw, pw < 2)
            parts = ", ".join(f"{k} {c.seconds:.3f}s" for k, c in
                              sorted(ctr.items()))
            print(f"phase16 {label}: {n} x {tl} bp (query {ql}) at band "
                  f"{bw} pw{pw}, T={T}: {wall:.3f}s = {n / wall:.4f} pairs/s; "
                  f"launches {cnt} (the wide row {wcnt}), {per} pairs and "
                  f"{Tc} rows a launch "
                  f"(LAUNCH_BYTES {P.LAUNCH_BYTES}); {parts}; walk and the "
                  f"rest {wall - sum(c.seconds for c in ctr.values()):.3f}s; "
                  f"peak device memory {peak / 1e6:.1f} MB")
            mm = np.asarray(m_, np.int64)
            for b, (rs, cg) in enumerate(res):
                bad = check_alignment(qs[b], ts[b], rs, cg, mm, gaps, pw)
                if not (rs.mat > 0.8 * min(ql, tl) and cg):
                    bad.append(f"implausible alignment {rs}")
                need(f"{label} pair {b}", len(bad), bad)
            qpad, qlens, tpad, tlens, rby, _ = P._pack_batch(qs, ts, bw)
            us, es, q0, ub, _ = P._init_state(MODE_OVERLAP, bw, pw,
                                              int(m_.max()), int(m_.min()),
                                              *gaps, n)
            fr = K.make_forward(T, bw // 16, MODE_OVERLAP, pw, *gaps,
                                int(m_.max()), int(m_.min()),
                                scores_only=True, device=dev)(
                qpad, qlens, tpad, tlens, P._mtx5(m_), rby, us, es, q0, ub)
            base = P._base_results(fr, MODE_OVERLAP, bw // 16, tlens)
            for b, (rs, _) in enumerate(res):
                got = (base[b].score, base[b].qe + 1, base[b].te + 1)
                if got != (rs.score, rs.qe, rs.te):
                    need(f"{label} pair {b}", 1, [
                        f"one-shot scores-only (score, qe, te) {got}, the "
                        f"result {(rs.score, rs.qe, rs.te)}"])
            print(f"phase16 {label}: every CIGAR consumes its [qb, qe) x "
                  f"[tb, te) and re-scores to its score; a one-shot "
                  f"scores-only forward of {T} rows gives each score and end")
            return per, cnt, wcnt, qs, ts

        # (c) align at the CLI defaults: the two-pass route at band 32,000
        _, cnt_c, wcnt_c, qs_c, ts_c = wide_align(
            "(c) align defaults", WIDE_ALIGN, SEED + 162, mtx, AFF)
        stamp16("c")
        # (d) map-ont costs: planes and backcal at band 24,064
        per_d, cnt_d, wcnt_d, qs_d, ts_d = wide_align(
            "(d) align map-ont", WIDE_ONT, SEED + 163, m_ont, ONT)
        T = roundup(WIDE_ONT[1], 128)
        groups = -(-WIDE_ONT[0] // per_d)
        if groups < 2 or cnt_d["planes"] != groups * -(-T // P.T_CHUNK):
            raise RuntimeError(f"phase 16 (d): {groups} launch groups and "
                               f"{cnt_d['planes']} planes launches")
        stamp16("d")

        # (e) kernel B past 512 words, then edit -W 0 on 24 kb
        blk_err, blk_plain_ms, cl_err = edit_block_rows("phase16 (e)")
        cl_err = max(cl_err, edit_cluster_rows("phase16 (e)"))
        n, tl, ql = WIDE_EDIT
        qs, ts = wide_pairs(n, tl, ql, SEED + 165)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        res = D.edit_batch(qs, ts, MODE_GLOBAL, 0, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _cuda.edit_launches
        if _cuda.edit_block_launches != launches:
            raise RuntimeError(f"phase 16 (e): {launches} launches, "
                               f"{_cuda.edit_block_launches} of the block "
                               "row")
        T = roundup(tl, 128)
        per = D._launch_pairs(T, 752)
        print(f"phase16 (e) edit_batch -W 0: {n} x {tl} bp (query {ql}, NW "
              f"752, T={T}): {wall:.3f}s = {n / wall:.4f} pairs/s, "
              f"{launches} launches of at most {per} pairs (LAUNCH_BYTES "
              f"{D.LAUNCH_BYTES}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
        if launches < 2 or launches != -(-n // per):
            raise RuntimeError(f"phase 16 (e): {launches} launches")
        for b, (rs, cg) in enumerate(res):
            if not (cg and rs.qe == ql and rs.te == tl
                    and 0 < rs.score < tl // 2):
                raise RuntimeError(f"phase 16 (e) pair {b}: implausible "
                                   f"alignment {rs}")
        (proc, t_cpu0), kmer_cpu = edit_cpu
        t_wait = time.time()
        try:
            cpu_out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise RuntimeError("phase 16 (e): the CPU edit outlived 600 s")
        if proc.returncode != 0:
            raise RuntimeError(f"phase 16 (e): edit --device cpu returned "
                               f"{proc.returncode}: {err[-500:]}")
        card = CLI._fmt_pairwise("q0", "t0", qs[0], ts[0], *res[0])
        if card != cpu_out:
            raise RuntimeError("phase 16 (e): pair 0 differs between the "
                               "card and the CPU")
        print(f"phase16 (e) pair 0: TSV == edit --device cpu (the CPU "
              f"process ran {time.time() - t_cpu0:.1f}s beside the card, "
              f"{time.time() - t_wait:.1f}s of it waited for here)")
        qs_e, ts_e, per_e, cnt_e = qs, ts, per, launches

        # past EDIT_BLOCK_MAX_NW: edit -m kmer of reads against the contigs
        # they start, the tails after the last anchor on the cluster row
        # (NW 4,192) and its sweep (past 65,536 words)
        qs, ts = contig_pairs(*WIDE_EDIT_KMER, SEED + 168)
        tails, real_bucket = [], D._edit_bucket

        def spy(qseqs, tseqs, mode, bw, banded, device):
            if bw // 32 > _cuda.EDIT_BLOCK_MAX_NW:
                tails.append((qseqs, tseqs, mode, bw, banded))
            return real_bucket(qseqs, tseqs, mode, bw, banded, device)
        D._edit_bucket = spy
        try:
            reset_counts()
            t0 = time.time()
            res = D.kmer_edit_batch(13, qs, ts, device=dev)
            torch.cuda.synchronize()
            wall = time.time() - t0
            cnt_c, cnt_w = _cuda.edit_cluster_launches, \
                _cuda.edit_sweep_launches
            cnt_all = _cuda.edit_launches
        finally:
            D._edit_bucket = real_bucket
        if cnt_c - cnt_w < 1 or cnt_w < 1 or len(tails) != 2:
            raise RuntimeError(f"phase 16 (e) kmer: {cnt_c} launches of the "
                               f"cluster row, {cnt_w} of its sweep, "
                               f"{len(tails)} buckets past NW "
                               f"{_cuda.EDIT_BLOCK_MAX_NW}")
        for b, (rs, cg) in enumerate(res):
            if not (cg and rs.qb == 0 and rs.mat > 0.6 * WIDE_EDIT_KMER[0]):
                raise RuntimeError(f"phase 16 (e) kmer pair {b}: "
                                   f"implausible alignment {rs}")
        card = "".join(CLI._fmt_pairwise(f"q{b}", f"t{b}", qs[b], ts[b], rs,
                                         cg) if rs.mat else ""
                       for b, (rs, cg) in enumerate(res))
        proc, t_cpu0 = kmer_cpu
        t_wait = time.time()
        try:
            cpu_out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise RuntimeError("phase 16 (e): the CPU edit -m kmer outlived "
                               "900 s")
        if proc.returncode != 0 or card != cpu_out:
            raise RuntimeError(f"phase 16 (e) kmer: edit --device cpu "
                               f"returned {proc.returncode}, TSVs "
                               f"{'equal' if card == cpu_out else 'differ'}: "
                               f"{err[-500:]}")
        print(f"phase16 (e) edit -m kmer: {len(qs)} reads of "
              f"{sum(WIDE_EDIT_KMER[:2])} bp whose first "
              f"{WIDE_EDIT_KMER[0]} start contigs of "
              f"{', '.join(str(c) for c in WIDE_EDIT_KMER[2])} bp: "
              f"{wall:.3f}s, {cnt_all} edit launches, {cnt_c} of the "
              f"cluster row ({cnt_w} of them the sweep); every TSV == edit "
              f"--device cpu -m kmer's (the CPU process ran "
              f"{time.time() - t_cpu0:.1f}s beside the card, "
              f"{time.time() - t_wait:.1f}s of it waited for here)")
        kmer_rows = {}
        for sq, st_, smode, sbw, sbanded in tails:
            g, ops = edit_operands(sq, st_, smode, sbw, sbanded)
            err, bad, p_ms, _ = edit_compare(g, ops)
            geo = _cuda.edit_cluster_default(g.NW, len(sq), dev)
            key = "edit_sweep" if geo[3] > 1 else "edit_cluster"
            if bad:
                raise RuntimeError(f"phase 16 (e) kmer tail at NW {g.NW}, "
                                   "the cluster row: " + "; ".join(bad[:8]))
            c_ms = timed_ms(lambda: _cuda.edit_rows(g, ops), 3)
            b_ms, b_by, b_text = bound(edit_bytes(g, ops), int(
                ops.tlen.sum()) * g.NW * EDIT_OPS_PER_WORD_ROW)
            print(f"phase16 (e) kmer tails: {len(sq)} pairs at NW {g.NW}, "
                  f"T={g.T}, {['global', 'overlap', 'extend'][smode]}, the "
                  f"cluster row {geo}{' (the sweep)' if geo[3] > 1 else ''}: "
                  f"against plain max_abs_err={err}, kernel {c_ms:.3f} ms = "
                  f"{c_ms / g.T * 1e3:.3f} us a row, plain on the card "
                  f"{p_ms:.1f} ms; bound {b_ms:.4f} ms by {b_by} ({b_text})")
            kmer_rows[key] = dict(
                ms=c_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                launches=cnt_w if key == "edit_sweep" else cnt_c - cnt_w,
                err=max(err, cl_err))
            del ops
        if sorted(kmer_rows) != ["edit_cluster", "edit_sweep"]:
            raise RuntimeError(f"phase 16 (e) kmer: tails of "
                               f"{sorted(kmer_rows)}")
        stamp16("e")

        # (f) kernel C past bw 1,022, then poa -G editbw=4096
        pw_row = pedit_block_rows("phase16 (f)")
        win = gen_poa_window(np.random.default_rng(SEED + 167))
        with tempfile.TemporaryDirectory() as tmp:
            fa = os.path.join(tmp, "w.fa")
            with open(fa, "w") as f:
                f.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(win)))
            outs = []
            for d in ("cuda", "cpu"):
                reset_counts()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = CLI.main(["poa", "--device", d, "-G", "editbw=4096",
                                   fa])
                if rc != 0:
                    raise RuntimeError(f"phase 16 (f): poa --device {d} "
                                       f"returned {rc}")
                if d == "cuda":
                    cnt_f = _cuda.pedit_block_launches
                    if cnt_f < 1:
                        raise RuntimeError("phase 16 (f): no launch of the "
                                           "block row")
                outs.append(buf.getvalue())
        if outs[0] != outs[1] or outs[0].count("\n") < 20:
            raise RuntimeError("phase 16 (f): poa -G editbw=4096 differs "
                               "between cuda and cpu")
        print(f"phase16 (f) poa -G editbw=4096 (pedit band 2048): --device "
              f"cuda == --device cpu ({outs[0].count(chr(10))} lines; "
              f"{cnt_f} launches of the block row on the card)")
        stamp16("f")

        # (g) cat: a join that needs the 4x retry at band 32,768
        from bsalign_tpu_torch.poa import cat as CAT
        text, expect = gen_wide_cat(SEED + 168)
        calls = []
        real = CAT.align_batch

        def recording(qs_, ts_, *a, **k):
            out = real(qs_, ts_, *a, **k)
            rs, cg = out[0]   # cat moves rs to the pieces' coordinates
            calls.append((qs_[0], ts_[0], a[1],
                           (dataclasses.replace(rs), list(cg))))
            return out
        with tempfile.TemporaryDirectory() as tmp:
            fa = os.path.join(tmp, "pieces.fa")
            with open(fa, "w") as f:
                f.write(text)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            CAT.align_batch = recording
            try:
                t0 = time.time()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = CLI.main(["cat", "--device", "cuda", fa])
                torch.cuda.synchronize()
                wall = time.time() - t0
            finally:
                CAT.align_batch = real
        if rc != 0:
            raise RuntimeError(f"phase 16 (g): cat returned {rc}")
        seq = "".join(buf.getvalue().splitlines()[1:])
        bands = [c[2] for c in calls]
        print(f"phase16 (g) cat of 2 pieces of {WIDE_CAT[0]} bp, stated "
              f"overlap {WIDE_CAT[2]}, real {WIDE_CAT[1]}: {wall:.3f}s, "
              f"joins at bands {bands}, kernel A launches {a_counts()[0]} "
              f"(the wide row {a_counts()[1]}); consensus "
              f"{len(seq)} bp ({expect} expected); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
        if bands != [roundup(WIDE_CAT[2], 16), roundup(4 * WIDE_CAT[2], 16)]:
            raise RuntimeError(f"phase 16 (g): joins at bands {bands}")
        if "N" in seq or abs(len(seq) - expect) > 0.005 * expect:
            raise RuntimeError(f"phase 16 (g): implausible consensus of "
                               f"{len(seq)} bp")
        q, t, _, (rs, cg) = calls[-1]
        bad = check_alignment(q, t, rs, cg, np.asarray(mtx, np.int64), AFF,
                              1)
        need("(g) the retried join", len(bad), bad)
        print(f"phase16 (g) the retried join's CIGAR consumes its [qb, qe) "
              f"x [tb, te) and re-scores to its score {rs.score}")
        stamp16("g")

        # (h) the wide instantiations at their main-path launch shapes:
        # time (one launch after a warm-up) and bound; launches of (c)-(g)
        def a_launch(label, qs, ts, bw, gaps, m_, emit, ops, launches):
            g, st = operands(qs, ts, MODE_OVERLAP, bw, gaps, emit, m_)
            g = g._replace(T=P.T_CHUNK)
            st = st._replace(tseq=st.tseq[:, :P.T_CHUNK].contiguous(),
                             rby=st.rby[:P.T_CHUNK].contiguous())
            ms = timed_ms(lambda: _cuda.banded8_rows(g, st), 1)
            n_ms = timed_ms(lambda: _cuda.banded8_rows(
                g, st, design="narrow"), 1)
            nb, cells = banded8_work(g, st, _cuda.banded8_rows(g, st))
            b_ms, b_by, b_text = bound(nb, cells * ops)
            print(f"phase16 (h) kernel A {label}: {len(qs)} pairs x "
                  f"{g.T} rows at band {bw} (W={g.W}, pw{g.piecewise}): the "
                  f"wide row {ms:.3f} ms = {ms / g.T:.4f} ms per row, "
                  f"{cells / (ms / 1e3):.4g} cells/s; the narrow row (planes "
                  f"in device memory) {n_ms:.3f} ms = {n_ms / g.T:.4f} ms per "
                  f"row ({n_ms / ms:.1f}x); launches {launches}; bound "
                  f"{b_ms:.4f} ms by {b_by} ({b_text})")
            return dict(ms=ms, narrow_ms=n_ms, bound_ms=b_ms, bound_by=b_by,
                        launches=launches)
        bw_c = roundup(WIDE_ALIGN[2], 128)
        rows = dict(
            wide_none=a_launch("none, (c)'s chunk", qs_c, ts_c, bw_c, AFF,
                               mtx, "none", BANDED8_NONE_OPS_PER_CELL,
                               wcnt_c["none"]),
            wide_codes=a_launch("codes, (c)'s chunk", qs_c, ts_c, bw_c, AFF,
                                mtx, "codes", BANDED8_OPS_PER_CELL,
                                wcnt_c["codes"]),
            wide_planes=a_launch("planes, (d)'s chunk", qs_d[:per_d],
                                 ts_d[:per_d], roundup(WIDE_ONT[2], 128), ONT,
                                 m_ont, "planes", BANDED8_PLANES_OPS_PER_CELL,
                                 wcnt_d["planes"]))
        if min(r["launches"] for r in rows.values()) < 1:
            raise RuntimeError(f"phase 16: the wide row launched "
                               f"{ {k: r['launches'] for k, r in rows.items()} } "
                               "times in (c) and (d)")
        g, ops = edit_operands(qs_e[:per_e], ts_e[:per_e], MODE_GLOBAL,
                               32 * 752, False)
        ms = timed_ms(lambda: _cuda.edit_rows(g, ops), 1)
        c_ms = timed_ms(lambda: _cuda.edit_rows(g, ops, design="cluster"), 1)
        same = edit_same(ops, *(_cuda.edit_rows(g, ops, design=d)
                                for d in ("block", "cluster")))
        nrows = int(ops.tlen.sum())
        b_ms, b_by, b_text = bound(edit_bytes(g, ops),
                                   nrows * g.NW * EDIT_OPS_PER_WORD_ROW)
        bk, bnw = _cuda.edit_block_geometry(g.NW)
        print(f"phase16 (h) kernel B block row (K {bk}, {bnw} warps), (e)'s "
              f"launch: {per_e} pairs x {g.T} rows at NW {g.NW}: {ms:.3f} ms "
              f"= {ms / g.T * 1e3:.3f} us a row, "
              f"{nrows * g.bw / (ms / 1e3):.4g} cells/s; the cluster row "
              f"{_cuda.edit_cluster_default(g.NW, per_e, dev)} {c_ms:.3f} "
              f"ms = {c_ms / g.T * 1e3:.3f} us a row ({c_ms / ms:.2f}x); "
              f"outputs "
              f"equal: {same}; launches {cnt_e} in (e); bound {b_ms:.4f} ms "
              f"by {b_by} ({b_text})")
        del ops
        if not same:
            raise RuntimeError("phase 16 (h): the block and cluster rows "
                               "differ at (e)'s launch")
        rows["edit_block"] = dict(ms=ms, plain_ms=blk_plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, launches=cnt_e, err=blk_err)
        rows.update(kmer_rows)
        rows["pedit_block"] = dict(pw_row, launches=cnt_f)
        rows["worst"] = worst
        stamp16("h")
        stamp(16)
        return rows


    def phase17():
        """Kernel A's wide row against the narrow row at bands 512, 2,048,
        16,384 and 32,000 in every emit and piecewise, against the plain
        version at band 512, on an adversarial state that makes it replay
        rows; then both rows' time per row at W 8 to 2,000 (the crossover).
        Returns the wide row's largest error and the plain version's ms by
        emit."""
        t17 = time.time()
        GAPS = {0: (0, -4, 0, 0), 1: (-3, -2, 0, 0), 2: (-4, -2, -24, -1)}
        m_ont = O.set_score_matrix(2, -4)
        worst, replays, plain_ms = 0, 0, {}

        def need(label, err, bad):
            nonlocal worst
            worst = max(worst, err)
            if bad:
                raise RuntimeError(f"phase 17 {label}: " + "; ".join(bad[:8]))

        def cut(qs, ts, mode, bw, pw, emit, T):
            g, st = operands(qs, ts, mode, bw, GAPS[pw], emit,
                             m_ont if pw == 2 else mtx)
            if g.piecewise != pw:
                raise RuntimeError(f"phase 17: piecewise {g.piecewise} at "
                                   f"band {bw}, not {pw}")
            T = min(T, g.T)
            return g._replace(T=T), st._replace(
                tseq=st.tseq[:, :T].contiguous(), rby=st.rby[:T].contiguous())

        def wide(g, st):
            nonlocal replays
            out = _cuda.banded8_rows(g, st, design="wide",
                                     count_replays=True)
            replays += int(out.pop("replays").sum())
            return out

        def combos():
            return [(pw, emit) for pw in (0, 1, 2)
                    for emit in ("codes", "planes", "none")
                    if not (emit == "codes" and pw == 2)]

        # (a) the wide row == the narrow row; 3 pairs, the last short (it
        # freezes early) and its query short
        for bw, L, T, mode in ((512, 700, 800, MODE_GLOBAL),
                               (2048, 2600, 600, MODE_OVERLAP),
                               (16384, 17000, 256, MODE_EXTEND),
                               (32000, 33000, 128, MODE_OVERLAP)):
            qs, ts = gen_pairs_fast(3, L, 0.10, SEED + 170 + bw % 89)
            qs[2], ts[2] = qs[2][:L // 2], ts[2][:min(L // 3, T // 2)]
            for pw, emit in combos():
                g, st = cut(qs, ts, mode, bw, pw, emit, T)
                rw = wide(g, st)
                rn = _cuda.banded8_rows(g, st, design="narrow")
                torch.cuda.synchronize()
                need(f"(a) band {bw} {emit} pw{pw}", *diff_raw(g, st, rw, rn))
            print(f"phase17 (a) band {bw} (W={bw // 16}, "
                  f"{['global', 'overlap', 'extend'][mode]}), 3 pairs x "
                  f"{min(T, g.T)} rows, every emit at piecewise 0/1/2: the "
                  f"wide row == the narrow row, max_abs_err=0")
        # (b) the wide row == the plain version at a small band
        qs, ts = gen_pairs(3, 700, 0.10, SEED + 171)
        qs[2] = qs[2][:300]
        for k, (pw, emit) in enumerate(combos()):
            mode = (MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND)[k % 3]
            g, st = cut(qs, ts, mode, 512, pw, emit, 400)
            rw = wide(g, st)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rp = K.forward_plain(g, st)
            e1.record()
            torch.cuda.synchronize()
            need(f"(b) {emit} pw{pw} vs plain", *diff_raw(g, st, rw, rp))
            plain_ms[emit] = e0.elapsed_time(e1)
            print(f"phase17 (b) band 512 (W=32) "
                  f"{['global', 'overlap', 'extend'][mode]} {emit} pw{pw}, 3 "
                  f"pairs x {g.T} rows: the wide row == plain, "
                  f"max_abs_err=0; plain on the card {plain_ms[emit]:.1f} ms")
        # (c) an adversarial state (random planes that drive f and g to the
        # clamp at 127): rows replay, and the outputs still agree
        rng = np.random.default_rng(SEED + 172)
        before = replays
        for pw, emit in ((1, "codes"), (2, "planes"), (0, "none")):
            g, st = cut(qs, ts, MODE_OVERLAP, 512, pw, emit, 48)
            shp = tuple(st.us.shape)

            def rnd(lo, hi):
                return torch.as_tensor(rng.integers(lo, hi, shp).astype(
                    np.int32), device=dev)
            st = st._replace(us=rnd(-128, -60),
                             es=rnd(20, 128) if pw >= 1 else None,
                             qs=rnd(20, 128) if pw == 2 else None)
            rw = wide(g, st)
            rn = _cuda.banded8_rows(g, st, design="narrow")
            rp = K.forward_plain(g, st)
            torch.cuda.synchronize()
            need(f"(c) adversarial {emit} pw{pw} vs narrow",
                 *diff_raw(g, st, rw, rn))
            need(f"(c) adversarial {emit} pw{pw} vs plain",
                 *diff_raw(g, st, rw, rp))
        if replays == before:
            raise RuntimeError("phase 17 (c): the adversarial state replayed "
                               "no row")
        print(f"phase17 (c) adversarial state, 3 pairs x 48 rows in 3 emits: "
              f"{replays - before} rows replayed, the wide row == narrow == "
              f"plain, max_abs_err=0")
        # (d) the crossover: microseconds per row of both rows, overlap,
        # piecewise 1, codes, 256 rows, at two batch sizes
        print(f"phase17 (d) crossover, us per row (256 rows, codes, pw1; "
              f"{smi_line}):")
        cross = {}
        for W in (8, 16, 32, 64, 128, 256, 1024, 2000):
            bw = 16 * W
            line = []
            for B in (8, 256):
                qs, ts = gen_pairs_fast(B, bw + 1000, 0.10, SEED + 173 + W)
                g, st = cut(qs, ts, MODE_OVERLAP, bw, 1, "codes", 256)
                n_ms = timed_ms(lambda: _cuda.banded8_rows(
                    g, st, design="narrow"), 3)
                w_ms = timed_ms(lambda: _cuda.banded8_rows(
                    g, st, design="wide"), 3)
                cross[(W, B)] = (n_ms, w_ms)
                line.append(f"B={B}: narrow {n_ms / g.T * 1e3:.3f}, wide "
                            f"{w_ms / g.T * 1e3:.3f} ({n_ms / w_ms:.2f}x)")
                del st
            print(f"phase17 (d) W={W}: " + "; ".join(line))
        faster = [W for W in (8, 16, 32, 64, 128, 256, 1024, 2000)
                  if all(cross[(W, B)][1] < cross[(W, B)][0]
                         for B in (8, 256))]
        print(f"phase17 (d) the wide row is faster at both batch sizes at W "
              f"{faster}; WIDE_W = {_cuda.WIDE_W}")
        print(f"phase17 replayed rows over the whole phase: {replays}")
        print(f"phase17 done at {time.time() - t_start:.1f}s "
              f"({time.time() - t17:.1f}s)")
        return worst, plain_ms

    if "--wide" in sys.argv[1:]:
        # phases 16 and 17 alone
        try:
            phase16(edit_cpu)
            phase17()
        except RuntimeError as e:
            return fail(str(e))
        err = ptxas_check(ptxas_wait)
        if err:
            return fail(err)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    if "--kernels" in sys.argv[1:]:
        # kernels B and C alone: phase 5, the edit kernel at its main-path
        # shape, phase 7; each kernel's time beside its plain version's;
        # then both block rows (phase 16 (e), (f) and (h)'s kernel parts)
        try:
            e_err = phase5()
            qs, ts = gen_pairs(512, 2000, 0.10, SEED + 20)
            _, err, e_ms, e_plain, e_bound, e_by = edit_main_kernel(qs, ts)
            _, p_err, p_ms, p_plain, p_bound, p_by, _ = phase7()
            edit_block_rows("kernels")
            edit_cluster_rows("kernels")
            pedit_block_rows("kernels")
            crossovers()
            n, tl, ql = WIDE_EDIT
            qs, ts = wide_pairs(n, tl, ql, SEED + 165)
            per = D._launch_pairs(roundup(tl, 128), 752)
            g, ops = edit_operands(qs[:per], ts[:per], MODE_GLOBAL, 32 * 752,
                                   False)
            ms = timed_ms(lambda: _cuda.edit_rows(g, ops), 1)
            c_ms = timed_ms(lambda: _cuda.edit_rows(g, ops,
                                                    design="cluster"), 1)
            k8_ms = timed_ms(lambda: _cuda.edit_rows(
                g, ops, design="block", geometry=(8, 3)), 1)
            print(f"kernels kernel B at (e)'s launch ({per} pairs x {g.T} "
                  f"rows, NW 752): block row {ms:.3f} ms = "
                  f"{ms / g.T * 1e3:.3f} us a row (3 warps of 8 words: "
                  f"{k8_ms / g.T * 1e3:.3f}); cluster row "
                  f"{_cuda.edit_cluster_default(752, per, dev)} {c_ms:.3f} "
                  f"ms = "
                  f"{c_ms / g.T * 1e3:.3f} us a row")
            del ops
        except RuntimeError as e:
            return fail(str(e))
        print(f"kernel edit_rows, 256 pairs x 2 kb at NW 64: {e_ms:.4f} ms, "
              f"plain on the card {e_plain:.1f} ms, bound {e_bound:.4f} ms "
              f"by {e_by}, max_abs_err={max(e_err, err)}")
        print(f"kernel pedit_rows, round 1 of 128 windows at band 32: "
              f"{p_ms:.4f} ms, plain on the card {p_plain:.1f} ms, bound "
              f"{p_bound:.4f} ms by {p_by}, max_abs_err={p_err}")
        err = ptxas_check(ptxas_wait)
        return fail(err) if err else 0

    # ---- phase 2: kernel against the plain version on the card ----
    cases = [
        ("64x1kb band128 global pw1", 64, 1000, 128, MODE_GLOBAL,
         (-3, -2, 0, 0), 1),
        ("64x1kb band128 overlap pw1", 64, 1000, 128, MODE_OVERLAP,
         (-3, -2, 0, 0), 2),
        ("64x1kb band128 extend pw0", 64, 1000, 128, MODE_EXTEND,
         (0, -4, 0, 0), 3),
        ("8x600bp band640 overlap pw1", 8, 600, 640, MODE_OVERLAP,
         (-3, -2, 0, 0), 4),
    ]
    max_err = 0
    for label, n, L, bw, mode, gaps, s in cases:
        qs, ts = gen_pairs(n, L, 0.10, SEED + s)
        g, st = operands(qs, ts, mode, bw, gaps)
        err, bad, p_ms = compare(g, st)
        max_err = max(max_err, err)
        k_ms = timed_ms(lambda: _cuda.banded8_rows(g, st), 5)
        print(f"phase2 {label}: W={g.W} T={g.T} max_abs_err={err}; "
              f"kernel {k_ms:.3f} ms, plain on the card {p_ms:.1f} ms")
        if bad:
            return fail(f"phase 2 {label}: kernel disagrees with plain: "
                        + "; ".join(bad))
    # bands whose stripes fill no whole group of 8 (W = 1, 3, 9), every emit
    for W, mode, gaps, m_ in ((1, MODE_GLOBAL, (-3, -2, 0, 0), mtx),
                              (3, MODE_OVERLAP, (0, -4, 0, 0), mtx),
                              (9, MODE_EXTEND, (-4, -2, -24, -1),
                               O.set_score_matrix(2, -4))):
        qs, ts = gen_pairs(16, 300, 0.10, SEED + 7 + W)
        qs[-1] = qs[-1][:37]   # a short query in the batch's last pair
        for emit in ("codes", "planes", "none"):
            g, st = operands(qs, ts, mode, 16 * W, gaps, emit, m_)
            if emit == "codes" and g.piecewise == 2:
                continue
            err, bad, _ = compare(g, st)
            max_err = max(max_err, err)
            print(f"phase2 16x300bp band{16 * W} {emit} pw{g.piecewise}: "
                  f"W={W} T={g.T} max_abs_err={err}")
            if bad:
                return fail(f"phase 2 band {16 * W} {emit}: kernel disagrees "
                            "with plain: " + "; ".join(bad))
    # global steering past the band (qlen >> tlen at band 16): full reset
    rng = np.random.default_rng(SEED + 6)
    qs = [rng.integers(0, 4, L).astype(np.uint8) for L in (800, 900, 700)]
    ts = [rng.integers(0, 4, L).astype(np.uint8) for L in (40, 45, 30)]
    g, st = operands(qs, ts, MODE_GLOBAL, 16, (-3, -2, 0, 0))
    err, bad, _ = compare(g, st)
    max_err = max(max_err, err)
    print(f"phase2 3 pairs band16 global full band reset: max_abs_err={err}")
    if bad:
        return fail("phase 2 full reset: kernel disagrees with plain: "
                    + "; ".join(bad))
    stamp(2)

    # ---- phase 3: the main path ----
    gaps = (-3, -2, 0, 0)
    bw = 128
    qs, ts = gen_pairs(512, 2000, 0.10, SEED)
    g_main, st_main = operands(qs[:P.DEVICE_CHUNK], ts[:P.DEVICE_CHUNK],
                               MODE_GLOBAL, bw, gaps)
    err, bad, plain_ms = compare(g_main, st_main)
    max_err = max(max_err, err)
    if bad:
        return fail("phase 3 chunk: kernel disagrees with plain: "
                    + "; ".join(bad))
    kernel_ms = timed_ms(lambda: _cuda.banded8_rows(g_main, st_main), 5)
    b_bytes, cells = banded8_work(g_main, st_main,
                                  _cuda.banded8_rows(g_main, st_main))
    b8_bound_ms, b8_bound_by, b8_bound_text = bound(
        b_bytes, cells * BANDED8_OPS_PER_CELL)
    print(f"phase3 kernel: {kernel_ms:.3f} ms per launch of "
          f"{P.DEVICE_CHUNK} pairs (T={g_main.T}, W={g_main.W}), "
          f"{cells / (kernel_ms / 1e3):.4g} cells/s; plain on the card "
          f"{plain_ms:.1f} ms; bound {b8_bound_ms:.4f} ms by {b8_bound_by} "
          f"({b8_bound_text})")

    try:
        split_line(f"codes {P.DEVICE_CHUNK}x2kb band128 pw1", g_main,
                   st_main, kernel_ms)
    except RuntimeError as e:
        return fail(f"phase 3 {e}")

    torch.cuda.synchronize()
    metrics.reset()
    reset_counts()
    t0 = time.time()
    res_gpu = P.align_batch(qs, ts, MODE_GLOBAL, bw, mtx, *gaps, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    launches = _cuda.launches_codes
    print(f"phase3 align_batch: 512 pairs in {e2e_s:.3f}s = "
          f"{512 / e2e_s:.2f} pairs/s, kernel launches {launches}")
    for nm, c in sorted(metrics.counters().items()):
        print(f"phase3 counter {nm}: {c.cells:.6g} units in {c.seconds:.4f}s "
              f"over {c.calls} calls")
    if launches < 2:
        return fail(f"main path launched the kernel {launches} times (< 2)")
    if len(res_gpu) != 512:
        return fail(f"align_batch returned {len(res_gpu)} results")
    for b, (rs, cg) in enumerate(res_gpu):
        if not (rs.mat > 0 and rs.aln > 0 and cg and rs.qe == len(qs[b])
                and rs.te == len(ts[b])):
            return fail(f"pair {b}: implausible global alignment {rs}")

    def tsv(results, idx, qs, ts):
        return "".join(CLI._fmt_pairwise(f"q{b}", f"t{b}", qs[b], ts[b],
                                         rs, cg)
                       for b, (rs, cg) in zip(idx, results))

    t0 = time.time()
    res_cpu = P.align_batch(qs[:32], ts[:32], MODE_GLOBAL, bw, mtx, *gaps,
                            device="cpu")
    cpu_s = time.time() - t0
    if tsv(res_gpu[:32], range(32), qs, ts) != tsv(res_cpu, range(32), qs,
                                                   ts):
        return fail("phase 3: TSV of the first 32 pairs differs from the "
                    "CPU path")
    print(f"phase3 TSV of 32 pairs == CPU path ({cpu_s:.1f}s on the CPU)")
    stamp(3)

    # ---- phase 4: band 2048 at the CLI defaults ----
    gaps = (-3, -2, 0, 0)
    qs, ts = gen_pairs(16, 2000, 0.10, SEED + 5)
    buckets = {}
    for i, q in enumerate(qs):
        buckets.setdefault(roundup(len(q), 128), []).append(i)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    res4 = [None] * len(qs)
    for b4, idxs in buckets.items():
        out = P.align_batch([qs[i] for i in idxs], [ts[i] for i in idxs],
                            MODE_OVERLAP, b4, mtx, *gaps, device=dev)
        for i, r in zip(idxs, out):
            res4[i] = r
    torch.cuda.synchronize()
    t4 = time.time() - t0
    cnt4, wide4 = a_counts()
    print(f"phase4 band(s) {sorted(buckets)}: 16 pairs in {t4:.3f}s; kernel "
          f"A launches {cnt4} (the wide row {wide4})")
    check = [i for i in range(len(qs)) if roundup(len(qs[i]), 128) == 2048]
    if not check:
        return fail("phase 4: no pair lands in the band-2048 bucket")
    if wide4["codes"] < 1:
        return fail("phase 4: the wide row never launched at band 2048")
    g4, st4 = operands([qs[i] for i in check], [ts[i] for i in check],
                       MODE_OVERLAP, 2048, gaps)
    w4 = timed_ms(lambda: _cuda.banded8_rows(g4, st4), 3)
    n4 = timed_ms(lambda: _cuda.banded8_rows(g4, st4, design="narrow"), 3)
    print(f"phase4 kernel A at the band-2048 launch ({len(check)} pairs x "
          f"{g4.T} rows, W=128): the wide row {w4:.3f} ms = "
          f"{w4 / g4.T * 1e3:.3f} us per row, the narrow row {n4:.3f} ms = "
          f"{n4 / g4.T * 1e3:.3f} us per row ({n4 / w4:.1f}x)")
    check = check[:2]
    cpu4 = P.align_batch([qs[i] for i in check], [ts[i] for i in check],
                         MODE_OVERLAP, 2048, mtx, *gaps, device="cpu")
    if tsv([res4[i] for i in check], check, qs, ts) != tsv(cpu4, check, qs,
                                                           ts):
        return fail("phase 4: band-2048 TSV differs from the CPU path")
    print(f"phase4 band 2048 pairs {check} == CPU path")
    stamp(4)

    # ---- phase 5: the edit kernel against its plain version ----
    try:
        edit_err = phase5()
    except RuntimeError as e:
        return fail(str(e))

    # ---- phase 6: the edit main path ----
    qs, ts = gen_pairs(512, 2000, 0.10, SEED + 20)
    try:
        main_idx, err, edit_ms, edit_plain_ms, edit_bound_ms, \
            edit_bound_by = edit_main_kernel(qs, ts)
    except RuntimeError as e:
        return fail(str(e))
    edit_err = max(edit_err, err)

    torch.cuda.synchronize()
    metrics.reset()
    reset_counts()
    t0 = time.time()
    res_e = D.edit_batch(qs, ts, MODE_GLOBAL, 0, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    edit_launches = _cuda.edit_launches
    print(f"phase6 edit_batch: 512 pairs in {e2e_s:.3f}s = "
          f"{512 / e2e_s:.2f} pairs/s, edit kernel launches {edit_launches}, "
          f"banded-8 launches {_cuda.launches_codes}")
    for nm, c in sorted(metrics.counters().items()):
        print(f"phase6 counter {nm}: {c.cells:.6g} cells in {c.seconds:.4f}s "
              f"over {c.calls} calls ({c.cells_per_s:.4g} cells/s)")
    if edit_launches < 2:
        return fail(f"edit main path launched the kernel {edit_launches} "
                    "times (< 2)")
    if len(res_e) != 512:
        return fail(f"edit_batch returned {len(res_e)} results")
    for b, (rs, cg) in enumerate(res_e):
        if not (rs.mat > 0 and cg and rs.qe == len(qs[b])
                and rs.te == len(ts[b]) and 0 < rs.score < len(ts[b]) // 3):
            return fail(f"pair {b}: implausible global edit alignment {rs}")

    def check_cpu(label, res, idx, qs, ts, run_cpu):
        t0 = time.time()
        cpu = run_cpu([qs[i] for i in idx], [ts[i] for i in idx])
        if tsv([res[i] for i in idx], idx, qs, ts) != tsv(cpu, idx, qs, ts):
            raise RuntimeError(f"phase 6 {label}: TSV of pairs {list(idx)} "
                               "differs from the CPU path")
        print(f"phase6 {label}: TSV of {len(idx)} pairs == CPU path "
              f"({time.time() - t0:.1f}s on the CPU)")

    try:
        check_cpu("-W 0", res_e, list(range(32)), qs, ts, lambda q, t:
                  D.edit_batch(q, t, MODE_GLOBAL, 0, device="cpu"))
        torch.cuda.synchronize()
        t0 = time.time()
        res_w = D.edit_batch(qs, ts, MODE_GLOBAL, 128, device=dev)
        torch.cuda.synchronize()
        t_w = time.time() - t0
        print(f"phase6 edit_batch -W 128: 512 pairs in {t_w:.3f}s = "
              f"{512 / t_w:.2f} pairs/s")
        check_cpu("-W 128", res_w, list(range(4)), qs, ts, lambda q, t:
                  D.edit_batch(q, t, MODE_GLOBAL, 128, device="cpu"))
        qk, tk = gen_pairs(64, 10000, 0.10, SEED + 21)
        torch.cuda.synchronize()
        t0 = time.time()
        res_k = D.kmer_edit_batch(13, qk, tk, device=dev)
        torch.cuda.synchronize()
        t_k = time.time() - t0
        print(f"phase6 kmer_edit_batch k 13: 64 x 10 kb pairs in {t_k:.3f}s "
              f"= {64 / t_k:.2f} pairs/s")
        check_cpu("kmer", res_k, list(range(4)), qk, tk, lambda q, t:
                  D.kmer_edit_batch(13, q, t, device="cpu"))
    except RuntimeError as e:
        return fail(str(e))
    stamp(6)

    # ---- phase 7: the pedit kernel against its plain version ----
    try:
        windows, pedit_err, pedit_ms, pedit_plain_ms, pedit_bound_ms, \
            pedit_bound_by, main_jobs = phase7()
    except RuntimeError as e:
        return fail(str(e))


    # ---- phase 8: the poa main path ----
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    res_p = PB.run_windows_lockstep(windows, BSPOAPar(), device=dev,
                                    want_msa=True)
    torch.cuda.synchronize()
    t_p = time.time() - t0
    pedit_launches = _cuda.pedit_launches
    probe = dict(PB.last_probe)
    print(f"phase8 run_windows_lockstep: 128 windows in {t_p:.3f}s = "
          f"{128 / t_p:.3f} windows/s, pedit kernel launches "
          f"{pedit_launches}, banded-8 {_cuda.launches_codes}, edit "
          f"{_cuda.edit_launches}")
    print("phase8 per window: " + ", ".join(
        f"{k} {v:.6g}" for k, v in probe.items()))
    if pedit_launches < 3:
        return fail(f"poa main path launched the pedit kernel "
                    f"{pedit_launches} times (< 3)")
    for w, r in enumerate(res_p):
        if not (700 <= len(r.cns) <= 900 and len(r.qlt) == len(r.cns)):
            return fail(f"window {w}: implausible consensus length "
                        f"{len(r.cns)}")
    t0 = time.time()
    res_c = PB.run_windows_lockstep(windows[:2], BSPOAPar(), device="cpu",
                                    want_msa=True)
    for w, (a, b) in enumerate(zip(res_p[:2], res_c)):
        if not (np.array_equal(a.cns, b.cns) and np.array_equal(a.qlt, b.qlt)
                and np.array_equal(a.alt, b.alt) and a.snvs == b.snvs
                and a.msa == b.msa):
            return fail(f"phase 8: window {w} differs from the CPU path")
    print(f"phase8 cns/qlt/alt/SNVs/MSA of 2 windows == CPU path "
          f"({time.time() - t0:.1f}s on the CPU)")
    import contextlib
    import io
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "w.fa")
        with open(fa, "w") as f:
            f.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(windows[0])))
        outs = []
        for d in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = CLI.main(["poa", "--device", d, fa])
            if rc != 0:
                return fail(f"phase 8: poa CLI --device {d} returned {rc}")
            outs.append(buf.getvalue())
    if outs[0] != outs[1] or outs[0].count("\n") < 20:
        return fail("phase 8: poa CLI stdout differs between cuda and cpu")
    print(f"phase8 poa CLI on window 0: --device cuda == --device cpu "
          f"({outs[0].count(chr(10))} lines)")
    stamp(8)

    # ---- phase 9: banded-8 planes and none emits against the plain ----
    LINEAR, AFFINE = (0, -4, 0, 0), (-3, -2, 0, 0)
    MAP_ONT = (-4, -2, -24, -1)          # -O 4 -E 2 -Q 24 -P 1
    mtx_ont = O.set_score_matrix(2, -4)  # -M 2 -X 4
    modes = (("global", MODE_GLOBAL), ("overlap", MODE_OVERLAP),
             ("extend", MODE_EXTEND))
    b8_err = 0

    def check(label, err, bad):
        nonlocal b8_err
        b8_err = max(b8_err, err)
        print(f"phase9 {label}: max_abs_err={err}")
        if bad:
            raise RuntimeError(f"phase 9 {label}: " + "; ".join(bad[:8]))

    try:
        for pw, gaps, m_ in ((0, LINEAR, mtx), (1, AFFINE, mtx),
                             (2, MAP_ONT, mtx_ont)):
            for mname, mode in modes:
                qs, ts = gen_pairs(16, 500, 0.10, SEED + 40 + 3 * pw + mode)
                g, st = operands(qs, ts, mode, 128, gaps, "planes", m_)
                err, bad, p_ms = compare(g, st)
                if g.piecewise != pw:
                    bad.append(f"piecewise {g.piecewise}, not {pw}")
                check(f"planes pw{pw} {mname} 16x500bp band128 (T={g.T}; "
                      f"plain {p_ms:.1f} ms)", err, bad)
                runs = {"planes": _cuda.banded8_rows(g, st)}
                for e in ("codes", "none") if pw < 2 else ("none",):
                    runs[e] = _cuda.banded8_rows(g._replace(emit=e), st)
                if mode == MODE_GLOBAL:
                    g_n = g._replace(emit="none")
                    err, bad, p_ms = compare(g_n, st)
                    check(f"none pw{pw} {mname} vs plain (plain "
                          f"{p_ms:.1f} ms)", err, bad)
                for e, r in runs.items():
                    if e != "none":
                        fin = {k: r[k] for k in ("fin_planes", "fin_ub",
                                                 "fin_reg")}
                        err, bad = diff_raw(g, st, runs["none"], fin)
                        check(f"none pw{pw} {mname} final state vs {e}",
                              err, bad)
        # piecewise 2 at band 16, qlen >> tlen: the band is fully reset (a
        # first gap piece shorter than the band: -O 4 -E 2 -Q 10 -P 1)
        rng = np.random.default_rng(SEED + 50)
        qs = [rng.integers(0, 4, L).astype(np.uint8) for L in (800, 900, 700)]
        ts = [rng.integers(0, 4, L).astype(np.uint8) for L in (40, 45, 30)]
        g, st = operands(qs, ts, MODE_GLOBAL, 16, (-4, -2, -10, -1),
                         "planes")
        err, bad, _ = compare(g, st)
        begs = _cuda.banded8_rows(g, st)["begs"].cpu().numpy()
        jump = max(int(np.diff(begs[:30, b], prepend=0).max())
                   for b in range(3))
        if g.piecewise != 2 or jump < 16:
            bad.append(f"no full reset at piecewise {g.piecewise} "
                       f"(largest move {jump})")
        check(f"planes pw2 band16 full reset (largest move {jump})", err,
              bad)
        # resume: chunks of 256 rows over T = 1,024 against one launch, and
        # the plain version in the same chunks against the kernel's
        for emit, gaps, m_ in (("codes", AFFINE, mtx),
                               ("planes", MAP_ONT, mtx_ont),
                               ("none", MAP_ONT, mtx_ont)):
            qs, ts = gen_pairs(16, 1000, 0.10, SEED + 60)
            ts[3] = ts[3][:600]     # a pair that ends in an earlier chunk
            g, st = operands(qs, ts, MODE_GLOBAL, 128, gaps, emit, m_)
            one = _cuda.banded8_rows(g, st)
            parts = {"kernel": [], "plain": []}
            for who, fn in (("kernel", _cuda.banded8_rows),
                            ("plain", K.forward_plain)):
                reg, state = None, [st.us, st.es, st.qs, st.ub]
                for c0 in range(0, g.T, 256):
                    stc = st._replace(
                        tseq=st.tseq[:, c0:c0 + 256].contiguous(),
                        rby=st.rby[c0:c0 + 256].contiguous(), us=state[0],
                        es=state[1], qs=state[2], ub=state[3],
                        reg=st.reg if reg is None else reg, row0=c0)
                    r = fn(g._replace(T=256), stc)
                    parts[who].append(r)
                    state = (r["fin_planes"] + [None, None])[:3] \
                        + [r["fin_ub"]]
                    reg = r["fin_reg"]
            torch.cuda.synchronize()
            for who, rs in parts.items():
                last = rs[-1]
                joined = {k: (last[k] if k.startswith("fin") or last[k] is None
                              else torch.cat([x[k] for x in rs], 0))
                          for k in last}
                err, bad = diff_raw(g, st, joined, one)
                check(f"{emit} resumed 4 x 256 rows ({who}) vs one launch",
                      err, bad)
    except RuntimeError as e:
        return fail(str(e))
    stamp(9)

    # ---- phase 10: the 2-piece main path (planes emit + backcal) ----
    qs, ts = gen_pairs(512, 2000, 0.10, SEED + 70)
    g_pl, st_pl = operands(qs[:P.DEVICE_CHUNK], ts[:P.DEVICE_CHUNK],
                           MODE_GLOBAL, 128, MAP_ONT, "planes", mtx_ont)
    err, bad, planes_plain_ms = compare(g_pl, st_pl)
    b8_err = max(b8_err, err)
    if bad:
        return fail("phase 10 chunk: planes kernel disagrees with plain: "
                    + "; ".join(bad[:8]))
    planes_ms = timed_ms(lambda: _cuda.banded8_rows(g_pl, st_pl), 5)
    pl_bytes, pl_cells = banded8_work(g_pl, st_pl,
                                      _cuda.banded8_rows(g_pl, st_pl))
    planes_bound_ms, planes_bound_by, planes_bound_text = bound(
        pl_bytes, pl_cells * BANDED8_PLANES_OPS_PER_CELL)
    try:
        split_line(f"planes {P.DEVICE_CHUNK}x2kb band128 pw2", g_pl, st_pl,
                   planes_ms)
    except RuntimeError as e:
        return fail(f"phase 10 {e}")
    del st_pl
    print(f"phase10 planes kernel: {planes_ms:.3f} ms per launch of "
          f"{P.DEVICE_CHUNK} pairs (T={g_pl.T}, W={g_pl.W}, piecewise 2), "
          f"{pl_cells / (planes_ms / 1e3):.4g} cells/s, max_abs_err={err}; "
          f"plain on the card {planes_plain_ms:.1f} ms; bound "
          f"{planes_bound_ms:.4f} ms by {planes_bound_by} "
          f"({planes_bound_text})")
    torch.cuda.synchronize()
    metrics.reset()
    reset_counts()
    t0 = time.time()
    res10 = P.align_batch(qs, ts, MODE_GLOBAL, 128, mtx_ont, *MAP_ONT,
                          device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    planes_launches = _cuda.launches_planes
    print(f"phase10 align_batch map-ont: 512 pairs in {e2e_s:.3f}s = "
          f"{512 / e2e_s:.2f} pairs/s, planes launches {planes_launches}, "
          f"codes {_cuda.launches_codes}, none {_cuda.launches_none}")
    for nm, c in sorted(metrics.counters().items()):
        print(f"phase10 counter {nm}: {c.cells:.6g} units in "
              f"{c.seconds:.4f}s over {c.calls} calls")
    if planes_launches < 2:
        return fail(f"2-piece path launched the planes kernel "
                    f"{planes_launches} times (< 2)")
    for b, (rs, cg) in enumerate(res10):
        if not (rs.mat > 0 and cg and rs.qe == len(qs[b])
                and rs.te == len(ts[b])):
            return fail(f"phase 10 pair {b}: implausible alignment {rs}")
    t0 = time.time()
    cpu10 = P.align_batch(qs[:32], ts[:32], MODE_GLOBAL, 128, mtx_ont,
                          *MAP_ONT, device="cpu")
    if tsv(res10[:32], range(32), qs, ts) != tsv(cpu10, range(32), qs, ts):
        return fail("phase 10: TSV of the first 32 pairs differs from the "
                    "CPU path")
    print(f"phase10 TSV of 32 pairs == CPU path "
          f"({time.time() - t0:.1f}s on the CPU)")
    stamp(10)

    # ---- phase 11: long reads, two-pass and chunked planes ----
    def run_align(qs, ts, mtx_, gaps, t_chunk=None):
        """align_batch with T_CHUNK and REALIGN_T raised to t_chunk when
        given; returns results, seconds, peak device bytes, counters."""
        saved = (P.T_CHUNK, P.REALIGN_T)
        if t_chunk:
            P.T_CHUNK = P.REALIGN_T = t_chunk
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics.reset()
            reset_counts()
            t0 = time.time()
            res = P.align_batch(qs, ts, MODE_GLOBAL, 128, mtx_, *gaps,
                                device=dev)
            torch.cuda.synchronize()
            return (res, time.time() - t0, torch.cuda.max_memory_allocated(),
                    dict(codes=_cuda.launches_codes,
                         planes=_cuda.launches_planes,
                         none=_cuda.launches_none),
                    metrics.counters())
        finally:
            P.T_CHUNK, P.REALIGN_T = saved

    def same_results(ra, rb):
        return all(vars(a) == vars(b) and ca == cb
                   for (a, ca), (b, cb) in zip(ra, rb)) and len(ra) == len(rb)

    qs, ts = gen_pairs_fast(256, 50000, 0.10, SEED + 80)
    T11 = roundup(max(len(t) for t in ts), 128)
    n_chunks = -(-T11 // P.T_CHUNK)
    # the none kernel against the plain version at the first chunk's shape
    g_n, st_n = operands(qs, ts, MODE_GLOBAL, 128, AFFINE, "none")
    g_n = g_n._replace(T=P.T_CHUNK)
    st_n = st_n._replace(tseq=st_n.tseq[:, :P.T_CHUNK].contiguous(),
                         rby=st_n.rby[:P.T_CHUNK].contiguous())
    err, bad, none_plain_ms = compare(g_n, st_n)
    b8_err = max(b8_err, err)
    if bad:
        return fail("phase 11 chunk: none kernel disagrees with plain: "
                    + "; ".join(bad[:8]))
    none_ms = timed_ms(lambda: _cuda.banded8_rows(g_n, st_n), 3)
    refwd_ms = timed_ms(lambda: _cuda.banded8_rows(
        g_n._replace(emit="codes"), st_n), 3)
    n_bytes, n_cells = banded8_work(g_n, st_n, _cuda.banded8_rows(g_n, st_n))
    none_bound_ms, none_bound_by, none_bound_text = bound(
        n_bytes, n_cells * BANDED8_NONE_OPS_PER_CELL)
    try:
        split_line(f"none 256x{P.T_CHUNK} rows band128 pw1", g_n, st_n,
                   none_ms)
    except RuntimeError as e:
        return fail(f"phase 11 {e}")
    del st_n
    print(f"phase11 none kernel: {none_ms:.3f} ms per launch of 256 pairs x "
          f"{P.T_CHUNK} rows (W=8), {n_cells / (none_ms / 1e3):.4g} "
          f"cells/s, max_abs_err={err}; codes at the same shape "
          f"{refwd_ms:.3f} ms; plain on the card {none_plain_ms:.1f} ms; "
          f"bound {none_bound_ms:.4f} ms by {none_bound_by} "
          f"({none_bound_text})")
    two, t_two, mem_two, cnt_two, ctr = run_align(qs, ts, mtx, AFFINE)
    none_launches = cnt_two["none"]
    print(f"phase11 two-pass 256 x 50 kb (T={T11}, {n_chunks} chunks): "
          f"{t_two:.3f}s = {256 / t_two:.2f} pairs/s, launches {cnt_two}, "
          f"peak device memory {mem_two / 1e6:.1f} MB")
    for nm, c in sorted(ctr.items()):
        print(f"phase11 counter {nm}: {c.cells:.6g} units in "
              f"{c.seconds:.4f}s over {c.calls} calls")
    walk_s = t_two - sum(c.seconds for c in ctr.values())
    print(f"phase11 pass 1 (scores only) {ctr['banded8_fwd'].seconds:.3f}s, "
          f"pass 2 re-forward waits {ctr['banded8_refwd'].seconds:.3f}s, "
          f"walk and the rest {walk_s:.3f}s")
    if cnt_two != dict(codes=n_chunks, planes=0, none=n_chunks):
        return fail(f"phase 11: two-pass launches {cnt_two}, expected "
                    f"{n_chunks} none and {n_chunks} codes")
    one, t_one, mem_one, cnt_one, _ = run_align(qs, ts, mtx, AFFINE,
                                                t_chunk=1 << 20)
    print(f"phase11 one-shot codes: {t_one:.3f}s = {256 / t_one:.2f} "
          f"pairs/s, launches {cnt_one}, peak device memory "
          f"{mem_one / 1e6:.1f} MB")
    if cnt_one["codes"] != 1 or not same_results(two, one):
        return fail("phase 11: two-pass results differ from the one-shot "
                    "run")
    for b, (rs, cg) in enumerate(two):
        if not (rs.mat > 0 and cg and rs.qe == len(qs[b])
                and rs.te == len(ts[b])):
            return fail(f"phase 11 pair {b}: implausible alignment {rs}")
    print("phase11 two-pass == one-shot: every AlnResult and CIGAR of 256 "
          "pairs")
    del two, one
    qs, ts = gen_pairs_fast(16, 20000, 0.10, SEED + 81)
    chk, t_chk, mem_chk, cnt_chk, _ = run_align(qs, ts, mtx_ont, MAP_ONT)
    one, t_one, mem_one, cnt_one, _ = run_align(qs, ts, mtx_ont, MAP_ONT,
                                                t_chunk=1 << 20)
    print(f"phase11 chunked planes 16 x 20 kb map-ont: {t_chk:.3f}s, "
          f"launches {cnt_chk}, peak {mem_chk / 1e6:.1f} MB; one-shot "
          f"{t_one:.3f}s, launches {cnt_one}, peak {mem_one / 1e6:.1f} MB")
    if cnt_chk["planes"] < 2 or cnt_one["planes"] != 1 \
            or not same_results(chk, one):
        return fail("phase 11: chunked planes results differ from the "
                    "one-shot run")
    print("phase11 chunked planes == one-shot planes: 16 pairs")
    stamp(11)

    # ---- phases 12-15: cat, --dist, the batch split, poa extras ----
    import contextlib
    import io
    import re
    from bsalign_tpu_torch.parallel import loopback
    from bsalign_tpu_torch.parallel import mesh as MESH
    from bsalign_tpu_torch.poa import extras as X

    def cli_out(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = CLI.main(argv)
        if rc != 0:
            raise RuntimeError(f"{' '.join(argv[:3])} returned {rc}")
        return buf.getvalue()

    def phase12(cat_cpu):
        """cat: the whole contig on the card, each launch of kernel A timed
        with CUDA events; the first CAT_CPU windows against the CPU
        process started after phase 1."""
        if cat_cpu is None:
            cat_cpu = start_cat_cpu()
        proc, paths, expect, t_cpu0 = cat_cpu
        events = []
        rows = _cuda.banded8_rows

        def timed_rows(g, st, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = rows(g, st, **kw)
            e1.record()
            events.append((e0, e1))
            return out
        torch.cuda.synchronize()
        reset_counts()
        _cuda.banded8_rows = timed_rows
        try:
            t0 = time.time()
            out = cli_out(["cat", "--device", "cuda", paths[0]])
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            _cuda.banded8_rows = rows
        cnt, wide = a_counts()
        launches = sum(cnt.values())
        joins = CAT_WINDOWS - 1
        k_ms = sum(a.elapsed_time(b) for a, b in events)
        seq = "".join(out.splitlines()[1:])
        print(f"phase12 cat --device cuda: {CAT_WINDOWS} windows of "
              f"{CAT_WIN} bp in {wall:.3f}s = "
              f"{joins / wall:.2f} joins/s; kernel A {launches} launches "
              f"({wide['codes']} of the wide row), "
              f"{k_ms:.1f} ms = {k_ms / joins:.3f} ms per join, "
              f"{k_ms / 1e3 / wall * 100:.1f}% of the wall time; "
              f"consensus {len(seq)} bp ({expect} expected, less what the "
              f"failed join cuts)")
        if launches < joins or cnt["codes"] != launches:
            raise RuntimeError(f"phase 12: kernel A launched {launches} "
                               f"times for {joins} joins")
        # the failed join cuts the consensus where its junk alignment
        # starts (the reference's behavior): up to 4 x CAT_OV bases less
        tol = 0.005 * expect
        if seq.count("NNNNNN") != 1 or seq.count("N") != 6 \
                or not expect - 4 * CAT_OV - tol <= len(seq) <= expect + tol:
            raise RuntimeError(f"phase 12: implausible consensus: "
                               f"{len(seq)} bp, {seq.count('N')} N")
        gpu8 = cli_out(["cat", "--device", "cuda", paths[1]])
        t_wait = time.time()
        try:
            cpu8, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise RuntimeError("phase 12: the CPU cat outlived 900 s")
        if proc.returncode != 0:
            raise RuntimeError(f"phase 12: cat --device cpu returned "
                               f"{proc.returncode}: {err[-500:]}")
        if gpu8 != cpu8:
            raise RuntimeError(f"phase 12: the first {CAT_CPU} windows "
                               "differ between --device cuda and cpu")
        print(f"phase12 first {CAT_CPU} windows (the retry among them): "
              f"--device cuda == --device cpu "
              f"({len(cpu8)} bytes; the CPU process ran "
              f"{time.time() - t_cpu0:.1f}s beside the earlier phases, "
              f"{time.time() - t_wait:.1f}s of it waited for here)")
        stamp(12)

    def phase13():
        """--dist: two processes on the one card, gloo, against one."""
        tmp = tempfile.mkdtemp(prefix="bsa_dist_")
        atexit.register(shutil.rmtree, tmp, True)
        for cmd, n, flags, seed in (
                ("align", 512, ["-m", "global", "-W", "128"], SEED + 130),
                ("edit", 128, ["-m", "global", "-W", "0"], SEED + 131)):
            qs, ts = gen_pairs(n, 2000, 0.10, seed)
            fa = os.path.join(tmp, f"{cmd}.fa")
            with open(fa, "w") as f:
                for i, (q, t) in enumerate(zip(qs, ts)):
                    f.write(f">q{i}\n{''.join('ACGT'[b] for b in q)}\n"
                            f">t{i}\n{''.join('ACGT'[b] for b in t)}\n")
            single, got, info = loopback.run_loopback(
                fa, cmd=cmd, nprocs=2, device="cuda", flags=flags + ["-v"],
                timeout=300)
            gathers, fwds = [], []
            for err in info["stderr"]:
                m = re.search(r"\[METRIC\] dist_gather .*?([\d.]+)s", err)
                gathers.append(m.group(1) if m else "not read")
                m = re.search(r"\[METRIC\] (banded8|edit)_fwd .*\((\d+) "
                              r"calls\)", err)
                fwds.append(m.group(2) if m else "not read")
            print(f"phase13 {cmd} --dist, {n} pairs x 2 kb "
                  f"{' '.join(flags)}, 2 processes on cuda:0: process walls "
                  + ", ".join(f"{t:.2f}s" for t in info["dist_s"])
                  + f" (start to exit), gather {', '.join(gathers)} s, "
                  f"kernel forwards {', '.join(fwds)}; one process "
                  f"{info['single_s']:.2f}s")
            if got != single or got.count("\n") != 4 * n:
                raise RuntimeError(f"phase 13: {cmd} --dist output differs "
                                   "from the single process's")
            print(f"phase13 {cmd} --dist == one process ({len(got)} bytes)")
        stamp(13)

    def phase14(main_jobs):
        """The batch split over make_mesh() and over [cuda:0] * 2 against
        the unsplit launch: kernel A codes at phase 3's launch shape, B at
        phase 6's, C on phase 7's round-1 jobs; then the dryrun."""
        meshes = [("make_mesh()", MESH.make_mesh()), ("[cuda:0] * 2",
                                                      [dev, dev])]
        print(f"phase14 devices: {torch.cuda.device_count()}")

        def launched():
            return (_cuda.launches_codes + _cuda.edit_launches
                    + _cuda.pedit_launches)

        def timed(fn):
            """fn's result, its host-clock ms and its kernel launches (the
            second of two calls)."""
            fn()
            torch.cuda.synchronize()
            n0 = launched()
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.time() - t0) * 1e3, launched() - n0

        qs, ts = gen_pairs(512, 2000, 0.10, SEED)
        qs, ts = qs[:P.DEVICE_CHUNK], ts[:P.DEVICE_CHUNK]
        gaps = (-3, -2, 0, 0)
        pw = O.get_piecewise(*gaps, 128)
        qpad, qlens, tpad, tlens, rby, T = P._pack_batch(qs, ts, 128)
        us, es, qs0, ub, _ = P._init_state(MODE_GLOBAL, 128, pw, smax, smin,
                                           *gaps, len(qs))
        args = (qpad, qlens, tpad, tlens, P._mtx5(mtx), rby, us, es, qs0,
                ub)
        geo = (T, 8, MODE_GLOBAL, pw, *gaps, smax, smin)
        want, t_one, _ = timed(lambda: K.make_forward(
            *geo, codes=True, device=dev)(*args))
        for label, mesh in meshes:
            got, t_split, n = timed(lambda: MESH.make_sharded_forward(
                *geo, mesh, codes=True)(*args))
            for f in K.ForwardResult._fields:
                a, b = getattr(got, f), getattr(want, f)
                if f == "planes":
                    a, b = [x for x in a if x is not None], \
                        [x for x in b if x is not None]
                elif not isinstance(a, list):
                    a, b = [a], [b]
                if len(a) != len(b) or not all(
                        torch.equal(x, y) for x, y in zip(a, b)):
                    raise RuntimeError(f"phase 14 banded-8 over {label}: "
                                       f"{f} differs from the unsplit run")
            print(f"phase14 banded-8 codes {len(qs)} x 2 kb over {label}: "
                  f"== unsplit; {n} launches; split {t_split:.2f} ms, unsplit "
                  f"{t_one:.2f} ms (host clock, operands to results)")

        qs6, ts6 = gen_pairs(512, 2000, 0.10, SEED + 20)   # phase 6's
        main_idx = [i for i, q in enumerate(qs6) if roundup(roundup(
            len(q), 64), 256) == 2048][:D.DEVICE_CHUNK]
        T6, NWQ, ops = D._pack_bucket([qs6[i] for i in main_idx],
                                      [ts6[i] for i in main_idx], 2048, False)
        want, t_one, _ = timed(lambda: KE.make_edit_forward(
            T6, 64, MODE_GLOBAL, NWQ, False, device=dev)(*ops))
        tl = ops[3]
        for label, mesh in meshes:
            got, t_split, n = timed(lambda: MESH.make_sharded_edit_forward(
                T6, 64, MODE_GLOBAL, NWQ, False, mesh)(*ops))
            same = all(np.array_equal(getattr(got, f), getattr(want, f))
                       for f in ("smin", "ry", "final_score", "final_sbeg"))
            for f in ("pm", "pp", "sbeg"):   # rows past tlen are unwritten
                a, b = getattr(got, f), getattr(want, f)
                same &= all(np.array_equal(a[:tl[j], ..., j],
                                           b[:tl[j], ..., j])
                            for j in range(len(tl)))
            if not same:
                raise RuntimeError(f"phase 14 edit over {label}: differs "
                                   "from the unsplit run")
            print(f"phase14 edit {len(tl)} x 2 kb NW 64 over {label}: "
                  f"== unsplit; {n} launches; split {t_split:.2f} ms, unsplit "
                  f"{t_one:.2f} ms")

        want, t_one, _ = timed(lambda: PE.pedit_forward_batch(main_jobs,
                                                              device=dev))
        for label, mesh in meshes:
            got, t_split, n = timed(lambda: MESH.sharded_pedit_forward(
                main_jobs, mesh))
            if len(got) != len(want) or not all(
                    np.array_equal(a0, b0) and np.array_equal(a1, b1)
                    for (a0, a1), (b0, b1) in zip(got, want)):
                raise RuntimeError(f"phase 14 pedit over {label}: differs "
                                   "from the unsplit run")
            print(f"phase14 pedit {len(main_jobs)} jobs over {label}: "
                  f"== unsplit; {n} launches; split {t_split:.2f} ms, unsplit "
                  f"{t_one:.2f} ms")
        MESH.dryrun_multichip(torch.cuda.device_count())
        print(f"phase14 dryrun_multichip({torch.cuda.device_count()}) passed")
        stamp(14)

    def phase15():
        """poa extras on the card and on the CPU: merge_msas of 4 finished
        windows of one locus, remsa_lsps on 2 of them."""
        rng = np.random.default_rng(SEED + 150)
        reads = gen_poa_window(rng, nreads=40, reflen=500)
        res = {}
        for d in (dev, torch.device("cpu")):
            reset_counts()
            t0 = time.time()
            wins = []
            for k in range(4):
                g = BSPOA(BSPOAPar(), device=d)
                g.beg()
                for s in reads[10 * k:10 * k + 10]:
                    g.push(s)
                g.end()
                wins.append(g)
            mats = []
            for g in wins:
                order = np.asarray(g.msaidxs, np.int64)
                mats.append((np.asarray(g.msacols)[order].copy(), g.nrds))
            dg = X.merge_msas(BSPOAPar(), mats, device=d)
            out = [m.tobytes() for m, _ in mats]
            out += [bytes(dg.cns), np.asarray(dg.msacols)[
                np.asarray(dg.msaidxs, np.int64)].tobytes()]
            for g in wins[:2]:
                n = X.remsa_lsps(g, g.par)
                out += [n, bytes(g.cns), bytes(g.qlt)]
            res[d.type] = out
            print(f"phase15 {d.type}: 4 windows, merge_msas ({dg.nrds} "
                  f"reads, consensus {len(dg.cns)} bp) and remsa_lsps on 2 "
                  f"({out[-6]} and {out[-3]} windows re-POAed) in "
                  f"{time.time() - t0:.2f}s, pedit launches "
                  f"{_cuda.pedit_launches}")
            if d.type == "cuda" and _cuda.pedit_launches < 1:
                raise RuntimeError("phase 15: the pedit kernel never "
                                   "launched on the card")
            if not 450 <= len(dg.cns) <= 550:
                raise RuntimeError(f"phase 15: implausible merged "
                                   f"consensus of {len(dg.cns)} bp")
        if res["cuda"] != res["cpu"]:
            raise RuntimeError("phase 15: extras differ between the card "
                               "and the CPU")
        print("phase15 MSAs, merged MSA and consensus, LSP re-POAs: card "
              "== CPU")
        stamp(15)

    try:
        phase12(cat_cpu)
        phase13()
        phase14(main_jobs)
        phase15()
        r16 = phase16(edit_cpu)
        w_err, w_plain = phase17()
    except RuntimeError as e:
        return fail(str(e))

    err = ptxas_check(ptxas_wait)
    if err:
        return fail(err)

    for mod in ("jax", "bsalign_tpu"):
        if mod in sys.modules:
            return fail(f"{mod} was imported")
    print(json.dumps({"kernels": [{
        "name": "banded8_codes", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/banded8.cu",
        "replaces": "bsalign_tpu/ops/banded8_pallas.py:742",
        "launches": launches, "max_abs_err": max(max_err, b8_err),
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": b8_bound_ms, "bound_by": b8_bound_by,
        "library_ms": None}, {
        "name": "banded8_planes", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/banded8.cu",
        "replaces": "bsalign_tpu/ops/banded8_pallas.py:742",
        "launches": planes_launches, "max_abs_err": b8_err,
        "ms": planes_ms, "plain_ms": planes_plain_ms,
        "bound_ms": planes_bound_ms, "bound_by": planes_bound_by,
        "library_ms": None}, {
        "name": "banded8_none", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/banded8.cu",
        "replaces": "bsalign_tpu/ops/banded8_pallas.py:742",
        "launches": none_launches, "max_abs_err": b8_err,
        "ms": none_ms, "plain_ms": none_plain_ms,
        "bound_ms": none_bound_ms, "bound_by": none_bound_by,
        "library_ms": None}, {
        "name": "edit_rows", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/edit.cu",
        "replaces": "bsalign_tpu/ops/edit_pallas.py:88",
        "launches": edit_launches, "max_abs_err": edit_err,
        "ms": edit_ms, "plain_ms": edit_plain_ms,
        "bound_ms": edit_bound_ms, "bound_by": edit_bound_by,
        "library_ms": None}, {
        "name": "pedit_rows", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/pedit.cu",
        "replaces": "bsalign_tpu/ops/pedit_pallas.py:46",
        "launches": pedit_launches, "max_abs_err": pedit_err,
        "ms": pedit_ms, "plain_ms": pedit_plain_ms,
        "bound_ms": pedit_bound_ms, "bound_by": pedit_bound_by,
        "library_ms": None}] + [{
        "name": f"banded8_{key}", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/banded8_wide.cu",
        "replaces": "bsalign_tpu/ops/banded8_pallas.py:742",
        "launches": r16[key]["launches"],
        "max_abs_err": max(w_err, r16["worst"]), "ms": r16[key]["ms"],
        "plain_ms": w_plain[key.split("_")[1]],
        "bound_ms": r16[key]["bound_ms"], "bound_by": r16[key]["bound_by"],
        "library_ms": None} for key in ("wide_codes", "wide_planes",
                                        "wide_none")] + [{
        "name": "edit_block_rows", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/edit.cu",
        "replaces": "bsalign_tpu/ops/edit_pallas.py:88",
        "launches": r16["edit_block"]["launches"],
        "max_abs_err": r16["edit_block"]["err"], "ms": r16["edit_block"]["ms"],
        "plain_ms": r16["edit_block"]["plain_ms"],
        "bound_ms": r16["edit_block"]["bound_ms"],
        "bound_by": r16["edit_block"]["bound_by"], "library_ms": None}] + [{
        "name": f"{key}_rows", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/edit.cu",
        "replaces": "bsalign_tpu/ops/edit_pallas.py:88",
        "launches": r16[key]["launches"],
        "max_abs_err": r16[key]["err"], "ms": r16[key]["ms"],
        "plain_ms": r16[key]["plain_ms"],
        "bound_ms": r16[key]["bound_ms"],
        "bound_by": r16[key]["bound_by"], "library_ms": None}
        for key in ("edit_cluster", "edit_sweep")] + [{
        "name": "pedit_block_rows", "route": "cuda",
        "source": "bsalign_tpu_torch/csrc/pedit.cu",
        "replaces": "bsalign_tpu/ops/pedit_pallas.py:46",
        "launches": r16["pedit_block"]["launches"],
        "max_abs_err": r16["pedit_block"]["err"],
        "ms": r16["pedit_block"]["ms"],
        "plain_ms": r16["pedit_block"]["plain_ms"],
        "bound_ms": r16["pedit_block"]["bound_ms"],
        "bound_by": r16["pedit_block"]["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
