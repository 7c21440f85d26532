"""CPU models of the block and cluster rows of kernel B (csrc/edit.cu
edit_blk_rows_kernel, edit_cl_rows_kernel, edit_cl_sweep_kernel) and the
block row of kernel C (csrc/pedit.cu pedit_blk_rows_kernel) in numpy, held
bit for bit against the plain versions (ops/edit.py and ops/pedit.py
forward_plain), which tests/test_torch_edit.py and tests/test_torch_pedit.py
hold to the JAX package.

Each model follows its kernel's order of work, with the warp's width (WL
lanes) and the words or cells a thread holds (K) as parameters, so that
small bands cross several "warps":

- B: a cluster of C blocks of warps a pair (the block row: C 1), thread t
  of the cluster owning words [t*K, (t+1)*K), or with pieces > 1 (the
  sweep) that many pieces of K words, its generate / propagate combined
  piece by piece. Per row each lane forms generate / propagate over its
  words and the top HP/HN bits of its last word for a carry in of 0 and 1,
  each warp its lookahead over lanes for both and publishes one word (its
  carry out for both, its last lane's top bits for both, the warp's
  row-score partial of the row before); each block's lookahead over those
  words for a carry into the block of 0 and 1 gives the block's word, and
  the cluster's lookahead over the blocks' words each block's carry in;
  lane 0 takes the warp below's top bits by the carry that warp received,
  warp 0 the block below's. Band shifts go through a copy of the row
  across the cluster; the row score is reduced a row later.
- C: a block of warps a job, thread t of NT holding band cells t + NT*k,
  two to a word. Neighbours come from the thread beside (within a warp by
  shuffle, across warps from the published boundary words), thread 0 and
  the last thread wrap to each other's next k; only the last word of a
  thread masks cells past the band. Operands per pair of steps (to K 8) or
  per step. Rows go through a ring and leave in chunks of 16 positions,
  bytewise in the chunks a job shares with its neighbours; the zero rows
  go straight out. The model writes into buffers of 0xA5, so a byte it
  leaves unwritten shows.
- The launchers' geometry functions over NW 64-1,048,576 and bw
  1,023-32,510 against their stated limits.
"""
import numpy as np
import pytest
import torch

from bsalign_tpu_torch.align import editdist as D
from bsalign_tpu_torch.constants import MODE_EXTEND, MODE_GLOBAL, MODE_OVERLAP
from bsalign_tpu_torch.ops import _cuda
from bsalign_tpu_torch.ops import edit as KE
from bsalign_tpu_torch.ops import pedit as PE

from .test_torch_pedit import _mk_job

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
SMIN0 = 0x7FFFFFFF


# ---------------------------------------------------------------- B --------

def _lowmask(w, n):
    m = n - 32 * w
    return 0 if m <= 0 else (M32 if m >= 32 else (1 << m) - 1)


def _popc(x):
    return bin(x).count("1")


def edit_cluster_model(g, ops, WL, K, nwarp, C, pieces=1):
    """The cluster row's raw outputs (the keys of forward_plain) for the
    operands ops (numpy on the CPU): C blocks of nwarp warps of WL lanes,
    each thread owning `pieces` pieces of K consecutive words (pieces > 1:
    the sweep, each thread's generate / propagate combined piece by piece).
    C 1 is the block row."""
    NW, T, bw = g.NW, g.T, 32 * g.NW
    overlap = g.mode == MODE_OVERLAP
    track = g.mode != MODE_GLOBAL
    qeq = ops.qeq.numpy().view(np.uint32)
    B, NWQ = qeq.shape[1], qeq.shape[2]
    NT, KT = WL * nwarp, K * pieces          # threads a block, words a thread
    S = NT * KT                              # words a block
    NA = C * S
    assert NA >= NW > (C - 1) * S
    out = dict(pm=np.zeros((B, T, NW), np.uint32),
               pp=np.zeros((B, T, NW), np.uint32),
               sbeg=np.zeros((B, T), np.int32),
               fin_pm=np.zeros((B, NW), np.uint32),
               fin_pp=np.zeros((B, NW), np.uint32),
               scal=np.zeros((B, 4), np.int32))
    for b in range(B):
        qlen, tlen = int(ops.qlen[b]), min(int(ops.tlen[b]), T)
        pm, pp = [0] * NA, [M32] * NA
        sbeg, smin, ry, rbeg_f = 0, SMIN0, 0, 0
        part, sbeg_prev = [0] * (C * nwarp), 0    # each warp's partial
        for i in range(tlen):
            tb = int(ops.tseq[b, i])
            plane = qeq[tb if 1 <= tb <= 3 else 0, b]
            rbeg, movx = int(ops.rbegs[i, b]), int(ops.movxs[i, b])
            if not overlap and movx > 0:   # band shift: a cluster reduction
                mv = min(movx, bw)
                sbeg += sum(_popc(pp[w] & _lowmask(w, mv))
                            - _popc(pm[w] & _lowmask(w, mv))
                            for w in range(NA))
                if movx >= bw:
                    pm, pp = [0] * NA, [M32] * NA
                else:   # each word from the blocks holding its sources
                    ws, bs = movx >> 5, movx & 31
                    cp_m, cp_p = list(pm), list(pp)

                    def rd(a, s):
                        return a[s] if s < NW else 0
                    for w in range(NA):
                        s = w + ws
                        keep = _lowmask(w, bw - movx)
                        lm = (rd(cp_m, s) | rd(cp_m, s + 1) << 32) >> bs
                        lp = (rd(cp_p, s) | rd(cp_p, s + 1) << 32) >> bs
                        pm[w] = lm & M32 & keep
                        pp[w] = (lp & M32 & keep) | (M32 ^ keep)
            if not overlap:
                sbeg += 1
            bsh = rbeg & 31
            X, s0, gen, prop = [], [], [], []
            for w in range(NA):
                ws = (rbeg >> 5) + w
                e0 = int(plane[ws]) if 0 <= ws < NWQ else 0
                e1 = int(plane[ws + 1]) if 0 <= ws + 1 < NWQ else 0
                x = (((e1 << 32) | e0) >> bsh) & M32 | pm[w]
                ad = x & pp[w]
                s = ad + pp[w]
                X.append(x)
                s0.append(s & M32)
                gen.append(s > M32)
                prop.append((s & M32) == M32)

            def top(w, c):   # top HP/HN bits of word w for a carry c into it
                A = (s0[w] + c) & M32
                D0 = (A ^ pp[w]) | X[w]
                hp = pm[w] | (M32 ^ (D0 | pp[w]))
                hn = pp[w] & D0
                return (hp >> 31) | (hn >> 31 << 1)
            # each thread: generate / propagate over its pieces, the top
            # bits of its last word for a carry into the thread of 0 and 1
            G, P, t01 = [], [], []
            for th in range(C * NT):
                g_, p_ = False, True
                for k in range(pieces):
                    gk, pk, gl, pl = False, True, False, True
                    for j in range(K):
                        w = th * KT + k * K + j
                        if j == K - 1:
                            gl, pl = gk, pk
                        gk = gen[w] or (prop[w] and gk)
                        pk = pk and prop[w]
                    if k == pieces - 1:
                        w = th * KT + KT - 1
                        t01.append((top(w, gl or (pl and g_)),
                                    top(w, gl or (pl and (g_ or p_)))))
                    g_ = gk or (pk and g_)
                    p_ = p_ and pk
                G.append(g_)
                P.append(p_)
            # each warp's word: carry out and its last lane's top bits for
            # a carry into the warp of 0 and of 1, its partial
            cl, words = [], []
            for wp in range(C * nwarp):
                lanes = range(wp * WL, (wp + 1) * WL)
                gm = sum(G[t] << (t - wp * WL) for t in lanes)
                pmask = sum(P[t] << (t - wp * WL) for t in lanes) | gm
                sum0 = pmask + gm
                c0s, c1s = (sum0 ^ pmask ^ gm), ((sum0 + 1) ^ pmask ^ gm)
                cl.append([((c0s >> (t - wp * WL)) & 1,
                            (c1s >> (t - wp * WL)) & 1) for t in lanes])
                last = (wp + 1) * WL - 1
                words.append((sum0 >> WL, (sum0 + 1) >> WL,
                              t01[last][cl[wp][-1][0]],
                              t01[last][cl[wp][-1][1]], part[wp]))
            # each block's word from its warps' (its lookahead for a carry
            # into the block of 0 and of 1)
            cBs, bwords = [], []
            for r in range(C):
                ww = words[r * nwarp:(r + 1) * nwarp]
                gB = sum(w[0] << k for k, w in enumerate(ww))
                pB = sum(w[1] << k for k, w in enumerate(ww)) | gB
                sB = pB + gB
                cB = ((sB ^ pB ^ gB), ((sB + 1) ^ pB ^ gB))
                cBs.append(cB)
                h = nwarp - 1
                bwords.append(((sB >> nwarp) & 1, ((sB + 1) >> nwarp) & 1,
                               ww[-1][2 + ((cB[0] >> h) & 1)],
                               ww[-1][2 + ((cB[1] >> h) & 1)],
                               sum(w[4] for w in ww)))
            if track and i > 0:
                tot = sum(w[4] for w in bwords)
                if sbeg_prev + tot < smin:
                    smin, ry = sbeg_prev + tot, i - 1
            gC = sum(w[0] << k for k, w in enumerate(bwords))
            pC = sum(w[1] << k for k, w in enumerate(bwords)) | gC
            cC = (pC + gC) ^ pC ^ gC
            HP, HN, D0 = [0] * NA, [0] * NA, [0] * NA
            cth, lo = [], []
            for th in range(C * NT):
                r, t = divmod(th, NT)
                wp, ln = divmod(th, WL)
                cB = cBs[r][(cC >> r) & 1]
                c = cl[wp][ln][(cB >> (t // WL)) & 1]
                cth.append(c)
                for j in range(KT):
                    w = th * KT + j
                    A = (s0[w] + c) & M32
                    c = gen[w] or (prop[w] and c)
                    D0[w] = (A ^ pp[w]) | X[w]
                    HP[w] = pm[w] | (M32 ^ (D0[w] | pp[w]))
                    HN[w] = pp[w] & D0[w]
            for th in range(C * NT):
                r, t = divmod(th, NT)
                wp, ln = divmod(th, WL)
                if ln:      # the lane below's top bits by its carry in
                    lo_ = t01[th - 1][cth[th - 1]]
                elif t:     # the warp below's word, by its carry in
                    cB = cBs[r][(cC >> r) & 1]
                    lo_ = words[wp - 1][2 + ((cB >> (t // WL - 1)) & 1)]
                elif r:     # the block below's word, by its carry in
                    lo_ = bwords[r - 1][2 + ((cC >> (r - 1)) & 1)]
                else:
                    lo_ = 0 if overlap else 1
                for j in range(KT):
                    w = th * KT + j
                    hps = ((HP[w] << 1) & M32) | (HP[w - 1] >> 31 if j
                                                 else lo_ & 1)
                    hns = ((HN[w] << 1) & M32) | (HN[w - 1] >> 31 if j
                                                 else lo_ >> 1)
                    pp[w] = hns | (M32 ^ (D0[w] | hps))
                    pm[w] = hps & D0[w]
            if track:
                n = min(max(qlen - rbeg, 0), bw)
                part = [sum(_popc(pp[w] & _lowmask(w, n))
                            - _popc(pm[w] & _lowmask(w, n))
                            for w in range(wp * WL * KT, (wp + 1) * WL * KT))
                        for wp in range(C * nwarp)]
                sbeg_prev = sbeg
            out["pm"][b, i] = pm[:NW]
            out["pp"][b, i] = pp[:NW]
            out["sbeg"][b, i] = sbeg
            rbeg_f = rbeg
        if track and tlen > 0 and sbeg_prev + sum(part) < smin:
            smin, ry = sbeg_prev + sum(part), tlen - 1
        out["fin_pm"][b], out["fin_pp"][b] = pm[:NW], pp[:NW]
        out["scal"][b] = (sbeg, smin, ry, rbeg_f)
    return {k: torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32
                               else v) for k, v in out.items()}


def edit_block_model(g, ops, WL, K):
    """The block row's raw outputs for the operands ops (numpy on the
    CPU), warps of WL lanes, K words a thread: the cluster row of one
    block."""
    return edit_cluster_model(g, ops, WL, K, -(-g.NW // (WL * K)), 1)


def _edit_ops(qs, ts, mode, nw, banded, traj=None):
    T, _, (qeq, qlens, tpad, tlens, rbegs, movxs) = D._pack_bucket(
        qs, ts, 32 * nw, banded)
    if traj is not None:
        rbegs, movxs = traj(rbegs, tlens, qlens, T)
    return KE.Geometry(T, nw, mode), KE.operands_from_numpy(
        qeq, qlens, tpad, tlens, rbegs, movxs, T=T, device="cpu")


def _jumpy(rbegs, tlens, qlens, T):
    """Band starts that jump by a few words every 7 rows (shifts across
    the model's warps) and past the band's width every 29 (full resets)."""
    r = np.zeros_like(rbegs)
    for b, tl in enumerate(tlens):
        cur = 0
        for i in range(int(tl)):
            cur += 9000 if i % 29 == 13 else (i % 7 == 3) * (97 + 32 * b)
            r[i, b] = min(cur, int(qlens[b]) - 8)
    m = np.diff(r, axis=0, prepend=0).astype(np.int32)
    for b, tl in enumerate(tlens):
        m[int(tl):, b] = 0
    return r, m


def _rand(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def _b_case(name, mode, nw):
    """(qs, ts, banded, traj) of a named B case at NW words."""
    rng = np.random.default_rng(nw * 7 + mode)
    bw = 32 * nw
    if name == "full":     # queries within the band, one longer (overlap)
        qs = [_rand(rng, bw - 40), _rand(rng, bw - 3)]
        ts = [_rand(rng, 60), qs[1][10:80].copy()]
        if mode == MODE_OVERLAP:
            qs.append(_rand(rng, bw + 150))
            ts.append(_rand(rng, 50))
        return qs, ts, False, None
    if name == "carry":    # all-propagate words: the carry crosses warps
        same = _rand(rng, bw - 20)
        # one C at the query's start, then A: against a C target the first
        # word generates and every other word propagates (Eq 0, pp all
        # ones), so the first row's carry ripples through every warp
        one = np.zeros(bw - 10, np.uint8)
        one[0] = 1
        return ([same, np.full(bw - 30, 2, np.uint8), one],
                [same[:70].copy(), np.full(60, 2, np.uint8),
                 np.full(40, 1, np.uint8)], False, None)
    if name == "minima":   # row-score bounds qlen - rbeg in several blocks
        qs = [_rand(rng, bw * k // 4 - 5) for k in (1, 2, 3)]
        return qs, [np.concatenate([q[:40], _rand(rng, 20)]) for q in qs], \
            False, None
    if name == "banded":   # odd rbeg % 32, rows with movx > 0
        return ([_rand(rng, bw + 300 + 17 * k) for k in range(2)],
                [_rand(rng, 90 - 11 * k) for k in range(2)], True, None)
    # shifts across warps and full resets (not in overlap: no shift there)
    return ([_rand(rng, 20000), _rand(rng, 15000)],
            [_rand(rng, 70), _rand(rng, 58)], True, _jumpy)


B_CASES = [(name, mode, nw, WL, K)
           for name, nws in (("full", (5, 13, 40)), ("carry", (9, 24)),
                             ("banded", (7, 20)), ("jumpy", (11, 30)))
           for mode in (MODE_GLOBAL, MODE_OVERLAP, MODE_EXTEND)
           if not (name == "jumpy" and mode == MODE_OVERLAP)
           for nw in nws for WL, K in ((4, 1), (4, 2))
           if -(-nw // (WL * K)) >= 2]


@pytest.mark.parametrize("case", B_CASES, ids=lambda c: "-".join(map(str, c)))
def test_edit_block_model_matches_plain(case):
    name, mode, nw, WL, K = case
    qs, ts, banded, traj = _b_case(name, mode, nw)
    g, ops = _edit_ops(qs, ts, mode, nw, banded, traj)
    assert -(-nw // (WL * K)) >= 2           # the band crosses warps
    if traj is not None or banded:
        live = np.arange(g.T)[:, None] < ops.tlen.numpy()[None]
        assert ops.movxs.numpy()[live].max() > 0
        assert (ops.rbegs.numpy()[live] % 32 % 2 == 1).any()
    if traj is not None:
        assert ops.movxs.numpy().max() >= 32 * nw
    got = edit_block_model(g, ops, WL, K)
    want = KE.forward_plain(g, ops)
    for b, n in enumerate(ops.tlen.tolist()):
        for f in ("pm", "pp", "sbeg"):
            assert torch.equal(got[f][b, :n], want[f][b, :n]), (f, b)
    for f in ("fin_pm", "fin_pp", "scal"):
        assert torch.equal(got[f], want[f]), f


# the cluster row: (WL, K, warps, C, pieces, NW), the band across 2-3
# blocks, the last two the sweep (2 and 3 pieces a thread)
CL_GEOS = [(4, 1, 2, 3, 1, 21), (4, 2, 2, 2, 1, 30), (4, 1, 2, 3, 2, 40),
           (4, 2, 1, 2, 3, 37)]
CL_CASES = [(name, mode) + geo
            for name, modes in (("full", (0, 1, 2)), ("carry", (0, 1, 2)),
                                ("banded", (0, 1, 2)), ("jumpy", (0, 2)),
                                ("minima", (1, 2)))
            for mode in modes for geo in CL_GEOS]


@pytest.mark.parametrize("case", CL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_edit_cluster_model_matches_plain(case):
    """The cluster row's model against the plain version: a carry through
    every block (carry), band shifts whose words cross blocks and full
    resets (jumpy), row-score bounds in different blocks (minima)."""
    name, mode, WL, K, nwarp, C, pieces, nw = case
    qs, ts, banded, traj = _b_case(name, mode, nw)
    g, ops = _edit_ops(qs, ts, mode, nw, banded, traj)
    S = WL * nwarp * K * pieces
    assert C * S >= nw > (C - 1) * S
    if name == "jumpy":   # shifts of more than a block, and full resets
        live = np.arange(g.T)[:, None] < ops.tlen.numpy()[None]
        mv = ops.movxs.numpy()[live]
        assert ((mv > 32 * S) & (mv < 32 * nw)).any() or \
            ((mv > 32 * 2) & (mv < 32 * nw)).any()
        assert mv.max() >= 32 * nw
    if name == "minima":
        assert len({(int(q) - 1) // (32 * S) for q in ops.qlen}) >= 2
    got = edit_cluster_model(g, ops, WL, K, nwarp, C, pieces)
    want = KE.forward_plain(g, ops)
    for b, n in enumerate(ops.tlen.tolist()):
        for f in ("pm", "pp", "sbeg"):
            assert torch.equal(got[f][b, :n], want[f][b, :n]), (f, b)
    for f in ("fin_pm", "fin_pp", "scal"):
        assert torch.equal(got[f], want[f]), f


# ---------------------------------------------------------------- C --------

def _ring_size(bw):
    rs = 1024
    while rs < 2 * (bw + 2) + 32:
        rs *= 2
    return rs


def pedit_block_model(pk, WL, K, nwarp, pair=None):
    """Both output matrices of the block row for the packed jobs pk (CPU),
    warps of WL lanes, K cells a thread; operands per pair of steps (pair,
    by default K <= 8) or per step."""
    NT = WL * nwarp
    bw, HW, rowlen = pk.bw, pk.HW, pk.bw + 2
    assert NT * K >= bw and NT * (K - 2) <= bw and K % 2 == 0
    pair = K <= 8 if pair is None else pair
    rd, cn = pk.rd.numpy(), pk.cn.numpy()
    rdm = pk.rdm.numpy().reshape(-1, 4).astype(np.int64)
    cnm = pk.cnm.numpy().reshape(-1, 4).astype(np.int64)
    o0 = np.full(pk.total + 32, 0xA5, np.uint8)
    o1 = np.full(pk.total + 32, 0xA5, np.uint8)
    RS = _ring_size(bw)
    i = np.arange(NT)[:, None] + NT * np.arange(K)[None]   # [NT, K] cells
    inb = i < bw
    last = np.zeros((NT, K), bool)
    last[:, K - 2:] = True
    assert inb[~last].all()          # past the band: the last word alone
    for jr in pk.jobs.numpy():
        ro, co, off, pad, mlen, mbeg, mend = (int(x) for x in jr[:7])

        def pos_x(ix):     # (selector base, counts) of read positions
            ok = (ix >= 0) & (ix < pad)
            b = np.where(ok, rd[ro + np.clip(ix, 0, pad - 1)], 4)
            c = np.where(ok[..., None], rdm[ro + np.clip(ix, 0, pad - 1)], 0)
            return np.minimum(b, 4), c

        def pos_y(iy):
            ok = (iy >= 0) & (iy < pad)
            b = np.where(ok, cn[co + np.clip(iy, 0, pad - 1)], 0)
            c = np.where(ok[..., None], cnm[co + np.clip(iy, 0, pad - 1)], 0)
            return np.minimum(b, 4), c

        def score(x, y):   # byte `y base` of x's counts + byte `x base` of y's
            (xb, xc), (yb, yc) = x, y
            xs = np.where(yb < 4, np.take_along_axis(
                xc, np.minimum(yb, 3)[..., None], -1)[..., 0], 0)
            ys = np.where(xb < 4, np.take_along_axis(
                yc, np.minimum(xb, 3)[..., None], -1)[..., 0], 0)
            return np.minimum(xs + ys, 255)

        beg = off & 15
        base = off - beg
        end = beg + (2 * mlen + 2) * rowlen
        ring = np.zeros(RS, np.int64)

        def put(c0, c1, zero):
            for c in range(c0, c1):
                q = 16 * c
                a, e = max(q, beg), min(q + 16, end)
                xs = np.arange(q, q + 16) if (a, e) == (q, q + 16) \
                    else np.arange(a, e)    # whole chunk, or bytewise
                v = np.zeros(len(xs), np.int64) if zero \
                    else ring[xs & (RS - 1)]
                o0[base + xs] = v & 255
                o1[base + xs] = v >> 8

        zl = beg + 2 * mbeg * rowlen
        nsteps = max(2 * (mend - mbeg) - 1, 1)
        zt = zl + (1 + nsteps) * rowlen
        put(0, zl >> 4, True)
        done = zl & ~15
        ring[np.arange(done, zl) & (RS - 1)] = 0

        def row(q, P0, P1, e0, e1):
            ring[(q + 1 + i[inb]) & (RS - 1)] = P0[inb] | P1[inb] << 8
            ring[q & (RS - 1)] = e0
            ring[(q + bw + 1) & (RS - 1)] = e1

        P0 = np.where(inb & (i + 1 == HW), 255, 0)
        P1 = np.where(inb & (i + 1 == HW + 1), 255, 0)
        q = zl
        row(q, P0, P1, (HW == 0) * 255 | (HW == -1) * 255 << 8,
            (HW == bw + 1) * 255 | (HW == bw) * 255 << 8)
        q += rowlen
        X0, Y0 = mbeg, mlen - 1 - mbeg
        xe = pos_x(X0 + i)
        for s in range(nsteps):
            odd, m = s & 1, s >> 1
            put(done >> 4, q >> 4, False)
            done = q & ~15
            if pair:
                if not odd:
                    y, xn = pos_y(Y0 - m + i), pos_x(X0 + m + 1 + i)
                    a, ao = score(xe, y), score(xn, y)
                    xe = xn
                else:
                    a = ao
            else:
                a = score(pos_x(X0 + ((s + 1) >> 1) + i), pos_y(Y0 - m + i))
            if not odd:   # pv from the thread below; thread 0 wraps to k-1
                pu, pv = P0, np.empty_like(P1)
                pv[1:] = P1[:-1]
                pv[0, 1:] = P1[NT - 1, :-1]
                pv[0, 0] = 255 if s == 0 and HW == -1 else 0
            else:         # pu from the thread above; the last wraps to k+1
                pv, pu = P1, np.empty_like(P0)
                pu[:-1] = P0[1:]
                pu[NT - 1, :-1] = P0[0, 1:]
                pu[NT - 1, -1] = 0
            h = np.maximum(np.maximum(a, pu), pv)
            P0 = np.where(last & ~inb, 0, h - pv)   # masked in the last word
            P1 = h - pu
            row(q, P0, P1, 255 if odd else 0, 0 if odd else 255 << 8)
            q += rowlen
        ring[np.arange(zt, (zt + 15) & ~15) & (RS - 1)] = 0
        put(done >> 4, zt >> 4, False)
        put(zt >> 4, (zt + 15) >> 4, False)
        put((zt + 15) >> 4, (end + 15) >> 4, True)
    return torch.as_tensor(o0), torch.as_tensor(o1)


def _c_jobs(bw, HW, kind, rng):
    jobs = [_mk_job(rng, int(rng.integers(8, 40)), bw) for _ in range(3)]
    jobs.append(_mk_job(rng, 10, bw, span=1))
    jobs.append(_mk_job(rng, 12, bw, span=2))
    for j in jobs:
        j.HW = HW
        j.mbeg = max(j.mbeg, 1) if j.mend - j.mbeg > 2 else j.mbeg
        j.mend = min(j.mend, j.mlen - 1) if j.mend - j.mbeg > 2 else j.mend
    if kind == "bases":    # bases >= 4 on both sides
        for j in jobs:
            j.seqs0[rng.random(len(j.seqs0)) < 0.2] = 5
            j.seqs1[rng.random(len(j.seqs1)) < 0.2] = 4
    if kind == "pad":      # buffers cut short: positions past pad default
        jobs = [PE.PeditJob(j.seqs0[:j.mlen + 2].copy(),
                            j.seqs1[:j.mlen + 2].copy(),
                            j.mats0[:, :j.mlen + 2].copy(),
                            j.mats1[:, :j.mlen + 2].copy(), j.mlen, j.mbeg,
                            j.mend, j.bw, j.HW) for j in jobs]
    return jobs


C_CASES = [(bw, hw, kind, WL, K, pair)
           for bw in (5, 22, 47, 70)
           for hw in ("mid", -1, 0, "bw", "bw+1")
           for kind in ("random", "bases", "pad")
           for WL, K in ((4, 2), (4, 4))
           for pair in ((True, False) if (K, kind) == (4, "random")
                        else (True,))
           if 4 * -(-bw // (WL * K)) * (K - 2) <= bw]


@pytest.mark.parametrize("case", C_CASES, ids=lambda c: "-".join(map(str, c)))
def test_pedit_block_model_matches_plain(case):
    bw, hw, kind, WL, K, pair = case
    HW = {"mid": bw // 2, "bw": bw, "bw+1": bw + 1}.get(hw, hw)
    rng = np.random.default_rng(bw * 31 + K)
    jobs = _c_jobs(bw, HW, kind, rng)
    pk = PE.pack_jobs(jobs, "cpu")
    nwarp = -(-bw // (WL * K))
    got = pedit_block_model(pk, WL, K, nwarp, pair)
    want = PE.forward_plain(pk)
    assert torch.equal(got[0][:pk.total], want[0])
    assert torch.equal(got[1][:pk.total], want[1])
    assert (got[0][pk.total:] == 0xA5).all()   # nothing past the last job


# ---------------------------------------------------------- geometry -------

@pytest.mark.parametrize("nw", [513, 640, 641, 752, 1024, 2048, 2049, 3200,
                                4096, 4097])
def test_edit_block_geometry(nw):
    geo = _cuda.edit_block_geometry(nw)
    if nw > _cuda.EDIT_BLOCK_MAX_NW:
        assert geo is None and _cuda.edit_design(nw) == "cluster"
        return
    K, nwarp = geo
    assert _cuda.edit_design(nw) == "block"
    assert K in (4, 8) and 1 <= nwarp <= _cuda.EDIT_BLOCK_MAXW
    assert _cuda.edit_geometry_ok(nw, K, nwarp)
    assert 32 * K * nwarp >= nw > 32 * K * (nwarp - 1)   # no idle warp
    assert K == 4 or nw > 32 * 4 * _cuda.EDIT_BLOCK_MAXW  # K 4 while it fits


@pytest.mark.parametrize("nw,geo,ok", [
    (1536, (4, 12), True), (1536, (8, 6), True), (1536, (8, 7), True),
    (1536, (4, 11), False), (1536, (16, 3), False), (1536, (8, 17), False),
    (513, (4, 0), False), (4096, (8, 16), True), (4097, (8, 16), False)])
def test_edit_geometry_ok(nw, geo, ok):
    assert _cuda.edit_geometry_ok(nw, *geo) is ok


@pytest.mark.parametrize("bw,geo,ok", [
    (4094, (4, 32), True), (4094, (8, 16), True), (4094, (16, 8), True),
    (4094, (32, 4), True), (4094, (4, 31), False), (4094, (32, 8), False),
    (4094, (2, 64), False), (4094, (3, 43), False), (1023, (2, 16), True),
    (32510, (32, 32), True), (32510, (16, 64), False)])
def test_pedit_geometry_ok(bw, geo, ok):
    assert _cuda.pedit_geometry_ok(bw, *geo) is ok


@pytest.mark.parametrize("bw,want", [
    (5, (2, 1)), (64, (2, 1)), (65, (4, 1)), (128, (4, 1)), (1022, (4, 8)),
    (1023, (4, 8)), (1024, (4, 8)), (1534, (4, 12)), (2048, (4, 16)),
    (2049, (8, 9)), (4094, (8, 16)), (8192, (8, 32)), (8193, (16, 17)),
    (16384, (16, 32)), (16385, (32, 17)), (20000, (32, 20)),
    (32510, (32, 32))])
def test_pedit_block_geometry(bw, want):
    K, nwarp = _cuda.pedit_block_geometry(bw)
    NT = 32 * nwarp
    assert (K, nwarp) == want
    assert K in (2, 4, 8, 16, 32) and 1 <= nwarp <= _cuda.PEDIT_BLOCK_MAXW
    assert _cuda.pedit_geometry_ok(bw, K, nwarp)
    assert NT * K >= bw >= NT * (K - 2)     # past the band: the last word
    assert 2 * _ring_size(bw) <= _cuda.SMEM_MAX
    assert bw <= _cuda.PEDIT_MAX_BW


@pytest.mark.parametrize("nw", [64, 128, 129, 513, 2049, 4097, 4192, 8192,
                                8193, 16384, 32768, 32769, 65536, 65537,
                                100000, 1 << 20])
@pytest.mark.parametrize("maxc", [_cuda.EDIT_CLUSTER_MAX,
                                  _cuda.EDIT_CLUSTER_MAX_NP])
@pytest.mark.parametrize("pairs", [1, 2, 64, 256])
def test_edit_cluster_geometry(nw, maxc, pairs):
    K, nwarp, C, pieces = _cuda.edit_cluster_geometry(nw, maxc, pairs)
    S = 32 * nwarp * K * pieces
    full = 32 * _cuda.EDIT_BLOCK_MAXW * 8
    assert _cuda.edit_cluster_geometry_ok(nw, K, nwarp, C, pieces)
    assert C <= maxc and C * S >= nw > (C - 1) * S
    if nw <= full * maxc:              # in registers
        assert pieces == 1
        C0 = max(2, -(-nw // full))
        want = max(C0, min(maxc, 132 // pairs,
                           -(-nw // _cuda.EDIT_CLUSTER_WORDS)))
        assert (K, nwarp) == _cuda.edit_block_geometry(-(-nw // want))
        assert C == -(-nw // (32 * nwarp * K)) <= want
        if pairs >= 66 and nw > 128:   # the SMs leave two blocks a pair
            assert C == C0
    else:                              # the sweep
        assert (K, nwarp) == (8, _cuda.EDIT_SWEEP_MAXW)
        assert pieces == -(-nw // (maxc * 32 * nwarp * 8)) >= 2
    if nw > _cuda.EDIT_BLOCK_MAX_NW:
        assert _cuda.edit_design(nw) == "cluster"


@pytest.mark.parametrize("nw,geo,ok", [
    (4192, (8, 9, 2, 1), True), (4192, (4, 11, 3, 1), True),
    (4192, (4, 5, 7, 1), True), (4192, (4, 9, 4, 1), True),
    (4192, (8, 9, 1, 1), False), (4192, (4, 9, 8, 1), False),
    (4192, (8, 16, 3, 1), False), (4192, (16, 9, 2, 1), False),
    (4192, (8, 17, 1, 1), False), (100000, (8, 8, 13, 4), True),
    (100000, (8, 16, 13, 2), False), (100000, (8, 16, 16, 2), False),
    (100000, (4, 16, 16, 4), False), (100000, (8, 16, 17, 1), False),
    (100000, (8, 16, 8, 4), False), (2049, (4, 9, 2, 1), True),
    (2049, (8, 0, 2, 1), False), (2049, (8, 9, 2, 0), False)])
def test_edit_cluster_geometry_ok(nw, geo, ok):
    assert _cuda.edit_cluster_geometry_ok(nw, *geo) is ok
