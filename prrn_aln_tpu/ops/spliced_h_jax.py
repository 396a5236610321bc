"""Device (JAX) spliced DP: protein/profile vs genomic DNA (fwd2h).

Banded ``lax.scan`` formulation of the reference Algorithm H
(src/fwd2h.h:131-583 initH/forwardH with the RVPDJ_nv record), matching
``ops/spliced_h_np.forward_h`` cell-for-cell on the default local mode:

* codon-stepped band r = n - 3m; H/G/SJ lanes as (W+6,) field arrays;
* frameshift verticals/horizontals (1/2-nt) as 4-way argmaxes;
* the three per-phase donor candidate lists (NCAND_H=4, INTR=2) are
  fixed-size scan state; phase-1/2 junction codons use precomputed
  (position x base-class) chimeric-codon tables so the merge is pure
  gathers; the sj shadow row carries the phase-2 acceptor;
* traceback via dense event planes (winner, vert/hori choice k,
  per-lane junction merges with donor push-column + crossspj bit, sj
  use) walked on the host into the oracle's knot chain; initH/lastH
  run on the host over the fetched border arrays.

Reference: fwd2h.h:270-583; the NumPy oracle (validated against an
instrumented reference build) is the parity target.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import alphabet as ab
from ..splice import tron
from .spliced_np import NEVSEL, DEAD, DIAG, NEWD, VERT, HORI, SPIN, SPJCI
from .spliced_h_np import (_IS_DIAG, _IS_VERT, _IS_HORI, DIR2NOD,
                           NCAND_H, INTR, HORI3, VERT3)
from .spliced_jax import _pen_arrays, _penalty

F32 = jnp.float32
I32 = jnp.int32

# event bit layout
EVH_WINNER = 0x3
EVH_SJ = 1 << 2
EVH_VK = 3 << 3          # vertical source k (0..3)
EVH_HK = 3 << 5          # horizontal source k (0..3)
EVH_JXH = 1 << 7
EVH_JXF = 1 << 8
EVH_JXG = 1 << 9
EVH_CSH = 1 << 10        # merged lane-0 candidate was crossspj

_DIAG_MASK = np.array([1 if _IS_DIAG[d] else 0 for d in range(16)], np.int32)
_VERT_MASK = np.array([1 if _IS_VERT[d] else 0 for d in range(16)], np.int32)
_HORI_MASK = np.array([1 if _IS_HORI[d] else 0 for d in range(16)], np.int32)
_D2N = np.array(DIR2NOD, np.int32)
_H3 = np.array(HORI3, np.int32)
_V3 = np.array(VERT3, np.int32)


def _codon_tables(b: np.ndarray):
    """Chimeric junction-codon tables (SpJunc/spliceTron semantics):
    A1[J, e3] = aa of codon (b[J-2], b[J-1], base-elem e3; e3=4 none);
    A2[nb, r1] = aa of codon (base-red r1; r1=4 none, b[nb], b[nb+1]);
    e3idx[n]/r1idx[n] index them by the partner position.  Vectorized
    (round 5): the python per-position loop cost 0.3 s of the spliced
    e2e on the 35 kb flagship case."""
    N = len(b)
    red = np.asarray(tron._RED, np.int64)
    elem = np.asarray(tron._ELEM, np.int64)
    gencode = np.asarray(tron.GENCODE, np.int64)
    # b padded so at(i) = bp[i + 2] with NIL outside [0, N)
    bp = np.full(N + 4, ab.NIL, np.int64)
    bp[2:2 + N] = np.asarray(b, np.int64)

    def aa_vec(c1r, c2, c3e):
        """codon_aa over arrays: c1 as reduced class (4 = none), c3 as
        element (4 = none)."""
        r2 = red[c2]
        r2c = np.clip(r2, 0, 3)
        c1c = np.clip(c1r, 0, 3)
        idx = 16 * c1c + 4 * r2c + np.where(c3e < 4, c3e, 0)
        a = gencode[idx]
        a = np.where((a == tron._A.SER) & (c2 == 5), tron.SER2,
                     np.where((a == tron.TRM) & (c2 == 5), tron.TRM2,
                              a))
        a = np.where(c1r >= 4, tron._MOST_ABUND[r2c], a)
        a = np.where(r2 >= 4, tron.AMB, a)
        a = np.where(c2 <= ab.GAP, tron.UNP, a)
        return a

    p = np.arange(N + 1)
    c1 = bp[p]                       # at(p-2)
    c2 = bp[p + 1]                   # at(p-1)
    r1 = np.where(c1 > ab.GAP, red[c1], 4)
    e3g = np.arange(5)
    A1 = aa_vec(r1[:, None], c2[:, None], e3g[None, :]) \
        .astype(np.int32)
    c2a = bp[p + 2]                  # at(p)
    c3a = bp[p + 3]                  # at(p+1)
    e3a = np.where(c3a > ab.GAP, elem[c3a], 4)
    rg = np.arange(5)
    A2 = aa_vec(rg[None, :], c2a[:, None], e3a[:, None]) \
        .astype(np.int32)
    e3idx = np.where(c2a > ab.GAP, elem[c2a], 4).astype(np.int32)
    r1idx = np.where(c2 > ab.GAP, red[c2], 4).astype(np.int32)
    return A1, A2, e3idx, r1idx


@functools.partial(jax.jit,
                   static_argnums=(0, 1, 2, 3, 4, 5, 6))
def _sweep_h(M, N, lw, up, a_exg, b_exg, lcl,
             H0, qprof, pack, pen_pack):
    """Wavefront forwardH: one `lax.scan` step per anti-diagonal wave
    t = 3m + n; every row m advances exactly one genome column per
    wave, so all dependencies become fixed-depth ring reads (the
    horizontal e1 phase-ring is a delay-3 buffer in wave time) and the
    per-row donor candidate lists evolve in exactly the row-sweep
    order.  This replaces the per-cell inner scan (which serialized
    all ~M*W cells) with ~3M+N waves of (M+1)-lane vector work — the
    fwd2d1.cc anti-diagonal idea applied to the codon-stepped spliced
    grid (fwd2h.h:270-583).

    H0: the initH band arrays (top row + left column records, host
    built); the final band value/dir arrays returned preserve untouched
    init slots exactly like the row sweep.  Event planes come back in
    wave layout: evw[t - t_min, m], jdw[t - t_min, m, 4]."""
    a_exgl, a_exgr = a_exg
    b_exgl, b_exgr = b_exg
    W = up - lw + 1
    MR = M + 1
    gop = pack["gop"]
    gep = pack["gep"]
    gap_e1 = pack["gap_e1"]
    gap_e2 = pack["gap_e2"]
    gap_w1 = pack["gap_w1"]
    gap_w2 = pack["gap_w2"]
    gap_w3 = pack["gap_w3"]
    fO = pack["fO"]
    dmask = jnp.asarray(_DIAG_MASK)
    vmask = jnp.asarray(_VERT_MASK)
    hmask = jnp.asarray(_HORI_MASK)
    d2n = jnp.asarray(_D2N)
    v3t = jnp.asarray(_V3)
    h3t = jnp.asarray(_H3)
    trn = pack["trn"]
    sigE = pack["sigE"]
    phs5 = pack["phs5"]
    phs3 = pack["phs3"]
    sig5mix = pack["sig5mix"]
    dinc5 = pack["dinc5"]
    dinc3 = pack["dinc3"]
    pair53 = pack["pair53"]
    sss3 = pack["sss3"]
    apia = pack["api"]
    A1 = pack["A1"]
    A2 = pack["A2"]
    e3idx = pack["e3idx"]
    r1idx = pack["r1idx"]

    mvec = jnp.arange(MR, dtype=I32)
    n_first = jnp.maximum(3 * mvec + lw, 1)
    n_last = jnp.minimum(3 * mvec + up, N)
    nf1 = jnp.roll(n_first, 1)
    nl1 = jnp.roll(n_last, 1)
    internal_v = jnp.logical_or(jnp.bool_(not a_exgr), mvec < M)
    r0_max = min(up, N)
    t_min = 3 + max(3 + lw, 1)
    t_max = 3 * M + min(3 * M + up, N)

    off0 = -lw + 3                       # band slot of (row 0, col 0)
    FIELDS = ("V", "D", "GA", "GB", "J")
    # packed f32 record matrices: one slice/gather yields all 5 fields
    R0M = jnp.stack([jax.lax.dynamic_slice_in_dim(
        H0[f].astype(F32), off0, r0_max + 1) for f in FIELDS], axis=1)
    # left records by ii = 3m - n, decimated by 6 (ii is stride-6 in m
    # for fixed t): L6[q, r] = left[6q + r - LPAD]
    LL = off0
    L0M = jnp.stack([H0[f][:off0 + 1][::-1].astype(F32)
                     for f in FIELDS], axis=1)
    LPAD = 6 * (MR + 2)
    _lrows = LPAD + LL + 1 + 6 * (MR + 2)
    _lrows += (-_lrows) % 6
    L0P = jnp.zeros((_lrows, 5), F32).at[LPAD:LPAD + LL + 1].set(L0M)
    L6 = L0P.reshape(-1, 6, 5)

    # per-position signal pack, decimated by 3 for affine wave reads:
    # cols = [trn, sigE, phs5, phs3, sig5mix, dinc3, sss3, e3idx,
    #         A2[.,0..4]] -> v[m] = TAB[c - 3m] via a reversed slice
    def _padded(x, fill, L):
        x = jnp.asarray(x, F32)
        k = min(x.shape[0], L)
        return jnp.full(L, F32(fill)).at[:k].set(x[:k])
    TL = N + 2
    TABP = jnp.stack([
        _padded(trn, 0, TL), _padded(sigE, 0, TL),
        _padded(phs5, -2, TL), _padded(phs3, -2, TL),
        _padded(sig5mix, 0, TL), _padded(dinc3, 0, TL),
        _padded(sss3, 0, TL), _padded(e3idx, 4, TL),
        _padded(A2[:, 0], 0, TL), _padded(A2[:, 1], 0, TL),
        _padded(A2[:, 2], 0, TL), _padded(A2[:, 3], 0, TL),
        _padded(A2[:, 4], 0, TL)], axis=1)
    NTC = TABP.shape[1]
    TPAD_F = 3 * (MR + 2)
    TPAD_B = 3 * M + 8
    _trows = TPAD_F + TL + TPAD_B
    _trows += (-_trows) % 3
    TP = jnp.full((_trows, NTC), F32(0.0))
    TP = TP.at[:, 2].set(-2.0).at[:, 3].set(-2.0).at[:, 7].set(4.0)
    TP = TP.at[TPAD_F:TPAD_F + TL].set(TABP)
    TP3 = TP.reshape(-1, 3, NTC)

    def aff3r_all(t):
        """One slice covering the four per-wave table reads: returns
        {dc: (MR, NTC) with row m = TABP[t + dc - 2 - 3m]} for
        dc = 0..3 (i.e. columns t-2, t-1, t, t+1)."""
        start = t - 2 - 3 * (MR - 1) + TPAD_F
        B = jax.lax.dynamic_slice(TP, (start, 0), (3 * MR + 1, NTC))
        return [B[dc::3][:MR][::-1] for dc in range(4)]

    def left6_all(t):
        """One slice covering the seven left-record reads: returns
        {dc: (MR, 5) with row m = left[6m + dc - 3 - t]} for
        dc = 0..6."""
        start = LPAD - 3 - t
        B = jax.lax.dynamic_slice(L0P, (start, 0), (6 * MR + 7, 5))
        return [B[dc::6][:MR] for dc in range(7)]

    # apia by 3m + d (d in {-1,0,1}): forward stride-3 slice
    APAD = 6
    _arows = APAD + apia.shape[0] + 6
    _arows += (-_arows) % 3
    AP = jnp.zeros(_arows, F32).at[APAD:APAD + apia.shape[0]].set(
        apia.astype(F32))
    AP3 = AP.reshape(-1, 3)

    def aff3f(d):
        """(MR,) with row m = apia[3m + d]."""
        cc = d + APAD
        r = jnp.mod(cc, 3)
        q = (cc - r) // 3
        return jax.lax.dynamic_slice(AP3, (q, r), (MR, 1))[:, 0]

    eye3 = jnp.eye(3, dtype=jnp.bool_)
    eye5 = jnp.eye(NCAND_H + 1, dtype=jnp.bool_)
    nevv = jnp.full(MR, NEVSEL, F32)
    zi = jnp.zeros(MR, I32)
    VERT_, SLA1_, SLA2_ = I32(4), I32(5), I32(6)
    HORI_, HOR1_, HOR2_ = I32(8), I32(9), I32(10)

    def sel(stacked, k):
        """Per-row pick from a (4, MR) or (3, MR) stack — explicit
        select chain so XLA fuses it (no gather kernel)."""
        out = stacked[0]
        for j in range(1, stacked.shape[0]):
            out = jnp.where(k == j, stacked[j], out)
        return out

    def lane3(arr, li):
        """arr (MR, 3, ...) selected per-row by lane li — fusible."""
        out = arr[:, 0]
        for j in (1, 2):
            cond = (li == j)
            out = jnp.where(cond.reshape((MR,) + (1,) *
                                         (out.ndim - 1)), arr[:, j],
                            out)
        return out

    def take5(lane, idxs):
        """lane (MR, K<=5) gathered at idxs (MR, J) — select chain."""
        out = jnp.broadcast_to(lane[:, 0:1], idxs.shape)
        for j in range(1, lane.shape[1]):
            out = jnp.where(idxs == j, lane[:, j:j + 1], out)
        return out

    def unpack5(mat, use, base=None):
        """(MR, 5) packed record -> 5 typed field vectors, applied
        where `use` over `base` (or guards)."""
        if base is None:
            base = (nevv, zi, zi, zi, zi)
        return (jnp.where(use, mat[:, 0], base[0]),
                jnp.where(use, mat[:, 1].astype(I32), base[1]),
                jnp.where(use, mat[:, 2].astype(I32), base[2]),
                jnp.where(use, mat[:, 3].astype(I32), base[3]),
                jnp.where(use, mat[:, 4].astype(I32), base[4]))

    def same_row(ring, t, n, k, leftmat):
        """(m, n-k) record from the ring at wave t-k; below-band reads
        get the left-column init record (H lanes) or guards (ne)."""
        nk = n - k
        use_ring = nk >= n_first
        out = []
        for fi, rf in enumerate(ring):
            guard = F32(NEVSEL) if fi == 0 else I32(0)
            out.append(jnp.where(use_ring, rf, guard))
        if leftmat is not None:
            use_left = ~use_ring & (nk <= 0) \
                & (3 * mvec - nk >= 0) & (3 * mvec - nk <= LL)
            out = list(unpack5(leftmat, use_left, tuple(out)))
        return tuple(out)

    def row_below(ring, t, n, off, r0row, leftmat):
        """(m-1, n-off) record from the ring at wave t-(3+off), rows
        shifted down by one; m==1 reads the initH top row via r0row
        (a (5,) packed record at column t-3-off)."""
        col = n - off
        ok = (mvec >= 2) & (col >= nf1) & (col <= nl1)
        out = []
        for fi, rf in enumerate(ring):
            guard = F32(NEVSEL) if fi == 0 else I32(0)
            out.append(jnp.where(ok, jnp.roll(rf, 1), guard))
        if leftmat is not None:
            ii = 3 * (mvec - 1) - col
            use_left = ~ok & (mvec >= 2) & (col <= 0) \
                & (ii >= 0) & (ii <= LL)
            out = list(unpack5(leftmat, use_left, tuple(out)))
        is1 = mvec == 1
        if r0row is not None:
            out[0] = jnp.where(is1, r0row[0], out[0])
            for fi in range(1, 5):
                out[fi] = jnp.where(is1, r0row[fi].astype(I32),
                                    out[fi])
        else:
            for fi in range(len(out)):
                guard = F32(NEVSEL) if fi == 0 else I32(0)
                out[fi] = jnp.where(is1, guard, out[fi])
        return tuple(out)

    R0P = jnp.full((r0_max + 1 + 16, 5), F32(NEVSEL))
    R0P = R0P.at[:, 1:].set(0.0).at[8:8 + r0_max + 1].set(R0M)

    def r0_all(t):
        """One slice covering the four top-row record reads: returns
        {dc: (5,) packed record at column t - 6 + dc} for dc = 0..3."""
        start = jnp.clip(t - 6 + 8, 0, R0P.shape[0] - 4)
        B = jax.lax.dynamic_slice(R0P, (start, 0), (4, 5))
        out = []
        for dc in range(4):
            c = t - 6 + dc
            ok = (c >= 0) & (c <= r0_max)
            row = B[dc]
            out.append((jnp.where(ok, row[0], F32(NEVSEL)),
                        jnp.where(ok, row[1], 0.0),
                        jnp.where(ok, row[2], 0.0),
                        jnp.where(ok, row[3], 0.0),
                        jnp.where(ok, row[4], 0.0)))
        return out

    def gapopen(ga, gb, d3):
        pos = (ga >= gb) & (d3 > 0)
        neg = (ga <= gb) & (d3 < 0)
        return jnp.where(pos | neg, gop, F32(0.0))

    qpM = qprof[:MR]                       # row m -> qprof[m]
    qp1M = qprof[1:MR + 1]

    aa26 = jnp.arange(tron.TSIMD, dtype=I32)

    def qprow(prof, aa):
        """Per-row profile lookup as a fusible one-hot contraction."""
        oh = (aa[..., None] == aa26).astype(F32)
        if aa.ndim == 1:
            return jnp.sum(prof * oh, axis=-1)
        return jnp.sum(prof[:, None, :] * oh, axis=-1)

    def is_diag_d(x):
        x = x & 15
        return (x == DIAG) | (x == NEWD)

    def is_vert_d(x):
        x = x & 15
        return ((x >= 4) & (x <= 7)) | (x == 12)

    def is_hori_d(x):
        x = x & 15
        return ((x >= 8) & (x <= 11)) | (x == 13)

    def d2n_of(x):
        """DIR2NOD as a fused select chain (aln.h:42)."""
        x = x & 15
        out = jnp.full_like(x, -1)
        out = jnp.where((x == DIAG) | (x == NEWD), 0, out)
        out = jnp.where(((x >= 8) & (x <= 10)) | (x == 13), 1, out)
        out = jnp.where(((x >= 4) & (x <= 6)) | (x == 12), 2, out)
        out = jnp.where(x == 11, 3, out)
        out = jnp.where(x == 7, 4, out)
        return out

    # e1 pre-init record (fwd2h.h: m==1 && !b_exgl): injected at the
    # single wave where row 1 first reads phase slot 2
    if not b_exgl:
        n1_ = 3 + lw
        n0_ = max(n1_ - 1, 0)
        r_pre = n0_ + 1 - 3
        s_pre = min(max(r_pre - lw + 3, 0), W + 5)
        e1pre = (gap_w3, H0["D"][s_pre], H0["GA"][s_pre],
                 H0["GB"][s_pre], H0["J"][s_pre])
        e1pre_t = int(max(n0_ + 1, 1) + 2 + 3)   # wave of n_first+2
    else:
        e1pre = None
        e1pre_t = -1

    def list_get(arr, li, idx):
        lane = jnp.take_along_axis(arr, li[:, None, None],
                                   axis=1)[:, 0, :]
        return jnp.take_along_axis(lane, idx[:, None], axis=1)[:, 0]

    def wave_step(carry, t):
        (Hh, Neh, Gh, SJh,
         clV, clJ, clD, clCS, nxs, ncands) = carry
        n = t - 3 * mvec
        valid = (mvec >= 1) & (n >= n_first) & (n <= n_last)
        internal = internal_v
        pua = jnp.where(internal, gep, F32(0.0))
        ni = jnp.clip(n, 0, N)
        nm2 = jnp.clip(n - 2, 0, N - 1)

        # affine per-position table reads: ONE slice each for the
        # signal pack, the left records and the top-row records
        TBm2, TBm1, TB0, TBp1 = aff3r_all(t)
        LB = left6_all(t)
        RB = r0_all(t)

        hq = row_below(Hh[5], t, n, 3, RB[0], LB[0])   # (m-1, n-3)
        f1 = row_below(Hh[4], t, n, 2, RB[1], LB[1])   # (m-1, n-2)
        f2 = row_below(Hh[3], t, n, 1, RB[2], LB[2])   # (m-1, n-1)
        f3 = row_below(Hh[2], t, n, 0, RB[3], LB[3])   # (m-1, n)
        gdep = row_below(Gh[2], t, n, 0, None, None)   # G (m-1, n)
        sjr = row_below(SJh[5], t, n, 3, None, None)   # SJ (m-1, n-3)
        b1 = same_row(Hh[0], t, n, 1, LB[4])           # (m, n-1)
        b2 = same_row(Hh[1], t, n, 2, LB[5])           # (m, n-2)
        b3 = same_row(Hh[2], t, n, 3, LB[6])           # (m, n-3)
        eq = same_row(Neh[2], t, n, 3, None)           # ne (m, n-3)
        if e1pre is not None:
            use = (mvec == 1) & (t == e1pre_t)
            eq = tuple(jnp.where(use, p, e)
                       for e, p in zip(eq, e1pre))

        hqV, hqD = hq[0], hq[1]
        sjV, sjDv, sjGA_, sjGB_, sjJ_, sjK_ = sjr
        sE = jnp.where(n >= 2, TBm2[:, 1], F32(0.0))

        # ---- diagonal (or sj crossing) -----------------------------
        sj_used = (sjDv != 0) & (n > 2)
        dv = qprow(qpM, TBm2[:, 0].astype(I32)) + sE
        hV = jnp.where(sj_used, sjV, hqV + dv)
        hGA = jnp.where(sj_used, sjGA_, I32(0))
        hGB = jnp.where(sj_used, sjGB_, I32(0))
        hJ = jnp.where(sj_used, sjJ_, hq[4])
        hDsrc = jnp.where(sj_used, sjDv, hqD)
        hD = jnp.where(is_diag_d(hDsrc), I32(DIAG), I32(NEWD))
        bad = n <= 2
        hV = jnp.where(bad, F32(NEVSEL), hV)
        hD = jnp.where(bad, I32(0), hD)
        hGA = jnp.where(bad, I32(0), hGA)
        hGB = jnp.where(bad, I32(0), hGB)
        hJ = jnp.where(bad, I32(0), hJ)

        # ---- vertical + frameshift deletions -----------------------
        c0 = gdep[0] + gapopen(gdep[2], gdep[3], 3)
        c1 = f1[0] + jnp.where(is_vert_d(f1[1]), gap_e1, gap_w1)
        c2 = f2[0] + jnp.where(is_vert_d(f2[1]), gap_e2, gap_w2)
        c3 = f3[0] + gapopen(f3[2], f3[3], 3)
        cands = jnp.stack([c0, c1, c2, c3])
        vk = jnp.argmax(cands, axis=0).astype(I32)
        srcD = sel(jnp.stack([gdep[1], f1[1], f2[1], f3[1]]), vk)
        srcGB = sel(jnp.stack([gdep[3], f1[3], f2[3], f3[3]]), vk)
        srcJ = sel(jnp.stack([gdep[4], f1[4], f2[4], f3[4]]), vk)
        d3v = jnp.where(vk == 0, 3, vk)
        gV = sel(cands, vk) + pua
        gGA = zi
        gGB = srcGB + d3v
        gJ = srcJ
        gD = jnp.where(vk == 1, SLA1_, jnp.where(vk == 2, SLA2_, VERT_)) \
            | (srcD & SPIN)

        # ---- horizontal + frameshift insertions --------------------
        h3gop = gapopen(b3[2], b3[3], -3)
        hc0 = jnp.where(n > 2, eq[0], F32(NEVSEL))
        hc3 = jnp.where(n > 2, b3[0] + h3gop, F32(NEVSEL))
        hc2 = jnp.where(n > 1, b2[0]
                        + jnp.where(is_hori_d(b2[1]),
                                    gap_e2, gap_w2), F32(NEVSEL))
        hc1 = b1[0] + jnp.where(is_hori_d(b1[1]), gap_e1, gap_w1)
        hcands = jnp.stack([hc0, hc1, hc2, hc3])
        hk = jnp.argmax(hcands, axis=0).astype(I32)
        hsrcV = sel(jnp.stack([eq[0], b1[0], b2[0], b3[0]]), hk)
        hsrcD = sel(jnp.stack([eq[1], b1[1], b2[1], b3[1]]), hk)
        hsrcGA = sel(jnp.stack([eq[2], b1[2], b2[2], b3[2]]), hk)
        hsrcJ = sel(jnp.stack([eq[4], b1[4], b2[4], b3[4]]), hk)
        x = sel(hcands, hk) - hsrcV + gep + sE
        d3h = jnp.where(hk == 0, 3, hk)
        neV = hsrcV + x
        neGA = hsrcGA + d3h
        neGB = zi
        neJ = hsrcJ
        spin = hsrcD & SPIN
        neD = jnp.where(hk == 1, HOR1_, jnp.where(hk == 2, HOR2_, HORI_)) \
            | spin

        # ---- running max -------------------------------------------
        w = zi
        mxV = hV
        w = jnp.where(gV > mxV, I32(2), w)
        mxV = jnp.maximum(gV, mxV)
        w = jnp.where(neV >= mxV, I32(1), w)
        mxV = jnp.maximum(neV, mxV)

        # ---- 3' acceptor merges (per phase) ------------------------
        jx = jnp.zeros((3, MR), jnp.bool_)
        jdon = jnp.zeros((4, MR), I32)
        jcs0 = jnp.zeros(MR, jnp.bool_)
        jnb = jnp.zeros((3, MR), I32)
        lvV = jnp.stack([hV, neV, gV])
        sj_nV, sj_nJ, sj_nK = nevv, zi, zi
        sj_set = jnp.zeros(MR, jnp.bool_)
        sj_clr = jnp.zeros(MR, jnp.bool_)
        p3 = TB0[:, 3].astype(I32)
        has_acc = valid & internal & (n < N) & (p3 != -2)
        nxt_aa = jnp.where(n + 1 < N, TBp1[:, 0].astype(I32),
                           I32(ab.AMB))
        qp1_nxt = qprow(qp1M, nxt_aa)
        api_m1 = aff3f(-1)       # apia[3m - 1]  (phs = 1)
        api_0 = aff3f(0)
        api_p1 = aff3f(1)        # apia[3m + 1]  (phs = -1)
        for pi in range(2):
            if pi == 0:
                phs = jnp.where(p3 == 2, I32(-1), p3.astype(I32))
                ap = has_acc
            else:
                phs = jnp.full(MR, 1, I32)
                ap = has_acc & (p3 == 2)
            nb = n - phs
            is_p1 = phs == 1
            is_m1 = phs == -1
            VAR = jnp.where(is_p1[:, None], TBm1,
                            jnp.where(is_m1[:, None], TBp1, TB0))
            dinc3v = VAR[:, 5].astype(I32)
            sss3v = VAR[:, 6]
            e3v = VAR[:, 7].astype(I32)
            A2row = VAR[:, 8:13].astype(I32)      # (MR, 5)
            sigJ = jnp.where(is_p1, api_m1,
                             jnp.where(is_m1, api_p1, api_0))
            li = jnp.clip(phs + 1, 0, 2)
            # all NCAND_H ranked candidates at once (rank axis = 4)
            nxrow = lane3(nxs, li)[:, :NCAND_H]
            laneV = lane3(clV, li)
            laneJ = lane3(clJ, li)
            laneD = lane3(clD, li)
            laneCS = lane3(clCS, li)
            nc_li = lane3(ncands, li)
            cV = take5(laneV, nxrow)
            cJ = take5(laneJ, nxrow)
            cD = take5(laneD, nxrow)
            cCS = take5(laneCS, nxrow)
            act = ap[:, None] & (jnp.arange(NCAND_H)[None, :]
                                 < nc_li[:, None])      # (MR, 4)
            cJc = jnp.clip(cJ, 0, N)
            xm = (cV + sigJ[:, None]
                  + _penalty(pen_pack, nb[:, None] - cJ)
                  + pair53[dinc5[cJc], dinc3v[:, None]]
                  + sss3v[:, None])
            aa1 = A1[cJc, e3v[:, None]]
            pm1 = jnp.where((aa1 == tron.TRM) | (aa1 == tron.TRM2),
                            fO, F32(0.0))
            qa1 = qprow(qpM, aa1)
            xm = xm + jnp.where((cD == 0) & is_p1[:, None],
                                pm1 + qa1, F32(0.0))
            aa2 = take5(A2row, r1idx[cJc])
            pm2 = jnp.where((aa2 == tron.TRM) | (aa2 == tron.TRM2),
                            fO, F32(0.0))
            qa2 = qprow(qp1M, aa2)
            y = xm + pm2 + qa2
            # sj shadow: LAST qualifying rank wins (the oracle
            # overwrites sj per qualifying candidate in rank order)
            sj_q = (act & (cD == 0) & is_m1[:, None]
                    & (y > (mxV + qp1_nxt)[:, None]))
            any_sj = jnp.any(sj_q, axis=1)
            last = (NCAND_H - 1
                    - jnp.argmax(sj_q[:, ::-1], axis=1)).astype(I32)
            lastc = jnp.clip(last, 0, NCAND_H - 1)[:, None]
            sj_nV = jnp.where(any_sj, take5(y, lastc)[:, 0], sj_nV)
            sj_nJ = jnp.where(any_sj, nb, sj_nJ)
            sj_nK = jnp.where(any_sj,
                              take5(cJ, lastc)[:, 0] + phs, sj_nK)
            sj_set = sj_set | any_sj
            # per-lane best candidate: ranked order = descending value,
            # strict `>` updates, so the FIRST rank achieving the
            # masked max wins (argmax tie -> lowest rank)
            for lane in range(3):
                inlane = act & (cD == lane)
                xmm = jnp.where(inlane, xm, F32(NEVSEL))
                best = jnp.argmax(xmm, axis=1)[:, None]
                bx = jnp.max(xmm, axis=1)
                better = jnp.any(inlane, axis=1) & (bx > lvV[lane])
                lvV = lvV.at[lane].set(jnp.where(better, bx,
                                                 lvV[lane]))
                jx = jx.at[lane].set(jx[lane] | better)
                bJ = take5(cJ, best)[:, 0]
                jdon = jdon.at[lane].set(
                    jnp.where(better, bJ + phs, jdon[lane]))
                jnb = jnb.at[lane].set(jnp.where(better, nb,
                                                 jnb[lane]))
                if lane == 0:
                    bCS = take5(cCS, best)[:, 0]
                    jcs0 = jnp.where(better, bCS != 0, jcs0)
                    merged0 = better
            sj_clr = sj_clr | (ap & is_m1 & merged0)
            mxV = sel(lvV, w)
            for k in range(3):
                upd = jx[k] & (lvV[k] > mxV)
                w = jnp.where(upd, I32(k), w)
                mxV = jnp.where(upd, lvV[k], mxV)
        hV, neV, gV = lvV[0], lvV[1], lvV[2]
        hD = jnp.where(jx[0], hD | SPJCI, hD)
        hJ = jnp.where(jx[0], jnb[0], hJ)
        neD = jnp.where(jx[1], neD | SPJCI, neD)
        neJ = jnp.where(jx[1], jnb[1], neJ)
        gD = jnp.where(jx[2], gD | SPJCI, gD)
        gJ = jnp.where(jx[2], jnb[2], gJ)
        sj_on = sj_set & ~sj_clr

        # ---- write the cell record ---------------------------------
        cVx = sel(jnp.stack([hV, neV, gV]), w)
        cDx = sel(jnp.stack([hD, neD, gD]), w)
        cGAx = sel(jnp.stack([hGA, neGA, gGA]), w)
        cGBx = sel(jnp.stack([hGB, neGB, gGB]), w)
        cJx = sel(jnp.stack([hJ, neJ, gJ]), w)

        # ---- 5' donor pushes (per phase) ---------------------------
        p5 = TB0[:, 2].astype(I32)
        has_don = valid & internal & (n < N) & (p5 != -2)
        lvV2 = jnp.stack([cVx, neV, gV])
        lvD2 = jnp.stack([cDx, neD, gD])
        hd = d2n_of(cDx)
        jidx5 = jnp.arange(NCAND_H + 1)[None, :]
        for pi in range(2):
            if pi == 0:
                phs = jnp.where(p5 == 2, I32(-1), p5.astype(I32))
                dp = has_don
            else:
                phs = jnp.full(MR, 1, I32)
                dp = has_don & (p5 == 2)
            nb = n - phs
            is_p1 = phs == 1
            is_m1 = phs == -1
            sigJ = jnp.where(is_p1, TBm1[:, 4],
                             jnp.where(is_m1, TBp1[:, 4], TB0[:, 4]))
            li = jnp.clip(phs + 1, 0, 2)
            li1h = li[:, None] == jnp.arange(3)        # (MR, 3)
            # lane views, updated across the 3 source lanes then
            # written back once per phase
            nxrow = lane3(nxs, li)
            laneV = lane3(clV, li)
            laneJ = lane3(clJ, li)
            laneD = lane3(clD, li)
            laneCS = lane3(clCS, li)
            ncl = lane3(ncands, li)
            touched = jnp.zeros(MR, jnp.bool_)
            for k in range(3):
                kk = I32(k)
                crossspj = is_p1 & (k == 0)
                ok = dp
                if k == 0:
                    ok = ok & ((hd == 0) | is_p1)
                fV = jnp.where(crossspj, hqV, lvV2[k])
                fD = jnp.where(crossspj, hqD, lvD2[k])
                ok = ok & (fD != 0) & ((fD & SPIN) == 0)
                thr_on = ~crossspj & (kk != hd) & (hd >= 0)
                y = mxV + jnp.where(
                    (hd == 0) | (((kk - hd) % 2) != 0),
                    jnp.where(k // 2 == 1, gop, F32(0.0)),
                    F32(0.0))
                ok = ok & jnp.where(thr_on, fV > y, True)
                xp = fV + sigJ
                nc1 = jnp.minimum(ncl + 1, NCAND_H)
                l_start = jnp.where(ncl < NCAND_H, ncl + 1,
                                    I32(NCAND_H))
                # ranked values are nonincreasing: insertion position
                # = #{j < l_start : vals[j] >= xp} (the swap loop's
                # stopping point); the permutation rotates
                # nxrow[l_start] into `pos`
                vals = take5(laneV, nxrow)
                pos = jnp.sum((jidx5 < l_start[:, None])
                              & (vals >= xp[:, None]),
                              axis=1).astype(I32)
                at_ls = take5(nxrow, l_start[:, None])[:, 0]
                shifted = jnp.concatenate(
                    [nxrow[:, :1], nxrow[:, :-1]], axis=1)
                new_nx = jnp.where(
                    jidx5 < pos[:, None], nxrow,
                    jnp.where(jidx5 == pos[:, None], at_ls[:, None],
                              jnp.where(jidx5 <= l_start[:, None],
                                        shifted, nxrow)))
                accept = ok & (pos < INTR)
                slot1h = (at_ls[:, None]
                          == jnp.arange(NCAND_H + 1)) \
                    & accept[:, None]
                laneV = jnp.where(slot1h, xp[:, None], laneV)
                laneJ = jnp.where(slot1h, nb[:, None], laneJ)
                laneD = jnp.where(slot1h, kk, laneD)
                laneCS = jnp.where(
                    slot1h, jnp.where(crossspj, I32(1),
                                      I32(0))[:, None], laneCS)
                nxrow = jnp.where(ok[:, None], new_nx, nxrow)
                ncl = jnp.where(ok, jnp.where(accept, nc1, nc1 - 1),
                                ncl)
                touched = touched | ok
            wb = (li1h & touched[:, None])[:, :, None]
            clV = jnp.where(wb, laneV[:, None, :], clV)
            clJ = jnp.where(wb, laneJ[:, None, :], clJ)
            clD = jnp.where(wb, laneD[:, None, :], clD)
            clCS = jnp.where(wb, laneCS[:, None, :], clCS)
            nxs = jnp.where(wb, nxrow[:, None, :], nxs)
            ncands = jnp.where(li1h & touched[:, None],
                               ncl[:, None], ncands)

        ev = (w | jnp.where(sj_used, EVH_SJ, 0)
              | (vk << 3) | (hk << 5)
              | jnp.where(jx[0], EVH_JXH, 0)
              | jnp.where(jx[1], EVH_JXF, 0)
              | jnp.where(jx[2], EVH_JXG, 0)
              | jnp.where(jcs0, EVH_CSH, 0))
        ev = jnp.where(valid, ev, I32(-1)).astype(jnp.int16)
        jdon = jdon.at[3].set(jnp.where(sj_used, sjK_, I32(0)))

        newH = (cVx, cDx, cGAx, cGBx, cJx)
        newNe = (neV, neD, neGA, neGB, neJ)
        newG = (gV, gD, gGA, gGB, gJ)
        newSJ = (jnp.where(sj_on, sj_nV, F32(NEVSEL)),
                 jnp.where(sj_on, I32(NEWD), I32(0)),
                 zi, zi,
                 jnp.where(sj_on, sj_nJ, I32(0)),
                 jnp.where(sj_on, sj_nK, I32(0)))
        Hh2 = (newH,) + Hh[:5]
        Neh2 = (newNe,) + Neh[:2]
        Gh2 = (newG,) + Gh[:2]
        SJh2 = (newSJ,) + SJh[:5]

        carry2 = (Hh2, Neh2, Gh2, SJh2, clV, clJ, clD, clCS, nxs,
                  ncands)
        return carry2, (ev, jdon.T, cVx, cDx)


    Hrec0 = (nevv, zi, zi, zi, zi)
    SJrec0 = (nevv, zi, zi, zi, zi, zi)
    carry0 = (tuple(Hrec0 for _ in range(6)),
              tuple(Hrec0 for _ in range(3)),
              tuple(Hrec0 for _ in range(3)),
              tuple(SJrec0 for _ in range(6)),
              jnp.full((MR, 3, NCAND_H + 1), NEVSEL, F32),
              jnp.zeros((MR, 3, NCAND_H + 1), I32),
              jnp.zeros((MR, 3, NCAND_H + 1), I32),
              jnp.zeros((MR, 3, NCAND_H + 1), I32),
              jnp.tile(jnp.arange(NCAND_H + 1, dtype=I32), (MR, 3, 1)),
              jnp.zeros((MR, 3), I32))
    ts = jnp.arange(t_min, t_max + 1, dtype=I32)
    # no unroll: on the H100 unroll 8 halves the warm sweep but makes
    # its compile ~10x longer, and every new (M, N, band) compiles anew
    # (PERF.md); on the CPU unrolling only adds compile time
    carry_f, (evw, jdw, Vw, Dw) = jax.lax.scan(wave_step, carry0, ts)

    # final band arrays reconstructed from the per-wave cell planes
    # (replaces a per-step 36k-wide scatter, which XLA serializes):
    # slot r's final record was written at its last live row
    # m_last(r) = min(M, (N - r) // 3), i.e. wave t = 6*m_last + r.
    r_sl = jnp.arange(-3, W + 3, dtype=I32) + lw      # band layout idx()
    m_last = jnp.minimum(M, jnp.where(N >= r_sl, (N - r_sl) // 3,
                                      -1)).astype(I32)
    m_first = jnp.maximum(1, jnp.where(r_sl >= 1, 1,
                                       (1 - r_sl + 2) // 3))
    touched = (m_last >= m_first) & (r_sl >= lw) & (r_sl <= up)
    tw = jnp.clip(6 * m_last + r_sl - t_min, 0, Vw.shape[0] - 1)
    mc_ = jnp.clip(m_last, 0, MR - 1)
    bandV = jnp.where(touched, Vw[tw, mc_], H0["V"].astype(F32))
    bandD = jnp.where(touched, Dw[tw, mc_], H0["D"].astype(I32))
    return bandV, bandD, evw, jdw


def forward_h_device(qprof, b, exin, ipen, prm, lw, up,
                     exga=(True, True), exgb=(True, True),
                     api=None, lcl=15):
    """Device forwardH + host initH/lastH/traceback; same contract as
    spliced_h_np.forward_h: returns (score, knots)."""
    M = qprof.shape[0] - 2
    N = len(b)
    W = up - lw + 1
    a_exgl, a_exgr = exga
    b_exgl, b_exgr = exgb
    trn = exin.trn

    def idx(r):
        return r - lw + 3

    HV = np.full(W + 6, NEVSEL, np.float32)
    HD = np.zeros(W + 6, np.int32)
    HGA = np.zeros(W + 6, np.int32)
    HGB = np.zeros(W + 6, np.int32)
    HJ = np.zeros(W + 6, np.int32)
    GV = np.full(W + 6, NEVSEL, np.float32)
    GD = np.zeros(W + 6, np.int32)
    GGA = np.zeros(W + 6, np.int32)
    GGB = np.zeros(W + 6, np.int32)
    GJ = np.zeros(W + 6, np.int32)

    def sigS_at(nn):
        if exin.sigS is not None and 0 <= nn < N:
            return float(exin.sigS[nn])
        return 0.0

    def upd_init(i, src, gop, d3):
        HV[i] = HV[src] + gop
        HJ[i] = HJ[src]
        if d3 == 0:
            HGA[i] = HGB[i] = 0
        elif d3 > 0:
            HGA[i], HGB[i] = 0, HGB[src] + d3
        else:
            HGA[i], HGB[i] = HGA[src] - d3, 0

    # ---------------- initH (fwd2h.h:131-200) --------------------------
    # init0_k[slot]: walk bookkeeping for row 0: -1 = own record (DEAD),
    # 1..3 = chained from slot-k, 0 = untouched
    init0_k = np.zeros(W + 6, np.int8)
    HV[idx(0)] = max(sigS_at(1), 0.0)
    HD[idx(0)] = DEAD if a_exgl else DIAG
    init0_k[idx(0)] = -1
    rr = min(up, N)
    if a_exgl:
        for n in range(1, rr + 1):
            i = idx(n)
            if n < 3:
                HV[i] = max(sigS_at(n + 1), 0.0)
                HD[i] = DEAD
                HJ[i] = n
                init0_k[i] = -1
                continue
            x = 0.0
            if lcl & 1:
                x = max(x, sigS_at(n + 1))
            if (lcl & 4) and n < N:
                x = max(x, float(exin.sig3[n]))
            cand = [x,
                    HV[idx(n - 1)] + (prm.gap_w1),
                    HV[idx(n - 2)] + (prm.gap_w2),
                    HV[idx(n - 3)]
                    + prm.term_gap_ext3(n - HJ[idx(n - 3)])
                    + (float(exin.sigE[n - 2]) if n >= 2 else 0.0)]
            # inline first-max (np.argmax per iteration cost 0.44 s
            # of the flagship e2e across these 68k-iteration loops)
            k = 0
            if cand[1] > cand[0]:
                k = 1
            if cand[2] > cand[k]:
                k = 2
            if cand[3] > cand[k]:
                k = 3
            if k:
                upd_init(i, idx(n - k), cand[k] - HV[idx(n - k)], -k)
                HD[i] = HORI3[k]
                init0_k[i] = k
            else:
                HV[i] = x
                HD[i] = DEAD
                HJ[i] = n
                HGA[i] = HGB[i] = 0
                init0_k[i] = -1
    # left column
    rr = max(lw, -3 * M)
    m = 0
    initc = {}              # (m, n) -> record knot for b_exgl inits
    for ii in range(1, -rr + 1):
        r = -ii
        i = idx(r)
        if b_exgl:
            HV[i] = 0.0
            HD[i] = DEAD
            HJ[i] = ii % 3
            initc[r] = (m, ii % 3)
        elif ii < 3:
            upd_init(i, idx(r + ii),
                     prm.gap_w1 if ii == 1 else prm.gap_w2, ii)
            HD[i] = VERT + ii
        else:
            src = idx(r + 3)
            gnp = prm.gop if HGA[src] >= HGB[src] else 0.0
            upd_init(i, src, gnp + prm.unp, 3)
            HD[i] = VERT
        if ii % 3 == 0:
            m += 1

    # ---------------- device sweep -------------------------------------
    if api is not None and not isinstance(api, np.ndarray):
        api_arr = np.array([float(api(pt)) for pt in range(3 * M + 4)],
                           np.float32)
    elif api is not None:
        api_arr = np.asarray(api, np.float32)
    else:
        api_arr = np.zeros(3 * M + 4, np.float32)

    A1, A2, e3idx, r1idx = _codon_tables(b)
    pack = dict(
        gop=jnp.float32(prm.gop), gep=jnp.float32(prm.gep),
        gap_e1=jnp.float32(prm.gap_e1), gap_e2=jnp.float32(prm.gap_e2),
        gap_w1=jnp.float32(prm.gap_w1), gap_w2=jnp.float32(prm.gap_w2),
        gap_w3=jnp.float32(prm.gap_w3), fO=jnp.float32(prm.fO),
        trn=jnp.asarray(np.asarray(trn, np.int32)),
        sigE=jnp.asarray(np.asarray(exin.sigE, np.float32)),
        phs5=jnp.asarray(np.asarray(exin.phs5[:N + 1], np.int32)),
        phs3=jnp.asarray(np.asarray(exin.phs3[:N + 1], np.int32)),
        sig5mix=jnp.asarray(np.asarray(exin.sig.sig5, np.float32)),
        dinc5=jnp.asarray(np.asarray(exin.sig.dinc5, np.int64)),
        dinc3=jnp.asarray(np.asarray(exin.sig.dinc3, np.int64)),
        pair53=jnp.asarray(np.asarray(exin.sig.pair53, np.float32)),
        sss3=jnp.asarray(np.asarray(exin.sig.sss3, np.float32)),
        api=jnp.asarray(api_arr),
        A1=jnp.asarray(A1), A2=jnp.asarray(A2),
        e3idx=jnp.asarray(e3idx), r1idx=jnp.asarray(r1idx))
    pen_pack = _pen_arrays(ipen)
    H0 = dict(V=jnp.asarray(HV), D=jnp.asarray(HD), GA=jnp.asarray(HGA),
              GB=jnp.asarray(HGB), J=jnp.asarray(HJ))
    bandV, bandD, evs, jdons = _sweep_h(
        M, N, lw, up, (a_exgl, a_exgr), (b_exgl, b_exgr),
        lcl, H0, jnp.asarray(qprof, jnp.float32), pack, pen_pack)
    t_min = 3 + max(3 + lw, 1)
    fHV = np.asarray(bandV).astype(np.float64)
    fHD = np.asarray(bandD)
    # the whole (waves, M+1) int16 event plane comes to the host for the
    # walk; jdons stays on device and the walker touches it only at the
    # few junction/sj events, fetching single rows lazily
    evs = np.asarray(evs)
    return _finish_h(fHV, fHD, evs, jdons, t_min, M, N, lw, up,
                     (a_exgl, a_exgr), (b_exgl, b_exgr), lcl, exin,
                     prm, init0_k, initc, idx, W)


def _finish_h(fHV, fHD, evs, jdons, t_min, M, N, lw, up, exga, exgb,
              lcl, exin, prm, init0_k, initc, idx, W):
    """Host lastH (fwd2h.h:203-268) + traceback walk over the fetched
    event planes."""
    a_exgl, a_exgr = exga
    b_exgl, b_exgr = exgb

    def sigT_at(nn):
        if exin.sigT is not None and 0 <= nn < N:
            return float(exin.sigT[nn])
        return NEVSEL

    m3 = 3 * M
    rw = max(lw, -m3)
    r9 = N - m3
    # origin cell of the record currently held at each slot
    orig = {}
    for r in range(rw, min(up, N) + 1):
        if r <= r9:
            orig[r] = (M, m3 + r)
        else:
            mm = (N - r) // 3
            orig[r] = (mm, 3 * mm + r)
    extra = {}            # slot r -> extra lastH knot (sigT records)
    lV = fHV.copy()
    lD = fHD.copy()
    glen = [0, 0, 0]
    best_r = r9
    best_val = lV[idx(r9)]
    if a_exgr:
        p = 0
        rf = rw
        while rf <= r9:
            hh = idx(rf)
            if p == 3:
                p = 0
            glen[p] += 3
            nn = rf + m3
            cand = [lV[hh], NEVSEL, NEVSEL]
            if rf - rw >= 3 and lD[hh - 3] != DEAD:
                cand[1] = (lV[hh - 3]
                           + (float(exin.sigE[nn - 2]) if nn >= 2 else 0)
                           + prm.term_gap_ext3(glen[p]))
                if (lcl & 2) and not (lD[hh] & SPIN):
                    cand[2] = lV[hh - 3] + sigT_at(nn - 2)
            # inline first-max (np.argmax on a 3-list cost 0.44 s
            # of the flagship e2e across these 68k-iteration loops)
            k = 0
            if cand[1] > cand[0]:
                k = 1
            if cand[2] > cand[k]:
                k = 2
            if k:
                lV[hh] = cand[k]
                lD[hh] = lD[hh - 3]
                orig[rf] = orig[rf - 3]
                extra[rf] = extra.get(rf - 3)
            elif not _IS_HORI[int(lD[hh]) & 15]:
                glen[p] = 0
            if k == 2:
                lD[hh] = DEAD
                if lV[hh] > best_val:
                    best_val = lV[hh]
                    best_r = rf
                    extra[rf] = (M, nn - 3)
            else:
                if k:
                    lD[hh] = HORI
                if cand[k] > best_val:
                    best_val = cand[k]
                    best_r = rf
            rf += 1
            p += 1
    if b_exgr:
        for r in range(min(up, N), r9, -1):
            x = fHV[idx(r)] + (prm.extra_gop if r % 3 else 0.0)
            if x > best_val:
                best_val = x
                best_r = r
    pdel = best_r - r9
    rf, rwn = M, N
    if pdel > 0:
        rf -= (pdel + 2) // 3
        pp = pdel % 3
        if pp:
            rwn -= (3 - pp)
    elif pdel < 0:
        rwn += pdel

    knots = [(rf, rwn)]
    ex = extra.get(best_r)
    if ex is not None:
        knots.append(ex)
    om, on = orig.get(best_r, (M, m3 + best_r))
    back = _walk_h(evs, jdons, t_min, om, on, M, N, lw, up,
                   init0_k, initc, a_exgl, b_exgl, idx)
    knots.extend(back)
    knots.reverse()
    return float(best_val), knots


def _walk_h(evs, jdons, t_min, m0, n0, M, N, lw, up, init0_k, initc,
            a_exgl, b_exgl, idx):
    """Backward walk over wave-layout event planes (evs[t - t_min, m]);
    knots in backward order."""
    knots = []
    m, n = m0, n0
    state = 0

    def ev_at(mm, nn):
        ti = 3 * mm + nn - t_min
        if mm < 1 or mm >= evs.shape[1] or ti < 0 or ti >= evs.shape[0]:
            return None
        e = int(evs[ti, mm])
        return None if e < 0 else e

    def cls_at(mm, nn):
        if mm == 0:
            k = int(init0_k[idx(nn - 0)]) if 0 <= idx(nn) < len(init0_k) \
                else 0
            if k == -1:
                return "dead"
            if k > 0:
                return "hori"
            return "dead"
        e = ev_at(mm, nn)
        if e is None:
            return "dead" if b_exgl else "vert"
        return ("diag", "hori", "vert")[e & EVH_WINNER]

    guard = 0
    while guard < 6 * (M + N + 8):
        guard += 1
        if m <= 0:
            break
        e = ev_at(m, n)
        if e is None:
            break
        _jd = None

        def jd(i, _m=m, _n=n):
            # lazy single-row fetch (jdons may live on device); only
            # junction/sj cells ever need it
            nonlocal _jd
            if _jd is None:
                _jd = np.asarray(jdons[3 * _m + _n - t_min, _m])
            return int(_jd[i])

        if state == 0:
            w = e & EVH_WINNER
            if w == 0:
                if e & EVH_JXH:
                    knots.append((m, n))
                    knots.append((m, jd(0)))
                    if e & EVH_CSH:
                        n = jd(0) - 3
                        m -= 1
                        if cls_at(m, n) != "diag":
                            knots.append((m, n))
                        continue
                    n = jd(0)
                    continue
                if e & EVH_SJ:
                    knots.append((m - 1, jd(3)))
                    m -= 1
                    n = jd(3)
                    continue
                if cls_at(m - 1, n - 3) != "diag":
                    knots.append((m - 1, n - 3))
                m -= 1
                n -= 3
                continue
            state = int(w)
            continue
        if state == 1:
            if e & EVH_JXF:
                knots.append((m, n))
                knots.append((m, jd(1)))
                n = jd(1)
                continue
            hk = (e & EVH_HK) >> 5
            if hk == 0:
                n -= 3
                continue
            n -= (1, 1, 2, 3)[hk]
            state = 0
            continue
        # state 2: vertical
        if e & EVH_JXG:
            knots.append((m, n))
            knots.append((m, jd(2)))
            n = jd(2)
            continue
        vk = (e & EVH_VK) >> 3
        if vk == 0:
            m -= 1
            continue
        n -= (0, 2, 1, 0)[vk]
        m -= 1
        state = 0
        continue

    # init records
    if m == 0:
        # follow the init-row chain to its DEAD record
        nn = n
        guard = 0
        while guard < W_GUARD(N):
            guard += 1
            i = idx(nn)
            if not (0 <= i < len(init0_k)):
                break
            k = int(init0_k[i])
            if k > 0:
                nn -= k
                continue
            break
        knots.append((0, nn))
    else:
        r = n - 3 * m
        rec = initc.get(r)
        if rec is not None:
            knots.append(rec)
        else:
            knots.append((m, max(n, 0)))
    return knots


def W_GUARD(N):
    return N + 8
