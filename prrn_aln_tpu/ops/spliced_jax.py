"""Device (JAX) spliced alignment DP: cDNA vs genomic DNA (fwd2s).

Banded ``lax.scan`` formulation of the reference recurrence
(src/fwd2s.h:126-380 initS/forwardS/lastS with the RVPDJ_nv record),
matching ``ops/spliced_np.spliced_align_np`` cell-for-cell:

* outer scan over cDNA rows m, inner scan over band slots (r = n - m);
  H/G lanes live in (W+2,) field arrays carried across rows;
* the per-row donor candidate list (NCAND_S=4 slots, INTR=2 fresh
  ranks) is a fixed-size scan state (values, donor positions, lanes,
  rank permutation) with the reference's insertion-sort unrolled;
* intron penalty / splice signals are table gathers (penalty table +
  log tail, pair53/sss3 arrays), so the whole sweep jits;
* traceback replaces the reference's Vmf record chain (vmf.h:36-57)
  with dense per-cell event planes (winner lane, vert/hori restarts,
  per-lane junction merges + donor positions) walked on the host into
  the same knot chain the oracle emits.

The kernel runs in float32 on device; scores match the float64 oracle to
~1e-4 relative and paths are identical whenever score ties are not
float-marginal.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .spliced_np import (NEVSEL, DEAD, DIAG, NEWD, VERT, HORI, SPIN, SPJC,
                         SPJCI, DIR2NOD, NCAND_S, INTR, stdskl,
                         _IS_DIAG, _IS_VERT, _IS_HORI)

F32 = jnp.float32
I32 = jnp.int32

# event plane bit layout
EV_WINNER = 0x3          # 0=h(diag) 1=f1(hori) 2=g(vert)
EV_VNEW = 1 << 2         # vertical lane restarted from H
EV_HNEW = 1 << 3         # horizontal lane restarted from H
EV_JXH = 1 << 4          # junction merged into h lane
EV_JXF = 1 << 5
EV_JXG = 1 << 6

_DIAG_MASK = np.array([1 if _IS_DIAG[d] else 0 for d in range(16)], np.int32)
_VERT_MASK = np.array([1 if _IS_VERT[d] else 0 for d in range(16)], np.int32)
_HORI_MASK = np.array([1 if _IS_HORI[d] else 0 for d in range(16)], np.int32)
_DIR2NOD = np.array(DIR2NOD, np.int32)


def _pen_arrays(ipen):
    return dict(table=jnp.asarray(ipen.table, F32),
                llmt=jnp.int32(ipen.llmt), rlmt=jnp.int32(ipen.rlmt),
                mu=jnp.float32(ipen.mu), int_ep=jnp.float32(ipen.int_ep),
                int_fx=jnp.float32(ipen.int_fx),
                gap_wi=jnp.float32(ipen.gap_wi))


def _penalty(pen, length):
    """IntronPenalty::Penalty as a jnp expression."""
    li = jnp.clip(length - pen["llmt"], 0, pen["table"].shape[0] - 1)
    tab = pen["table"][li]
    tail = pen["int_fx"] + pen["int_ep"] * jnp.log(
        jnp.maximum(length.astype(F32) - pen["mu"], 1.0))
    out = jnp.where(length >= pen["rlmt"], tail, tab)
    out = jnp.where(length < pen["llmt"], F32(NEVSEL), out)
    out = jnp.where(length < 0, pen["gap_wi"], out)
    return out


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _sweep(la, lb, lw, up, a_exg, b_exg,
           H0, G0, S, sig_pack, pen_pack):
    """Run forwardS; returns final (H, G) field arrays and event planes.

    H0/G0: dicts of (W+2,) field arrays from initS.
    S: (la, lb) match scores. sig_pack: signal arrays over the genome.
    """
    a_exgl, a_exgr = a_exg
    b_exgl, b_exgr = b_exg
    W = up - lw + 1
    gop = sig_pack["gop"]
    gep = sig_pack["gep"]
    dmask = jnp.asarray(_DIAG_MASK)
    vmask = jnp.asarray(_VERT_MASK)
    hmask = jnp.asarray(_HORI_MASK)
    d2n = jnp.asarray(_DIR2NOD)
    cano3 = sig_pack["cano3"]
    cano5 = sig_pack["cano5"]
    sig5 = sig_pack["sig5"]
    dinc5 = sig_pack["dinc5"]
    dinc3 = sig_pack["dinc3"]
    pair53 = sig_pack["pair53"]
    sss3 = sig_pack["sss3"]

    m_start = 1 if a_exgl else 0
    slots = jnp.arange(1, W + 1)

    def row_step(carry, m):
        HV, HD, HGA, HGB, HJ, GV, GD, GGA, GGB, GJ = carry
        first_row = (m == 0)
        internal = jnp.logical_or(not a_exgr, m < la)
        pua = jnp.where(internal, gep, F32(0.0))
        n_lo = jnp.maximum(m + lw, 1)
        n_hi = jnp.minimum(m + up, lb)
        srow = S[jnp.maximum(m - 1, 0)]

        def cell(ic, xs):
            (f1V, f1D, f1GA, f1GB, f1J,
             hlV, hlJ, hlD, nx, ncand,
             hpV, hpD, hpGA, hpGB, hpJ) = ic
            s = xs
            n = m + lw + s - 1
            valid = (n >= n_lo) & (n <= n_hi)
            # sources
            dV, dD, dJ = HV[s], HD[s], HJ[s]                # (m-1, n-1)
            uV, uD, uGA, uGB, uJ = HV[s+1], HD[s+1], HGA[s+1], HGB[s+1], HJ[s+1]
            guV, guGA, guGB, guJ = GV[s+1], GGA[s+1], GGB[s+1], GJ[s+1]

            bscr = srow[jnp.clip(n - 1, 0, lb - 1)]

            # ---- diagonal ----
            hV = dV + bscr
            hD = jnp.where(dmask[dD & 15] == 1, I32(DIAG), I32(NEWD))
            hGA = I32(0)
            hGB = I32(0)
            hJ = dJ
            no_diag = first_row
            hV = jnp.where(no_diag, F32(NEVSEL), hV)
            hD = jnp.where(no_diag, I32(DEAD), hD)

            # ---- vertical ----
            gopv = jnp.where(uGA >= uGB, gop, F32(0.0))
            gnpv = jnp.where(guGA >= guGB, gop, F32(0.0))
            vnew = (vmask[uD & 15] == 0) & (uV + gopv > guV + gnpv)
            gV = jnp.where(vnew, uV + gopv, guV + gnpv) + pua
            gJ = jnp.where(vnew, uJ, guJ)
            gGA = I32(0)
            gGB = jnp.where(vnew, uGB, guGB) + 1
            gD = I32(VERT)
            gV = jnp.where(no_diag, F32(NEVSEL), gV)
            vnew = vnew & ~no_diag

            # ---- horizontal ----
            goph = jnp.where(hpGA <= hpGB, gop, F32(0.0))
            hnew = (hmask[hpD & 15] == 0) & (hpV + goph > f1V)
            nf1V = jnp.where(hnew, hpV + goph, f1V)
            nf1J = jnp.where(hnew, hpJ, f1J)
            nf1GA = jnp.where(hnew, hpGA, f1GA) + 1
            nf1GB = I32(0)
            nf1V = nf1V + gep
            nf1D = (jnp.where(hnew, hpD, f1D) & SPIN) + HORI

            # ---- running max (h -> g strict -> f1 ties) ----
            w = I32(0)
            mxV = hV
            w = jnp.where(gV > mxV, I32(2), w)
            mxV = jnp.maximum(gV, mxV)
            w = jnp.where(nf1V >= mxV, I32(1), w)
            mxV = jnp.maximum(nf1V, mxV)

            # ---- 3' acceptor: merge candidates ----
            is_acc = valid & internal & (cano3[n] > 0)
            jx = jnp.zeros(3, jnp.bool_)
            jdon = jnp.zeros(3, I32)
            lv = jnp.stack([hV, nf1V, gV])
            for l in range(NCAND_S):
                idx = nx[l]
                act = is_acc & (l < ncand)
                dlen = n - hlJ[idx]
                x = (hlV[idx] + _penalty(pen_pack, dlen)
                     + pair53[dinc5[hlJ[idx]], dinc3[n]] + sss3[n])
                lane = jnp.clip(hlD[idx], 0, 2)
                better = act & (x > lv[lane])
                lv = jnp.where(better, lv.at[lane].set(x), lv)
                jx = jnp.where(better, jx.at[lane].set(True), jx)
                jdon = jnp.where(better, jdon.at[lane].set(hlJ[idx]), jdon)
            hV = lv[0]
            nf1V = lv[1]
            gV = lv[2]
            hD = jnp.where(jx[0], hD | SPJCI, hD)
            hJ = jnp.where(jx[0], n, hJ)
            nf1D = jnp.where(jx[1], nf1D | SPJCI, nf1D)
            nf1J = jnp.where(jx[1], n, nf1J)
            gD = jnp.where(jx[2], gD | SPJCI, gD)
            gJ = jnp.where(jx[2], n, gJ)
            # merged lanes contest the max strictly, in lane order
            mxV = jnp.stack([hV, nf1V, gV])[w]
            for k in range(3):
                upd = jx[k] & (lv[k] > mxV)
                w = jnp.where(upd, I32(k), w)
                mxV = jnp.where(upd, lv[k], mxV)

            # ---- write the cell record (h <- mx) ----
            cV = jnp.stack([hV, nf1V, gV])[w]
            cD = jnp.stack([hD, nf1D, gD])[w]
            cGA = jnp.stack([hGA, nf1GA, gGA])[w]
            cGB = jnp.stack([hGB, nf1GB, gGB])[w]
            cJ = jnp.stack([hJ, nf1J, gJ])[w]

            # ---- 5' donor: push candidates ----
            is_don = valid & internal & (cano5[n] > 0)
            hd = d2n[cD & 15]
            sj = sig5[n]
            lvD = jnp.stack([cD, nf1D, gD])
            lvV = jnp.stack([cV, nf1V, gV])
            for k in range(3):
                kk = I32(k)
                ok = is_don
                if k == 0:
                    ok = ok & (hd == 0)
                fD = lvD[k]
                fV = lvV[k]
                ok = ok & (fD != 0) & ((fD & SPIN) == 0)
                thr_on = (kk != hd) & (hd >= 0) & (k != 0)
                y = mxV + jnp.where(
                    (hd == 0) | (((kk - hd) % 2) != 0),
                    jnp.where(kk // 2 == 1, gop, F32(0.0)), F32(0.0))
                ok = ok & jnp.where(thr_on, fV > y, True)
                x = fV + sj
                # insertion sort over ranks (fwd2s.h:362 semantics)
                nc1 = jnp.minimum(ncand + 1, NCAND_S)
                ncand_new = jnp.where(ok, nc1, ncand)
                l_start = jnp.where(ncand < NCAND_S, ncand + 1,
                                    I32(NCAND_S))
                pos = I32(0)
                broken = jnp.logical_not(ok)
                nx2 = nx
                for l in range(NCAND_S - 1, -1, -1):
                    active = (l < l_start) & ~broken
                    gt = x > hlV[nx2[l]]
                    do_swap = active & gt
                    tmp_l = nx2[l]
                    tmp_l1 = nx2[l + 1]
                    nx2 = nx2.at[l].set(jnp.where(do_swap, tmp_l1, tmp_l))
                    nx2 = nx2.at[l + 1].set(jnp.where(do_swap, tmp_l,
                                                      tmp_l1))
                    stop = active & ~gt
                    pos = jnp.where(stop, I32(l + 1), pos)
                    broken = broken | stop
                accept = ok & (pos < INTR)
                slot = nx2[jnp.clip(pos, 0, NCAND_S)]
                hlV = jnp.where(accept, hlV.at[slot].set(x), hlV)
                hlJ = jnp.where(accept, hlJ.at[slot].set(n), hlJ)
                hlD = jnp.where(accept, hlD.at[slot].set(kk), hlD)
                nx = jnp.where(ok, nx2, nx)
                ncand = jnp.where(ok & ~accept, ncand_new - 1, ncand_new)

            ev = (w | jnp.where(vnew, EV_VNEW, 0)
                  | jnp.where(hnew, EV_HNEW, 0)
                  | jnp.where(jx[0], EV_JXH, 0)
                  | jnp.where(jx[1], EV_JXF, 0)
                  | jnp.where(jx[2], EV_JXG, 0))

            # retain old values on invalid slots
            outH = tuple(jnp.where(valid, new, old) for new, old in
                         zip((cV, cD, cGA, cGB, cJ),
                             (HV[s], HD[s], HGA[s], HGB[s], HJ[s])))
            outG = tuple(jnp.where(valid, new, old) for new, old in
                         zip((gV, gD, gGA, gGB, gJ),
                             (GV[s], GD[s], GGA[s], GGB[s], GJ[s])))
            hp_new = tuple(jnp.where(valid, new, old) for new, old in
                           zip((cV, cD, cGA, cGB, cJ),
                               (HV[s], HD[s], HGA[s], HGB[s], HJ[s])))
            nf1 = (jnp.where(valid, nf1V, f1V),
                   jnp.where(valid, nf1D, f1D),
                   jnp.where(valid, nf1GA, f1GA),
                   jnp.where(valid, nf1GB, f1GB),
                   jnp.where(valid, nf1J, f1J))
            carry2 = (*nf1, hlV, hlJ, hlD, nx, ncand, *hp_new)
            ev = jnp.where(valid, ev, I32(-1))
            return carry2, (outH, outG, ev, jdon)

        ic0 = (F32(NEVSEL), I32(0), I32(0), I32(0), I32(0),
               jnp.full(NCAND_S + 1, NEVSEL, F32),
               jnp.zeros(NCAND_S + 1, I32),
               jnp.zeros(NCAND_S + 1, I32),
               jnp.arange(NCAND_S + 1, dtype=I32), I32(0),
               HV[0], HD[0], HGA[0], HGB[0], HJ[0])
        _, (oh, og, ev, jdon) = jax.lax.scan(cell, ic0, slots)
        HV2 = HV.at[1:W + 1].set(oh[0])
        HD2 = HD.at[1:W + 1].set(oh[1])
        HGA2 = HGA.at[1:W + 1].set(oh[2])
        HGB2 = HGB.at[1:W + 1].set(oh[3])
        HJ2 = HJ.at[1:W + 1].set(oh[4])
        GV2 = GV.at[1:W + 1].set(og[0])
        GD2 = GD.at[1:W + 1].set(og[1])
        GGA2 = GGA.at[1:W + 1].set(og[2])
        GGB2 = GGB.at[1:W + 1].set(og[3])
        GJ2 = GJ.at[1:W + 1].set(og[4])
        return (HV2, HD2, HGA2, HGB2, HJ2,
                GV2, GD2, GGA2, GGB2, GJ2), (ev, jdon)

    carry0 = (H0["V"], H0["D"], H0["GA"], H0["GB"], H0["J"],
              G0["V"], G0["D"], G0["GA"], G0["GB"], G0["J"])
    rows = jnp.arange(m_start, la + 1)
    carry_f, (evs, jdons) = jax.lax.scan(row_step, carry0, rows)
    return carry_f, evs, jdons


def spliced_align_device(a, b, signals, ipen, mtx, u=2.0, v=6.0,
                         lw=None, up=None,
                         exga=(True, True), exgb=(True, True)):
    """Device forwardS + host traceback; same contract as
    spliced_align_np (score, skl)."""
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = len(a), len(b)
    if lw is None or up is None:
        from .window import stripe
        wdw = stripe(la, lb, 100)
        lw, up = wdw.lw, wdw.up
    W = up - lw + 1
    a_exgl, a_exgr = exga
    b_exgl, b_exgr = exgb
    gop_, gep_ = -float(v), -float(u)

    # ---------------- initS on host (fwd2s.h:126) ----------------------
    HV = np.full(W + 2, NEVSEL, np.float32)
    HD = np.zeros(W + 2, np.int32)
    HGA = np.zeros(W + 2, np.int32)
    HGB = np.zeros(W + 2, np.int32)
    HJ = np.zeros(W + 2, np.int32)
    GV = np.full(W + 2, NEVSEL, np.float32)
    GD = np.zeros(W + 2, np.int32)
    GGA = np.zeros(W + 2, np.int32)
    GGB = np.zeros(W + 2, np.int32)
    GJ = np.zeros(W + 2, np.int32)

    def idx(r):
        return r - lw + 1

    HV[idx(0)] = 0.0
    HD[idx(0)] = DEAD if a_exgl else DIAG
    if a_exgl:
        for r in range(1, min(up, lb) + 1):
            HV[idx(r)] = 0.0
            HD[idx(r)] = DIAG
            HJ[idx(r)] = r
            HGB[idx(r)] = r
    m = 0
    for r in range(-1, max(lw, -la) - 1, -1):
        m += 1
        i = idx(r)
        if b_exgl:
            HV[i] = 0.0
            HD[i] = DEAD
            HJ[i] = 0
        else:
            src = idx(r + 1)
            gnp = gop_ if HGA[src] >= HGB[src] else 0.0
            HV[i] = HV[src] + gnp + gep_
            HD[i] = VERT
            HJ[i] = HJ[src]
            HGA[i] = 0
            HGB[i] = HGB[src] + 1

    S = mtx[a.astype(np.int64)][:, b.astype(np.int64)].astype(np.float32) \
        if la else np.zeros((1, max(lb, 1)), np.float32)

    sig_pack = dict(
        cano3=jnp.asarray(np.asarray(signals.cano3, np.int32)),
        cano5=jnp.asarray(np.asarray(signals.cano5, np.int32)),
        sig5=jnp.asarray(np.asarray(signals.sig5, np.float32)),
        dinc5=jnp.asarray(np.asarray(signals.dinc5, np.int64)),
        dinc3=jnp.asarray(np.asarray(signals.dinc3, np.int64)),
        pair53=jnp.asarray(np.asarray(signals.pair53, np.float32)),
        sss3=jnp.asarray(np.asarray(signals.sss3, np.float32)),
        gop=jnp.float32(gop_), gep=jnp.float32(gep_))
    pen_pack = _pen_arrays(ipen)

    H0 = dict(V=jnp.asarray(HV), D=jnp.asarray(HD), GA=jnp.asarray(HGA),
              GB=jnp.asarray(HGB), J=jnp.asarray(HJ))
    G0 = dict(V=jnp.asarray(GV), D=jnp.asarray(GD), GA=jnp.asarray(GGA),
              GB=jnp.asarray(GGB), J=jnp.asarray(GJ))

    carry_f, evs, jdons = _sweep(la, lb, lw, up,
                                 (a_exgl, a_exgr), (b_exgl, b_exgr),
                                 H0, G0, jnp.asarray(S),
                                 sig_pack, pen_pack)
    HVf = np.asarray(carry_f[0])
    evs = np.asarray(evs)
    jdons = np.asarray(jdons)

    # ---------------- lastS on host (fwd2s.h:171) -----------------------
    r9 = lb - la
    mx_r = r9
    best = HVf[idx(r9)]
    if b_exgr:
        for r in range(min(up, lb), r9, -1):
            if HVf[idx(r)] > best:
                best = HVf[idx(r)]
                mx_r = r
    if a_exgr:
        for r in range(max(lw, -la), r9 + 1):
            if HVf[idx(r)] > best:
                best = HVf[idx(r)]
                mx_r = r
    i = mx_r - r9
    rf, rw_ = la, lb
    if i > 0:
        rf -= i
    if i < 0:
        rw_ += i

    knots = _traceback(evs, jdons, rf, rw_, la, lb, lw, up,
                       a_exgl, b_exgl, 1 if a_exgl else 0)
    knots.append((rf, rw_))
    return float(best), stdskl(knots)


def _traceback(evs, jdons, m0, n0, la, lb, lw, up, a_exgl, b_exgl,
               m_start):
    """Walk the event planes back from (m0, n0); returns knots in
    forward order (matching the oracle's reversed record chain)."""
    knots: list[tuple[int, int]] = []
    m, n = m0, n0
    state = 0          # 0 = cell record (H), 1 = f1 lane, 2 = g lane

    def ev_at(mm, nn):
        s = nn - mm - lw           # 0-based slot within the W planes
        mi = mm - m_start
        if mi < 0 or s < 0 or s >= evs.shape[1] or mi >= evs.shape[0]:
            return None
        e = int(evs[mi, s])
        return None if e < 0 else e

    def cls_at(mm, nn):
        """diag/hori/vert/dead class of the final record at a cell."""
        if mm == 0:
            # init row: origin DEAD when a_exgl else DIAG; others DIAG
            e = ev_at(0, nn)
            if e is None:
                if nn == 0:
                    return "dead" if a_exgl else "diag"
                return "diag" if a_exgl else "dead"
            return ("diag", "hori", "vert")[e & EV_WINNER]
        if nn <= 0 or nn - mm < lw:
            return "dead" if b_exgl else "vert"
        e = ev_at(mm, nn)
        if e is None:
            return "dead"
        return ("diag", "hori", "vert")[e & EV_WINNER]

    guard = 0
    while guard < 4 * (la + lb + 4):
        guard += 1
        if m <= 0 or n <= 0 or n - m < lw:
            break
        e = ev_at(m, n)
        if e is None:
            break
        s = n - m - lw
        mi = m - m_start
        if state == 0:
            w = e & EV_WINNER
            if w == 0:
                if e & EV_JXH:
                    j = int(jdons[mi, s, 0])
                    knots.append((m, n))
                    knots.append((m, j))
                    n = j
                    continue
                # diagonal: knot at source when its class isn't diag
                if cls_at(m - 1, n - 1) != "diag":
                    knots.append((m - 1, n - 1))
                m -= 1
                n -= 1
                continue
            state = w
            continue
        if state == 1:                    # f1 lane
            if e & EV_JXF:
                j = int(jdons[mi, s, 1])
                knots.append((m, n))
                knots.append((m, j))
                n = j
                continue
            if e & EV_HNEW:
                state = 0
            n -= 1
            continue
        # g lane
        if e & EV_JXG:
            j = int(jdons[mi, s, 2])
            knots.append((m, n))
            knots.append((m, j))
            n = j
            continue
        if e & EV_VNEW:
            state = 0
        m -= 1
        continue

    # initial record
    if m == 0:
        knots.append((0, n))
    elif n <= 0 or n - m < lw:
        if b_exgl:
            knots.append((m, max(n, 0)))      # add(m, 0, 0) init record
        else:
            knots.append((0, 0))              # chain ends at the origin
    else:
        knots.append((m, n))
    knots.reverse()
    return knots
