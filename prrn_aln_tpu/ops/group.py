"""JAX anti-diagonal wavefront group-to-group DP.

The device formulation of the banded group DP (see ops/group_np.py for
the semantics oracle): one `lax.scan` over anti-diagonals; each step
updates every band slot whose parity matches the diagonal with pure
vector ops.  Per-slot state carries the H/G/F lane values plus
per-member gap-run lengths, so the exact pairwise gap-open accounting
(crg22w) is evaluated as a broadcast compare (slots, an, bn) — identical
to the row-scan arithmetic, including tie order.

Boundary rows/columns (initB) are folded into the sweep as forced
horizontal/vertical chains on the m'==0 / n'==0 cells.

Direction bits are emitted per step for host-side traceback.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..msa.msa import Msa
from ..msa import sshp as _sshp
from .window import Window, stripe
from .group_np import _col_arrays, DIAG, VERT, HORI, VERT2, HORI2

NEVSEL = -1.0e30

# H dir codes (match group_np)
D_DEAD, D_DIAG, D_VERT, D_HORI = 0, 1, 2, 3

# output sharding of the last group_align_batch launch (introspection
# for multi-device tests / the driver dryrun)
LAST_BATCH_SHARDING = None


def _bucket(x: int, q: int = 64) -> int:
    return ((x + q - 1) // q) * q


def _wavefront_core(
    S,            # (la_max, lb_max) column score table (incl. full-phase
                  # intron diag bonus, folded in by the packers)
    B0,           # (la_max, lb_max) phase-0 intron bonus to the winning
                  # gap lane (fwd2c.h:306-312 mx->val += match_score)
    na_a, gda, pga,   # (la_max+1, an) column arrays of A (0 = boundary)
    na_b, gdb, pgb,   # (lb_max+1, bn)
    cfa, efa,     # (la_max+1,)
    cfb, efb,     # (lb_max+1,)
    wa, wb,       # (an,), (bn,)
    la, lb,       # scalars (traced)
    lw, up,       # band
    u, gop_scale,         # gap extend; GOP = -scale*v
    v2divv1=np.float32(0.0), u2divu1=np.float32(0.0),
    k1=np.int32(10 ** 9),
    *, nslot, nsteps, an, bn, la_max, lb_max, ls3=False,
):
    r_all = lw - 1 + jnp.arange(nslot)
    f32 = jnp.float32

    Hval = jnp.full(nslot, NEVSEL, f32)
    Hdir = jnp.zeros(nslot, jnp.int8)
    Hgla = jnp.zeros((nslot, an), jnp.int32)
    Hglb = jnp.zeros((nslot, bn), jnp.int32)
    Gval = jnp.full(nslot, NEVSEL, f32)
    Ggla = jnp.zeros((nslot, an), jnp.int32)
    Gglb = jnp.zeros((nslot, bn), jnp.int32)
    Fval = jnp.full(nslot, NEVSEL, f32)
    Fgla = jnp.zeros((nslot, an), jnp.int32)
    Fglb = jnp.zeros((nslot, bn), jnp.int32)
    # long-gap (double-affine) lane pair, fwd2c.h g2/f2 (-yl3)
    G2val = jnp.full(nslot, NEVSEL, f32)
    G2gla = jnp.zeros((nslot, an), jnp.int32)
    G2glb = jnp.zeros((nslot, bn), jnp.int32)
    F2val = jnp.full(nslot, NEVSEL, f32)
    F2gla = jnp.zeros((nslot, an), jnp.int32)
    F2glb = jnp.zeros((nslot, bn), jnp.int32)

    corner = r_all == 0
    Hval = jnp.where(corner, 0.0, Hval)
    Hdir = jnp.where(corner, D_DIAG, Hdir).astype(jnp.int8)

    agap = na_a <= 0.0       # (la_max+1, an) gap mask per column
    bgap = na_b <= 0.0

    def crg(gla, glb, acol, bcol, d3, mc, nc):
        """(slots,) weighted new-gap counts; acol/bcol are gathered
        per-slot column indices (clipped)."""
        ge = gla[:, :, None] >= glb[:, None, :]
        if d3 == 0:
            le = glb[:, None, :] >= gla[:, :, None]
            t1 = ((wa[None, :] * na_a[mc])[:, :, None] * ge *
                  (wb[None, :] * gdb[nc])[:, None, :]).sum((1, 2))
            t2 = ((wa[None, :] * gda[mc])[:, :, None] * le *
                  (wb[None, :] * na_b[nc])[:, None, :]).sum((1, 2))
            return (t1 + t2) * gop_scale
        if d3 > 0:
            return ((wa[None, :] * na_a[mc])[:, :, None] * ge *
                    (wb[None, :] * pgb[nc])[:, None, :]).sum((1, 2)) * gop_scale
        le = glb[:, None, :] >= gla[:, :, None]
        return ((wa[None, :] * pga[mc])[:, :, None] * le *
                (wb[None, :] * na_b[nc])[:, None, :]).sum((1, 2)) * gop_scale

    def shift_lo(x, fill):
        return jnp.concatenate([jnp.full((1,) + x.shape[1:], fill, x.dtype),
                                x[:-1]], axis=0)

    def shift_hi(x, fill):
        return jnp.concatenate([x[1:],
                                jnp.full((1,) + x.shape[1:], fill, x.dtype)],
                               axis=0)

    def step(carry, d):
        (Hval, Hdir, Hgla, Hglb, Gval, Ggla, Gglb,
         Fval, Fgla, Fglb, G2val, G2gla, G2glb,
         F2val, F2gla, F2glb) = carry
        m_vec = (d - r_all) >> 1          # m' of the cell (consumed cols)
        n_vec = d - m_vec
        parity = (d - r_all) % 2 == 0
        valid = (parity & (m_vec >= 0) & (m_vec <= la)
                 & (n_vec >= 0) & (n_vec <= lb)
                 & (r_all >= lw) & (r_all <= up)
                 & (d > 0))
        mc = jnp.clip(m_vec, 0, la_max)    # column index (m' itself)
        nc = jnp.clip(n_vec, 0, lb_max)
        is_top = m_vec == 0                # forced horizontal chain
        is_left = n_vec == 0               # forced vertical chain

        # gathered per-slot column data
        a_gap_col = agap[mc]               # (slots, an)
        b_gap_col = bgap[nc]
        s_cell = S[jnp.clip(m_vec - 1, 0, la_max - 1),
                   jnp.clip(n_vec - 1, 0, lb_max - 1)]
        b0_cell = jnp.where(
            (m_vec >= 1) & (n_vec >= 1),
            B0[jnp.clip(m_vec - 1, 0, la_max - 1),
               jnp.clip(n_vec - 1, 0, lb_max - 1)], 0.0)
        pua = cfa[mc] * efb[nc] * (-u)
        pub = cfb[nc] * efa[mc] * (-u)

        # shifted previous-step states
        Hval_lo, Hdir_lo = shift_lo(Hval, NEVSEL), shift_lo(Hdir, 0)
        Hgla_lo, Hglb_lo = shift_lo(Hgla, 0), shift_lo(Hglb, 0)
        Hval_hi, Hdir_hi = shift_hi(Hval, NEVSEL), shift_hi(Hdir, 0)
        Hgla_hi, Hglb_hi = shift_hi(Hgla, 0), shift_hi(Hglb, 0)
        Gval_hi = shift_hi(Gval, NEVSEL)
        Ggla_hi, Gglb_hi = shift_hi(Ggla, 0), shift_hi(Gglb, 0)
        Fval_lo = shift_lo(Fval, NEVSEL)
        Fgla_lo, Fglb_lo = shift_lo(Fgla, 0), shift_lo(Fglb, 0)
        G2val_hi = shift_hi(G2val, NEVSEL)
        G2gla_hi, G2glb_hi = shift_hi(G2gla, 0), shift_hi(G2glb, 0)
        F2val_lo = shift_lo(F2val, NEVSEL)
        F2gla_lo, F2glb_lo = shift_lo(F2gla, 0), shift_lo(F2glb, 0)

        # ---- diagonal candidate (pred: same slot, step d-2) ------------
        gop_d = crg(Hgla, Hglb, None, None, 0, mc, nc)
        d_val = Hval + s_cell + gop_d
        d_gla = jnp.where(a_gap_col, Hgla + 1, 0)
        d_glb = jnp.where(b_gap_col, Hglb + 1, 0)

        # ---- vertical lane --------------------------------------------
        gnp_v = crg(Ggla_hi, Gglb_hi, None, None, 1, mc, nc)
        gop_v = crg(Hgla_hi, Hglb_hi, None, None, 1, mc, nc)
        open_v = (Hdir_hi != D_VERT) & (Hval_hi + gop_v > Gval_hi + gnp_v)
        gv = jnp.where(open_v, Hval_hi + gop_v, Gval_hi + gnp_v) + pua
        g_gla = jnp.where(a_gap_col,
                          jnp.where(open_v[:, None], Hgla_hi, Ggla_hi) + 1, 0)
        g_glb = jnp.where(open_v[:, None], Hglb_hi, Gglb_hi) + 1
        vert_ok = m_vec >= 2
        gv = jnp.where(vert_ok, gv, NEVSEL)

        # ---- horizontal lane ------------------------------------------
        gnp_h = crg(Fgla_lo, Fglb_lo, None, None, -1, mc, nc)
        gop_h = crg(Hgla_lo, Hglb_lo, None, None, -1, mc, nc)
        open_h = (Hdir_lo != D_HORI) & (Hval_lo + gop_h > Fval_lo + gnp_h)
        fv = jnp.where(open_h, Hval_lo + gop_h, Fval_lo + gnp_h) + pub
        f_gla = jnp.where(open_h[:, None], Hgla_lo, Fgla_lo) + 1
        f_glb = jnp.where(b_gap_col,
                          jnp.where(open_h[:, None], Hglb_lo, Fglb_lo) + 1, 0)
        hori_ok = n_vec >= 2
        fv = jnp.where(hori_ok, fv, NEVSEL)

        # ---- long-gap lanes (ls=3) --------------------------------------
        if ls3:
            gnp_v2 = v2divv1 * crg(G2gla_hi, G2glb_hi, None, None, 1,
                                   mc, nc)
            gop_v2 = v2divv1 * crg(Hgla_hi, Hglb_hi, None, None, 1,
                                   mc, nc)
            open_v2 = ((Hdir_hi != D_VERT)
                       & (Hval_hi + gop_v2 > G2val_hi + gnp_v2))
            g2v = jnp.where(open_v2, Hval_hi + gop_v2,
                            G2val_hi + gnp_v2) + u2divu1 * pua
            g2_gla = jnp.where(
                a_gap_col,
                jnp.where(open_v2[:, None], Hgla_hi, G2gla_hi) + 1, 0)
            g2_glb = jnp.where(open_v2[:, None], Hglb_hi, G2glb_hi) + 1
            g2v = jnp.where(vert_ok, g2v, NEVSEL)

            gnp_h2 = v2divv1 * crg(F2gla_lo, F2glb_lo, None, None, -1,
                                   mc, nc)
            gop_h2 = v2divv1 * crg(Hgla_lo, Hglb_lo, None, None, -1,
                                   mc, nc)
            open_h2 = ((Hdir_lo != D_HORI)
                       & (Hval_lo + gop_h2 > F2val_lo + gnp_h2))
            f2v = jnp.where(open_h2, Hval_lo + gop_h2,
                            F2val_lo + gnp_h2) + u2divu1 * pub
            f2_gla = jnp.where(open_h2[:, None], Hgla_lo, F2gla_lo) + 1
            f2_glb = jnp.where(
                b_gap_col,
                jnp.where(open_h2[:, None], Hglb_lo, F2glb_lo) + 1, 0)
            f2v = jnp.where(hori_ok, f2v, NEVSEL)

        # ---- boundary chains ------------------------------------------
        # top row (m'==0, n'>=1): H = H[r-1] + crg(d3=-1) + pub, dir HORI
        top_val = Hval_lo + gop_h + pub
        # left col (n'==0, m'>=1): H = H[r+1] + crg(d3=+1) + pua, dir VERT
        left_val = Hval_hi + gop_v + pua
        if ls3:
            # terminal runs >= k1 accrue at the long-gap rates
            # (group_np boundary: npr/mpr >= codonk1)
            top_val = jnp.where(n_vec >= k1,
                                Hval_lo + v2divv1 * gop_h
                                + u2divu1 * pub, top_val)
            left_val = jnp.where(m_vec >= k1,
                                 Hval_hi + v2divv1 * gop_v
                                 + u2divu1 * pua, left_val)

        # ---- select (lane order: g, g2 strict, f ties, f2 ties) --------
        mx_val = gv
        mx_lane = jnp.full(gv.shape, VERT, jnp.int8)
        if ls3:
            t = g2v > mx_val
            mx_val = jnp.where(t, g2v, mx_val)
            mx_lane = jnp.where(t, VERT2, mx_lane).astype(jnp.int8)
        t = fv >= mx_val
        mx_val = jnp.where(t, fv, mx_val)
        mx_lane = jnp.where(t, HORI, mx_lane).astype(jnp.int8)
        if ls3:
            t = f2v >= mx_val
            mx_val = jnp.where(t, f2v, mx_val)
            mx_lane = jnp.where(t, HORI2, mx_lane).astype(jnp.int8)
        # phase-0 intron bonus lands on the winning gap lane and persists
        # in its stored value (the reference mutates through mx)
        has_b0 = (b0_cell != 0.0) & (mx_val > NEVSEL / 2)
        mx_val = mx_val + jnp.where(has_b0, b0_cell, 0.0)
        gv = gv + jnp.where(has_b0 & (mx_lane == VERT), b0_cell, 0.0)
        fv = fv + jnp.where(has_b0 & (mx_lane == HORI), b0_cell, 0.0)
        if ls3:
            g2v = g2v + jnp.where(has_b0 & (mx_lane == VERT2), b0_cell,
                                  0.0)
            f2v = f2v + jnp.where(has_b0 & (mx_lane == HORI2), b0_cell,
                                  0.0)
        nondiag = mx_val > d_val
        is_vlane = (mx_lane == VERT) | (mx_lane == VERT2)
        h_val = jnp.where(nondiag, mx_val, d_val)
        h_dir = jnp.where(nondiag,
                          jnp.where(is_vlane, D_VERT, D_HORI),
                          D_DIAG).astype(jnp.int8)
        h_src = jnp.where(nondiag, mx_lane, DIAG).astype(jnp.int8)
        if ls3:
            mx_gla = jnp.where((mx_lane == VERT)[:, None], g_gla,
                     jnp.where((mx_lane == VERT2)[:, None], g2_gla,
                     jnp.where((mx_lane == HORI)[:, None], f_gla,
                               f2_gla)))
            mx_glb = jnp.where((mx_lane == VERT)[:, None], g_glb,
                     jnp.where((mx_lane == VERT2)[:, None], g2_glb,
                     jnp.where((mx_lane == HORI)[:, None], f_glb,
                               f2_glb)))
        else:
            mx_gla = jnp.where((mx_lane == VERT)[:, None], g_gla, f_gla)
            mx_glb = jnp.where((mx_lane == VERT)[:, None], g_glb, f_glb)
        h_gla = jnp.where(nondiag[:, None], mx_gla, d_gla)
        h_glb = jnp.where(nondiag[:, None], mx_glb, d_glb)

        # overlay boundary chains
        h_val = jnp.where(is_top, top_val, jnp.where(is_left, left_val,
                                                     h_val))
        h_dir = jnp.where(is_top, D_HORI,
                          jnp.where(is_left, D_VERT, h_dir)).astype(jnp.int8)
        h_src = jnp.where(is_top, HORI,
                          jnp.where(is_left, VERT, h_src)).astype(jnp.int8)
        top_gla, top_glb = Hgla_lo + 1, jnp.where(b_gap_col, Hglb_lo + 1, 0)
        left_gla = jnp.where(a_gap_col, Hgla_hi + 1, 0)
        left_glb = Hglb_hi + 1
        h_gla = jnp.where(is_top[:, None], top_gla,
                          jnp.where(is_left[:, None], left_gla, h_gla))
        h_glb = jnp.where(is_top[:, None], top_glb,
                          jnp.where(is_left[:, None], left_glb, h_glb))

        # ---- masked writeback -----------------------------------------
        vm = valid
        Hval = jnp.where(vm, h_val, Hval)
        Hdir = jnp.where(vm, h_dir, Hdir).astype(jnp.int8)
        Hgla = jnp.where(vm[:, None], h_gla, Hgla)
        Hglb = jnp.where(vm[:, None], h_glb, Hglb)
        gval_n = jnp.where(vm & ~is_top & ~is_left, gv, NEVSEL)
        Gval = jnp.where(vm, gval_n, Gval)
        Ggla = jnp.where(vm[:, None], g_gla, Ggla)
        Gglb = jnp.where(vm[:, None], g_glb, Gglb)
        fval_n = jnp.where(vm & ~is_top & ~is_left, fv, NEVSEL)
        Fval = jnp.where(vm, fval_n, Fval)
        Fgla = jnp.where(vm[:, None], f_gla, Fgla)
        Fglb = jnp.where(vm[:, None], f_glb, Fglb)
        opens = (jnp.where(vm & open_v, 1, 0)
                 + jnp.where(vm & open_h, 2, 0)).astype(jnp.int8)
        if ls3:
            g2val_n = jnp.where(vm & ~is_top & ~is_left, g2v, NEVSEL)
            G2val = jnp.where(vm, g2val_n, G2val)
            G2gla = jnp.where(vm[:, None], g2_gla, G2gla)
            G2glb = jnp.where(vm[:, None], g2_glb, G2glb)
            f2val_n = jnp.where(vm & ~is_top & ~is_left, f2v, NEVSEL)
            F2val = jnp.where(vm, f2val_n, F2val)
            F2gla = jnp.where(vm[:, None], f2_gla, F2gla)
            F2glb = jnp.where(vm[:, None], f2_glb, F2glb)
            opens = (opens + jnp.where(vm & open_v2, 4, 0)
                     + jnp.where(vm & open_h2, 8, 0)).astype(jnp.int8)

        dirs = jnp.where(vm, h_src, -1).astype(jnp.int8)
        carry = (Hval, Hdir, Hgla, Hglb, Gval, Ggla, Gglb,
                 Fval, Fgla, Fglb, G2val, G2gla, G2glb,
                 F2val, F2gla, F2glb)
        return carry, (dirs, opens)

    carry = (Hval, Hdir, Hgla, Hglb, Gval, Ggla, Gglb, Fval, Fgla, Fglb,
             G2val, G2gla, G2glb, F2val, F2gla, F2glb)
    carry, (dirs, opens) = jax.lax.scan(
        step, carry, jnp.arange(nsteps, dtype=jnp.int32))
    Hval = carry[0]
    score = jnp.max(jnp.where(r_all == lb - la, Hval, NEVSEL))
    return score, dirs, opens


_wavefront_group = functools.partial(
    jax.jit, static_argnames=("nslot", "nsteps", "an", "bn", "la_max",
                              "lb_max", "ls3"))(_wavefront_core)


@functools.partial(
    jax.jit, static_argnames=("nslot", "nsteps", "an", "bn", "la_max",
                              "lb_max", "ls3"))
def _wavefront_from_profiles(
    CA, CB,       # (la_max, C) / (lb_max, C) channel stacks: the score
                  # image S = CA @ CB.T is built HERE on device, so
                  # only O(L*C) bytes cross the host->device link per
                  # pair instead of the O(La*Lb) image
    ea0, eb0,     # (la_max,) / (lb_max,) phase-0 eij densities: B0 outer
    na_a, gda, pga, na_b, gdb, pgb, cfa, efa, cfb, efb, wa, wb,
    la, lb, lw, up, u, gop_scale,
    v2divv1=np.float32(0.0), u2divu1=np.float32(0.0),
    k1=np.int32(10 ** 9),
    *, nslot, nsteps, an, bn, la_max, lb_max, ls3=False,
):
    S = jnp.matmul(CA, CB.T, precision=jax.lax.Precision.HIGHEST)
    B0 = ea0[:, None] * eb0[None, :]
    return _wavefront_core(
        S, B0, na_a, gda, pga, na_b, gdb, pgb, cfa, efa, cfb, efb,
        wa, wb, la, lb, lw, up, u, gop_scale, v2divv1, u2divu1, k1,
        nslot=nslot, nsteps=nsteps, an=an, bn=bn,
        la_max=la_max, lb_max=lb_max, ls3=ls3)


def _bonus_images(A: Msa, B: Msa, la_max: int, lb_max: int, spb: float,
                  scale: float = 1.0):
    """Intron-position bonus images (fwd2c.h:306-312): BD (all phases,
    folded into the diagonal score image) and B0 (phase 0, applied to the
    winning gap lane)."""
    B0 = np.zeros((la_max, lb_max), np.float32)
    BD = None
    if spb > 0 and A.eijdns is not None and B.eijdns is not None:
        EA = A.eijdns[:A.length]
        EB = B.eijdns[:B.length]
        BD = (scale * spb) * (EA @ EB.T)
        B0[:A.length, :B.length] = (scale * spb) * np.outer(EA[:, 0],
                                                            EB[:, 0])
    return BD, B0


NSHP = 6      # max sshp propensity channels (sshp.py SsHpPrm.factors)
NEIJ = 3      # intron phase channels (msa.eijdns)


def _pack_profiles(A: Msa, B: Msa, mtx, la_max: int, lb_max: int,
                   spb: float = 0.0, scale: float = 1.0):
    """Channel stacks for the on-device score-image build.

    S = CA @ CB.T reproduces  freqA*mtx*freqB^T  (profile similarity,
    mseq.cc:413-435 VECPRO x frequency)  +  scale*spb*(EA @ EB^T)  (all-
    phase intron-position bonus, fwd2c.h:306-312)  +  sshp channels
    (maln2.cc:1778-1792); ea0/eb0 give the phase-0 gap-lane bonus outer
    product.  Only these O(L x C) stacks cross the host->device link —
    the O(La*Lb) image is built on device in
    ``_wavefront_from_profiles``.
    """
    dim = mtx.shape[1]
    C = dim + NEIJ + NSHP
    La, Lb = A.length, B.length
    CA = np.zeros((la_max, C), np.float32)
    CB = np.zeros((lb_max, C), np.float32)
    CA[:La, :dim] = (A.freq.astype(np.float64)
                     @ mtx.astype(np.float64)).astype(np.float32)
    CB[:Lb, :dim] = B.freq.astype(np.float32)
    ea0 = np.zeros(la_max, np.float32)
    eb0 = np.zeros(lb_max, np.float32)
    if spb > 0 and A.eijdns is not None and B.eijdns is not None:
        EA = A.eijdns[:La]
        EB = B.eijdns[:Lb]
        k = min(EA.shape[1], NEIJ)
        CA[:La, dim:dim + k] = (scale * spb) * EA[:, :k]
        CB[:Lb, dim:dim + k] = EB[:, :k]
        ea0[:La] = (scale * spb) * EA[:, 0]
        eb0[:Lb] = EB[:, 0]
    ss = _sshp.pair_channels(A, B)
    if ss is not None:
        qa, qb = ss
        k2 = min(qa.shape[1], NSHP)
        CA[:La, dim + NEIJ:dim + NEIJ + k2] = qa[:, :k2]
        CB[:Lb, dim + NEIJ:dim + NEIJ + k2] = qb[:, :k2]
    return CA, CB, ea0, eb0


def uniform_side(msa: Msa) -> bool:
    """Gap-free group: internal gap columns are absent, so every
    member's gap-run length is identical along any DP path (runs only
    come from DP-inserted gaps, which advance uniformly).  The exact
    pairwise crg accounting then collapses to weighted column sums --
    the reference's no-internal-gap DPunit closed form (fwd2c.cc
    DPunit vs DPunit_nv; tier auto-selection maln2.cc:43-60
    advised_sim2).  Collapsing turns the (an*bn) per-cell gap-open
    work and the 10*an gap-run state into O(1) per slot."""
    import os
    if os.environ.get("PRRN_GROUP_UNIFORM", "1") == "0":
        return False
    from .. import alphabet as ab
    return msa.many > 1 and bool(np.all(msa.codes > ab.GAP))


def effective_members(msa: Msa) -> int:
    return 1 if uniform_side(msa) else msa.many


def _pack_cols(A: Msa, B: Msa, pa: int, pb: int, la_max: int, lb_max: int,
               ua: bool = False, ub: bool = False):
    """Padded per-column gap/thickness arrays + member weights
    (the non-image operands of the wavefront kernel).  ``ua``/``ub``
    collapse a gap-free side to one effective member (see
    uniform_side): every member factor enters the crg sums linearly,
    so the weighted column sums are exact."""
    na_a, gda, pga = _col_arrays(A)
    na_b, gdb, pgb = _col_arrays(B)
    an, bn = A.many, B.many
    w_a = (A.weight if A.weight is not None else np.ones(an)) \
        .astype(np.float64)
    w_b = (B.weight if B.weight is not None else np.ones(bn)) \
        .astype(np.float64)
    if ua:
        na_a = (na_a * w_a).sum(1, keepdims=True).astype(np.float32)
        gda = (gda * w_a).sum(1, keepdims=True).astype(np.float32)
        pga = (pga * w_a).sum(1, keepdims=True).astype(np.float32)
        an = 1
    if ub:
        na_b = (na_b * w_b).sum(1, keepdims=True).astype(np.float32)
        gdb = (gdb * w_b).sum(1, keepdims=True).astype(np.float32)
        pgb = (pgb * w_b).sum(1, keepdims=True).astype(np.float32)
        bn = 1

    def padc(x, rows, cols):
        out = np.zeros((rows, cols), np.float32)
        out[:x.shape[0], :x.shape[1]] = x
        return out

    na_a, gda, pga = (padc(x, la_max + 1, pa) for x in (na_a, gda, pga))
    na_b, gdb, pgb = (padc(x, lb_max + 1, pb) for x in (na_b, gdb, pgb))
    na_a[:, an:] = 1.0
    pga[:, an:] = 1.0
    na_b[:, bn:] = 1.0
    pgb[:, bn:] = 1.0

    def pad1(x, rows):
        out = np.zeros(rows, np.float32)
        out[:x.shape[0]] = x
        return out

    cfa = pad1(A.cfq[:A.length + 1], la_max + 1)
    efa = pad1(A.efq[:A.length + 1], la_max + 1)
    cfb = pad1(B.cfq[:B.length + 1], lb_max + 1)
    efb = pad1(B.efq[:B.length + 1], lb_max + 1)
    wa = np.zeros(pa, np.float32)
    wa[:an] = 1.0 if ua else (
        A.weight if A.weight is not None else np.ones(an))
    wb = np.zeros(pb, np.float32)
    wb[:bn] = 1.0 if ub else (
        B.weight if B.weight is not None else np.ones(bn))
    return na_a, gda, pga, na_b, gdb, pgb, cfa, efa, cfb, efb, wa, wb


def skl_in_band(skl, lw: int, up: int) -> bool:
    """True iff every cell of the path lies inside the stripe.  Segment
    interiors stay between their endpoint diagonals, so endpoint checks
    suffice."""
    return all(lw <= n - m <= up for m, n in skl)


def group_align(A: Msa, B: Msa, mtx: np.ndarray, u: float, v: float,
                wdw: Window | None = None, scale: float = 1.0,
                pads: tuple[int, int] | None = None, spb: float = 0.0,
                ls: int = 1, u1: float = 0.6, k1: int = 7,
                _retried: bool = False):
    """Align two prepared groups with the JAX wavefront kernel.
    Returns (score, skl).

    ``pads`` = (member_pad, length_pad): pad member counts (with
    zero-weight phantom members) and length buckets to fixed values so
    repeated calls in a progressive/refinement session reuse one compiled
    executable.

    A path that escapes the stripe or a score that never left the
    sentinel means the band was too narrow; like the reference's
    corner-miss recovery (maln2.cc:1944-1952, sh := -100) the alignment
    is retried once with a full-width band.
    """
    La, Lb = A.length, B.length
    ua, ub = uniform_side(A), uniform_side(B)
    an = 1 if ua else A.many
    bn = 1 if ub else B.many
    if wdw is None:
        wdw = stripe(La, Lb, -60)
    lw, up = wdw.lw, wdw.up

    if pads is not None:
        an_pad, len_pad = pads
        an_pad = max(an_pad, an, bn)
        la_max = lb_max = _bucket(max(La, Lb, len_pad))
        nslot = _bucket(up - lw + 3, 128)
        nsteps = _bucket(La + Lb + 1, 256)
    else:
        an_pad = 0
        la_max, lb_max = _bucket(La), _bucket(Lb)
        nslot = _bucket(up - lw + 3)
        nsteps = _bucket(La + Lb + 1)

    CA, CB, ea0, eb0 = _pack_profiles(A, B, mtx, la_max, lb_max,
                                      spb=spb, scale=scale)
    pa = max(an_pad, an)
    pb = max(an_pad, bn)
    cols = _pack_cols(A, B, pa, pb, la_max, lb_max, ua=ua, ub=ub)

    ls3 = ls >= 3
    v2divv1 = (v + (u - u1) * k1) / v if ls3 else 0.0
    u2divu1 = (u1 / u) if ls3 else 0.0
    score, dirs, opens = _wavefront_from_profiles(
        CA, CB, ea0, eb0, *cols,
        np.int32(La), np.int32(Lb), np.int32(lw), np.int32(up),
        np.float32(u), np.float32(-scale * v),
        np.float32(v2divv1), np.float32(u2divu1),
        np.int32(k1 if ls3 else 10 ** 9),
        nslot=nslot, nsteps=nsteps, an=pa, bn=pb,
        la_max=la_max, lb_max=lb_max, ls3=ls3)
    # walk the traceback on device: fetch O(La+Lb) moves, not the
    # (nsteps, nslot) planes
    max_iters = _bucket(2 * (La + Lb) + 4, 512)
    moves, cnt = _traceback_device(
        dirs, opens, jnp.int32(La), jnp.int32(Lb), jnp.int32(lw),
        max_iters=max_iters)
    moves = np.asarray(moves)[:int(cnt)][::-1]
    skl = _moves_to_skl(moves, La, Lb)
    if not _retried and (float(score) <= NEVSEL / 2
                         or not skl_in_band(skl, lw, up)):
        wide = stripe(La, Lb, -100)
        return group_align(A, B, mtx, u, v, wdw=wide, scale=scale,
                           pads=pads, spb=spb, ls=ls, u1=u1, k1=k1,
                           _retried=True)
    return float(score), skl


@functools.partial(jax.jit, static_argnames=("max_iters",))
def _traceback_device(dirs, opens, La, Lb, lw, *, max_iters):
    """Device-side traceback walk over the per-step direction planes.

    A `lax.while_loop` replays the host walk of ``_traceback_wave`` on
    device, so only the O(La+Lb) move list is fetched instead of the
    full (nsteps, nslot) int8 planes.  Returns (moves, nmoves) with
    moves recorded end-to-start; the host reverses and converts to an
    SKL.  Replaces the reference's Vmf chain walk (src/vmf.h:36-57).
    """
    nsteps = dirs.shape[0]
    i8 = jnp.int8

    # lane codes: 0=H 1=G 2=G2 3=F 4=F2
    def cond(st):
        m, n, lane, cnt, it, moves = st
        # `it` bounds the walk against corrupt planes (a bad path is
        # caught by the caller's skl_in_band corner-miss retry)
        return ((m > 0) | (n > 0)) & (it < 3 * max_iters)

    def body(st):
        m, n, lane, cnt, it, moves = st
        d = m + n
        slot = -(lw - 1) + (n - m)
        ok = (d > 0) & (d < nsteps)
        dc = jnp.clip(d, 0, nsteps - 1)
        src = jnp.where(ok, dirs[dc, slot], -1).astype(jnp.int32)
        op = jnp.where(ok, opens[dc, slot], 0).astype(jnp.int32)

        is_h = lane == 0
        is_g = (lane == 1) | (lane == 2)
        # H-lane transition
        h_diag = is_h & (src == DIAG)
        h_lane = jnp.where(src == VERT, 1,
                  jnp.where(src == VERT2, 2,
                   jnp.where(src == HORI2, 4, 3)))
        # gap lanes
        g_open = jnp.where(lane == 1, op & 1, op & 4) != 0
        f_open = jnp.where(lane == 3, op & 2, op & 8) != 0

        emit = jnp.where(is_h, jnp.where(h_diag, DIAG, -1),
                 jnp.where(is_g, VERT, HORI)).astype(jnp.int32)
        new_m = jnp.where(h_diag | is_g, m - 1, m)
        new_n = jnp.where(h_diag | (~is_h & ~is_g), n - 1, n)
        new_lane = jnp.where(is_h,
                     jnp.where(h_diag, 0, h_lane),
                     jnp.where(is_g,
                       jnp.where(g_open | (new_n == 0), 0, lane),
                       jnp.where(f_open | (new_m == 0), 0, lane)))
        # always write at cnt (a -1 is overwritten by the next emit,
        # since cnt only advances on emits)
        moves = jax.lax.dynamic_update_index_in_dim(
            moves, emit.astype(i8), jnp.clip(cnt, 0, max_iters - 1), 0)
        cnt = cnt + jnp.where(emit >= 0, 1, 0)
        return new_m, new_n, new_lane, cnt, it + 1, moves

    st = (La.astype(jnp.int32), Lb.astype(jnp.int32), jnp.int32(0),
          jnp.int32(0), jnp.int32(0), jnp.full((max_iters,), -1, i8))
    m, n, lane, cnt, it, moves = jax.lax.while_loop(cond, body, st)
    return moves, jnp.minimum(cnt, max_iters)


def _moves_to_skl(moves, La: int, Lb: int):
    """Forward move list (DIAG/VERT/HORI) -> SKL vertex list."""
    skl = [(0, 0)]
    mm = nn = 0
    prev = None
    for mv in moves:
        if prev is not None and mv != prev:
            skl.append((mm, nn))
        if mv == DIAG:
            mm += 1
            nn += 1
        elif mv == VERT:
            mm += 1
        else:
            nn += 1
        prev = mv
    skl.append((La, Lb))
    return skl


@functools.lru_cache(maxsize=64)
def _tb_fn(max_iters):
    return jax.jit(jax.vmap(functools.partial(_traceback_device,
                                              max_iters=max_iters)))


def traceback_batch(dirs, opens, las, lbs, lws, la_max: int, lb_max: int):
    """Walk a whole batch of traceback planes on device; return SKLs.

    dirs/opens: (B, nsteps, nslot) device arrays.  One vmapped
    while_loop + one small fetch of the (B, max_iters) move lists.
    """
    max_iters = 2 * (la_max + lb_max) + 4
    fn = _tb_fn(max_iters)
    moves, cnts = fn(dirs, opens,
                     jnp.asarray(las, jnp.int32), jnp.asarray(lbs, jnp.int32),
                     jnp.asarray(lws, jnp.int32))
    moves = np.asarray(moves)
    cnts = np.asarray(cnts)
    out = []
    for k in range(moves.shape[0]):
        mv = moves[k, :cnts[k]][::-1]
        out.append(_moves_to_skl(mv, int(las[k]), int(lbs[k])))
    return out


def _traceback_wave(dirs: np.ndarray, opens: np.ndarray, La: int, Lb: int,
                    lw: int):
    """Host traceback over the per-step direction records."""
    moves = []
    m, n = La, Lb
    lane = "H"
    off = -(lw - 1)

    def rec(m, n):
        d = m + n
        slot = off + (n - m)
        if 0 < d < dirs.shape[0]:
            return dirs[d, slot], opens[d, slot]
        return -1, 0

    while m > 0 or n > 0:
        src, op = rec(m, n)
        if lane == "H":
            if src == DIAG:
                moves.append(DIAG)
                m, n = m - 1, n - 1
            elif src == VERT:
                lane = "G"
            elif src == VERT2:
                lane = "G2"
            elif src == HORI2:
                lane = "F2"
            else:
                lane = "F"
        elif lane in ("G", "G2"):
            opened = bool(op & (1 if lane == "G" else 4))
            moves.append(VERT)
            m -= 1
            if opened or n == 0:
                lane = "H"
        else:
            opened = bool(op & (2 if lane == "F" else 8))
            moves.append(HORI)
            n -= 1
            if opened or m == 0:
                lane = "H"
    moves.reverse()
    skl = [(0, 0)]
    mm = nn = 0
    prev = None
    for mv in moves:
        if prev is not None and mv != prev:
            skl.append((mm, nn))
        if mv == DIAG:
            mm += 1
            nn += 1
        elif mv == VERT:
            mm += 1
        else:
            nn += 1
        prev = mv
    skl.append((La, Lb))
    return skl


@functools.lru_cache(maxsize=64)
def _batch_fn(nslot, nsteps, an, bn, la_max, lb_max):
    """Cached jit(vmap(wavefront)) per shape bucket: rebuilding the
    lambda per call forced a full retrace every batch (~5 s/batch of
    pure tracing overhead in round 3)."""
    return jax.jit(jax.vmap(
        lambda *args: _wavefront_from_profiles(
            *args, nslot=nslot, nsteps=nsteps, an=an, bn=bn,
            la_max=la_max, lb_max=lb_max)))


def group_align_batch(pairs, mtx, u: float, v: float, sh: int,
                      pads: tuple[int, int], spb: float = 0.0,
                      scale: float = 1.0, mesh=None):
    """Score+traceback a batch of group pairs in one launch.

    ``pairs`` = list of (A, B) prepared Msa pairs, padded to common
    shapes via ``pads`` (member_pad, length_pad).  The speculative
    best-of-n refinement fan-out (SURVEY P3) collapses into this batch
    axis.  When ``mesh`` is given, the batch axis is sharded over the
    mesh's first axis (each device fills its shard of candidates — the
    device replacement for the reference's per-partition pthread
    fan-out, prrn5.cc:594-631).  Returns list of (score, skl).
    """
    if not pairs:
        return []
    an_pad, len_pad = pads
    an_pad = max([an_pad] + [effective_members(m)
                             for ab_ in pairs for m in ab_])
    la_max = lb_max = _bucket(max([len_pad] +
                                  [m.length for ab_ in pairs for m in ab_]))
    wdws = [stripe(A.length, B.length, sh) for A, B in pairs]
    nslot = _bucket(max(w.up - w.lw + 3 for w in wdws), 128)
    nsteps = _bucket(max(A.length + B.length + 1 for A, B in pairs), 256)

    nreal = len(pairs)
    pad_n = 0
    if mesh is not None:
        ndev = int(mesh.devices.size)
        pad_n = (-nreal) % ndev
    ins = []
    for (A, B), w in zip(pairs, wdws):
        ins.append(_pack_inputs(A, B, mtx, u, v, w, an_pad, la_max, lb_max,
                                spb=spb, scale=scale))
    ins.extend([ins[0]] * pad_n)
    batched = [jnp.stack([x[k] for x in ins])
               for k in range(len(ins[0]))]
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        batched = [jax.device_put(x, shard) for x in batched]
    vm = _batch_fn(nslot, nsteps, an_pad, an_pad, la_max, lb_max)
    score, dirs, opens = vm(*batched)
    global LAST_BATCH_SHARDING
    LAST_BATCH_SHARDING = getattr(dirs, "sharding", None)
    # device-side traceback: the while_loop walk fetches only the move
    # lists (~KBs) instead of the full int8 planes
    las = np.array([A.length for A, B in pairs]
                   + [pairs[0][0].length] * pad_n, np.int32)
    lbs = np.array([B.length for A, B in pairs]
                   + [pairs[0][1].length] * pad_n, np.int32)
    lws = np.array([w.lw for w in wdws] + [wdws[0].lw] * pad_n, np.int32)
    skls = traceback_batch(dirs, opens, las, lbs, lws, la_max, lb_max)
    score = np.asarray(score)    # one bulk fetch, not one per pair
    out = []
    for k, ((A, B), w) in enumerate(zip(pairs, wdws)):
        skl = skls[k]
        if (float(score[k]) <= NEVSEL / 2
                or not skl_in_band(skl, w.lw, w.up)):
            # corner-miss recovery (maln2.cc:1944-1952): redo this item
            # alone with a full-width band
            wide = stripe(A.length, B.length, -100)
            out.append(group_align(A, B, mtx, u, v, wdw=wide, scale=scale,
                                   pads=pads, spb=spb, _retried=True))
        else:
            out.append((float(score[k]), skl))
    return out


def _pack_inputs(A: Msa, B: Msa, mtx, u, v, wdw, an_pad, la_max, lb_max,
                 spb: float = 0.0, scale: float = 1.0):
    """Build the _wavefront_from_profiles argument tuple for one pair
    (channel stacks instead of the full score image: the image matmul
    runs on device)."""
    CA, CB, ea0, eb0 = _pack_profiles(A, B, mtx, la_max, lb_max,
                                      spb=spb, scale=scale)
    cols = _pack_cols(A, B, an_pad, an_pad, la_max, lb_max,
                      ua=uniform_side(A), ub=uniform_side(B))
    return (CA, CB, ea0, eb0, *cols,
            np.int32(A.length), np.int32(B.length),
            np.int32(wdw.lw), np.int32(wdw.up),
            np.float32(u), np.float32(-scale * v))
