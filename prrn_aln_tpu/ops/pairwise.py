"""Batched banded anti-diagonal wavefront DP in JAX.

Score-only affine-gap (Gotoh) pairwise alignment scanned along
anti-diagonals — the device formulation of the reference's wavefront
scorer (reference: src/fwd2d1.cc).  The band is a dense vector of diagonal
slots r = n - m; every scan step updates the slots whose parity matches the
current anti-diagonal under a validity mask, so all work is (batch, width)
element-wise vector ops, with the substitution lookup done as a flat
gather from the (dim*dim) matrix.  This is the one device engine of the
distance and sl-forest edge passes (msa/distance.py).

All shapes are static under ``jit``: pairs are padded to (max_len_a,
max_len_b, max_width); per-pair lengths and band limits are traced scalars.
Batching is a leading axis via ``vmap`` — many pairs fill the vector lanes,
which is how all-pairs distance matrices are produced.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_SENT = -(2 ** 31 // 8) * 7.0    # reference NEG_INT
NEVSEL = -1.0e30


@functools.partial(
    jax.jit,
    static_argnames=("nslot", "nsteps", "dim", "local"))
def wavefront_scores(
    a_batch: jax.Array,     # (B, Ma) int32 codes, 0-padded
    b_batch: jax.Array,     # (B, Mb) int32
    la: jax.Array,          # (B,) actual lengths
    lb: jax.Array,          # (B,)
    lw: jax.Array,          # (B,) band low diagonal
    up: jax.Array,          # (B,) band high diagonal
    mtx: jax.Array,         # (dim, dim) f32 substitution matrix
    u: jax.Array,           # (B,) gap extend (positive)
    v: jax.Array,           # (B,) gap open (positive)
    tgapf: jax.Array,       # (B,) terminal gap factor
    exg: jax.Array,         # (B, 4) bool: a-left, a-right, b-left, b-right
    *,
    nslot: int,             # static slot count >= max band width
    nsteps: int,            # static step count >= max (la+lb-1)
    dim: int,               # matrix dimension
    local: bool = False,    # SWG local (algmode.lcl & 16)
) -> jax.Array:
    """Returns (B,) alignment scores."""
    flat = mtx.reshape(-1)

    def one_pair(a, b, la, lb, lw, up, u, v, tgapf, exg):
        r_all = lw - 1 + jnp.arange(nslot)          # (R,)
        in_band = (r_all >= lw - 1) & (r_all <= up + 1)

        # boundary conditions (fwd2d1.cc:66-89)
        pos = r_all > 0
        neg = r_all < 0
        hh = jnp.zeros(nslot, jnp.float32)
        pen_pos = -(v + r_all * u) * tgapf
        pen_neg = -(v - r_all * u) * tgapf
        hh = jnp.where(pos & ~exg[0], pen_pos, hh)
        hh = jnp.where(neg & ~exg[2], pen_neg, hh)
        hh = jnp.where((r_all == lw - 1) | (r_all == up + 1), NEG_SENT, hh)
        hh = jnp.where(~in_band, NEG_SENT, hh)
        ff = jnp.full(nslot, NEVSEL, jnp.float32)
        gg = jnp.full(nslot, NEVSEL, jnp.float32)

        def step(carry, d):
            hh, ff, gg, maxh = carry
            m_vec = (d - r_all) >> 1
            n_vec = d - m_vec
            valid = (
                ((d - r_all) % 2 == 0)
                & (m_vec >= 0) & (m_vec < la)
                & (n_vec >= 0) & (n_vec < lb)
                & (r_all >= lw) & (r_all <= up)
            )
            mc = jnp.clip(m_vec, 0, a.shape[0] - 1)
            nc = jnp.clip(n_vec, 0, b.shape[0] - 1)
            s = flat[a[mc] * dim + b[nc]]

            h_lo = jnp.concatenate([jnp.array([NEG_SENT], jnp.float32), hh[:-1]])
            f_lo = jnp.concatenate([jnp.array([NEVSEL], jnp.float32), ff[:-1]])
            h_hi = jnp.concatenate([hh[1:], jnp.array([NEG_SENT], jnp.float32)])
            g_hi = jnp.concatenate([gg[1:], jnp.array([NEVSEL], jnp.float32)])

            f_new = jnp.maximum(h_lo - v, f_lo) - u
            g_new = jnp.maximum(h_hi - v, g_hi) - u
            h_new = jnp.maximum(jnp.maximum(hh + s, f_new), g_new)
            if local:
                h_new = jnp.maximum(h_new, 0.0)
                maxh = jnp.maximum(
                    maxh, jnp.max(jnp.where(valid, h_new, NEVSEL)))

            hh = jnp.where(valid, h_new, hh)
            ff = jnp.where(valid, f_new, ff)
            gg = jnp.where(valid, g_new, gg)
            return (hh, ff, gg, maxh), None

        init = (hh, ff, gg, jnp.float32(NEVSEL))
        (hh, ff, gg, maxh), _ = jax.lax.scan(
            step, init, jnp.arange(nsteps, dtype=jnp.int32))

        if local:
            return maxh

        # closed-form lastD (see ops/pairwise_np._last_d)
        r_end = lb - la
        best = jnp.max(jnp.where(r_all == r_end, hh, NEVSEL))
        f_b = jnp.where(exg[3], 0.0, tgapf)
        sel_b = (r_all > r_end) & (r_all <= jnp.minimum(up + 1, lb))
        cand_b = hh - f_b * (v + (r_all - r_end) * u)
        best_b = jnp.max(jnp.where(sel_b, cand_b, NEVSEL))
        best = jnp.where(f_b < 1.0, jnp.maximum(best, best_b), best)
        f_a = jnp.where(exg[1], 0.0, tgapf)
        sel_a = (r_all < r_end) & (r_all >= jnp.maximum(lw - 1, -la + 1))
        cand_a = hh - f_a * (v + (r_end - r_all) * u)
        best_a = jnp.max(jnp.where(sel_a, cand_a, NEVSEL))
        best = jnp.where(f_a < 1.0, jnp.maximum(best, best_a), best)
        return best

    return jax.vmap(one_pair)(
        a_batch, b_batch, la, lb, lw, up,
        u.astype(jnp.float32), v.astype(jnp.float32),
        tgapf.astype(jnp.float32), exg)
