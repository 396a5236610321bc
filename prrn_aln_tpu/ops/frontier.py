"""Cross-chip band-frontier ring: ONE ultra-long banded pair split
across devices (SURVEY §5.7 sequence-parallel analog).

The band-packed row sweep (lane j of row m holds column n = m + lw + j)
is sharded along the BAND axis over a device mesh; each row exchanges
only its shard-boundary state:

* the vertical/diagonal predecessors of a shard's last lane live on
  the right neighbor's first lane -> one `ppermute` per row pulls the
  neighbor's (H, G) boundary column left;
* the within-row affine E-scan E(n) = cummax(C + j*u) - j*u factors
  into a local cummax plus an exclusive running-max carry over the
  device axis -> a (ndev-1)-step `ppermute` chain per row (2 devices:
  one hop);
* the C term of a shard's first lane is the left neighbor's last-lane
  X -> one more `ppermute`.

This is the recipe for pairs whose band exceeds one device's memory or
FLOP budget: collectives ride the mesh axis, state stays
device-resident, and the arithmetic is identical to the single-device
sweep (validated exactly on the virtual CPU mesh by
tests/test_frontier.py).  Reference role: the pthread wavefront
partitioning of src/fwd2d1.cc:7-10, re-expressed as SPMD collectives.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

NEVSEL = -1.0e30
NEG_SENT = -(2 ** 31 // 8) * 7.0


def _cummax(t):
    W = t.shape[-1]
    j = jnp.arange(W)
    k = 1
    while k < W:
        r = jnp.roll(t, k)
        t = jnp.maximum(t, jnp.where(j < k, NEVSEL, r))
        k <<= 1
    return t


def frontier_pairwise_score(a: np.ndarray, b: np.ndarray, lw: int,
                            up: int, u: float, v: float, mtx,
                            mesh: Mesh, axis: str = "band") -> float:
    """Global-mode banded affine score of ONE pair with the band
    sharded over ``mesh`` axis ``axis``.  Exact (modulo f32
    reassociation) vs the single-device row sweep."""
    la, lb = len(a), len(b)
    ndev = mesh.shape[axis]
    W = up - lw + 1
    Wp = ((W + ndev * 8 - 1) // (ndev * 8)) * (ndev * 8)
    Wl = Wp // ndev
    S = np.asarray(mtx, np.float32)[np.asarray(a)[:, None],
                                    np.asarray(b)[None, :]]
    # band-packed substitution rows: s_rows[m, j] = S[m, m + lw + j]
    jj = np.arange(Wp)
    s_rows = np.full((la, Wp), NEG_SENT, np.float32)
    n_idx = np.arange(la)[:, None] + lw + jj[None, :]
    ok = (n_idx >= 0) & (n_idx < lb)
    mg, jg = np.nonzero(ok)
    s_rows[mg, jg] = S[mg, n_idx[mg, jg]]

    uf, vf = np.float32(u), np.float32(v)

    def local(s_sh):
        ax = jax.lax.axis_index(axis)
        jloc = jnp.arange(Wl)
        jglob = ax * Wl + jloc
        ju = jglob.astype(jnp.float32) * uf
        n0 = jglob + lw           # column of row 0 at this lane

        # row -1 boundary (virtual): H(-1, n) on slot n+1; readable
        # only inside the band (slot r = n+1 <= up)
        nv = n0 - 1
        hinit = jnp.where(nv == -1, 0.0,
                          jnp.where((nv >= 0) & (nv + 1 <= up),
                                    -(vf + (nv + 1) * uf),
                                    NEG_SENT)).astype(jnp.float32)
        ginit = jnp.full(Wl, NEVSEL, jnp.float32)

        def right_first(x):
            """my last-lane successor = right neighbor's first lane."""
            got = jax.lax.ppermute(x[0:1], axis,
                                   [(i, (i - 1) % ndev)
                                    for i in range(ndev)])
            edge = jnp.where(ax == ndev - 1, NEG_SENT, got[0])
            return jnp.concatenate([x[1:], edge[None]])

        def left_last(x, fill):
            got = jax.lax.ppermute(x[Wl - 1:Wl], axis,
                                   [(i, (i + 1) % ndev)
                                    for i in range(ndev)])
            edge = jnp.where(ax == 0, fill, got[0])
            return jnp.concatenate([edge[None], x[:-1]])

        def row(carry, sm):
            H, G = carry
            mf, s_row = sm
            n_vec = mf + lw + jglob.astype(jnp.float32)
            Hs = right_first(H)
            Gs = right_first(G)
            G0 = jnp.maximum(Hs - vf, Gs) - uf
            D0 = H + s_row
            X = jnp.maximum(D0, G0)
            valid = (n_vec >= 0) & (n_vec < lb) & (jglob < W)
            colb = -(vf + (mf + 1.0) * uf)
            # the left-column boundary lives on slot -(m+1): readable
            # only while that slot is inside the band (m < -lw)
            C = left_last(X, NEG_SENT) - vf - uf
            C = jnp.where((n_vec == 0.0) & (mf < -lw),
                          (colb - vf) - uf, C)
            T = C + ju
            M = _cummax(T)
            # exclusive running-max carry over the device axis
            carry_in = jnp.float32(NEVSEL)
            mymax = M[Wl - 1]
            for _ in range(ndev - 1):
                got = jax.lax.ppermute(
                    jnp.stack([mymax]), axis,
                    [(i, (i + 1) % ndev) for i in range(ndev)])[0]
                got = jnp.where(ax == 0, NEVSEL, got)
                carry_in = jnp.maximum(carry_in, got)
                mymax = jnp.maximum(mymax, got)
            M = jnp.maximum(M, carry_in)
            E = M - ju
            H0 = jnp.maximum(X, E)
            H0 = jnp.where(valid, H0, NEG_SENT)
            return (H0, G0), H0

        mfs = jnp.arange(la, dtype=jnp.float32)
        (_, _), rows = jax.lax.scan(row, (hinit, ginit), (mfs, s_sh))
        last = rows[la - 1]
        n_last = (la - 1) + lw + jglob
        sc = jnp.max(jnp.where(n_last == lb - 1, last, NEVSEL))
        return jax.lax.pmax(sc, axis)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(None, axis),),
                       out_specs=P(), check_vma=False)
    return float(jax.jit(fn)(jnp.asarray(s_rows)))


def maybe_init_distributed() -> bool:
    """Multi-host DCN bring-up (SURVEY §5.8): initialize
    jax.distributed when the standard coordinator env is present
    (JAX_COORDINATOR_ADDRESS / PRRN_DIST=1 with COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID).  No-op on single-host runs."""
    import os
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") \
        or os.environ.get("COORDINATOR_ADDRESS")
    if not addr and os.environ.get("PRRN_DIST") != "1":
        return False
    kw = {}
    if addr:
        kw["coordinator_address"] = addr
    np_ = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if np_ is not None:
        kw["num_processes"] = int(np_)
    if pid is not None:
        kw["process_id"] = int(pid)
    try:
        jax.distributed.initialize(**kw)
        return True
    except Exception as e:          # pragma: no cover - env-specific
        import sys
        print(f"; jax.distributed init skipped: {e}", file=sys.stderr)
        return False
