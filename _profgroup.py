"""Group-DP + spliced throughput probes (bench.py --group / --spliced)."""
import time
import numpy as np


def group_dp_gcups(reps=3):
    """Refinement-engine throughput: group_align_batch on a 32-pair
    batch of 8-member x 384-col profile groups (sl-forest refinement
    shape)."""
    from prrn_aln_tpu import scoring, alphabet as ab
    from prrn_aln_tpu.config import AlnParams
    from prrn_aln_tpu.msa.msa import Msa
    from prrn_aln_tpu.ops import group as gops
    from prrn_aln_tpu.ops.window import stripe

    rng = np.random.default_rng(3)
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))

    def mk(many, L):
        codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
        gaps = rng.random((many, L)) < 0.05
        codes[gaps] = ab.GAP
        m = Msa(codes=codes, molc=ab.PROTEIN,
                names=[f"s{i}" for i in range(many)])
        m.prepare(mtx.shape[0])
        return m

    NP_, L = 32, 384
    pairs = [(mk(8, L), mk(8, L)) for _ in range(NP_)]
    sh = -60
    # warm-up (compile)
    gops.group_align_batch(pairs, mtx, u=2.0, v=9.0, sh=sh, pads=(8, L))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        gops.group_align_batch(pairs, mtx, u=2.0, v=9.0, sh=sh, pads=(8, L))
        best = min(best, time.perf_counter() - t0)
    # device-only split: same batch, DP fill only
    import jax
    import jax.numpy as jnp
    wdws = [stripe(A.length, B.length, sh) for A, B in pairs]
    an_pad = 8
    la_max = lb_max = gops._bucket(L)
    nslot = gops._bucket(max(w.up - w.lw + 3 for w in wdws), 128)
    nsteps = gops._bucket(max(A.length + B.length + 1 for A, B in pairs), 256)
    ins = [gops._pack_inputs(A, B, mtx, 2.0, 9.0, w, an_pad, la_max, lb_max)
           for (A, B), w in zip(pairs, wdws)]
    batched = [jnp.stack([x[k] for x in ins]) for k in range(len(ins[0]))]
    vm = gops._batch_fn(nslot, nsteps, an_pad, an_pad, la_max, lb_max)
    jax.block_until_ready(vm(*batched))
    t0 = time.perf_counter()
    jax.block_until_ready(vm(*batched))
    dev = time.perf_counter() - t0
    print("group-DP device-only: %.1f ms/batch" % (dev * 1e3), flush=True)
    w = stripe(L, L, sh)
    m = np.arange(L)[:, None]
    n = np.arange(L)[None, :]
    cells = int((((n - m) >= w.lw) & ((n - m) <= w.up)).sum()) * NP_
    return cells / best / 1e9, best, dev, cells


def spliced_gcups(reps=2):
    """Spliced fwd2h end-to-end throughput on a 8kb x 360aa window."""
    from prrn_aln_tpu.splice.hapi import spliced_align_h
    rng = np.random.default_rng(5)
    gen = "".join(rng.choice(list("ACGT"), size=8192))
    aa = "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), size=360))
    spliced_align_h(gen, aa)            # warm-up (compile)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        spliced_align_h(gen, aa)
        best = min(best, time.perf_counter() - t0)
    cells = len(gen) * len(aa)
    return cells / best / 1e9, best


if __name__ == "__main__":
    import sys
    if "spliced" in sys.argv:
        s, ts = spliced_gcups()
        print("spliced: %.3f GCUPS (%.1f ms)" % (s, ts * 1e3), flush=True)
    else:
        g, t, _, _ = group_dp_gcups()
        print("group-DP: %.3f GCUPS (%.1f ms/batch)" % (g, t * 1e3),
              flush=True)
