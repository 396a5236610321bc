#!/usr/bin/env python3
"""Benchmark: DP cell-update throughput of the distance-pass engine
(``ops/pairwise.wavefront_scores``, the batched anti-diagonal scan that
msa/distance.py::all_pairs_scores runs).

Measurement rules:
  * runs only on a GPU; without one it exits non-zero and prints no
    result;
  * each timed launch ends in ``block_until_ready``; compilation is
    timed apart from the warm launches;
  * cells are the in-band cells actually requested (the stripe of
    src/aln2.cc:156-174 at the prrn5 distance-pass default sh=-60),
    not the full rectangle;
  * scores are checked against the NumPy oracle before timing.

Prints the card's name and power limit, then one JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}}
"""

import json
import sys
import time

import numpy as np


def band_cells(la: int, lb: int, lw: int, up: int) -> int:
    """Number of DP cells inside the stripe lw <= n - m <= up."""
    m = np.arange(la)[:, None]
    n = np.arange(lb)[None, :]
    r = n - m
    return int(((r >= lw) & (r <= up)).sum())


def _device():
    from prrn_aln_tpu import devinfo
    try:
        dev = devinfo.require_gpu()
    except devinfo.NoGPUError as e:
        raise SystemExit(f"FAIL: {e}")
    print(devinfo.card_name_and_power(), flush=True)
    return dev


def scaling_main():
    """Scaling efficiency of the sharded all-pairs distance pass over
    mesh sizes 1..ndev: reports T1 / (k * Tk)."""
    dev = _device()
    import jax
    from jax.sharding import Mesh
    from prrn_aln_tpu import scoring
    from prrn_aln_tpu.config import AlnParams
    from prrn_aln_tpu.msa import distance

    rng = np.random.default_rng(11)
    seqs = [rng.integers(3, 23, size=160).astype(np.int32)
            for _ in range(40)]
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    devs = jax.devices()
    sizes = [k for k in (1, 2, 4, 8) if k <= len(devs)]
    times = {}
    for k in sizes:
        mesh = Mesh(np.array(devs[:k]), axis_names=("pairs",))
        distance.all_pairs_scores(seqs, mtx, 2.0, 9.0, -60, mesh=mesh)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            distance.all_pairs_scores(seqs, mtx, 2.0, 9.0, -60, mesh=mesh)
            best = min(best, time.perf_counter() - t0)
        times[k] = best
    kmax = sizes[-1]
    eff = times[sizes[0]] / (kmax * times[kmax]) if kmax > 1 else 1.0
    print(json.dumps({
        "metric": "distance_scaling_efficiency",
        "value": eff, "unit": f"T1/({kmax}*T{kmax})",
        "times_s": {str(k): v for k, v in times.items()},
        "device": dev,
    }))


def main():
    if "--scaling" in sys.argv:
        scaling_main()
        return
    dev = _device()
    if "--group" in sys.argv or "--spliced" in sys.argv:
        # secondary engine metrics (see _profgroup.py)
        import _profgroup
        if "--group" in sys.argv:
            g, t, dv, cells = _profgroup.group_dp_gcups()
            # device-only member-pair cell updates (an*bn=64 per band
            # cell: the unit the refinement engine actually computes)
            print(json.dumps({"metric": "group_dp_device_throughput",
                              "value": cells * 64 / dv / 1e9,
                              "unit": "GCUPS(member-pair)",
                              "e2e_batch_s": t, "device_batch_s": dv,
                              "device": dev}))
        if "--spliced" in sys.argv:
            g, t = _profgroup.spliced_gcups()
            print(json.dumps({"metric": "spliced_h_throughput",
                              "value": g, "unit": "GCUPS", "e2e_s": t,
                              "device": dev}))
        return

    import jax
    from prrn_aln_tpu import scoring
    from prrn_aln_tpu.config import AlnParams
    from prrn_aln_tpu.ops.pairwise import wavefront_scores
    from prrn_aln_tpu.ops.pairwise_np import pairwise_score_np
    from prrn_aln_tpu.ops.window import stripe

    rng = np.random.default_rng(7)
    # distance-pass scale: one launch = 512 pairs of 512 x 512 residues
    B, L = 512, 512
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    w = stripe(L, L, -60)
    a = rng.integers(3, 23, size=(B, L)).astype(np.int32)
    b = rng.integers(3, 23, size=(B, L)).astype(np.int32)
    args = [jax.device_put(x) for x in (
        a, b, np.full(B, L, np.int32), np.full(B, L, np.int32),
        np.full(B, w.lw, np.int32), np.full(B, w.up, np.int32), mtx,
        np.full(B, 2.0, np.float32), np.full(B, 9.0, np.float32),
        np.ones(B, np.float32), np.zeros((B, 4), bool))]
    t0 = time.perf_counter()
    run = wavefront_scores.lower(
        *args, nslot=w.width, nsteps=2 * L - 1, dim=mtx.shape[0],
        local=False).compile()
    compile_s = time.perf_counter() - t0
    got = np.asarray(jax.block_until_ready(run(*args)))

    nchk = 4
    err = max(abs(got[k] - pairwise_score_np(a[k], b[k], mtx, 2.0, 9.0, w))
              for k in range(nchk))
    if err > 1e-3 * max(1.0, float(np.abs(got[:nchk]).max())):
        raise SystemExit(f"FAIL: engine/oracle mismatch {err}")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        times.append(time.perf_counter() - t0)
    warm = float(np.median(times))
    cells = B * band_cells(L, L, w.lw, w.up)
    print(json.dumps({
        "metric": "pairwise_banded_wavefront_throughput",
        "value": cells / warm / 1e9,
        "unit": "GCUPS",
        "warm_s": warm, "compile_s": compile_s,
        "us_per_step": warm / (2 * L - 1) * 1e6,
        "device": dev,
    }))


if __name__ == "__main__":
    main()
