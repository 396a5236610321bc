"""JAX wavefront kernel vs golden reference scores (batched)."""

import json
from pathlib import Path

import numpy as np
import pytest

from prrn_aln_tpu import scoring
from prrn_aln_tpu.config import AlnParams
from prrn_aln_tpu.ops.window import stripe
from prrn_aln_tpu.ops.pairwise import wavefront_scores

FIX = Path(__file__).parent / "fixtures"
FIXTURE = json.loads((FIX / "pairwise_fixtures.json").read_text())
PROT_MTX, _ = scoring.protein_matrix(
    AlnParams(pam=FIXTURE["matrices"]["protein_pam"]))
DNA_MTX, _ = scoring.dna_matrix(AlnParams(
    u=FIXTURE["matrices"]["dna_u"],
    n_mismatch=FIXTURE["matrices"]["dna_mismatch"]))


def _batchify(cases, mtx, local):
    """Pad a set of fixture cases into one batch."""
    seqs = FIXTURE["seqs"]
    items = []
    for c in cases:
        a = np.array(seqs[c["a"]]["codes"], dtype=np.int32)
        b = np.array(seqs[c["b"]]["codes"], dtype=np.int32)
        wdw = stripe(len(a), len(b), c["sh"])
        items.append((a, b, wdw, c))
    ma = max(len(i[0]) for i in items)
    mb = max(len(i[1]) for i in items)
    nslot = max(i[2].width for i in items)
    nsteps = max(len(i[0]) + len(i[1]) - 1 for i in items)
    B = len(items)
    A = np.zeros((B, ma), np.int32)
    Bm = np.zeros((B, mb), np.int32)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    lw = np.zeros(B, np.int32)
    up = np.zeros(B, np.int32)
    u = np.zeros(B, np.float32)
    v = np.zeros(B, np.float32)
    tg = np.ones(B, np.float32)
    exg = np.zeros((B, 4), bool)
    want = np.zeros(B, np.float64)
    for i, (a, b, wdw, c) in enumerate(items):
        A[i, :len(a)] = a
        Bm[i, :len(b)] = b
        la[i], lb[i] = len(a), len(b)
        lw[i], up[i] = wdw.lw, wdw.up
        u[i], v[i], tg[i] = c["u"], c["v"], c["tgapf"]
        lcl = c["lcl"]
        exg[i] = [lcl & 1, lcl & 2, lcl & 4, lcl & 8]
        want[i] = c["score"]
    got = wavefront_scores(
        A, Bm, la, lb, lw, up, mtx, u, v, tg, exg,
        nslot=nslot, nsteps=nsteps, dim=mtx.shape[0], local=local)
    return np.asarray(got), want


@pytest.mark.parametrize("molc,local", [(1, False), (1, True),
                                        (2, False), (2, True)])
def test_wavefront_batch_matches_reference(molc, local):
    cases = [c for c in FIXTURE["cases"]
             if FIXTURE["seqs"][c["a"]]["molc"] == molc
             and bool(c["lcl"] & 16) == local]
    assert cases
    mtx = PROT_MTX if molc == 1 else DNA_MTX
    got, want = _batchify(cases, mtx, local)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0.05)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_ragged_banded_batch_matches_oracle(seed):
    """Ragged lengths, per-pair stripes, free end-gap flags and a
    terminal-gap factor in one batch: every pair's score equals the
    NumPy oracle's."""
    from prrn_aln_tpu.ops.pairwise_np import pairwise_score_np
    rng = np.random.default_rng(seed)
    B, L = 8, 80
    a = rng.integers(3, 23, size=(B, L)).astype(np.int32)
    b = rng.integers(3, 23, size=(B, L)).astype(np.int32)
    la = rng.integers(30, L + 1, size=B).astype(np.int32)
    lb = rng.integers(30, L + 1, size=B).astype(np.int32)
    for i in range(B):
        a[i, la[i]:] = 0
        b[i, lb[i]:] = 0
    wd = [stripe(int(la[i]), int(lb[i]), -60) for i in range(B)]
    lw = np.array([w.lw for w in wd], np.int32)
    up = np.array([w.up for w in wd], np.int32)
    exg = rng.integers(0, 2, size=(B, 4)).astype(bool)
    got = np.asarray(wavefront_scores(
        a, b, la, lb, lw, up, PROT_MTX,
        np.full(B, 2.0, np.float32), np.full(B, 9.0, np.float32),
        np.full(B, 0.5, np.float32), exg,
        nslot=int(max(w.width for w in wd)) + 2,
        nsteps=int((la + lb).max()), dim=PROT_MTX.shape[0], local=False))
    for i in range(B):
        want = pairwise_score_np(
            a[i, :la[i]], b[i, :lb[i]], PROT_MTX, 2.0, 9.0, wd[i],
            tgapf=0.5, exgl_a=exg[i, 0], exgr_a=exg[i, 1],
            exgl_b=exg[i, 2], exgr_b=exg[i, 3])
        assert abs(got[i] - want) <= 1e-3 * max(1.0, abs(want)), i
