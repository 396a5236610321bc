"""Group-DP scan engine (ops/group.py) vs the row-scan NumPy oracle
(ops/group_np.py): scores to f32 accuracy and identical paths — or, where
f32 summation order flips an exact tie, two paths of equal score under the
oracle's model (ops/path_score.py).

Cases: the reference galign fixtures (themselves golden-tested against
align2, src/maln2.cc:1875), random gapped batches with uneven group sizes,
weighted members with a narrow band and GOP scale, and single pairs on
the plain and the double-affine (ls=3) lanes.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from prrn_aln_tpu import scoring, alphabet as ab
from prrn_aln_tpu.config import AlnParams
from prrn_aln_tpu.msa.msa import Msa, msa_from_strings
from prrn_aln_tpu.msa import distance, tree
from prrn_aln_tpu.ops import group as gops
from prrn_aln_tpu.ops.group_np import group_align_np
from prrn_aln_tpu.ops.path_score import score_path
from prrn_aln_tpu.ops.window import stripe

FIX = Path(__file__).parent / "fixtures"
GFIX = json.loads((FIX / "galign_fixtures.json").read_text())
MTX, _ = scoring.protein_matrix(AlnParams(pam=150))
# one member/length bucket for every fixture case: few compiled shapes
FIX_PADS = (max(max(c["an"], c["bn"]) for c in GFIX["cases"]), 128)


def _fixture_msa(fname, weighted):
    info = GFIX["files"][fname]
    m = msa_from_strings(info["rows"], ab.PROTEIN, info["names"])
    if weighted:
        if m.many == 1:
            m.weight = np.array([1.0])
        elif m.many == 2:
            m.weight = np.array([0.5, 0.5])
        else:
            d = distance.msa_distance_matrix(m.codes)
            m.weight = tree.calc_seq_weights(tree.upgma(d, m.many))
    m.prepare(MTX.shape[0])
    return m


def _rand_msa(rng, many, L, gap=0.08, weighted=False):
    codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
    codes[rng.random((many, L)) < gap] = ab.GAP
    codes[:, 0] = ab.ALA + rng.integers(0, 20)   # no all-gap column 0
    m = Msa(codes=codes, molc=ab.PROTEIN,
            names=[f"s{i}" for i in range(many)])
    if weighted:
        m.weight = rng.random(many).astype(np.float64) + 0.5
    m.prepare(MTX.shape[0])
    return m


def _check(A, B, got, sh=-60, scale=1.0, ls=1):
    wdw = stripe(A.length, B.length, sh)
    s_np, k_np = group_align_np(A, B, MTX, u=2.0, v=9.0, wdw=wdw,
                                scale=scale, ls=ls)
    s_dv, k_dv = got
    assert abs(s_dv - s_np) <= 1e-3 * max(1.0, abs(s_np))
    if k_dv != k_np and ls == 1:
        # an f32 tie flip: both paths must be equally optimal
        mine = score_path(A, B, MTX, k_dv, u=2.0, v=9.0, scale=scale)
        ref = score_path(A, B, MTX, k_np, u=2.0, v=9.0, scale=scale)
        assert mine == pytest.approx(ref, rel=1e-6, abs=1e-3)
    else:
        assert k_dv == k_np


def _case_id(c):
    w = "w" if "wa" in c else "i"
    return f"{Path(c['a']).name}-{Path(c['b']).name}-{w}"


@pytest.mark.parametrize("case", GFIX["cases"], ids=_case_id)
def test_galign_fixture_pair_batch(case):
    weighted = "wa" in case
    A = _fixture_msa(case["a"], weighted)
    B = _fixture_msa(case["b"], weighted)
    if case["swp"]:
        A, B = B, A
    (got,) = gops.group_align_batch([(A, B)], MTX, u=2.0, v=9.0, sh=-60,
                                    pads=FIX_PADS)
    _check(A, B, got)


def test_random_batch():
    rng = np.random.default_rng(11)
    pairs = [(_rand_msa(rng, rng.integers(1, 6), rng.integers(40, 90)),
              _rand_msa(rng, rng.integers(1, 6), rng.integers(40, 90)))
             for _ in range(6)]
    res = gops.group_align_batch(pairs, MTX, u=2.0, v=9.0, sh=-60,
                                 pads=(6, 96))
    for (A, B), got in zip(pairs, res):
        _check(A, B, got)


def test_weighted_narrow_band_scaled():
    rng = np.random.default_rng(5)
    pairs = [(_rand_msa(rng, 4, 70, weighted=True),
              _rand_msa(rng, 3, 80, weighted=True)) for _ in range(3)]
    res = gops.group_align_batch(pairs, MTX, u=2.0, v=9.0, sh=-30,
                                 pads=(4, 96), scale=2.5)
    for (A, B), got in zip(pairs, res):
        _check(A, B, got, sh=-30, scale=2.5)


@pytest.mark.parametrize("ls", [1, 3])
def test_single_pair(ls):
    rng = np.random.default_rng(17 + ls)
    A = _rand_msa(rng, 3, 60)
    B = _rand_msa(rng, 2, 75)
    wdw = stripe(A.length, B.length, -60)
    got = gops.group_align(A, B, MTX, u=2.0, v=9.0, wdw=wdw, pads=(4, 96),
                           ls=ls)
    _check(A, B, got, ls=ls)
