"""No-internal-gap (DPunit) tier: gap-free groups collapse to weighted
column sums (reference fwd2c.cc DPunit vs DPunit_nv; auto-selection
maln2.cc:43-60)."""

import numpy as np
import pytest

from prrn_aln_tpu import alphabet as ab, scoring
from prrn_aln_tpu.config import default_params
from prrn_aln_tpu.msa.msa import Msa
from prrn_aln_tpu.ops import group as gops


def _gapfree_msa(rng, many, length, dim):
    codes = rng.integers(3, 23, (many, length)).astype(np.int64)
    m = Msa(codes=codes, molc=ab.PROTEIN,
            names=[f"s{i}" for i in range(many)],
            weight=rng.uniform(0.5, 1.5, many))
    m.prepare(dim)
    return m


@pytest.mark.parametrize("many", [4, 8])
def test_uniform_collapse_matches_nv(monkeypatch, many):
    pm, _ = scoring.build_matrix(ab.PROTEIN,
                                 default_params(ab.PROTEIN, "aln"))
    rng = np.random.default_rng(11)
    A = _gapfree_msa(rng, many, 90, pm.shape[0])
    B = _gapfree_msa(rng, many, 100, pm.shape[0])
    assert gops.uniform_side(A) and gops.uniform_side(B)

    monkeypatch.setenv("PRRN_GROUP_UNIFORM", "0")
    s0, k0 = gops.group_align(A, B, pm, u=2.0, v=9.0)
    monkeypatch.setenv("PRRN_GROUP_UNIFORM", "1")
    s1, k1 = gops.group_align(A, B, pm, u=2.0, v=9.0)
    assert abs(s1 - s0) <= 1e-3 * max(1.0, abs(s0))
    assert k0 == k1


def test_gapped_side_not_collapsed():
    rng = np.random.default_rng(3)
    codes = rng.integers(3, 23, (4, 50)).astype(np.int64)
    codes[1, 10:14] = ab.GAP
    m = Msa(codes=codes, molc=ab.PROTEIN, names=list("abcd"))
    m.prepare(26)
    assert not gops.uniform_side(m)
