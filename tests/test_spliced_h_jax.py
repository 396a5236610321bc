"""Device (JAX) fwd2h kernel vs the NumPy oracle: score + knot parity."""

from pathlib import Path

import numpy as np
import pytest

from prrn_aln_tpu import scoring, alphabet as ab
from prrn_aln_tpu.config import default_params
from prrn_aln_tpu.splice import tron
from prrn_aln_tpu.splice.exin import build_exin
from prrn_aln_tpu.splice.penalty import IntronPenalty
from prrn_aln_tpu.ops.spliced_h_np import forward_h, HParams
from prrn_aln_tpu.ops.spliced_h_jax import forward_h_device

FIX = Path(__file__).parent / "fixtures"


def _qprof(a):
    pm, _ = scoring.build_matrix(ab.PROTEIN,
                                 default_params(ab.PROTEIN, "aln"))
    tm = tron.tron_matrix(pm, u=2.0, o=30.0)
    M = len(a)
    qprof = np.zeros((M + 2, tron.TSIMD))
    for m in range(1, M + 1):
        qprof[m] = tm[a[m - 1]]
    qprof[M + 1] = qprof[M]
    return qprof


def _run_both(g, p, sh_pct=50, api=None):
    b = ab.encode(g, ab.DNA)
    a = ab.encode(p, ab.PROTEIN)
    M, N = len(a), len(b)
    qprof = _qprof(a)
    ex = build_exin(b)
    ipen = IntronPenalty.build(f=1.0, y=8.0, sss=0.5, u=2.0, v=9.0,
                               ip=15.0, fact=8.0)
    shld = 3 * (sh_pct * min(M, N) // 100)
    lw, up = -shld, min(N - 3 * M + shld, N)
    s_np, k_np = forward_h(qprof, b, ex, ipen, HParams(), lw, up, api=api)
    s_dv, k_dv = forward_h_device(qprof, b, ex, ipen, HParams(), lw, up,
                                  api=api)
    return (s_np, k_np), (s_dv, k_dv)


def test_device_h_mini_gene(cet10b9, ce13a1):
    """CET10B9 slice x ce13a1 prefix — the one-intron mini case."""
    g = cet10b9(31549, 32450)
    p = ce13a1[:172]
    (s_np, k_np), (s_dv, k_dv) = _run_both(g, p)
    assert abs(s_dv - s_np) <= 1e-3 * max(1.0, abs(s_np))
    assert k_dv == k_np


def test_device_h_two_introns(cet10b9, ce13a1):
    """Longer CET10B9 slice covering two introns of ce13a1."""
    g = cet10b9(31549, 33100)
    p = ce13a1[:290]
    (s_np, k_np), (s_dv, k_dv) = _run_both(g, p)
    assert abs(s_dv - s_np) <= 1e-3 * max(1.0, abs(s_np))
    assert k_dv == k_np


def test_device_h_with_intron_bonus(cet10b9, ce13a1):
    g = cet10b9(31549, 32450)
    p = ce13a1[:172]
    pos = np.array([3 * 62])

    def api(pt):
        return 20.0 if np.any(pos == pt) else 0.0

    (s_np, k_np), (s_dv, k_dv) = _run_both(g, p, api=api)
    assert abs(s_dv - s_np) <= 1e-3 * max(1.0, abs(s_np))
    assert k_dv == k_np


def test_device_h_no_intron_plain(cet10b9, ce13a1):
    """Exon-only fragment (pure diagonal/frameshift machinery)."""
    g = cet10b9(31614, 31800)
    p = ce13a1[:60]
    (s_np, k_np), (s_dv, k_dv) = _run_both(g, p, sh_pct=100)
    assert abs(s_dv - s_np) <= 1e-3 * max(1.0, abs(s_np))
    assert k_dv == k_np
