"""Multi-device correctness on the 8-virtual-device CPU mesh (conftest
sets xla_force_host_platform_device_count=8): mesh and no-mesh runs must
agree exactly, and the sharded paths must actually place shards on every
device (SURVEY §5.8; the reference's serial-vs-threaded equivalence
check, src/calcserv.h:798-802)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from prrn_aln_tpu import alphabet as ab
from prrn_aln_tpu import scoring
from prrn_aln_tpu.config import AlnParams
from prrn_aln_tpu.msa import distance
from prrn_aln_tpu.msa.msa import msa_from_strings
from prrn_aln_tpu.ops import group as gops


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs multi-device (virtual CPU mesh)")
    return Mesh(np.array(devs), axis_names=("pairs",))


@pytest.fixture(scope="module")
def pmtx():
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    return mtx


def test_all_pairs_scores_mesh_matches_serial(mesh, pmtx):
    rng = np.random.default_rng(17)
    seqs = [rng.integers(3, 23, size=rng.integers(30, 70)).astype(np.int32)
            for _ in range(9)]             # 36 pairs over 8 devices
    want = distance.all_pairs_scores(seqs, pmtx, 2.0, 9.0, -60)
    got = distance.all_pairs_scores(seqs, pmtx, 2.0, 9.0, -60, mesh=mesh)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_group_align_batch_sharded_matches_serial(mesh, pmtx):
    rows = ["MKVLAAGFDDEERRKKLL", "MKVLAAGFDEEERRKQLL",
            "MKVLAGGFDDEERRKKLL", "MKVLAAGFDDEERRQKLL",
            "MKVLAAGFDDEDRRKKLL", "MKVIAAGFDDEERRKKLL"]
    A = msa_from_strings(rows[:3], ab.PROTEIN).prepare(pmtx.shape[0])
    B = msa_from_strings(rows[3:], ab.PROTEIN).prepare(pmtx.shape[0])
    C = msa_from_strings([r[2:] for r in rows[:2]],
                         ab.PROTEIN).prepare(pmtx.shape[0])
    pairs = [(A, B), (B, C), (A, C), (C, B), (A, B)]   # 5 -> pad to 8

    want = gops.group_align_batch(pairs, pmtx, u=2.0, v=9.0, sh=-60,
                                  pads=(6, 32))
    got = gops.group_align_batch(pairs, pmtx, u=2.0, v=9.0, sh=-60,
                                 pads=(6, 32), mesh=mesh)
    assert len(got) == len(want) == len(pairs)
    for (sw, kw), (sg, kg) in zip(want, got):
        assert sg == pytest.approx(sw, rel=1e-6, abs=1e-4)
        assert kg == kw

    # the batch axis really is partitioned: the recorded output sharding
    # must not be fully replicated
    sh_ = gops.LAST_BATCH_SHARDING
    assert sh_ is not None
    assert not sh_.is_fully_replicated


def test_group_batch_scale_matches_single():
    """_pack_inputs must honor the GOP scale exactly like group_align
    (round-1 latent bug: batch dropped the scale)."""
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    rows = ["MKVLAAGFDDEERRKKLL", "MKVLAAGFDEEERRKQLL",
            "MKVLAGGWDDEERRKKLL", "MKVLAAGFDDEERRQKLL"]
    A = msa_from_strings(rows[:2], ab.PROTEIN).prepare(mtx.shape[0])
    B = msa_from_strings(rows[2:], ab.PROTEIN).prepare(mtx.shape[0])
    from prrn_aln_tpu.ops.window import stripe
    wdw = stripe(A.length, B.length, -60)
    s1, k1 = gops.group_align(A, B, mtx, u=2.0, v=9.0, wdw=wdw,
                              scale=2.5, pads=(4, 32))
    (s2, k2), = gops.group_align_batch([(A, B)], mtx, u=2.0, v=9.0,
                                       sh=-60, pads=(4, 32), scale=2.5)
    assert s2 == pytest.approx(s1, rel=1e-6)
    assert k2 == k1
