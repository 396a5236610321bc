"""Device (indicator-matmul) k-mer distance pass vs the host loop.

The sl-forest edge discovery must produce identical qdiv distances on
either path (the overlap sum is exact integer arithmetic both ways).
"""

import numpy as np

from prrn_aln_tpu import alphabet as ab
from prrn_aln_tpu.msa import kmer


def _host_matrix(seqs, molc):
    kcs = [kmer.count_kmers(s, molc) for s in seqs]
    n = len(kcs)
    out = np.zeros(n * (n - 1) // 2)
    for j in range(1, n):
        for i in range(j):
            out[j * (j - 1) // 2 + i] = 100.0 * kmer.qdiv(
                kcs[i], kcs[j], molc)
    return out


def test_device_matches_host_protein():
    rng = np.random.default_rng(7)
    seqs = [(rng.integers(0, 20, size=rng.integers(40, 90)) +
             ab.ALA).astype(np.int8) for _ in range(50)]
    want = _host_matrix(seqs, ab.PROTEIN)
    got = kmer.kmer_distance_matrix(seqs, ab.PROTEIN)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_device_matches_host_dna():
    rng = np.random.default_rng(8)
    base = rng.integers(0, 4, size=200)
    seqs = []
    for _ in range(48):
        s = base.copy()
        mut = rng.random(len(s)) < 0.15
        s[mut] = rng.integers(0, 4, size=int(mut.sum()))
        seqs.append(ab.encode("".join("ACGT"[c] for c in s), ab.DNA))
    want = _host_matrix(seqs, ab.DNA)
    got = kmer.kmer_distance_matrix(seqs, ab.DNA)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
