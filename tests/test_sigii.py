"""Gene-structure-annotated MSA (GSA-MPSA): ;C parsing, SigII intron
positions, the -yJ DP bonus and -pi output (reference flagship test
`prrn5 -pi pas/ce13a17.fa`, sample/test.sh:2)."""

import re
from pathlib import Path

import numpy as np
import pytest

from prrn_aln_tpu import io, alphabet as ab
from prrn_aln_tpu.msa import sigii
from prrn_aln_tpu.pipeline import build_msa

FIX = Path(__file__).parent / "fixtures"
# the reference's `;C`-annotated sample/pas/ce13a17.fa (gene structures of
# the seven members); it is not in the repository, so the tests that need
# it skip unless a copy is placed here
SAMPLE = FIX / "ce13a17.fa"


def _annotated():
    """Records of the annotated family, or skip the calling test."""
    if not SAMPLE.exists():
        pytest.skip("needs the ;C-annotated ce13a17.fa (reference "
                    "sample/pas), which is not in the repository")
    return io.read_fasta(SAMPLE)


def _golden_rows(path):
    rows, order = {}, []
    for line in open(path):
        m = re.match(r"\s+\d+ ([A-Z\-\s]+)\| (\S+)", line)
        if m:
            seg, name = m.group(1), m.group(2)
            if name not in rows:
                rows[name] = []
                order.append(name)
            rows[name].append(seg.strip())
    return {n: "".join(v) for n, v in rows.items()}, order


def _golden_pfq(path):
    """Parse the ;b/;m block of a native output file."""
    bpairs, mems = [], []
    for line in open(path):
        if line.startswith(";b"):
            toks = line[2:].replace(",", " ").split()
            bpairs += [(int(toks[k]), int(toks[k + 1]))
                       for k in range(0, len(toks) - 1, 2)]
        elif line.startswith(";m"):
            mems += [int(t) for t in line[2:].split()]
    return bpairs, mems


def test_parse_exons_complement_reversed():
    recs = {r.name: r for r in _annotated()}
    # ce13a2 is complement(join(...)): transcription order = descending
    e2 = recs["ce13a2"].exons
    assert e2[0][0] > e2[-1][0]
    # ce13a1 is a plain join: ascending
    e1 = recs["ce13a1"].exons
    assert e1[0][0] < e1[-1][0]
    # cumulative junctions; total CDS length = 3 * protein length
    eij = sigii.eij_from_exons(e2)
    assert list(eij) == [186, 518, 618, 1175, 1319]
    total = sum(b - a + 1 for a, b in e2)
    assert total == 3 * len(recs["ce13a2"].seq)


def test_merged_pfq_matches_reference_B_block():
    """Project member-local junctions onto the reference's own refined
    alignment and compare with its ;B serialization byte content."""
    gold, order = _golden_rows(FIX / "golden_prrn_eij7.txt")
    recs = {r.name: r for r in _annotated()}
    codes = np.stack([ab.encode(gold[n], ab.PROTEIN) for n in order])
    elist = [sigii.eij_from_exons(recs[n].exons) for n in order]
    pfq = sigii.merged_pfq(codes, elist, None)
    bpairs, mems = _golden_pfq(FIX / "golden_prrn_eij7.txt")
    assert [(p, len(ms)) for p, ms, _ in pfq] == bpairs
    flat = [m + 1 for _, ms, _ in pfq for m in ms]
    assert flat == mems


def test_aln_positions_inverse():
    """read_native's ;B inversion is the exact inverse of aln_positions."""
    row = ab.encode("MS-LSIL--IAGASF", ab.PROTEIN)
    eij = np.array([9, 16, 23], np.int64)    # phases 0,1,2
    pos = sigii.aln_positions(row, eij)
    for p0, pa in zip(eij, pos):
        col = pa // 3
        nres = int((row[:col] > ab.GAP).sum())
        assert 3 * nres + pa % 3 == p0


def test_native_roundtrip_with_sigii(tmp_path):
    gold, order = _golden_rows(FIX / "golden_prrn_eij7.txt")
    recs = {r.name: r for r in _annotated()}
    from prrn_aln_tpu.msa.msa import Msa
    codes = np.stack([ab.encode(gold[n], ab.PROTEIN) for n in order])
    elist = [sigii.eij_from_exons(recs[n].exons) for n in order]
    msa = Msa(codes=codes, molc=ab.PROTEIN, names=order, eij=elist)
    text = io.write_native_block(msa)
    assert ";B 9 38" in text
    f = tmp_path / "m.msa"
    f.write_text("7 527 m\n" + text)
    back = io.read_native(f)
    for r, n in zip(back, order):
        want = sorted(int(x) for x in elist[order.index(n)])
        assert list(r.eij) == want, n


def test_sigii_block_byte_format():
    """;b/;m lines byte-match the reference writer (put_SigII wrap)."""
    gold, order = _golden_rows(FIX / "golden_prrn_eij7.txt")
    recs = {r.name: r for r in _annotated()}
    from prrn_aln_tpu.msa.msa import Msa
    codes = np.stack([ab.encode(gold[n], ab.PROTEIN) for n in order])
    elist = [sigii.eij_from_exons(recs[n].exons) for n in order]
    msa = Msa(codes=codes, molc=ab.PROTEIN, names=order, eij=elist)
    mine = [ln for ln in io.write_native_block(msa).splitlines()
            if ln.startswith((";B", ";b", ";m"))]
    ref = [ln for ln in open(FIX / "golden_prrn_eij7.txt")
           if ln.startswith((";B", ";b", ";m"))]
    assert mine == [ln.rstrip("\n") for ln in ref]


def test_pi_marks_match_reference():
    """-pi escape marks appear at the same (row, column, color) as the
    reference's markiis output."""
    gold, order = _golden_rows(FIX / "golden_prrn_eij7_pi.txt")
    # golden rows came through the escape stripper regex? no: marked rows
    # contain escapes, so _golden_rows missed them; parse marks directly.
    esc = re.compile(r"\x1b\[37;(\d+);1m(.)\x1b\[0m")
    ref_marks = set()
    row_idx = {}
    for line in open(FIX / "golden_prrn_eij7_pi.txt"):
        m = re.match(r"\s+(\d+) (.*)\| (\S+)$", line)
        if not m:
            continue
        body, name = m.group(2), m.group(3)
        if name not in row_idx:
            row_idx[name] = len(row_idx)
        # column offset of this block = columns already seen for row
        prev = row_idx.setdefault((name, "cols"), 0)
        col = prev if isinstance(prev, int) else 0
        plain = []
        k = 0
        while k < len(body):
            mm = esc.match(body, k)
            if mm:
                ref_marks.add((name, col + len(plain), int(mm.group(1))))
                plain.append(mm.group(2))
                k = mm.end()
            else:
                plain.append(body[k])
                k += 1
        row_idx[(name, "cols")] = col + len(plain)
    assert ref_marks, "no escapes parsed from golden"

    recs = {r.name: r for r in _annotated()}
    gold2, order2 = _golden_rows(FIX / "golden_prrn_eij7.txt")
    from prrn_aln_tpu.msa.msa import Msa
    codes = np.stack([ab.encode(gold2[n], ab.PROTEIN) for n in order2])
    elist = [sigii.eij_from_exons(recs[n].exons) for n in order2]
    msa = Msa(codes=codes, molc=ab.PROTEIN, names=order2, eij=elist)
    mine = {(order2[m], c, bg) for (m, c), bg in io._eij_marks(msa).items()}
    assert mine == ref_marks


@pytest.mark.slow
def test_prrn_annotated_global_refine_quality():
    """-YH0 (global refinement) on the annotated family: junction merge
    matches the reference and the shared-objective score (WSP + intron
    term under one weighting) is at least the reference's.  The
    reference's own bonus-on -YH0 run lands on a worse tie-equivalent
    optimum (DEVIATIONS.md #6), so >= is the correct assertion."""
    from prrn_aln_tpu.msa.msa import msa_from_strings
    from prrn_aln_tpu.msa import distance, tree, wsp
    from prrn_aln_tpu import scoring
    from prrn_aln_tpu.config import default_params

    recs = _annotated()
    msa = build_msa(recs, refine=True, randseed=0, local_thr=0.0)
    gold, order = _golden_rows(FIX / "golden_prrn_eij7_YH0.txt")
    assert msa.names == order
    pfq = sigii.merged_pfq(msa.codes, msa.eij, None)
    bpairs, _ = _golden_pfq(FIX / "golden_prrn_eij7_YH0.txt")
    assert [(p, len(ms)) for p, ms, _ in pfq] == bpairs

    params = default_params(ab.PROTEIN, "prrn")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    gmsa = msa_from_strings([gold[n] for n in order], ab.PROTEIN, order)
    d = distance.msa_distance_matrix(gmsa.codes)
    t = tree.upgma(d, gmsa.many)
    pairwt, _ = tree.calc_pair_weights(t)
    recd = {r.name: r for r in recs}
    elist = [sigii.eij_from_exons(recd[n].exons) for n in order]
    gmsa.eij = elist

    def total(m):
        return (wsp.wsp_score(m, mtx, v=9.0, pairwt=pairwt)
                + sigii.sp_sigii(m.codes, m.eij, pairwt, 20.0))

    assert total(msa) >= total(gmsa) - 1e-3


@pytest.mark.slow
def test_prrn_annotated_e2e_exact():
    """Flagship: prrn on the gene-structure-annotated 7-protein family
    reproduces the reference alignment byte-for-byte (the -yJ intron
    bonus changes gap placement vs. the clean run)."""
    recs = _annotated()
    msa = build_msa(recs, refine=True, randseed=0, local_thr=35.0)
    gold, order = _golden_rows(FIX / "golden_prrn_eij7.txt")
    assert msa.names == order
    for i, n in enumerate(msa.names):
        assert io.decode_row(msa, i) == gold[n], n
    pfq = sigii.merged_pfq(msa.codes, msa.eij, None)
    bpairs, _ = _golden_pfq(FIX / "golden_prrn_eij7.txt")
    assert [(p, len(ms)) for p, ms, _ in pfq] == bpairs
