"""Protein x genomic-DNA spliced alignment (fwd2h oracle): tron
translation, EXIN signals and the forwardH DP, validated against
instrumented reference runs (see ops/spliced_h_np.py)."""

from pathlib import Path

import numpy as np
import pytest

from prrn_aln_tpu import io, scoring, alphabet as ab
from prrn_aln_tpu.config import default_params
from prrn_aln_tpu.splice import tron
from prrn_aln_tpu.splice.exin import build_exin
from prrn_aln_tpu.splice.penalty import IntronPenalty
from prrn_aln_tpu.ops.spliced_h_np import forward_h, HParams

FIX = Path(__file__).parent / "fixtures"


def test_nuc2tron_known_codons():
    b = ab.encode("ATGAGTTTC", ab.DNA)
    trn = tron.nuc2tron(b)
    # codon centered at 1 = ATG = MET; at 4 = AGT = SER2; at 7 = TTC = PHE
    assert trn[1] == ab.MET
    assert trn[4] == tron.SER2
    assert trn[7] == ab.PHE


def test_tron_matrix_props():
    pm, _ = scoring.build_matrix(ab.PROTEIN,
                                 default_params(ab.PROTEIN, "aln"))
    tm = tron.tron_matrix(pm, u=2.0, o=30.0)
    assert tm.shape == (26, 26)
    assert tm[ab.MET, ab.MET] == pm[ab.MET, ab.MET]
    assert tm[ab.SER, tron.SER2] == pm[ab.SER, ab.SER]
    assert tm[ab.ALA, tron.TRM] == -30.0
    assert tm[ab.GAP, ab.ALA] == -2.0


@pytest.fixture(scope="module")
def mini(cet10b9, ce13a1):
    """Mini gene-prediction case: CET10B9[31550:32450] x ce13a1[:172]
    (one intron; reference aln -yl2 -L finds join(66..251,307..651))."""
    return cet10b9(31549, 32450), ce13a1[:172]


def test_forward_h_mini_structure(mini):
    g, p = mini
    b = ab.encode(g, ab.DNA)
    a = ab.encode(p, ab.PROTEIN)
    M, N = len(a), len(b)
    pm, _ = scoring.build_matrix(ab.PROTEIN,
                                 default_params(ab.PROTEIN, "aln"))
    tm = tron.tron_matrix(pm, u=2.0, o=30.0)
    qprof = np.zeros((M + 2, tron.TSIMD))
    for m in range(1, M + 1):
        qprof[m] = tm[a[m - 1]]
    qprof[M + 1] = qprof[M]
    ex = build_exin(b)
    ipen = IntronPenalty.build(f=1.0, y=8.0, sss=0.5, u=2.0, v=9.0,
                               ip=15.0, fact=8.0)
    shld = 3 * (50 * min(M, N) // 100)
    lw, up = -shld, min(N - 3 * M + shld, N)
    score, knots = forward_h(qprof, b, ex, ipen, HParams(), lw, up)
    # reference: exon1 = [65, 251), intron, exon2 = [306, 651)
    assert (0, 65) in knots
    assert (62, 251) in knots and (62, 306) in knots
    assert (172, 651) in knots
    assert score == pytest.approx(1013.06, abs=0.1)


def test_exin_signal_shapes(mini):
    g, _ = mini
    b = ab.encode(g, ab.DNA)
    ex = build_exin(b)
    L = len(b)
    assert ex.sigE.shape == (L,)
    assert ex.sigS is not None and ex.sigT is not None
    # canonical GT donor at the known intron start (0-based 251)
    assert ex.phs5[251] == 0
    # canonical AG acceptor ending at the known intron end
    assert ex.phs3[306] == 0


# ---------------------------------------------------------------------
# CLI gene-prediction parity (aln -yl2 -L <genome> <protein>), golden
# outputs captured from the reference build (fixtures aln_H_mini_*).

@pytest.fixture(scope="module")
def hresult():
    from prrn_aln_tpu.splice.hapi import spliced_align_h
    g = io.sniff_and_read(FIX / "mini_gen.fa")[0]
    q = io.sniff_and_read(FIX / "mini_pro.fa")[0]
    return spliced_align_h(g.seq, q.seq, gname=g.name, qname=q.name)


def test_h_exon_structure(hresult):
    assert hresult.exons == [(66, 251), (307, 651)]


def test_h_O5_intron_table_bytes(hresult):
    golden = (FIX / "aln_H_mini_O5.txt").read_text()
    assert hresult.render(5) == golden


def test_h_O1_alignment_text_bytes(hresult):
    """Byte parity on every line except the Score line (the verify
    re-score differs by <1 unit; see hapi.gene_structure_h)."""
    golden = (FIX / "aln_H_mini_O1.txt").read_text().splitlines()
    ours = hresult.render(1).splitlines()
    assert len(ours) == len(golden)
    for g, o in zip(golden, ours):
        if g.startswith("Score ="):
            continue
        assert o == g


def test_h_score_line_epsilon(hresult):
    assert hresult.reported_score == pytest.approx(1009.1, abs=1.0)
    assert hresult.gs.score == pytest.approx(994.1, abs=1.0)


def test_h_O0_gff3_structure(hresult):
    golden = (FIX / "aln_H_mini_O0.txt").read_text().splitlines()
    ours = hresult.render(0).splitlines()
    assert len(ours) == len(golden)
    for g, o in zip(golden, ours):
        gf, of = g.split("\t"), o.split("\t")
        # feature/coordinate/frame/attribute parity; scores epsilon
        assert of[:3] == gf[:3]
        if len(gf) > 4:
            assert of[3:5] == gf[3:5]
            assert of[6:] == gf[6:]


def test_h_O2_gap_attribute(hresult):
    golden = (FIX / "aln_H_mini_O2.txt").read_text().splitlines()
    ours = hresult.render(2).splitlines()
    for g, o in zip(golden, ours):
        if g.startswith("#"):
            assert o == g
            continue
        gf, of = g.split("\t"), o.split("\t")
        assert of[:5] == gf[:5]
        assert of[8].split("Gap=")[-1] == gf[8].split("Gap=")[-1]


def test_h_O3_bed(hresult):
    golden = (FIX / "aln_H_mini_O3.txt").read_text().splitlines()
    ours = hresult.render(3).splitlines()
    gf, of = golden[1].split("\t"), ours[1].split("\t")
    assert of[:4] == gf[:4]                 # coords + name
    assert of[5:] == gf[5:]                 # strand, thick, blocks


def test_h_exon_escr_and_iscr(hresult):
    e1, e2 = hresult.gs.exons
    assert e1.escr == pytest.approx(427.9, abs=0.1)     # exact vs ref
    assert e1.iscr == pytest.approx(4.7, abs=0.1)
    assert (e1.mch, e1.mmc, e1.unp) == (62, 0, 0)
    assert (e2.mch, e2.mmc, e2.unp) == (110, 0, 5)


def test_h_profile_query(hresult):
    """MSA-profile query: duplicated member profile reproduces the
    single-sequence gene structure."""
    from prrn_aln_tpu.splice.hapi import spliced_align_h
    g = io.sniff_and_read(FIX / "mini_gen.fa")[0]
    q = io.sniff_and_read(FIX / "mini_pro.fa")[0]
    msa = io.records_to_msa([q, q], ab.PROTEIN)
    res = spliced_align_h(g.seq, None, gname=g.name, qname=q.name,
                          msa=msa)
    assert res.exons == [(66, 251), (307, 651)]


def test_h_cli_dispatch(capsys):
    from prrn_aln_tpu.cli import aln_main
    aln_main(["-yl", "2", "-O", "5", str(FIX / "mini_gen.fa"),
              str(FIX / "mini_pro.fa")])
    out = capsys.readouterr().out
    golden = (FIX / "aln_H_mini_O5.txt").read_text()
    assert out == golden
