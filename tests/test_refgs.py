"""L6 concerted gene-structure refinement (perl/refgs.pl equivalent).

Mini family: the CET10B9[31550:32450] window (one intron,
join(66..251,307..651) — the structure aln -yl2 -L finds for ce13a1's
first 172 aa) with the other family members' prefixes as the reference
profile.  refgs must (a) declare a correctly-annotated member OK, and
(b) re-predict and fix a perturbed annotation.
"""

from pathlib import Path

import numpy as np
import pytest

from prrn_aln_tpu import io, alphabet as ab
from prrn_aln_tpu.io import SeqRecord
from prrn_aln_tpu import refgs as rg
from prrn_aln_tpu.utils.seqtools import translate

FIX = Path(__file__).parent / "fixtures"
TRUE_EXONS = [(66, 251), (307, 651)]


@pytest.fixture(scope="module")
def family(cet10b9):
    g = cet10b9(31549, 32450)
    recs = io.read_fasta(FIX / "ce13a17_clean.fa")
    cds = "".join(g[a - 1:b] for a, b in TRUE_EXONS)
    aa1 = translate(ab.encode(cds, ab.DNA))
    members = [SeqRecord("ce13a1", aa1, exons=list(TRUE_EXONS))]
    for r in recs:
        if r.name != "ce13a1":
            members.append(SeqRecord(r.name, r.seq[:172]))
    return g, members


def test_refgs_ok_when_unchanged(family):
    g, members = family

    def genome_of(name):
        return (g, 0) if name == "ce13a1" else None

    res = rg.refgs_family(members, genome_of, iters=2, rebuild=False)
    assert res.status["ce13a1"] == "ok"
    assert res.iters == 1          # converged on the first pass
    assert all(res.status[m.name] == "skip" for m in members[1:])


def test_refgs_fixes_perturbed_member(family):
    g, members = family
    # perturb: wrong second-exon start (overlapping window still)
    bad = [SeqRecord("ce13a1", members[0].seq,
                     exons=[(66, 251), (331, 651)])] + members[1:]

    def genome_of(name):
        return (g, 0) if name == "ce13a1" else None

    res = rg.refgs_family(bad, genome_of, iters=2, rebuild=True)
    assert res.status["ce13a1"] in ("ok", "changed")
    fixed = res.records[0]
    assert [tuple(e) for e in fixed.exons] == TRUE_EXONS
    assert res.msa is not None and res.msa.many == len(members)


def test_refgs_cli(tmp_path, family):
    g, members = family
    fam = tmp_path / "fam.fa"
    lines = []
    for r in members:
        lines.append(f">{r.name}")
        if r.exons:
            lines.append(";C join(" + ",".join(
                f"{a}..{b}" for a, b in r.exons) + ")")
        lines.append(r.seq)
    fam.write_text("\n".join(lines) + "\n")
    gen = tmp_path / "gen.fa"
    gen.write_text(">win\n" + g + "\n")
    out = tmp_path / "out.fa"
    from prrn_aln_tpu.cli import refgs_main
    rc = refgs_main(["-n", str(gen), "-m", "ce13a1", "-I", "1",
                     "-t", str(out), "-pq", str(fam)])
    assert rc == 0
    text = out.read_text()
    assert ";C join(66..251,307..651)" in text
