"""Full-size sample/test.sh spliced case vs the checked-in reference
golden (aln -yl2 -L nas/CET10B9 pas/ce13a.msa).

The full case is 34.9 kb x 526 aa with a ~35k-wide codon band (~19M DP
cells); the oracle needs ~10 min and the device kernel a few minutes on
CPU, so the end-to-end assertion is gated behind PRRN_FULL=1.  The
golden's exon table is
parsed and asserted unconditionally so the expected structure is pinned
in-repo.
"""

import os
import re
from pathlib import Path

import pytest

FIX = Path(__file__).parent / "fixtures"
GOLDEN = FIX / "golden_aln_yl2_full.txt"

# reference exon coordinates from the golden's ;C join(...) line
EXONS = [(31615, 31800), (31856, 32187), (32242, 32341),
         (32389, 32945), (33016, 33159), (33205, 33439)]


def _golden_exons():
    text = GOLDEN.read_text().replace("\n;C ", "")
    m = re.search(r"join\(([^)]+)\)", text)
    return [tuple(map(int, p.split("..")))
            for p in m.group(1).replace(" ", "").split(",")]


def test_golden_fixture_pins_structure():
    assert _golden_exons() == EXONS
    text = GOLDEN.read_text()
    assert "Score = 14013.7" in text


@pytest.mark.skipif(os.environ.get("PRRN_FULL") != "1",
                    reason="full-size case (set PRRN_FULL=1); ~19M-cell "
                           "codon band DP")
def test_full_case_matches_reference_structure():
    from prrn_aln_tpu import io, alphabet as ab
    from prrn_aln_tpu.splice.hapi import spliced_align_h
    g = io.sniff_and_read("/root/reference/sample/nas/CET10B9")[0] \
        .seq.upper()
    q = io.sniff_and_read("/root/reference/sample/pas/ce13a.msa")
    msa = io.records_to_msa(q, ab.PROTEIN)
    res = spliced_align_h(g, None, gname="CET10B9", qname=q[0].name,
                          msa=msa)
    assert res.exons == EXONS
