"""chip_smoke.py on the CPU: its device check refuses to run, and each
phase function passes at a tiny size (the real widths run on the GPU)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

FIX = ROOT / "tests" / "fixtures"


def test_device_check_fails_on_cpu():
    with pytest.raises(SystemExit) as e:
        cs.device_record()
    assert e.value.code != 0


def test_script_exits_nonzero_without_gpu(tmp_path):
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=600,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_run_phases_reports_failure(capsys):
    def boom():
        raise AssertionError("mismatch")
    assert not cs.run_phases([("good", lambda: {}), ("bad", boom)])
    out = capsys.readouterr().out
    assert "phase good: PASS" in out and "phase bad: FAIL" in out


def test_check_ce13a17_accepts_golden():
    msa = cs._read_msa(FIX / "golden_prrn_default7.txt")
    res = cs.check_ce13a17(msa)
    assert res["exact_rows"] == res["rows"] == 7
    assert res["wsp"] == pytest.approx(res["golden_wsp"])


def test_check_fam19_accepts_golden():
    res = cs.check_fam19(cs._read_msa(FIX / "golden_prrn_fam19.txt"))
    assert res["cols"] == 551


def test_phase_prrn_tiny(tmp_path):
    fa = tmp_path / "tiny.fa"
    fa.write_text(">a\nMKVLAAGFDDEERRKKLL\n>b\nMKVLAAGFDEEERRKQLL\n"
                  ">c\nMKVLAGGFDDEERRKKLL\n")
    res = cs.phase_prrn(fa, lambda m: {"rows": m.many}, tmp_path)
    assert res["rows"] == 3 and res["warm_s"] > 0


def test_phase_wavefront_tiny():
    res = cs.phase_wavefront(B=4, L=40, nsample=2)
    assert res["steps"] == 79 and res["checked"] == 2


def test_phase_group_tiny():
    res = cs.phase_group(npairs=2, members=2, L=40, nsample=1)
    assert res["checked"] == 1 and res["steps"] >= 81


def test_phase_fwd2h_tiny(cet10b9, ce13a1):
    res = cs.phase_fwd2h(cet10b9(31614, 31800), ce13a1[:60])
    assert res["M"] == 60 and res["N"] == 186
    assert res["event_plane_bytes"] > 0


def test_phase_fwd2s_tiny():
    rng = np.random.default_rng(0)
    exons = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(2)]
    intron = "GT" + "".join(rng.choice(list("ACGT"), 60)) + "AG"
    res = cs.phase_fwd2s(exons[0] + intron + exons[1], "".join(exons))
    assert res["rows"] == 81


def test_phase_four_on_virtual_devices():
    res = cs.phase_four(nseq=6, L=40, npairs=3, members=2, gL=30)
    assert res["cards"] >= 2 and res["distance_pairs"] == 15
