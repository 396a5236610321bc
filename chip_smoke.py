#!/usr/bin/env python3
"""Smoke test of the system on the GPU.

    python chip_smoke.py          # one GPU: main paths and engines
    python chip_smoke.py --four   # four GPUs: sharded paths vs one card

One process drives everything.  The one-GPU run

* names the device: the card's name and power limit (``nvidia-smi``, a
  child process that never imports JAX), ``device_kind``, the JAX
  version, ``XLA_FLAGS`` and the compilation cache directory;
* runs the main paths through the CLI entry points, each cold and then
  warm (output of the two must be identical): ``prrn`` on the 7-protein
  ce13a17 family against the reference golden rows, ``prrn`` on the
  19-protein fam19 (sl-forest route) against the reference golden's
  objective, ``aln -yl2`` on the 2.3 kb CET10B9 window against the
  reference exon structure and score, and ``aln -G`` against the
  reference output bytes;
* runs every device engine at real widths against its NumPy oracle:
  the distance wavefront (512 pairs of 512 x 512, sh=-60), the group DP
  (32 pairs of 8 members x 384 columns), spliced fwd2h (the window x
  ce13a1) and spliced fwd2s (gen1 x cdna1), printing compile and warm
  seconds, scan steps and microseconds per step, the step's
  ``memory_analysis()`` and the device's peak bytes in use.

Scores must agree with the float64 oracles to 1e-3 * max(1, |s|).  Paths
must be identical; where an f32 tie flips, both paths are re-scored
under the oracle's model and must be equally optimal, and the case is
printed as a DEVIATION.

``--four`` runs only the all-pairs distance pass and group_align_batch
sharded over a flat 4-card "pairs" mesh, and checks that each card holds
a shard and that the scores equal the one-card scores.

Each phase prints one ``phase <name>: PASS|FAIL {...}`` line.  The last
line, printed only when JAX runs on a GPU and every phase passed, is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``;
otherwise the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import io as _io
import json
import os
import re
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"
REF_FAM19 = (-30917.6, 8637.4)   # reference golden's (SP, tree-WSP)
TOL = 1e-3                 # |ds| <= TOL * max(1, |s|) vs the f64 oracle


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= TOL * max(1.0, abs(want))


def _peak_bytes():
    import jax
    st = jax.devices()[0].memory_stats()
    return None if st is None else st.get("peak_bytes_in_use")


def _mem(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys}


def _time_compiled(jitted, args, kwargs, reps=3):
    """Compile ``jitted`` for ``args``; returns (compiled, compile_s,
    warm_s, output) with warm_s the median of ``reps`` timed calls."""
    import jax
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kwargs).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compiled, compile_s, float(np.median(times)), out


def _time_warm(call, reps=2):
    """(median seconds, output) of ``reps`` already-compiled calls."""
    import jax
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(call())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _engine_report(compiled, compile_s, warm_s, steps) -> dict:
    return {"compile_s": compile_s, "warm_s": warm_s, "steps": steps,
            "us_per_step": warm_s / steps * 1e6, "memory": _mem(compiled),
            "peak_bytes_in_use": _peak_bytes()}


def _deviation(what: str, **info):
    print(f"DEVIATION {what}: " + json.dumps(info, default=str), flush=True)


# ---------------------------------------------------------------- device

def device_record() -> dict:
    """Exits the process (non-zero, no result line) unless JAX runs on a
    GPU."""
    from prrn_aln_tpu import devinfo
    try:
        return devinfo.require_gpu()
    except devinfo.NoGPUError as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        raise SystemExit(2)


def phase_device() -> dict:
    import jax
    from prrn_aln_tpu import devinfo
    print(devinfo.card_name_and_power(), flush=True)
    return {"device_kind": jax.devices()[0].device_kind,
            "jax": jax.__version__,
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "compilation_cache_dir": jax.config.jax_compilation_cache_dir}


# ------------------------------------------------------- CLI main paths

def _cli_twice(main, argv_of, tmp: Path, tag: str):
    """Run a CLI main cold then warm, each writing its own output file;
    returns (text, cold_s, warm_s).  Outputs must be identical."""
    texts, secs = [], []
    for k in ("cold", "warm"):
        out = tmp / f"{tag}_{k}.txt"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_io.StringIO()):
            rc = main(argv_of(out))
        secs.append(time.perf_counter() - t0)
        assert rc == 0, f"{tag} {k} exit code {rc}"
        texts.append(out.read_text())
    assert texts[0] == texts[1], f"{tag}: cold and warm outputs differ"
    return texts[1], secs[0], secs[1]


def _read_msa(path: Path):
    from prrn_aln_tpu import io, alphabet as ab
    recs = io.sniff_and_read(path)
    return io.records_to_msa(recs, ab.infer_molc(recs[0].seq))


def golden_rows(path: Path) -> dict:
    """name -> aligned row of a reference native block output."""
    rows: dict = {}
    for line in path.read_text().splitlines():
        mt = re.match(r"\s*\d+ (.{1,61})\| (\S+)", line)
        if mt:
            rows.setdefault(mt.group(2), []).append(mt.group(1).rstrip())
    return {k: "".join(v) for k, v in rows.items()}


def _pairwt(msa):
    from prrn_aln_tpu.msa import distance, tree
    d = distance.msa_distance_matrix(msa.codes)
    pairwt, _ = tree.calc_pair_weights(tree.upgma(d, msa.many))
    return pairwt


def check_ce13a17(msa, golden: Path = FIX / "golden_prrn_default7.txt"):
    """Rows vs the reference golden: same members and order, > 98% of
    the golden's aligned residue pairs, and a WSP at least the golden's
    under one weighting; rows that differ are printed as deviations."""
    from prrn_aln_tpu import io, scoring, alphabet as ab
    from prrn_aln_tpu.config import AlnParams
    from prrn_aln_tpu.msa import wsp
    from prrn_aln_tpu.msa.msa import msa_from_strings
    gold = golden_rows(golden)
    assert list(gold) == msa.names, (list(gold), msa.names)
    mine = {n: io.decode_row(msa, i) for i, n in enumerate(msa.names)}

    def cols(row):
        return [c for c, ch in enumerate(row) if ch not in "-."]
    agree = total = 0
    for x, a in enumerate(msa.names):
        for b in msa.names[x + 1:]:
            gb = {c: k for k, c in enumerate(cols(gold[b]))}
            mb = {c: k for k, c in enumerate(cols(mine[b]))}
            gp = {(k, gb[c]) for k, c in enumerate(cols(gold[a])) if c in gb}
            mp = {(k, mb[c]) for k, c in enumerate(cols(mine[a])) if c in mb}
            agree += len(gp & mp)
            total += len(gp)
    ident = agree / total
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    gmsa = msa_from_strings([gold[n] for n in msa.names], ab.PROTEIN,
                            msa.names)
    pairwt = _pairwt(gmsa)
    my_wsp = wsp.wsp_score(msa, mtx, v=9.0, pairwt=pairwt)
    ref_wsp = wsp.wsp_score(gmsa, mtx, v=9.0, pairwt=pairwt)
    exact = sum(mine[n] == gold[n] for n in msa.names)
    if exact < msa.many:
        _deviation("prrn ce13a17 rows", exact=exact, rows=msa.many,
                   wsp=my_wsp, golden_wsp=ref_wsp)
    assert ident > 0.98, f"column identity {ident}"
    assert my_wsp >= ref_wsp - max(2.0, 2e-4 * abs(ref_wsp)), \
        (my_wsp, ref_wsp)
    return {"exact_rows": exact, "rows": msa.many, "identity": ident,
            "wsp": my_wsp, "golden_wsp": ref_wsp}


def check_fam19(msa):
    """SP and tree-WSP at least the reference golden's (the sl-forest
    route's parity is at the objective level)."""
    from prrn_aln_tpu import scoring
    from prrn_aln_tpu.config import default_params
    from prrn_aln_tpu.msa import wsp
    assert msa.many == 19
    mtx, _ = scoring.build_matrix(msa.molc,
                                  default_params(msa.molc, "prrn"))
    sp = wsp.wsp_score(msa, mtx, v=9.0)
    wv = wsp.wsp_score(msa, mtx, v=9.0, pairwt=_pairwt(msa))
    assert sp >= REF_FAM19[0] - 0.5 and wv >= REF_FAM19[1] - 0.5, \
        (sp, wv, REF_FAM19)
    return {"cols": msa.length, "sp": sp, "tree_wsp": wv,
            "golden_sp": REF_FAM19[0], "golden_tree_wsp": REF_FAM19[1]}


def phase_prrn(fasta: Path, check, tmp: Path) -> dict:
    from prrn_aln_tpu.cli import prrn_main
    _, cold, warm = _cli_twice(
        prrn_main, lambda out: ["-o", str(out), str(fasta)], tmp,
        f"prrn_{fasta.stem}")
    res = check(_read_msa(tmp / f"prrn_{fasta.stem}_warm.txt"))
    return {"cold_s": cold, "warm_s": warm, "compile_s": cold - warm,
            **res}


def _exons_and_score(text: str):
    m = re.search(r"join\(([^)]+)\)", text.replace("\n;C ", ""))
    exons = [tuple(map(int, p.split("..")))
             for p in m.group(1).replace(" ", "").split(",")]
    s = re.search(r"Score = +([-\d.]+)", text)
    return exons, float(s.group(1))


def phase_aln_yl2(genome: Path, protein: Path, golden: Path,
                  tmp: Path) -> dict:
    """aln -yl2 (genome x protein, Algorithm H) vs the reference's exon
    structure and reported score."""
    from prrn_aln_tpu.cli import aln_main
    text, cold, warm = _cli_twice(
        aln_main, lambda out: ["-yl2", "-o", str(out), str(genome),
                               str(protein)], tmp, "aln_yl2")
    exons, score = _exons_and_score(text)
    g_exons, g_score = _exons_and_score(golden.read_text())
    assert exons == g_exons, (exons, g_exons)
    assert abs(score - g_score) <= 0.1, (score, g_score)
    return {"cold_s": cold, "warm_s": warm, "compile_s": cold - warm,
            "exons": len(exons), "score": score, "golden_score": g_score}


def phase_aln_G(genome: Path, cdna: Path, golden: Path, tmp: Path) -> dict:
    """aln -G (cDNA x genome, fwd2s) vs the reference output bytes."""
    from prrn_aln_tpu.cli import aln_main
    text, cold, warm = _cli_twice(
        aln_main, lambda out: ["-G", "-o", str(out), str(genome),
                               str(cdna)], tmp, "aln_G")
    assert text == golden.read_text(), "aln -G output differs from golden"
    return {"cold_s": cold, "warm_s": warm, "compile_s": cold - warm,
            "bytes": len(text)}


# ------------------------------------------------- engines vs oracles

def phase_wavefront(B: int = 512, L: int = 512, nsample: int = 8,
                    seed: int = 7) -> dict:
    """Distance wavefront (ops/pairwise) vs ops/pairwise_np."""
    import jax
    from prrn_aln_tpu import scoring
    from prrn_aln_tpu.config import AlnParams
    from prrn_aln_tpu.ops.pairwise import wavefront_scores
    from prrn_aln_tpu.ops.pairwise_np import pairwise_score_np
    from prrn_aln_tpu.ops.window import stripe

    rng = np.random.default_rng(seed)
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    w = stripe(L, L, -60)
    a = rng.integers(3, 23, size=(B, L)).astype(np.int32)
    b = rng.integers(3, 23, size=(B, L)).astype(np.int32)
    args = [jax.device_put(x) for x in (
        a, b, np.full(B, L, np.int32), np.full(B, L, np.int32),
        np.full(B, w.lw, np.int32), np.full(B, w.up, np.int32), mtx,
        np.full(B, 2.0, np.float32), np.full(B, 9.0, np.float32),
        np.ones(B, np.float32), np.zeros((B, 4), bool))]
    steps = 2 * L - 1
    compiled, cs, ws, out = _time_compiled(
        wavefront_scores, args, dict(nslot=w.width, nsteps=steps,
                                     dim=mtx.shape[0], local=False))
    got = np.asarray(out)
    sample = np.linspace(0, B - 1, nsample).astype(int)
    for k in sample:
        want = pairwise_score_np(a[k], b[k], mtx, 2.0, 9.0, w)
        assert _close(float(got[k]), want), (int(k), float(got[k]), want)
    return {"pairs": B, "checked": len(sample),
            **_engine_report(compiled, cs, ws, steps)}


def _rand_group(rng, many, L, mtx):
    from prrn_aln_tpu import alphabet as ab
    from prrn_aln_tpu.msa.msa import Msa
    codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
    codes[rng.random((many, L)) < 0.05] = ab.GAP
    codes[:, 0] = ab.ALA
    m = Msa(codes=codes, molc=ab.PROTEIN,
            names=[f"s{i}" for i in range(many)])
    m.prepare(mtx.shape[0])
    return m


def phase_group(npairs: int = 32, members: int = 8, L: int = 384,
                nsample: int = 2, seed: int = 3) -> dict:
    """Group DP (group_align_batch: scan fill + device traceback) vs
    ops/group_np."""
    import jax.numpy as jnp
    from prrn_aln_tpu import scoring
    from prrn_aln_tpu.config import AlnParams
    from prrn_aln_tpu.ops import group as gops
    from prrn_aln_tpu.ops.group_np import group_align_np
    from prrn_aln_tpu.ops.path_score import score_path
    from prrn_aln_tpu.ops.window import stripe

    rng = np.random.default_rng(seed)
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    pairs = [(_rand_group(rng, members, L, mtx),
              _rand_group(rng, members, L, mtx)) for _ in range(npairs)]
    sh, pads = -60, (members, L)

    # the DP fill alone, as group_align_batch packs it
    wdws = [stripe(A.length, B.length, sh) for A, B in pairs]
    la_max = gops._bucket(L)
    nslot = gops._bucket(max(w.up - w.lw + 3 for w in wdws), 128)
    nsteps = gops._bucket(max(A.length + B.length + 1
                              for A, B in pairs), 256)
    an = max([members] + [gops.effective_members(m)
                          for ab_ in pairs for m in ab_])
    ins = [gops._pack_inputs(A, B, mtx, 2.0, 9.0, w, an, la_max, la_max)
           for (A, B), w in zip(pairs, wdws)]
    batched = [jnp.stack([x[k] for x in ins]) for k in range(len(ins[0]))]
    fill = gops._batch_fn(nslot, nsteps, an, an, la_max, la_max)
    compiled, cs, ws, _ = _time_compiled(fill, batched, {})

    t0 = time.perf_counter()
    res = gops.group_align_batch(pairs, mtx, u=2.0, v=9.0, sh=sh, pads=pads)
    batch_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = gops.group_align_batch(pairs, mtx, u=2.0, v=9.0, sh=sh, pads=pads)
    batch_warm = time.perf_counter() - t0

    flips = 0
    for k in np.linspace(0, npairs - 1, nsample).astype(int):
        A, B = pairs[k]
        w = stripe(A.length, B.length, sh)
        s_np, k_np = group_align_np(A, B, mtx, u=2.0, v=9.0, wdw=w)
        s_dv, k_dv = res[k]
        assert _close(s_dv, s_np), (int(k), s_dv, s_np)
        if k_dv != k_np:
            mine = score_path(A, B, mtx, k_dv, u=2.0, v=9.0)
            ref = score_path(A, B, mtx, k_np, u=2.0, v=9.0)
            assert _close(mine, ref), (int(k), mine, ref)
            flips += 1
            _deviation("group path tie", pair=int(k), score=mine,
                       oracle_score=ref)
    return {"pairs": npairs, "members": members, "cols": L,
            "checked": nsample, "tie_flips": flips,
            "batch_cold_s": batch_cold, "batch_warm_s": batch_warm,
            **_engine_report(compiled, cs, ws, nsteps)}


def _qprof(protein: str):
    from prrn_aln_tpu import scoring, alphabet as ab
    from prrn_aln_tpu.config import default_params
    from prrn_aln_tpu.splice import tron
    pm, _ = scoring.build_matrix(ab.PROTEIN,
                                 default_params(ab.PROTEIN, "aln"))
    tm = tron.tron_matrix(pm, u=2.0, o=30.0)
    a = ab.encode(protein, ab.PROTEIN)
    qprof = np.zeros((len(a) + 2, tron.TSIMD))
    qprof[1:len(a) + 1] = tm[a]
    qprof[len(a) + 1] = qprof[len(a)]
    return qprof


@contextlib.contextmanager
def _capture(module, name: str, store: dict):
    """Record the arguments of the next calls of ``module.name``."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        store["args"], store["kwargs"] = args, kwargs
        return orig(*args, **kwargs)
    setattr(module, name, rec)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def phase_fwd2h(genome: str, protein: str) -> dict:
    """Spliced fwd2h (forward_h_device: wave-sweep scan + host lastH and
    walk) vs spliced_h_np.forward_h, plus the sweep alone and the fetch
    of its event plane."""
    import jax
    from prrn_aln_tpu import alphabet as ab
    from prrn_aln_tpu.ops import spliced_h_jax as shj
    from prrn_aln_tpu.ops.spliced_h_np import forward_h, HParams
    from prrn_aln_tpu.splice.exin import build_exin
    from prrn_aln_tpu.splice.penalty import IntronPenalty

    b = ab.encode(genome, ab.DNA)
    qprof = _qprof(protein)
    M, N = qprof.shape[0] - 2, len(b)
    ex = build_exin(b)
    ipen = IntronPenalty.build(f=1.0, y=8.0, sss=0.5, u=2.0, v=9.0,
                               ip=15.0, fact=8.0)
    shld = 3 * (50 * min(M, N) // 100)
    lw, up = -shld, min(N - 3 * M + shld, N)
    t0 = time.perf_counter()
    s_np, k_np = forward_h(qprof, b, ex, ipen, HParams(), lw, up)
    oracle_s = time.perf_counter() - t0

    cap: dict = {}
    with _capture(shj, "_sweep_h", cap) as sweep:
        t0 = time.perf_counter()
        s_dv, k_dv = shj.forward_h_device(qprof, b, ex, ipen, HParams(),
                                          lw, up)
        cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    shj.forward_h_device(qprof, b, ex, ipen, HParams(), lw, up)
    warm = time.perf_counter() - t0
    assert _close(s_dv, s_np), (s_dv, s_np)
    assert k_dv == k_np, "fwd2h knots differ from the oracle"

    # the sweep alone, as forward_h_device called it (its first call
    # compiled it: compile_s is the cold - warm end-to-end difference)
    args, kwargs = cap["args"], cap["kwargs"]
    warm_s, out = _time_warm(lambda: sweep(*args, **kwargs))
    evw = out[2]
    t0 = time.perf_counter()
    ev_host = np.asarray(evw)
    fetch_s = time.perf_counter() - t0
    compiled = sweep.lower(*args, **kwargs).compile()
    return {"M": M, "N": N, "band": up - lw + 1, "score": s_dv,
            "oracle_s": oracle_s, "e2e_cold_s": cold, "e2e_warm_s": warm,
            "event_plane_bytes": int(ev_host.nbytes),
            "event_plane_fetch_s": fetch_s,
            **_engine_report(compiled, cold - warm, warm_s,
                             int(evw.shape[0]))}


def phase_fwd2s(genome: str, cdna: str) -> dict:
    """Spliced fwd2s (spliced_align_device) vs spliced_np.spliced_align_np
    on the aln -G configuration."""
    import jax
    from prrn_aln_tpu import alphabet as ab, scoring
    from prrn_aln_tpu.config import default_params
    from prrn_aln_tpu.ops import spliced_jax as sj
    from prrn_aln_tpu.ops.spliced_np import spliced_align_np
    from prrn_aln_tpu.ops.window import stripe
    from prrn_aln_tpu.splice.api import ALN_DEF_SH
    from prrn_aln_tpu.splice.penalty import IntronPenalty
    from prrn_aln_tpu.splice.signals import SpliceSignals

    prm = default_params(ab.DNA, "aln")
    mtx, _ = scoring.dna_matrix(prm)
    bg = ab.encode(genome.upper(), ab.DNA)
    ac = ab.encode(cdna.upper(), ab.DNA)
    sig = SpliceSignals.build(bg)
    ipen = IntronPenalty.build(u=prm.u, v=prm.v)
    w = stripe(len(ac), len(bg), ALN_DEF_SH)
    kw = dict(u=prm.u, v=prm.v, lw=w.lw, up=w.up)
    s_np, k_np = spliced_align_np(ac, bg, sig, ipen, mtx, **kw)
    cap: dict = {}
    with _capture(sj, "_sweep", cap) as sweep:
        t0 = time.perf_counter()
        s_dv, k_dv = sj.spliced_align_device(ac, bg, sig, ipen, mtx, **kw)
        cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    sj.spliced_align_device(ac, bg, sig, ipen, mtx, **kw)
    warm = time.perf_counter() - t0
    assert _close(s_dv, s_np), (s_dv, s_np)
    assert k_dv == k_np, "fwd2s path differs from the oracle"

    args = cap["args"]
    warm_s, _ = _time_warm(lambda: sweep(*args))
    compiled = sweep.lower(*args).compile()
    W = w.up - w.lw + 1
    rows = len(ac) + 1
    # one scan step per (row, band slot): an outer scan over rows of
    # inner scans over slots
    rep = _engine_report(compiled, cold - warm, warm_s, rows * W)
    return {"rows": rows, "band": W, "score": s_dv, "e2e_cold_s": cold,
            "e2e_warm_s": warm, **rep}


# ------------------------------------------------------------ four cards

def phase_four(nseq: int = 32, L: int = 512, npairs: int = 32,
               members: int = 8, gL: int = 384, seed: int = 5) -> dict:
    """Sharded distance pass and group_align_batch over a flat "pairs"
    mesh of every device vs the same calls on one device."""
    import jax
    from jax.sharding import Mesh
    from prrn_aln_tpu import scoring
    from prrn_aln_tpu.config import AlnParams
    from prrn_aln_tpu.msa import distance
    from prrn_aln_tpu.ops import group as gops

    devs = jax.devices()
    mesh = Mesh(np.array(devs), axis_names=("pairs",))
    rng = np.random.default_rng(seed)
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    seqs = [rng.integers(3, 23, size=int(rng.integers(L // 2, L + 1)))
            .astype(np.int32) for _ in range(nseq)]

    one = distance.all_pairs_scores(seqs, mtx, 2.0, 9.0, -60)
    t0 = time.perf_counter()
    many = distance.all_pairs_scores(seqs, mtx, 2.0, 9.0, -60, mesh=mesh)
    dist_s = time.perf_counter() - t0
    assert np.array_equal(one, many), float(np.abs(one - many).max())
    pairs = [(i, j) for j in range(1, nseq) for i in range(j)]
    batched, kw = distance.pack_pairs(seqs, pairs, 2.0, 9.0, -60)
    out = distance.sharded_scores(mesh, batched, mtx, kw)
    held = {s.device for s in out.addressable_shards if s.data.size}
    assert len(held) == len(devs), f"distance shards on {len(held)} cards"

    gpairs = [(_rand_group(rng, members, gL, mtx),
               _rand_group(rng, members, gL, mtx)) for _ in range(npairs)]
    one_g = gops.group_align_batch(gpairs, mtx, u=2.0, v=9.0, sh=-60,
                                   pads=(members, gL))
    t0 = time.perf_counter()
    many_g = gops.group_align_batch(gpairs, mtx, u=2.0, v=9.0, sh=-60,
                                    pads=(members, gL), mesh=mesh)
    group_s = time.perf_counter() - t0
    assert [s for s, _ in one_g] == [s for s, _ in many_g], "group scores"
    assert [k for _, k in one_g] == [k for _, k in many_g], "group paths"
    gheld = gops.LAST_BATCH_SHARDING.device_set
    assert len(gheld) == len(devs), f"group shards on {len(gheld)} cards"
    return {"cards": len(devs), "distance_pairs": len(pairs),
            "distance_sharded_s": dist_s, "group_pairs": npairs,
            "group_sharded_s": group_s,
            "peak_bytes_in_use": _peak_bytes()}


# ------------------------------------------------------------------ main

def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:               # report every phase, then fail
            ok = False
            traceback.print_exc()
            print(f"phase {name}: FAIL {type(e).__name__}: {e}",
                  flush=True)
            continue
        res["phase_s"] = time.perf_counter() - t0
        print(f"phase {name}: PASS " + json.dumps(res, default=str),
              flush=True)
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    dev = device_record()
    from prrn_aln_tpu import io
    if four:
        ok = run_phases([("device", phase_device),
                         ("four_cards", phase_four)])
    else:
        win = io.sniff_and_read(FIX / "cet10b9_win31401.fa")[0].seq.upper()
        ce13a1 = io.sniff_and_read(FIX / "ce13a1_unaligned.fa")[0].seq
        gen1 = io.sniff_and_read(FIX / "gen1.fa")[0].seq
        cdna1 = io.sniff_and_read(FIX / "cdna1.fa")[0].seq
        with tempfile.TemporaryDirectory() as d:
            tmp = Path(d)
            ok = run_phases([
                ("device", phase_device),
                ("prrn_ce13a17", lambda: phase_prrn(
                    FIX / "ce13a17_clean.fa", check_ce13a17, tmp)),
                ("prrn_fam19", lambda: phase_prrn(
                    FIX / "fam19.fa", check_fam19, tmp)),
                ("aln_yl2_window", lambda: phase_aln_yl2(
                    FIX / "cet10b9_win31401.fa", FIX / "ce13a1_unaligned.fa",
                    FIX / "golden_aln_yl2_win_single.txt", tmp)),
                ("aln_G_gen1", lambda: phase_aln_G(
                    FIX / "gen1.fa", FIX / "cdna1.fa",
                    FIX / "aln_G_gen1_default.txt", tmp)),
                ("engine_wavefront", phase_wavefront),
                ("engine_group", phase_group),
                ("engine_fwd2h", lambda: phase_fwd2h(win, ce13a1)),
                ("engine_fwd2s", lambda: phase_fwd2s(gen1, cdna1)),
            ])
    if not ok:
        print("FAIL: a phase failed", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
