"""k-mer composition machinery: reduced alphabets, spaced seeds, and the
qdiv composition divergence.

Reference semantics: src/bitpat.{h,cc} (ReducWord / Bitpat word streams,
SEB reduced-alphabet series), src/qdiv.cc (Kcomp counts and the qdiv
similarity with its calibrated log transform).  Used as the selectivity
filter for the sparse distance graph of the sl-forest scale-out path —
exactness requirements are soft (SURVEY A.8): it decides which edges get
DP-scored, not the scores themselves.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import alphabet as ab

# SEB reduced-alphabet series (bitpat.cc DefConvPat); '|' separates classes
SEB_PATTERNS = {
    6: "ASJT|CP|DEHKNQR|FWY|G|ILMV|X|U",
    18: "A|C|DE|Q|F|Y|G|H|IV|K|R|L|M|N|P|SJ|T|W|X|U",
    20: "A|R|N|D|C|Q|E|G|H|I|L|K|M|F|P|SJ|T|W|Y|V|X|U",
}
FOURN_PATTERN = "A|C|G|TU|BDHKMNRSJVWXY"

# sltree defaults (sltree.cc:272-281)
PROT_K = 4
PROT_ALPHA = 18
PROT_SEEDS = ("11101", "11011")
DNA_K = 8
DNA_SEEDS = ("110011101", "11101011")


def reduced_table(molc: int, nalpha: int = 0) -> tuple[np.ndarray, int]:
    """Residue-code -> reduced-class table; unmapped entries = -1."""
    if molc == ab.PROTEIN:
        pat = SEB_PATTERNS[nalpha or PROT_ALPHA]
    else:
        pat = FOURN_PATTERN
    cls_of_letter = {}
    cls = 0
    for chunk in pat.split("|"):
        for ch in chunk:
            cls_of_letter[ch] = cls
        cls += 1
    tab = np.full(32, -1, np.int32)
    if molc == ab.PROTEIN:
        decode = ab.AMINO_DECODE
        for code in range(ab.ALA, ab.ASIMD):
            ch = decode[code] if code < len(decode) else "?"
            if ch in cls_of_letter:
                tab[code] = cls_of_letter[ch]
        # X and U merge into one trailing class (ReducWord, bitpat.cc:88)
        tab[tab == cls - 1] = cls - 2
        n_classes = cls - 1
    else:
        decode = ab.NUCL_DECODE
        for code in range(2, ab.NSIMD):
            ch = decode[code]
            if ch in cls_of_letter:
                tab[code] = cls_of_letter[ch]
        # the catch-all (ambiguity) class breaks words
        tab[tab == cls - 1] = -1
        n_classes = cls - 1
    return tab, n_classes


@dataclasses.dataclass
class KmerCounts:
    counts: list      # per-seed dense count arrays (int32)
    total: int        # total counted words
    many: int = 1


def count_kmers(codes: np.ndarray, molc: int, k: int | None = None,
                seeds: tuple[str, ...] | None = None,
                nalpha: int = 0) -> KmerCounts:
    """Spaced-seed word counts of one sequence (gaps break windows).
    Counting runs in the native host library when available."""
    from .. import native
    if k is None:
        k = PROT_K if molc == ab.PROTEIN else DNA_K
    if seeds is None:
        seeds = PROT_SEEDS if molc == ab.PROTEIN else DNA_SEEDS
        if not seeds:
            seeds = ("1" * k,)
    tab, nalpha_eff = reduced_table(molc, nalpha)
    red = tab[np.clip(codes, 0, 31)].astype(np.int8)
    counts = []
    total = 0
    for seed in seeds:
        c, t = native.kmer_count(red, seed, nalpha_eff)
        counts.append(c)
        total += t
    return KmerCounts(counts=counts, total=total)


# calibrated log-transform parameters (qdiv.cc:185-191)
_QDIV_PARAM = {0: (0.92042, 0.18677), 1: (0.34576, 0.07108),
               2: (0.22333, 0.03164), 3: (0.18704, 0.00501)}


def qdiv(a: KmerCounts, b: KmerCounts, molc: int,
         pam_corrected: bool = True) -> float:
    """Composition divergence (qdiv.cc:179-230), in [0, ~1]."""
    from .. import native
    s = 0
    for ca, cb in zip(a.counts, b.counts):
        s += native.kmer_min_overlap(ca, cb, a.many, b.many)
    if a.total and b.total:
        denom = min(a.total / a.many, b.total / b.many) * a.many * b.many
        f = s / denom
    else:
        f = 0.0
    d = 1.0 - f
    if not pam_corrected:
        return d
    p0, p1 = _QDIV_PARAM[3]
    f2 = p0 * math.log((p1 + f) / (p1 + 1.0)) + 1.0
    d2 = 1.0 - f2
    if molc == ab.PROTEIN:
        # Qpamd with default corr_mhits=0: pamcorrect is linear (100*x)
        return max(d2, 0.0)
    return _jukes_cantor(d2)


def _jukes_cantor(nid: float) -> float:
    if nid <= 0.0:
        return 0.0
    x = 1.0 - 20.0 / 19.0 * nid
    if x <= 0.0:
        return 1024.0
    return -19.0 / 20.0 * math.log(x)


def _pamcorrect(x: float) -> float:
    """divseq.cc pamcorrect via dvp2pam interpolation (simmtx.cc:68-78)."""
    if x >= 1.0:
        return 300.0
    if x <= 0.7:
        y = 1.0 - (0.987151 + 0.220560 * x) * x
    else:
        y = -1.260444 + (8.603930 - (13.869219 - 6.521836 * x) * x) * x
    if y <= 0.0:
        return 300.0
    pam = -100.0 * math.log(y)
    return min(pam, 300.0)


def _word_lists(seq_codes, molc: int, k=None, seeds=None, nalpha: int = 0):
    """Per-sequence spaced-seed word lists (same window/validity rules
    as native.kmer_count / bitpat.h WordTab) + the alphabet size."""
    if k is None:
        k = PROT_K if molc == ab.PROTEIN else DNA_K
    if seeds is None:
        seeds = PROT_SEEDS if molc == ab.PROTEIN else DNA_SEEDS
        if not seeds:
            seeds = ("1" * k,)
    tab, na = reduced_table(molc, nalpha)
    per_seed = []
    for seed in seeds:
        pos = [j for j, ch in enumerate(seed) if ch == "1"]
        width = len(seed)
        rows = []
        for codes in seq_codes:
            red = tab[np.clip(codes, 0, 31)].astype(np.int64)
            nwin = len(red) - width + 1
            if nwin <= 0:
                rows.append(np.empty(0, np.int64))
                continue
            w = np.zeros(nwin, np.int64)
            ok = np.ones(nwin, bool)
            for j in pos:
                c = red[j:j + nwin]
                ok &= c >= 0
                w = w * na + np.where(c < 0, 0, c)
            rows.append(w[ok])
        V = int(na) ** len(pos)
        per_seed.append((rows, V))
    return per_seed


def _device_overlap(per_seed, n: int) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs min-overlap matrix as device matmuls.

    min(a, b) = sum_t [a>=t][b>=t], so the pair overlap matrix is a sum
    of 0/1 indicator Gram matmuls — exact in bf16 x bf16 -> f32
    (products are 0/1, sums < 2^24).  Replaces the O(N^2) host loop
    (the sl-forest edge pass, reference role src/blksrc.cc:3260)."""
    import jax
    import jax.numpy as jnp
    O = np.zeros((n, n), np.float64)
    totals = np.zeros(n, np.int64)
    for rows, V in per_seed:
        lens = np.array([len(r) for r in rows])
        totals += lens
        Lp = max(1, int(lens.max()))
        W = np.full((n, Lp), V, np.int64)       # V = out-of-range pad
        for i, r in enumerate(rows):
            W[i, :len(r)] = r
        tmax = 1
        counts = []
        for r in rows:
            if len(r):
                counts.append(np.unique(r, return_counts=True))
                tmax = max(tmax, int(counts[-1][1].max()))
            else:
                counts.append((np.empty(0, np.int64),
                               np.empty(0, np.int64)))
        # repetitive/low-complexity sequences can make tmax ~ sequence
        # length; cap the matmul levels and add the (rare) residual
        # overlap min(ci, cj) - TCAP for high-multiplicity words on
        # host (ADVICE r4)
        TCAP = 16
        Wd = jnp.asarray(W, jnp.int32)
        C = jnp.zeros((n, V), jnp.int32).at[
            jnp.arange(n)[:, None], Wd].add(1, mode="drop")
        acc = jnp.zeros((n, n), jnp.float32)
        for t in range(1, min(tmax, TCAP) + 1):
            Bt = (C >= t).astype(jnp.bfloat16)
            acc = acc + jnp.matmul(Bt, Bt.T,
                                   preferred_element_type=jnp.float32)
        O += np.asarray(acc, np.float64)
        if tmax > TCAP:
            hi = [(w[c > TCAP], c[c > TCAP] - TCAP)
                  for w, c in counts]
            for i in range(n):
                wi, ci = hi[i]
                if not len(wi):
                    continue
                for j in range(n):
                    wj, cj = hi[j]
                    if not len(wj):
                        continue
                    common, ia, ja = np.intersect1d(
                        wi, wj, return_indices=True)
                    if len(common):
                        O[i, j] += float(
                            np.minimum(ci[ia], cj[ja]).sum())
    return O, totals


def kmer_distance_matrix(seq_codes: list[np.ndarray], molc: int,
                         **kw) -> np.ndarray:
    """Condensed all-pairs qdiv distances (x100 like the DP distances).

    Large inputs run the overlap pass as indicator matmuls on device
    (O(N^2 V) matmul work instead of an O(N^2) host loop); small inputs
    keep the native host path (no compile/dispatch overhead)."""
    n = len(seq_codes)
    if n >= 48:
        per_seed = _word_lists(seq_codes, molc, **kw)
        O, totals = _device_overlap(per_seed, n)
        iu, ju = np.triu_indices(n, 1)
        Ta = totals[iu].astype(np.float64)
        Tb = totals[ju].astype(np.float64)
        denom = np.minimum(Ta, Tb)
        with np.errstate(divide="ignore", invalid="ignore"):
            f = np.where(denom > 0, O[iu, ju] / denom, 0.0)
        p0, p1 = _QDIV_PARAM[3]
        f2 = p0 * np.log((p1 + f) / (p1 + 1.0)) + 1.0
        d2 = 1.0 - f2
        if molc == ab.PROTEIN:
            d = np.maximum(d2, 0.0)
        else:
            x = 1.0 - 20.0 / 19.0 * np.clip(d2, 0.0, None)
            d = np.where(d2 <= 0.0, 0.0,
                         np.where(x <= 0.0, 1024.0,
                                  -19.0 / 20.0 * np.log(
                                      np.where(x > 0, x, 1.0))))
        out = np.zeros(n * (n - 1) // 2)
        out[ju * (ju - 1) // 2 + iu] = 100.0 * d
        return out
    kcs = [count_kmers(s, molc, **kw) for s in seq_codes]
    out = np.zeros(n * (n - 1) // 2)
    for j in range(1, n):
        for i in range(j):
            out[j * (j - 1) // 2 + i] = 100.0 * qdiv(kcs[i], kcs[j], molc)
    return out


def kmer_knn_candidates(seq_codes: list[np.ndarray], molc: int,
                        m_nearest: int = 8, n_hash: int = 48,
                        band_rows: int = 2, bucket_cap: int = 128,
                        seed: int = 0, **kw):
    """Sub-quadratic M-nearest candidate discovery (the role of the
    reference's block-index search, blksrc.cc:3260): MinHash-LSH over
    the reduced-alphabet word streams proposes neighbour candidates in
    O(N * hashes) work, candidates are ranked by estimated Jaccard,
    and only the top ones get the exact qdiv distance -- no O(N^2)
    matrix or allocation anywhere.

    Returns (pairs, dist) where pairs is a sorted list of (i, j)
    candidate edges (i < j) and dist maps each pair to the exact
    100*qdiv distance.  Edge-selection exactness is soft (SURVEY A.8):
    this decides which edges get DP-scored, not the scores.
    """
    n = len(seq_codes)
    rng = np.random.default_rng(seed)
    per_seed = _word_lists(seq_codes, molc, **kw)
    # one flat word set per sequence; seeds get disjoint word ranges
    offs = np.cumsum([0] + [V for _, V in per_seed])
    words = []
    for i in range(n):
        ws = [np.asarray(rows[i], np.int64) + offs[s]
              for s, (rows, _) in enumerate(per_seed)]
        cat = np.concatenate(ws) if ws else np.zeros(0, np.int64)
        words.append(np.unique(cat) if len(cat)
                     else np.zeros(1, np.int64))

    P = np.int64((1 << 61) - 1)
    A = rng.integers(1, P, n_hash, dtype=np.int64)
    Bv = rng.integers(0, P, n_hash, dtype=np.int64)
    sig = np.empty((n, n_hash), np.int64)
    for i in range(n):
        w = words[i]
        sig[i] = ((w[None, :] * A[:, None] + Bv[:, None]) % P).min(1)

    nb = n_hash // band_rows
    cands: list[set] = [set() for _ in range(n)]
    for b in range(nb):
        keys = {}
        block = sig[:, b * band_rows:(b + 1) * band_rows]
        for i in range(n):
            keys.setdefault(block[i].tobytes(), []).append(i)
        for members in keys.values():
            if 1 < len(members) <= bucket_cap:
                for i in members:
                    cands[i].update(members)
    for i in range(n):
        cands[i].discard(i)
        if not cands[i]:            # isolated: seed with a sample
            cands[i].update(int(x) for x in
                            rng.choice(n, min(2 * m_nearest, n - 1),
                                       replace=False) if int(x) != i)

    kcs = [count_kmers(s, molc, **kw) for s in seq_codes]
    pairs = set()
    dist = {}

    def exact(i, j):
        key = (min(i, j), max(i, j))
        if key not in dist:
            dist[key] = 100.0 * qdiv(kcs[i], kcs[j], molc)
        return dist[key]

    for i in range(n):
        cl = list(cands[i])
        if len(cl) > 3 * m_nearest:
            # rank by signature agreement (Jaccard estimate)
            agree = (sig[cl] == sig[i][None, :]).mean(1)
            cl = [cl[k] for k in np.argsort(-agree)[:3 * m_nearest]]
        ranked = sorted(cl, key=lambda j: exact(i, j))[:m_nearest]
        for j in ranked:
            pairs.add((min(i, j), max(i, j)))
    return sorted(pairs), dist
