"""Count-vector distance metrics over KMA alignment columns.

Parity sources: matcmp.c:63-446 (the 17 metrics), matcmp.c:448-494
(cmpMats), stdstat.c:33-143 (fastp / p_chisqr).

Each metric is vectorized over positions: inputs are (L, 6) uint16
count matrices in [A, C, G, T, -, N] order (N moved last as in
matparse.c:251-258) and (L,) totals (sum of all six).  Indices 0..4
participate in the vector math; index 5 (N) is subtracted from totals by
the normalized variants.  All arithmetic follows the C expression order
in float64.  Metrics return -1 at positions they cannot score (caller
skips those, matcmp.c:475).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import erf as _erf

SQRT_PI = math.gamma(0.5)

_FASTP_EDGES = [
    (114.5242, 1e-26), (109.9604, 1e-25), (105.3969, 1e-24),
    (100.8337, 1e-23), (96.27476, 1e-22), (91.71701, 1e-21),
    (87.16164, 1e-20), (82.60901, 1e-19), (78.05917, 1e-18),
    (73.51245, 1e-17), (68.96954, 1e-16), (64.43048, 1e-15),
    (59.89615, 1e-14), (55.36699, 1e-13), (50.84417, 1e-12),
    (46.32844, 1e-11), (41.82144, 1e-10), (37.32489, 1e-9),
    (32.84127, 1e-8), (28.37395, 1e-7), (23.92814, 1e-6),
    (19.51139, 1e-5), (15.13671, 1e-4), (10.82759, 1e-3),
    (6.634897, 0.01), (3.841443, 0.05), (2.705532, 0.1),
    (2.072251, 0.15), (1.642374, 0.2), (1.323304, 0.25),
    (1.074194, 0.3), (0.8734571, 0.35), (0.7083263, 0.4),
    (0.5706519, 0.45), (0.4549364, 0.5), (0.3573172, 0.55),
    (0.2749959, 0.6), (0.2059001, 0.65), (0.1484719, 0.7),
    (0.1015310, 0.75), (0.06418475, 0.8), (0.03576578, 0.85),
    (0.01579077, 0.9), (0.00393214, 0.95),
]


def fastp(q: np.ndarray) -> np.ndarray:
    """fastp (stdstat.c:33-129): table lookup p-value."""
    q = np.asarray(q, np.float64)
    p = np.ones_like(q)
    for edge, val in reversed(_FASTP_EDGES):
        p = np.where(q > edge, val, p)
    return p


def p_chisqr(q: np.ndarray) -> np.ndarray:
    """p_chisqr (stdstat.c:132-142)."""
    q = np.asarray(q, np.float64)
    exact = 1 - 1.772453850 * _erf(np.sqrt(0.5 * np.abs(q))) / SQRT_PI
    return np.where(q < 0, 1e-26, np.where(q > 49, fastp(q), exact))


def _norm_frac(c1, c2, tot1, tot2):
    t1 = tot1.astype(np.float64) - c1[:, 5]
    t2 = tot2.astype(np.float64) - c2[:, 5]
    f1 = c1[:, :5].astype(np.float64) / t1[:, None]
    f2 = c2[:, :5].astype(np.float64) / t2[:, None]
    return f1, f2


def coscmp(c1, c2, tot1, tot2):
    """coscmp (matcmp.c:420-446): angle between count vectors."""
    a = c1[:, :5].astype(np.int64)
    b = c2[:, :5].astype(np.int64)
    d = (a * b).sum(axis=1).astype(np.float64)
    q1 = (a * a).sum(axis=1)
    q2 = (b * b).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        res = 1 - d / (np.sqrt(q1) * np.sqrt(q2))
    res = np.where(res < 0, 0.0, res)
    return np.where((q1 == 0) | (q2 == 0), -1.0, res)


def zcmp_factory(alpha: float):
    def zcmp(c1, c2, tot1, tot2):
        """zcmp (matcmp.c:311-344): consensus comparison gated on a
        McNemar-ish chi-square test.  The reference's x2 term reuses
        tot1/max1 (matcmp.c:338) — reproduced as-is."""
        max1 = c1[:, :5].max(axis=1).astype(np.int64)
        max2 = c2[:, :5].max(axis=1).astype(np.int64)
        t1 = tot1.astype(np.int64)
        t2 = tot2.astype(np.int64)
        with np.errstate(divide="ignore", invalid="ignore"):
            q1 = (t1 - (max1 << 1)).astype(np.float64) ** 2 / t1
            q2 = (t2 - (max2 << 1)).astype(np.float64) ** 2 / t2
        maj1 = t1 < (max1 << 1)
        x1 = (p_chisqr(q1) <= alpha) & maj1
        # the reference's second majority check reuses tot1/max1
        x2 = (p_chisqr(q2) <= alpha) & maj1
        return np.where(x1 & x2, 0.0, -1.0)
    return zcmp


def chi2cmp(c1, c2, tot1, tot2):
    a = c1[:, :5].astype(np.float64)
    b = c2[:, :5].astype(np.float64)
    T = a - b
    s = a + b
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(T != 0, T * T / s, 0.0)
    return np.sqrt(terms.sum(axis=1))


def nchi2cmp(c1, c2, tot1, tot2):
    f1, f2 = _norm_frac(c1, c2, tot1, tot2)
    diff = f1 - f2
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(diff != 0, diff * diff / (f1 + f2), 0.0)
    return np.sqrt(terms.sum(axis=1))


def ccmp(c1, c2, tot1, tot2):
    """ccmp (matcmp.c:281-309): Clausen distance."""
    a = c1[:, :5].astype(np.int64)
    b = c2[:, :5].astype(np.int64)
    lo = np.minimum(a, b).sum(axis=1).astype(np.float64)
    hi = np.maximum(a, b).sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 1 - lo / hi
    d = np.where(d < 0, 0.0, d)
    return np.where(hi == 0, -1.0, d)


def nccmp(c1, c2, tot1, tot2):
    """nccmp (matcmp.c:246-279).  NOTE: the reference resets T to 1 each
    iteration (matcmp.c:267), so the denominator is 1 + max-frac of the
    final column pair — reproduced faithfully."""
    f1, f2 = _norm_frac(c1, c2, tot1, tot2)
    lo = np.minimum(f1, f2)
    hi = np.maximum(f1, f2)
    d = lo.sum(axis=1)
    T = 1 + hi[:, 4]
    with np.errstate(divide="ignore", invalid="ignore"):
        res = 1 - d / T
    return np.where(res < 0, 0.0, res)


def bccmp(c1, c2, tot1, tot2):
    """bccmp (matcmp.c:230-244): Bray-Curtis on raw counts; denominator
    excludes N counts."""
    a = c1[:, :5].astype(np.int64)
    b = c2[:, :5].astype(np.int64)
    lo = np.minimum(a, b).sum(axis=1).astype(np.float64)
    den = (tot1.astype(np.int64) - c1[:, 5] + tot2.astype(np.int64)
           - c2[:, 5]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 1 - 2 * (lo / den)
    return np.where(d < 0, 0.0, d)


def nbccmp(c1, c2, tot1, tot2):
    f1, f2 = _norm_frac(c1, c2, tot1, tot2)
    d = 1 - np.minimum(f1, f2).sum(axis=1)
    return np.where(d < 0, 0.0, d)


def l1cmp(c1, c2, tot1, tot2):
    a = c1[:, :5].astype(np.int64)
    b = c2[:, :5].astype(np.int64)
    return np.abs(a - b).sum(axis=1).astype(np.float64)


def l2cmp(c1, c2, tot1, tot2):
    a = c1[:, :5].astype(np.int64)
    b = c2[:, :5].astype(np.int64)
    return np.sqrt(((a - b) ** 2).sum(axis=1).astype(np.float64))


def linfcmp(c1, c2, tot1, tot2):
    a = c1[:, :5].astype(np.int64)
    b = c2[:, :5].astype(np.int64)
    return np.abs(a - b).max(axis=1).astype(np.float64)


def lncmp_factory(n: int):
    def lncmp(c1, c2, tot1, tot2):
        a = c1[:, :5].astype(np.int64)
        b = c2[:, :5].astype(np.int64)
        d = (np.abs(a - b).astype(np.float64) ** n).sum(axis=1)
        d = d ** (1.0 / n)
        return np.where(d < 0, 0.0, d)
    return lncmp


def nl1cmp(c1, c2, tot1, tot2):
    f1, f2 = _norm_frac(c1, c2, tot1, tot2)
    return np.abs(f1 - f2).sum(axis=1)


def nl2cmp(c1, c2, tot1, tot2):
    f1, f2 = _norm_frac(c1, c2, tot1, tot2)
    return np.sqrt(((f1 - f2) ** 2).sum(axis=1))


def nlinfcmp(c1, c2, tot1, tot2):
    """nlinfcmp (matcmp.c:124-143).  The reference never advances its
    count pointers in the loop (matcmp.c:135), so every iteration
    re-reads column 0 — the result is |f1[0] - f2[0]|; reproduced."""
    f1, f2 = _norm_frac(c1, c2, tot1, tot2)
    return np.abs(f1[:, 0] - f2[:, 0])


def nlncmp_factory(n: int):
    def nlncmp(c1, c2, tot1, tot2):
        f1, f2 = _norm_frac(c1, c2, tot1, tot2)
        diff = np.abs(f1 - f2)
        # the first term is pow() of the SIGNED difference (matcmp.c:112)
        first = f1[:, 0] - f2[:, 0]
        d = first ** n + (diff[:, 1:] ** n).sum(axis=1)
        with np.errstate(invalid="ignore"):
            d = d ** (1.0 / n)  # negative d -> NaN, excluded upstream
        return np.where(d < 0, 0.0, d)
    return nlncmp


def pcmp(c1, c2, tot1, tot2):
    """pcmp (matcmp.c:346-359): 1 - p of the chi2 column test."""
    d = np.zeros(len(c1), np.float64)
    a = c1[:, :5].astype(np.float64)
    b = c2[:, :5].astype(np.float64)
    T = a - b
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(T != 0, T * T / (a + b), 0.0)
    d = terms.sum(axis=1)
    return 1 - p_chisqr(d)


def npcmp(c1, c2, tot1, tot2):
    f1, f2 = _norm_frac(c1, c2, tot1, tot2)
    diff = f1 - f2
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(diff != 0, diff * diff / (f1 + f2), 0.0)
    d = terms.sum(axis=1)
    return 1 - p_chisqr(d)


def get_veccmp(method: str, alpha: float = 0.05):
    """Method registry (dist.c:738-786)."""
    table = {
        "cos": coscmp, "z": zcmp_factory(alpha), "chi2": chi2cmp,
        "nchi2": nchi2cmp, "nc": nccmp, "c": ccmp, "np": npcmp,
        "p": pcmp, "nbc": nbccmp, "bc": bccmp, "nl1": nl1cmp,
        "nl2": nl2cmp, "nlinf": nlinfcmp, "l1": l1cmp, "l2": l2cmp,
        "linf": linfcmp,
    }
    if method in table:
        return table[method]
    if method.startswith("nl"):
        return nlncmp_factory(int(method[2:]))
    if method.startswith("l"):
        return lncmp_factory(int(method[1:]))
    return None


def cmp_mats(counts1, totals1, counts2, totals2, norm, min_depth,
             min_length, min_cov, veccmp):
    """cmpMats (matcmp.c:448-494): distance between two stripped count
    matrices.  Returns (dist, rows_inc):

    - dist == -2.0: sample2 fails the inclusion gates (or is longer than
      sample1's matrix — reported as -1.0 with rows_inc None upstream)
    - dist == -1.0: insufficient overlapping rows (rows_inc == 0)
    - otherwise the (optionally norm-scaled) summed metric.
    """
    row_num = len(counts2)
    if row_num > len(counts1):
        # mat1->len < rowNum (matcmp.c:469-471): -1 with N = the total of
        # the overflowing row (mat2->total is left mid-stream)
        return -1.0, int(totals2[len(counts1)])
    t2 = totals2.astype(np.int64)
    t1 = totals1[:row_num].astype(np.int64)
    deep2 = min_depth <= t2
    n_nucs = int(deep2.sum())
    both = deep2 & (min_depth <= t1)
    d = veccmp(counts1[:row_num], counts2, totals1[:row_num], totals2)
    use = both & (0 <= d)
    rows_inc = int(use.sum())
    if n_nucs < min_length or n_nucs < min_cov * row_num:
        return -2.0, rows_inc
    if rows_inc < min_length or rows_inc < min_cov * row_num:
        return -1.0, 0
    vals = d[use]
    dist = float(np.cumsum(vals)[-1]) if len(vals) else 0.0
    return (dist / rows_inc * norm if norm else dist), rows_inc
