"""Dense-vector distance family (reference distcmp.c:30-680).

Used by phycmp (compare two ltd matrices), tsv2phy (rows of a tsv ->
Phylip) and datclust.  Each metric exists per matrix dtype (d/f/s/b)
with the reference's exact conversion quirks:

- l1/l2/ln on s/b operate on raw stored ints; l1/linf apply uctod once
  at the end, l2's per-element diffs are uctod'ed (distcmp.c:114-127).
- linfcmp_s/b truncate each difference to unsigned char before the
  max (distcmp.c:262-296) — reproduced.
- bccmp/chi2cmp on s/b use raw stored values (scale cancels / is left
  uncancelled exactly as the C does).
- pearcmp s/b accumulate integer products and de-quantize ONCE
  (distcmp.c:588-634).

All accumulations follow C's sequential order via cumsum.

Counterpart of ccphylo_tpu/ops/distcmp.py: the port's own copy.
"""

from __future__ import annotations

import numpy as np


def _seq_sum(vals):
    if len(vals) == 0:
        return 0.0
    return float(np.cumsum(np.asarray(vals, np.float64))[-1])


def _vals(v, dtype, bs):
    """Logical float64 view of a stored vector."""
    v = np.asarray(v)
    if dtype in ("s", "b"):
        return v.astype(np.float64) / bs
    return v.astype(np.float64)


def _f32pair(v1, v2, op):
    """Binary op computed in float32 (C float op float stays float,
    e.g. coscmp_f's products, distcmp.c:436-456) then widened."""
    a = np.asarray(v1, np.float32)
    b = np.asarray(v2, np.float32)
    return op(a, b).astype(np.float64)


def l1cmp(v1, v2, dtype, bs):
    d1 = np.asarray(v1, np.float64)
    d2 = np.asarray(v2, np.float64)
    if dtype in ("s", "b"):
        # raw ints, one trailing uctod (distcmp.c:58-84)
        tot = _seq_sum(np.abs(np.asarray(v1, np.int64)
                              - np.asarray(v2, np.int64)))
        return tot / bs
    if dtype == "f":
        return _seq_sum(np.abs(_f32pair(v1, v2, np.subtract)))
    return _seq_sum(np.abs(d1 - d2))


def l2cmp(v1, v2, dtype, bs):
    if dtype in ("s", "b"):
        # uctod is an unparenthesized macro, so uctod(*v1 - *v2)
        # expands to *v1 - (*v2 / ByteScale) (bytescale.h:23,
        # distcmp.c:118-121) — reproduced
        diffs = (np.asarray(v1, np.float64)
                 - np.asarray(v2, np.float64) / bs)
    elif dtype == "f":
        diffs = _f32pair(v1, v2, np.subtract)
    else:
        diffs = np.asarray(v1, np.float64) - np.asarray(v2, np.float64)
    return float(np.sqrt(_seq_sum(diffs * diffs)))


def lncmp_factory(exponent: float):
    def lncmp(v1, v2, dtype, bs):
        if dtype in ("s", "b"):
            # same unparenthesized-uctod expansion as l2cmp_s/b
            diffs = np.abs(np.asarray(v1, np.float64)
                           - np.asarray(v2, np.float64) / bs)
        elif dtype == "f":
            diffs = np.abs(_f32pair(v1, v2, np.subtract))
        else:
            diffs = np.abs(np.asarray(v1, np.float64)
                           - np.asarray(v2, np.float64))
        d = _seq_sum(diffs ** exponent) ** (1.0 / exponent)
        return 0.0 if d < 0 else float(d)
    return lncmp


def linfcmp(v1, v2, dtype, bs):
    if dtype in ("s", "b"):
        # diffs wrap through unsigned char (distcmp.c:264-268)
        t = ((np.asarray(v1, np.int64) - np.asarray(v2, np.int64))
             & 0xFF).astype(np.uint8)
        return float(t.max()) / bs
    if dtype == "f":
        d = np.abs(_f32pair(v1, v2, np.subtract))
    else:
        d = np.abs(np.asarray(v1, np.float64)
                   - np.asarray(v2, np.float64))
    return float(d.max()) if len(d) else 0.0


def bccmp(v1, v2, dtype, bs):
    if dtype in ("s", "b"):
        a = np.asarray(v1, np.int64)
        b = np.asarray(v2, np.int64)
        d = int(np.minimum(a, b).sum())
        s = int((a + b).sum())
        res = 1 - 2 * (d / s) if s else np.inf
        # the C stores the ratio into an int first (distcmp.c:339)
        res = int(res) if np.isfinite(res) else 0
        return 0.0 if res < 0 else float(res)
    a = np.asarray(v1, np.float64)
    b = np.asarray(v2, np.float64)
    d = _seq_sum(np.minimum(a, b))
    if dtype == "f":
        s = _seq_sum(_f32pair(v1, v2, np.add))
    else:
        s = _seq_sum(a + b)
    res = 1 - 2 * d / s
    return 0.0 if res < 0 else float(res)


def chi2cmp(v1, v2, dtype, bs):
    a = np.asarray(v1, np.float64)
    b = np.asarray(v2, np.float64)
    if dtype == "f":
        T = _f32pair(v1, v2, np.subtract)
        den = _f32pair(v1, v2, np.add)
    else:
        T = a - b
        den = a + b
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(T != 0, T * T / den, 0.0)
    return float(np.sqrt(_seq_sum(terms)))


def coscmp(v1, v2, dtype, bs):
    a = _vals(v1, dtype, bs)
    b = _vals(v2, dtype, bs)
    if dtype == "f":
        d = _seq_sum(_f32pair(v1, v2, np.multiply))
        c1 = _seq_sum(_f32pair(v1, v1, np.multiply))
        c2 = _seq_sum(_f32pair(v2, v2, np.multiply))
    else:
        d = _seq_sum(a * b)
        c1 = _seq_sum(a * a)
        c2 = _seq_sum(b * b)
    if not c1 or not c2:
        return -1.0
    res = 1 - d / np.sqrt(c1 * c2)
    return 0.0 if res < 0 else float(res)


def pearcmp(v1, v2, dtype, bs):
    if dtype in ("s", "b"):
        a = np.asarray(v1, np.int64)
        b = np.asarray(v2, np.int64)
        n = len(a)
        e1 = _seq_sum(a) / bs
        e2 = _seq_sum(b) / bs
        v11 = _seq_sum(a * a) / bs
        v12 = _seq_sum(a * b) / bs
        v22 = _seq_sum(b * b) / bs
    elif dtype == "f":
        a = np.asarray(v1, np.float64)
        b = np.asarray(v2, np.float64)
        n = len(a)
        e1 = _seq_sum(a)
        e2 = _seq_sum(b)
        v11 = _seq_sum(_f32pair(v1, v1, np.multiply))
        v12 = _seq_sum(_f32pair(v1, v2, np.multiply))
        v22 = _seq_sum(_f32pair(v2, v2, np.multiply))
    else:
        a = np.asarray(v1, np.float64)
        b = np.asarray(v2, np.float64)
        n = len(a)
        e1 = _seq_sum(a)
        e2 = _seq_sum(b)
        v11 = _seq_sum(a * a)
        v12 = _seq_sum(a * b)
        v22 = _seq_sum(b * b)
    v11 -= e1 * e1 / n
    v12 -= e1 * e2 / n
    v22 -= e2 * e2 / n
    if not v11 or not v22:
        return 0.0
    return float(v12 / np.sqrt(v11 * v22))


METRICS = {
    "cos": coscmp, "chi2": chi2cmp, "bc": bccmp, "l1": l1cmp,
    "l2": l2cmp, "linf": linfcmp, "p": pearcmp,
}


def get_distcmp(method: str):
    """Registry used by tsv2phy (distcmp fn-ptrs, distcmp.c:25-28)."""
    if method in METRICS:
        return METRICS[method]
    if method.startswith("l"):
        try:
            return lncmp_factory(float(method[1:]))
        except ValueError:
            return None
    return None
