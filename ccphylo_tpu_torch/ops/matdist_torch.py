"""All-pairs count-matrix distances on a torch device: the `dist` .mat
path (counterpart of ops/matdist_jax.py).

The reference computes `.mat` distances per pair by re-streaming files
(cmpMats, matcmp.c:448-494).  Here the included samples' count matrices
are cut into position chunks that stream host -> device, (k, P, 6) at a
time, so k x L may exceed the card; on the card every pair's
per-position metric is reduced over the chunk, a block of sample rows
at a time, and the (k, k) sums are kept there in float64 until the last
chunk.

Plain tensor functions, no kernel.  `dtype` is float64 by default (the
reference's float32 was its device's limit); float32 on request, then
the chunk sums are float32 and only their accumulation is float64, as
in the reference.  Every metric follows the expression order of the
host's ops/veccmp.py, with the quirks it reproduces from the C: nlinf
reads column 0 only, nc's denominator uses the last column, z's second
majority test reuses sample 1's total and maximum, nl<n>'s first term
is the signed power and a negative base is excluded.

Exactness.  The inclusion gates (depth, length, the metric's own
exclusion) are integer comparisons for every metric but z and nl<n>,
so `R` (rows_inc) equals the host's; z's gate is held to the host's
column by column (see `EXACT_METRICS`), and nl<n> can gain or lose a
position where two channels differ (its base is rounding noise around
0 there, in the reference too).  The sums are taken in the device's
order: in float64 they agree with the host's sequential sum to ~1e-12,
and bit for bit where every per-position value is an integer
(`EXACT_METRICS`, while a pair's sum stays under 2^53).

Returns the same (dist, rows_inc) contract as cmp_mats for every pair
through `cmp_mats_from_table`, including the -1.0/-2.0 sentinels and
`norm` scaling.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.torchconfig import device as default_device
from .veccmp import _FASTP_EDGES, SQRT_PI

PCHUNK = 16384  # positions per streamed chunk

# metrics whose per-position values are integers: their float64 sums do
# not depend on the order of summation, so the card's table equals the
# host's cmp_mats bit for bit.  z sums zeros; its gate compares a
# p-value with alpha, and equals the host's on every column (total,
# majority count) up to depth 400 on CPU tensors
# (tests/test_torch_matdist.py) and up to depth 4096 on an H100
# (chip_smoke.py matdist): it could differ only where a p-value lies
# within an ulp of alpha.
EXACT_METRICS = ("l1", "linf", "z")


# --- per-position metrics ----------------------------------------------
# Each takes the channel slices a (bi, 1, P, 5) and b (1, kj, P, 5), the
# totals t1, t2 and the N counts n1, n2 ((bi, 1, P) and (1, kj, P)), all
# in the working dtype (exact for counts < 2^24 in float32), and returns
# (vals, valid) of shape (bi, kj, P): valid is False where the host
# metric yields -1 or NaN.  Citations are the matching matcmp.c metrics.


def _true(x):
    return torch.ones_like(x, dtype=torch.bool)


def _frac(a, t, nn):
    # normalized fractions over tot - N (matcmp.c _norm idiom); a sample
    # with no count gets fractions of 0 and is excluded by the caller
    tt = t - nn
    return a / torch.where(tt > 0, tt, 1.0)[..., None], tt


def _m_cos(a, b, t1, t2, n1, n2):
    d = (a * b).sum(-1)
    q1 = (a * a).sum(-1)
    q2 = (b * b).sum(-1)
    ok = (q1 > 0) & (q2 > 0)
    den = torch.sqrt(q1) * torch.sqrt(q2)
    res = (1.0 - d / torch.where(ok, den, 1.0)).clamp_min(0.0)
    return res, ok


def _m_l1(a, b, t1, t2, n1, n2):
    d = (a - b).abs().sum(-1)
    return d, _true(d)


def _m_l2(a, b, t1, t2, n1, n2):
    d = torch.sqrt(((a - b) ** 2).sum(-1))
    return d, _true(d)


def _m_linf(a, b, t1, t2, n1, n2):
    d = (a - b).abs().amax(-1)
    return d, _true(d)


def _chi2_sum(x, y):
    T = x - y
    s = x + y
    return torch.where(T != 0, T * T / torch.where(s > 0, s, 1.0), 0.0) \
        .sum(-1)


def _m_chi2(a, b, t1, t2, n1, n2):
    d = torch.sqrt(_chi2_sum(a, b))
    return d, _true(d)


def _m_c(a, b, t1, t2, n1, n2):
    lo = torch.minimum(a, b).sum(-1)
    hi = torch.maximum(a, b).sum(-1)
    d = (1.0 - lo / torch.where(hi > 0, hi, 1.0)).clamp_min(0.0)
    return d, hi > 0


def _m_bc(a, b, t1, t2, n1, n2):
    lo = torch.minimum(a, b).sum(-1)
    den = (t1 - n1) + (t2 - n2)
    d = (1.0 - 2.0 * (lo / torch.where(den > 0, den, 1.0))).clamp_min(0.0)
    return d, den > 0


def _m_nl1(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    return (f1 - f2).abs().sum(-1), (tt1 > 0) & (tt2 > 0)


def _m_nl2(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    return torch.sqrt(((f1 - f2) ** 2).sum(-1)), (tt1 > 0) & (tt2 > 0)


def _m_nlinf(a, b, t1, t2, n1, n2):
    # the reference re-reads column 0 every iteration (matcmp.c:135)
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    return (f1[..., 0] - f2[..., 0]).abs(), (tt1 > 0) & (tt2 > 0)


def _m_nbc(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    d = (1.0 - torch.minimum(f1, f2).sum(-1)).clamp_min(0.0)
    return d, (tt1 > 0) & (tt2 > 0)


def _m_nchi2(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    return torch.sqrt(_chi2_sum(f1, f2)), (tt1 > 0) & (tt2 > 0)


def _m_nc(a, b, t1, t2, n1, n2):
    # nccmp's T resets per iteration: the denominator is 1 + max-frac of
    # the LAST column (matcmp.c:267)
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    lo = torch.minimum(f1, f2).sum(-1)
    T = 1.0 + torch.maximum(f1[..., 4], f2[..., 4])
    return (1.0 - lo / T).clamp_min(0.0), (tt1 > 0) & (tt2 > 0)


def _p_chisqr(q):
    """p_chisqr (stdstat.c:132-142): the erf branch, and the fastp table
    chain (stdstat.c:33-129) for q > 49.  `torch.erf` need not equal the
    host's to the last bit: a threshold comparison (z's alpha gate) can
    differ from the host's only on a column whose p-value lies within
    an ulp of alpha."""
    p = torch.ones_like(q)
    for edge, val in reversed(_FASTP_EDGES):
        p = torch.where(q > edge, val, p)
    exact = 1.0 - 1.772453850 * torch.erf(torch.sqrt(0.5 * q.abs())) \
        / SQRT_PI
    return torch.where(q < 0, 1e-26, torch.where(q > 49, p, exact))


def _m_z_factory(alpha: float):
    def _m_z(a, b, t1, t2, n1, n2):
        """zcmp (matcmp.c:311-344): consensus comparison gated on the
        chi-square majority test; the reference's second majority check
        reuses tot1/max1 (matcmp.c:338), reproduced.  a, b, t are the
        raw counts and totals (z uses totals including N)."""
        max1 = a.amax(-1)
        max2 = b.amax(-1)
        # an empty column is 0/0 on the host: NaN, which passes no gate
        nan = float("nan")
        q1 = torch.where(t1 > 0, (t1 - 2 * max1) ** 2
                         / torch.where(t1 > 0, t1, 1.0), nan)
        q2 = torch.where(t2 > 0, (t2 - 2 * max2) ** 2
                         / torch.where(t2 > 0, t2, 1.0), nan)
        maj1 = t1 < 2 * max1
        x1 = (_p_chisqr(q1) <= alpha) & maj1
        x2 = (_p_chisqr(q2) <= alpha) & maj1
        ok = x1 & x2
        return torch.zeros(ok.shape, dtype=a.dtype, device=a.device), ok
    return _m_z


def _m_p(a, b, t1, t2, n1, n2):
    """pcmp (matcmp.c:346-359): 1 - p of the chi2 column test."""
    d = 1.0 - _p_chisqr(_chi2_sum(a, b))
    return d, _true(d)


def _m_np(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    d = 1.0 - _p_chisqr(_chi2_sum(f1, f2))
    return d, (tt1 > 0) & (tt2 > 0)


def _m_ln_factory(nn: int):
    def _m_ln(a, b, t1, t2, n1, n2):
        d = ((a - b).abs() ** nn).sum(-1) ** (1.0 / nn)
        return d.clamp_min(0.0), _true(d)
    return _m_ln


def _m_nln_factory(nn: int):
    def _m_nln(a, b, t1, t2, n1, n2):
        f1, tt1 = _frac(a, t1, n1)
        f2, tt2 = _frac(b, t2, n2)
        diff = (f1 - f2).abs()
        # the first term is pow() of the SIGNED difference (matcmp.c:112)
        first = (f1[..., 0] - f2[..., 0]) ** nn
        base = first + (diff[..., 1:] ** nn).sum(-1)
        d = base.clamp_min(0.0) ** (1.0 / nn)
        # negative base -> NaN on the host -> excluded upstream
        return d, (tt1 > 0) & (tt2 > 0) & (base >= 0)
    return _m_nln


METRICS = {
    "cos": _m_cos, "l1": _m_l1, "l2": _m_l2, "linf": _m_linf,
    "chi2": _m_chi2, "c": _m_c, "bc": _m_bc, "nl1": _m_nl1,
    "nl2": _m_nl2, "nlinf": _m_nlinf, "nbc": _m_nbc,
    "nchi2": _m_nchi2, "nc": _m_nc, "p": _m_p, "np": _m_np,
}


def resolve_metric(method: str, alpha: float = 0.05):
    """Metric spec for a dist -d method (None if unsupported).
    Parameterized metrics encode their parameter ("z@0.05", "l3",
    "nl4")."""
    if method == "z":
        return f"z@{alpha!r}"
    if method in METRICS:
        return method
    for pre in ("nl", "l"):
        if method.startswith(pre):
            try:
                int(method[len(pre):])
            except ValueError:
                return None
            return method
    return None


def _metric_fn(spec: str):
    if spec.startswith("z@"):
        return _m_z_factory(float(spec[2:]))
    if spec in METRICS:
        return METRICS[spec]
    if spec.startswith("nl"):
        return _m_nln_factory(int(spec[2:]))
    return _m_ln_factory(int(spec[1:]))


def _budget_bytes(dev: torch.device) -> int:
    """Bytes one pair tensor of a block may take: a sixteenth of the
    card's free memory (256 MiB on the CPU), which leaves room for the
    few temporaries of its size a metric holds at once."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0] // 16
    return 256 << 20


def _block_shape(k: int, L: int, dtype: torch.dtype,
                 dev: torch.device) -> tuple[int, int]:
    """(sample rows per block, positions per chunk) such that the
    (rows, k, positions, 5) pair tensor fits `_budget_bytes`: as many
    rows as fit at PCHUNK positions; where not even one row does (many
    samples), a shorter chunk."""
    P = max(1, min(PCHUNK, L))
    per_pos = max(1, k * 5 * torch.empty(0, dtype=dtype).element_size())
    budget = _budget_bytes(dev)
    bi = budget // (per_pos * P)
    if bi < 1:
        return 1, max(1, budget // per_pos)
    return min(k, bi), P


def _metric_chunk(counts: torch.Tensor, totals: torch.Tensor,
                  plens: torch.Tensor, metric: str, min_depth: int,
                  bi: int, S: torch.Tensor, R: torch.Tensor,
                  dtype: torch.dtype = torch.float64,
                  lower: bool = False) -> None:
    """One position chunk: counts (k, P, 6) and totals (k, P) int32,
    plens (k,) int32 = valid positions of each sample in this chunk.
    Adds every pair's masked sum of the metric over the chunk to S
    (k, k) float64 and its count of positions to R (k, k) int64, in
    place.  Pairs are gated per position on depth, per-sample length
    and the metric's own exclusion.  Sample rows are taken `bi` at a
    time so that the (bi, k, P, 5) pair tensors stay bounded; with
    `lower`, a block computes only the columns up to its last row (the
    strict lower triangle is complete, the rest of the table is not)."""
    fn = _metric_fn(metric)
    k, P, _ = counts.shape
    a_all = counts[:, :, :5].to(dtype)
    t_all = totals.to(dtype)
    n_all = counts[:, :, 5].to(dtype)
    pos = torch.arange(P, dtype=torch.int32, device=counts.device)
    deep = (totals >= min_depth) & (pos[None, :] < plens[:, None])  # (k, P)
    for i0 in range(0, k, bi):
        i1 = min(i0 + bi, k)
        kj = i1 if lower else k
        vals, valid = fn(a_all[i0:i1, None], a_all[None, :kj],
                         t_all[i0:i1, None], t_all[None, :kj],
                         n_all[i0:i1, None], n_all[None, :kj])
        use = deep[i0:i1, None, :] & deep[None, :kj, :] & valid
        S[i0:i1, :kj] += torch.where(use, vals, 0.0).sum(dim=2)
        R[i0:i1, :kj] += use.sum(dim=2)


def _u16(x: torch.Tensor) -> torch.Tensor:
    """uint16 counts that crossed as int16 bit patterns -> int32."""
    return x.to(torch.int32) & 0xFFFF


def pair_table(metric: str, counts_list, totals_list, min_depth: int,
               device=None, dtype: torch.dtype = torch.float64,
               lower: bool = False):
    """All-pairs (sum, rows_inc) over stripped samples for a metric spec
    of `resolve_metric`.

    counts_list[i]: (L_i, 6) uint16; totals_list[i]: (L_i,) int64.
    Positions beyond min(L_i, L_j) are excluded per pair (cmpMats
    truncates at sample2's length; the longer-than-sample1 case is the
    caller's -1 sentinel).  `device`: a torch device, default that of
    utils/torchconfig.py (the card).  Returns (S float64 (k, k), R int64
    (k, k)) as numpy arrays, the whole ordered table, or with `lower`
    only its strict lower triangle.  `pair_table.last` holds the seconds
    of the call, those the host spent packing chunks (numpy copies) and
    those in the copy calls (which also wait for the device to finish
    the chunk before)."""
    dev = default_device() if device is None else torch.device(device)
    t_start = time.perf_counter()
    k = len(counts_list)
    lens = np.array([len(c) for c in counts_list], np.int64)
    Lmax = int(lens.max()) if k else 0
    S = torch.zeros((k, k), dtype=torch.float64, device=dev)
    R = torch.zeros((k, k), dtype=torch.int64, device=dev)
    bi, chunk = _block_shape(k, Lmax, dtype, dev)
    t_pack = t_copy = 0.0
    for p0 in range(0, Lmax, chunk):
        t0 = time.perf_counter()
        P = min(chunk, Lmax - p0)
        cc = np.zeros((k, P, 6), np.uint16)
        tt = np.zeros((k, P), np.int32)
        for i in range(k):
            hi = min(len(counts_list[i]), p0 + P)
            if hi > p0:
                cc[i, :hi - p0] = counts_list[i][p0:hi]
                tt[i, :hi - p0] = totals_list[i][p0:hi]
        plens = np.clip(lens - p0, 0, P).astype(np.int32)
        t1 = time.perf_counter()
        t_pack += t1 - t0
        # torch has no arithmetic on uint16: the counts cross as int16
        # bit patterns
        counts = _u16(torch.from_numpy(cc.view(np.int16)).to(dev))
        totals = torch.from_numpy(tt).to(dev)
        plens = torch.from_numpy(plens).to(dev)
        t_copy += time.perf_counter() - t1
        _metric_chunk(counts, totals, plens, metric, min_depth, bi, S, R,
                      dtype, lower)
    out = S.cpu().numpy(), R.cpu().numpy()
    pair_table.last = {"s": time.perf_counter() - t_start,
                       "pack_s": t_pack, "copy_s": t_copy, "block_rows": bi,
                       "chunks": -(-Lmax // chunk) if Lmax else 0}
    return out


def cos_pair_table(counts_list, totals_list, min_depth: int, **kw):
    return pair_table("cos", counts_list, totals_list, min_depth, **kw)


def cmp_mats_from_table(S, R, i, j, len_i, len_j, n_nucs_j, norm,
                        min_depth, min_length, min_cov):
    """cmpMats' gate/sentinel logic (matcmp.c:448-494) from the batched
    table: the same (dist, rows_inc) results as ops/veccmp.cmp_mats up
    to the order of the sum."""
    if len_j > len_i:
        return -1.0, 0  # caller maps to the 'longer than' sentinel
    rows_inc = int(R[i, j])
    if n_nucs_j < min_length or n_nucs_j < min_cov * len_j:
        return -2.0, rows_inc
    if rows_inc < min_length or rows_inc < min_cov * len_j:
        return -1.0, 0
    dist = float(S[i, j])
    return (dist / rows_inc * norm if norm else dist), rows_inc
