"""Device Dynamic Neighbor-Joining on float and on quantized (u16/u8)
matrices (counterpart of tree/jax_engine.py).

Cycle-accurate DNJ (reference dnj.c:985-1052):

- state: the square distance matrix D (missing < 0), row sums sD, pair
  counts N, and the reference's asymmetric row caches: Q[i]/P[i] cover
  partners j < i only, like the lower-triangular C engine
  (dnj.c:43-128).  All of it lives on the torch device and is updated in
  place, the join records (I, J, LI, LJ) too until the end of the run.
- the float engine's join loop (`dnj_joins`, scan="batch", what the CLI
  runs) is one `dnj_segment_float` call per fenced segment of
  tree/segmenting.py (ops/segment_float.py): on the card one cooperative
  launch of csrc/dnj_segment_float.cu runs every scan pass and join body
  of the segment, and the host reads one int a segment, the join at
  which the segment stopped for the exact range (`InexactSums`); on CPU
  tensors the same call runs the plain loop of `_one_join`, described
  under ops/segment_float.py.  The pair selection replicates minQpair's
  seeded descending scan with strict-< tightening, in fused blocks of
  KBATCH rows; ``scan="seq"`` keeps the plain one-row-at-a-time scan
  (`_seq_scan`, for tests).  A join that finds no pair records I = J =
  0, LI = LJ = -1.
- the quantized engine (`dnj_joins_q`) still runs the plain loop: one
  host read per scan pass and one for the limbs, branches on host
  integers.

No padding: the matrix is (n, n) for n taxa, and a state carried over
from the JAX engine (interop.state_from_jax) may be larger than its
active count.

Exactness.  Every cell, sum and Q value of an integer matrix (the SNP
pipeline's output) is a dyadic rational; while they fit the mantissa
(53 bits in float64, 24 in float32) every operation is exact, the order
of a sum cannot matter, and the records are bit-identical to the JAX
engine's and, in float64, the Newick bytes to the host exact engine's
(tree/exact.py).  Each join stores (D_ik + D_kj - D_ij) / 2, which can
add one fractional bit per generation of a lineage, so the exact range
ends at some depth.  Outside it, and on non-integer matrices: the
kernel's block sums and `cumsum` and `sum` on CUDA are parallel, not
the C's left-to-right sums, and ``coef * d - sD[i] - sD`` is never
contracted to a fused multiply-add (the kernel rounds each operation
with the _rn intrinsics), so sD and Q can differ from the host engine's
in the last ulp, and on tie-dense data an ulp can flip a pick.  Ties
themselves, including the guaranteed three-way tie at the final join,
resolve identically by construction.  With ``exact_sums`` an engine
tracks the exact range as it runs (`sums_exact`: one flag on the
device, which the kernel keeps in every block and the plain loop reads
with each join's limbs) and raises InexactSums at the first join that
could read a sum outside it; the default CLI route then hands the tree
to the host engine.

The quantized engine keeps D as u16 or u8 cells with the reference's
ByteScale quantization (bytescale.h:22-23).  u16 cells are held as
int16 bit patterns (torch.uint16 has too few operators) and
dequantized through int32 ``& 0xFFFF``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import segment_float
from ..ops.select import topk_mask_indices
from ..utils import timing
from ..utils.torchconfig import device as default_device
from .newick_build import (byteshift_fix, form_last_bi_node,
                           form_last_node, form_node)
from .segmenting import run_segmented

KBATCH = 128  # rows revalidated per fused block in scan="batch"
_CH = 512     # rows per chunk of an init pass: temporaries stay (CH, m)
_TILE = 1024  # rows and columns of a tile `square_matrix` mirrors


def _big(dtype) -> float:
    """Stands in for the reference's DBL_MAX."""
    return torch.finfo(dtype).max


def _np_float(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


class InexactSums(ArithmeticError):
    """The row sums of a float engine left the exact range of its
    precision (`sums_exact`) before join `join`: from there a sum on the
    card may differ from the host engine's left-to-right sum in its last
    bit."""

    def __init__(self, join: int):
        super().__init__(f"row sums left the exact range before join {join}")
        self.join = join


def sums_exact(x, dim: int = -1):
    """Whether every partial sum of x along `dim`, in any order, is exact
    in x's precision: with s + 1 < 2^e (s the sum of |x|), the entries
    lie on the grid 2^-k, k = mantissa - e, so every partial sum is a
    multiple of 2^-k below 2^mantissa, one bit to spare.  Exponents come
    from frexp and the power of two is built from its bits, not from
    log2 or pow, which CUDA need not round exactly.  Device operations
    only: a bool tensor, no host read."""
    mant, bias, itype = (52, 1023, torch.int64) if x.dtype == torch.float64 \
        else (23, 127, torch.int32)
    e = torch.frexp(x.abs().sum(dim, keepdim=True) + 1).exponent
    p2 = ((mant + bias - e).to(itype) << mant).view(x.dtype)  # 2^k
    y = x * p2
    return (y == torch.round(y)).all(dim)


def track_sums(st, m: int, cells=None) -> None:
    """Start tracking the exact range on the state `st` of m active taxa:
    st["exact"] says whether every row sum taken so far (the init's here,
    each join's then, see `_update_d_exact`) was exact; `_limbs` reads it
    with the pair's values and raises InexactSums when it is not.
    cells(r0, r1): rows r0..r1 of the m x m matrix (default st["D"])."""
    cells = cells or (lambda r0, r1: st["D"][r0:r1, :m])
    ok = torch.ones((), dtype=torch.bool, device=st["sD"].device)
    for r0, r1 in _row_chunks(m):
        Dr = cells(r0, r1)
        ok &= sums_exact(torch.where(Dr >= 0, Dr, 0), dim=1).all()
    st["exact"] = ok


def _last_min(q, idx):
    """value + LAST index of the minimum (the `<=` scan rule), 0-d."""
    mn = q.min()
    return mn, torch.where(q == mn, idx, -1).max()


def _row_cache(q, idx, big):
    """(Q, P) of a row from its Q values over partners 0..len(q)-1:
    the last-wins minimum; (big, 0) when no partner is valid."""
    if q.numel() == 0:
        return q.new_full((), big), idx.new_zeros(())
    mn, p = _last_min(q, idx[:q.numel()])
    return mn, torch.where(mn == big, 0, p)


def _row_chunks(m: int):
    return [(r0, min(r0 + _CH, m)) for r0 in range(0, m, _CH)]


def _row_minima(Dr, Qm, lv, cols, big, hnj=True):
    """Row minima (Qc, Pc) of Qm over its valid cells lv.  Ties: with
    `hnj` the initHNJ rule (hclust.c:110-116): among equal-Q candidates
    ascending, accept while the raw distance Dr is a running minimum;
    else the last candidate wins."""
    Qc = Qm.min(dim=1).values
    sel = lv & (Qm == Qc[:, None])
    if hnj:
        dmask = torch.where(sel, Dr, big)
        sel = sel & (dmask == torch.cummin(dmask, dim=1).values)
    Pc = torch.where(sel, cols[None, :], -1).max(dim=1).values
    return Qc, Pc.clamp_min(0)


def _seed0(Q, m: int, idx):
    """The initial minQ seed: the last row 1..m-1 at the smallest Q."""
    if m <= 1:
        return idx.new_zeros(1)
    qrows = Q[1:m]
    return torch.where(qrows == qrows.min(), idx[1:m], -1).max().view(1)


def _init_caches(D, m: int, hnj: bool):
    """initSummaD (nj.c:111-180) and the per-row caches, in row chunks:
    Q minima with the initHNJ tie rule (hclust.c:56-130) if `hnj`, else
    raw-distance minima (initDmin, hclust.c:205-277; last-wins); plus
    the initial minQ seed (hclust.c:353-381).  D is (n, n) with n >= m
    and is only read.  Returns (sD, N, Q, P, seed): (n,) vectors (N and
    P int32) and the (1,) int64 seed row."""
    n, dtype, dev = D.shape[0], D.dtype, D.device
    big = _big(dtype)
    idx = torch.arange(n, device=dev)
    sD = torch.zeros(n, dtype=dtype, device=dev)
    N = torch.ones(n, dtype=torch.int32, device=dev)
    Q = torch.full((n,), big, dtype=dtype, device=dev)
    P = torch.zeros(n, dtype=torch.int32, device=dev)
    cols = idx[:m]
    for r0, r1 in _row_chunks(m):
        Dr = D[r0:r1, :m]
        v = (Dr >= 0) & (idx[r0:r1, None] != cols[None, :])
        # cumsum keeps the C's left-to-right order (initSummaD) where
        # the device's cumsum is sequential; see the module docstring
        sD[r0:r1] = torch.cumsum(torch.where(v, Dr, 0), dim=1)[:, -1]
        N[r0:r1] = 1 + v.sum(dim=1)
    for r0, r1 in _row_chunks(m):
        Dr = D[r0:r1, :m]
        lv = (Dr >= 0) & (cols[None, :] < idx[r0:r1, None])
        if hnj:
            coef = ((N[r0:r1, None] + N[None, :m] - 4) >> 1).to(dtype)
            Qm = torch.where(lv, coef * Dr - sD[r0:r1, None]
                             - sD[None, :m], big)
        else:
            Qm = torch.where(lv, Dr, big)
        Q[r0:r1], P[r0:r1] = _row_minima(Dr, Qm, lv, cols, big, hnj)
    return sD, N, Q, P, _seed0(Q, m, idx)


def _dnj_init(D, m: int):
    """initSummaD + initHNJ + initial minQ seed (nj.c:111-180,
    hclust.c:56-130,353-381); see `_init_caches`."""
    return _init_caches(D, m, hnj=True)


def _ltd_row_of(k, j: int):
    """Row r of the ltd flat cell f = off(j) + k (k > j): the largest r
    with r(r-1)/2 <= f.  The float32 sqrt estimate is fixed up with the
    division-form predicate (r-j) <= 2k // (r+j-1), which never forms
    the O(n^2) product."""
    f_f = k.to(torch.float32) + float(np.float32(j) * np.float32(j - 1)
                                      / np.float32(2))
    r0 = torch.floor((1.0 + torch.sqrt(8.0 * f_f + 1.0)) / 2.0).long()
    two_k = 2 * k
    best = torch.full_like(k, j + 1)  # off(j+1) <= off(j)+k always (k > j)
    for d in range(5):
        cand = (r0 - 2 + d).clamp_min(j + 1)
        ok = (cand - j) <= two_k // (cand + j - 1).clamp_min(1)
        best = torch.where(ok, torch.maximum(best, cand), best)
    return best


def _walker_targets(adv, i: int, j: int, idx):
    """Targets of the sD/N walker updates (nj.c:836-1044): the C's
    pointer walkers do not advance past both-missing cells, so cell k's
    update lands in a walker slot (shifted down), not in k: row slots
    0.. for k < j, then the skip-j advance, the skip-i advance, column
    slots.  Cells that do not advance target j, which the caller
    overwrites right after the scatter; all other targets are
    distinct."""
    adv_r = adv & (idx < j)
    adv_c = adv & (idx > j)
    wpos = torch.cumsum(adv_r, 0) - 1
    prevc = torch.cumsum(adv_c, 0) - adv_c.long()
    tgt = torch.where(adv_r, wpos,
                      adv_r.sum() + 1 + (idx > i).long() + prevc)
    return torch.where(adv, tgt, j), adv_c


def _update_d_exact(D, sD, N, i: int, j: int, Li: float, Lj: float,
                    m_t: int, idx, exact=None):
    """updateD (nj.c:836-1044) with the reference's exact bookkeeping,
    in place on the m_t active taxa:

    * the sD/N updates target walker slots (`_walker_targets`);
    * the column-part one-sided D_kj branch reads the out-of-row ltd
      cell D->mat[j][k] (nj.c:1022): "garbage" that may alias a cell
      stored earlier in the same sweep; its sD[j] contribution is
      (stored - garbage), not the stored value.

    Returns (valid_k, newD): the mask of the cells k != i, j and the
    updated row j with -1 outside it.  `exact`, if given, is the flag of
    `track_sums`, and-ed with the exactness of the sum of row j.
    """
    idx = idx[:m_t]
    D_ik = D[i, :m_t]
    D_kj = D[j, :m_t]
    valid_k = torch.ones(m_t, dtype=torch.bool, device=D.device)
    valid_k[i] = False
    valid_k[j] = False
    vi = D_ik >= 0
    vj = D_kj >= 0
    both = valid_k & vi & vj
    only_i = valid_k & vi & ~vj
    only_j = valid_k & ~vi & vj
    d2 = ((D_ik + D_kj - D_ik[j]) / 2).clamp_min(0.0)
    # both-missing valid cells fall through to D_kj: unchanged, exactly
    # the C's no-store
    stored = torch.where(both, d2,
                         torch.where(only_i, D_ik - Li,
                                     torch.where(only_j, D_kj - Lj, D_kj)))
    adv = both | only_i | only_j
    tgt, adv_c = _walker_targets(adv, i, j, idx)

    # out-of-row garbage read for column only_j (nj.c:1020-1037)
    kk = idx.clamp_min(j + 1)
    r = _ltd_row_of(kk, j)
    c = kk - (r - j) * (r + j - 1) // 2
    seen = (r < idx) & (r != i)  # stored earlier in this column sweep
    garb_cj = torch.where(r == idx, stored,
                          torch.where(adv_c[r] & seen, stored[r],
                                      D[:m_t, j][r]))
    garb = torch.where(c == j, garb_cj, D[r, c])
    krow = idx < j
    contrib = torch.where(only_j & ~krow, stored - garb, stored)

    sd_delta = torch.where(both, -(D_ik + D_kj - d2),
                           torch.where(only_i, -Li,
                                       torch.where(only_j & krow, -Lj,
                                                   contrib)))
    sD.index_add_(0, tgt, torch.where(adv, sd_delta, 0))
    N.index_add_(0, tgt, (both | only_j).to(torch.int32).neg())
    # row/col j rebuild (C accumulation order = ascending k)
    summand = torch.where(adv, contrib, 0)
    if exact is not None:
        exact &= sums_exact(summand)
    sD[j] = torch.cumsum(summand, 0)[-1]
    N[j] = 1 + adv.sum()
    newrow = torch.where(valid_k, stored, D_kj)
    D[j, :m_t] = newrow
    D[:m_t, j] = newrow
    return valid_k, torch.where(valid_k, stored, -1.0)


def _limb_lengths(D_ij, sDi, sDj, Ni: int, Nj: int, neg_limbs: bool, f):
    """limbLength / limbLengthNeg (nj.c:42-109) in the precision of the
    numpy scalar type `f`; Ni, Nj are N - 2."""
    D_ij, sDi, sDj = f(D_ij), f(sDi), f(sDj)
    if Ni > 0 and Nj > 0:
        delta = (sDi - D_ij) / f(Ni) - (sDj - D_ij) / f(Nj)
        Li, Lj = (D_ij + delta) / f(2), (D_ij - delta) / f(2)
    elif Ni > 0:
        Li, Lj = f(0), D_ij
    elif Nj > 0:
        Li, Lj = D_ij, f(0)
    else:
        Li = Lj = D_ij / f(2)
    if not neg_limbs:
        if Li < 0:
            Li, Lj = f(0), D_ij
        elif Lj < 0:
            Li, Lj = D_ij, f(0)
    return float(Li), float(Lj)


def _limbs(D, sD, N, i: int, j: int, neg_limbs: bool, st=None, t=0):
    """Limb lengths of the pair (i, j) from the pre-update state: one
    host read of D_ij, sD and N of both rows (all exact in float64).
    With a state `st` whose exact range is tracked (`track_sums`), its
    flag comes in the same read; join t raises InexactSums if a row sum
    before it was not exact."""
    vals = [D[i, j].double(), sD[i].double(), sD[j].double(),
            N[i].double(), N[j].double()]
    if st is not None and "exact" in st:
        vals.append(st["exact"].double())
    vals = torch.stack(vals).tolist()
    if len(vals) > 5 and not vals[5]:
        raise InexactSums(t)
    return _limb_lengths(vals[0], vals[1], vals[2], int(vals[3]) - 2,
                         int(vals[4]) - 2, neg_limbs, _np_float(D.dtype))


# ---------------------------------------------------------------------
# minQpair (dnj.c:43-128): the seeded scan of the cached row minima


def _scan_start(Q, P, seed, big):
    """Running minimum and pair to start a scan from: the seed row's
    cache if it has one.  (1,) tensors."""
    Qs = Q[seed]
    seed_ok = (seed != 0) & (Qs != big)
    return (torch.where(seed_ok, Qs, big), torch.where(seed_ok, seed, 0),
            torch.where(seed_ok, P[seed].long(), 0))


def _seq_scan(row_q, Q, P, seed, m_t: int, idx, big):
    """minQpair's descending one-row-at-a-time revalidation; one host
    read per visited row.  Returns the pair (i, j) as integers."""
    minv, pi, pj = _scan_start(Q, P, seed, big)
    cur = m_t - 1
    while cur >= 1:
        candm = Q[1:cur + 1] < minv
        i = int(torch.where(candm, idx[1:cur + 1], -1).max())
        if i < 1:
            break
        newq, newp = _last_min(row_q(i), idx[:i])
        Q[i] = newq
        P[i] = newp
        better = newq < minv
        minv = torch.where(better, newq, minv)
        pi = torch.where(better, i, pi)
        pj = torch.where(better, newp, pj)
        cur = i - 1
    return tuple(torch.cat([pi, pj]).tolist())


def _batch_scan(block_q, Q, P, seed, m_t: int, idx, big, stats=None):
    """Fused candidate-row revalidation: all rows whose cached bound
    beats the running min are recomputed KBATCH at a time as one (K,
    m_t) block (`block_q(rows)` gives their Q values, big where
    invalid); the set shrinks every pass (fresh rows can't re-qualify:
    the running min absorbs their new row minima).  One host read per
    pass: the candidate count and the pair so far.  `stats` ((2,)
    int64), if given, adds the passes and the rows whose cache a pass
    rewrote.  Returns (i, j)."""
    minv, pi, pj = _scan_start(Q, P, seed, big)
    while True:
        cm = Q[1:m_t] < minv
        cnt, i, j = torch.cat([cm.sum().view(1), pi, pj]).tolist()
        if cnt == 0:
            return i, j
        # the min(cnt, KBATCH) largest candidate rows, descending
        r = topk_mask_indices(cm, idx[1:m_t], min(cnt, KBATCH)).long()
        q = block_q(r)
        rmin = q.min(dim=1).values
        rarg = torch.where(q == rmin[:, None], idx[None, :m_t], -1) \
            .max(dim=1).values
        # C-exact cache gating: minQpair's descending sweep
        # (dnj.c:43-128) recomputes row i iff its cached Q beats the
        # running min rm at the visit.  Because a fresh row minimum can
        # never be below its cached lower bound, min(rm, newQ[i]) is a
        # no-op exactly when the C skips row i, so rm threads through
        # skipped rows as a plain shifted prefix-min of (minv, fresh
        # minima of larger rows), and the C's revalidated set is
        # recovered in one fused pass.  Rows outside it keep their
        # stale caches.
        rm = torch.cummin(torch.cat([minv, rmin[:-1]]), dim=0).values
        Qr = Q[r]
        reval = Qr < rm
        Q[r] = torch.where(reval, rmin, Qr)
        P[r] = torch.where(reval, rarg.to(P.dtype), P[r])
        if stats is not None:
            stats[0] += 1
            stats[1] += reval.sum()
        # pair update: strict improvement, largest row wins a tie (the
        # C scan visits rows descending and requires newq < running
        # min, so the largest row locks an equal min first)
        bmin = rmin.min()
        atmin = rmin == bmin
        bi = torch.where(atmin, r, -1).max()
        karg = torch.where(atmin & (r == bi), rarg, 0).max()
        better = bmin < minv
        minv = torch.where(better, bmin, minv)
        pi = torch.where(better, bi, pi)
        pj = torch.where(better, karg, pj)


def _repair_rows(qc, ok, Q, P, s: slice, c: int, Qc, idx, big):
    """Cache repair of the rows `s` that see a fresh cell in column c
    (updateDNJ dnj.c:607-710, DNJ_popArrange dnj.c:817-975): their Q
    values qc through that cell (valid where `ok`) replace the cached
    minima they tie or beat.  Returns the row to chain the next seed
    from, (1,) int64: the last row at the smallest replaced value if
    that ties or beats row c's own cache Qc, else c."""
    Qs = Q[s]
    upd = ok & (qc <= Qs)
    Q[s] = torch.where(upd, qc, Qs)
    P[s] = torch.where(upd, c, P[s])
    mq = torch.where(upd, qc, big).min()
    hit = torch.where(upd & (qc == mq), idx[s], -1).max()
    return torch.where(upd.any() & (mq <= Qc), hit, c).view(1)


def _chain_seed(Q, mi, mj, last: int):
    """Seed chaining (dnj.c:1026-1032) from the two repair candidates."""
    Qmj, Qmi = Q[mj], Q[mi]
    return torch.where(
        mj == last, mi,
        torch.where(mi == last, mj,
                    torch.where((Qmj < Qmi) | ((mi < mj) & (Qmj == Qmi)),
                                mj, mi)))


def _no_pair(st, t: int, last: int, big):
    """Record "no joinable pair left" (missing-data early stop,
    dnj.c:1009): I = J = 0, LI = LJ = -1."""
    st["I"][t] = st["J"][t] = 0
    st["LI"][t] = st["LJ"][t] = -1.0
    if "Q" in st:
        st["Q"][last] = big
        st["seed"] = torch.zeros_like(st["seed"])


def _record(st, t: int, i: int, j: int, Li: float, Lj: float):
    st["I"][t], st["J"][t], st["LI"][t], st["LJ"][t] = i, j, Li, Lj


def _row_q(D, sD, N, i: int, big):
    """Q over row i's smaller partners; big where the cell is missing."""
    drow = D[i, :i]
    c = ((N[i] + N[:i] - 4) >> 1).to(D.dtype)
    return torch.where(drow >= 0, c * drow - sD[i] - sD[:i], big)


def _col_q(D, sD, N, c: int, s: slice):
    """Q of the rows `s` through their cell in column c, and where that
    cell is present."""
    dcol = D[s, c]
    coef = ((N[c] + N[s] - 4) >> 1).to(D.dtype)
    return coef * dcol - sD[c] - sD[s], dcol >= 0


def _move_last(D, sD, N, i: int, m_t: int):
    """popArrange data movement (matrix.c:518-602): the last row into
    slot i; the caller has checked i != last."""
    last = m_t - 1
    newrow = D[last, :m_t].clone()
    newrow[i] = 0.0
    newrow[last] = -1.0
    D[i, :m_t] = newrow
    D[:m_t, i] = newrow
    sD[i] = sD[last]
    N[i] = N[last]


def _one_join(st, t: int, m: int, neg_limbs: bool, scan: str, stats=None):
    """Join t of the DNJ loop on the state `st`, in place; `stats` as in
    `_batch_scan`."""
    D, sD, N, Q, P, idx = (st[k] for k in ("D", "sD", "N", "Q", "P", "idx"))
    dtype = D.dtype
    big = _big(dtype)
    m_t = m - t
    last = m_t - 1

    def block_q(r):
        Dr = D[r, :m_t]
        c = ((N[r][:, None] + N[None, :m_t] - 4) >> 1).to(dtype)
        q = c * Dr - sD[r][:, None] - sD[None, :m_t]
        return torch.where((idx[None, :m_t] < r[:, None]) & (Dr >= 0), q,
                           big)

    # ---- minQpair(seed) (dnj.c:43-128)
    if scan == "seq":
        i, j = _seq_scan(lambda r: _row_q(D, sD, N, r, big), Q, P,
                         st["seed"], m_t, idx, big)
    else:
        i, j = _batch_scan(block_q, Q, P, st["seed"], m_t, idx, big, stats)
    if i == 0 and j == 0:
        return _no_pair(st, t, last, big)

    Li, Lj = _limbs(D, sD, N, i, j, neg_limbs, st, t)
    _record(st, t, i, j, Li, Lj)
    _update_d_exact(D, sD, N, i, j, Li, Lj, m_t, idx, st.get("exact"))

    # ---- updateDNJ cache repair + mi candidate (dnj.c:607-710)
    Qj, Pj = _row_cache(_row_q(D, sD, N, j, big), idx, big)
    Q[j] = Qj
    P[j] = Pj
    s = slice(j + 1, m_t)
    qc, ok = _col_q(D, sD, N, j, s)
    ok[i - j - 1] = False  # row i leaves with this join
    mi_cand = _repair_rows(qc, ok, Q, P, s, j, Qj, idx, big)

    # ---- DNJ_popArrange (dnj.c:817-975): move last into slot i
    if i != last:
        _move_last(D, sD, N, i, m_t)
        Qi, Pi = _row_cache(_row_q(D, sD, N, i, big), idx, big)
        Q[i] = Qi
        P[i] = Pi
        mj_cand = idx.new_full((1,), i)
        if i + 1 < last:  # rows i < k < last see cell (k, i)
            s2 = slice(i + 1, last)
            qc2, ok2 = _col_q(D, sD, N, i, s2)
            mj_cand = _repair_rows(qc2, ok2, Q, P, s2, i, Qi, idx, big)
    else:
        mj_cand = idx.new_zeros(1)
    Q[last] = big
    st["seed"] = _chain_seed(Q, mi_cand, mj_cand, last)


def _records(n: int, dtype):
    f = _np_float(dtype)
    return {"I": np.zeros(n, np.int32), "J": np.zeros(n, np.int32),
            "LI": np.zeros(n, f), "LJ": np.zeros(n, f)}


def _dnj_segment(st, t0: int, t1: int, m: int, neg_limbs=False,
                 scan="batch"):
    """Joins [t0, t1) of the plain DNJ loop, in place on `st` (its
    records may be host arrays, as `state_from_numpy` gives them)."""
    for t in range(t0, t1):
        _one_join(st, t, m, neg_limbs, scan)
    return st


def _run_segment(st, t0: int, t1: int, m: int, neg_limbs=False, prep=None):
    """Joins [t0, t1) on the state `st` of `_new_state` through
    `dnj_segment_float` (`prep` from its prepare on the same state), then
    one host read: raises InexactSums at the join where the segment
    stopped."""
    segment_float.dnj_segment_float(
        *(st.get(k) for k in segment_float.STATE_KEYS), t0, t1, m,
        neg_limbs, prep=prep)
    t = int(st["first_inexact"])
    if t >= 0:
        raise InexactSums(t)
    return st


def _new_state(D, m: int) -> dict:
    """The DNJ state of the m active taxa of D before the first join, its
    records on D's device."""
    sD, N, Q, P, seed = _dnj_init(D, m)
    n, dev = D.shape[0], D.device
    return {"D": D, "sD": sD, "N": N, "Q": Q, "P": P, "seed": seed,
            "idx": torch.arange(n, device=dev),
            "I": torch.zeros(n, dtype=torch.int32, device=dev),
            "J": torch.zeros(n, dtype=torch.int32, device=dev),
            "LI": torch.zeros(n, dtype=D.dtype, device=dev),
            "LJ": torch.zeros(n, dtype=D.dtype, device=dev),
            "first_inexact": torch.full((1,), -1, dtype=torch.int32,
                                        device=dev),
            "stats": torch.zeros(2, dtype=torch.int64, device=dev)}


def dnj_joins(D, m: int, neg_limbs=False, scan="batch", exact_sums=False):
    """Run all m-2 DNJ joins on the device of D, in place.

    D: (n, n) square distance matrix (missing < 0, diagonal 0), n >= m;
    m: active count.  Returns (I, J, LI, LJ, d_last, D): host arrays of
    join records and the last pair's distance; records with I == J == 0
    mean "no joinable pair left" (missing-data early stop, dnj.c:1009).

    scan="batch": one `dnj_segment_float` call per segment (on the card
    the kernel, one launch and one host read a segment; on CPU tensors
    the plain loop); its scan recomputes candidate rows (cached Q <
    running min) in fused blocks and is trajectory-exact, ties included:
    a shifted prefix-min recovers the C's running min at every row
    visit, so exactly the rows minQpair would recompute get fresh caches
    (see `_batch_scan`), and batches are taken in the C's descending row
    order.  scan="seq" runs the plain loop with minQpair's sequential
    descending row revalidation, cycle for cycle.  The records reach the
    host once, at the end.  While tracing is on (utils/timing.py) the
    batch scan's passes are added to the counter `tree/scan_passes`.

    exact_sums: track the exact range (`track_sums`) and raise
    InexactSums at the first join whose picks or limbs could read a row
    sum that is not exact (the sums of the last join feed none).
    """
    if scan not in ("seq", "batch"):
        raise ValueError(f"scan must be seq or batch, not {scan!r}")
    m = int(m)
    with timing.phase("tree/init"):
        st = _new_state(D, m)
        if exact_sums:
            track_sums(st, m)
        prep = segment_float.dnj_segment_float_prepare(
            *(st.get(k) for k in segment_float.STATE_KEYS), m) \
            if scan == "batch" and D.is_cuda and m > 2 else None
    if scan == "seq":
        def seg(st, t0, t1):
            return _dnj_segment(st, t0, t1, m, neg_limbs, "seq")
    else:
        def seg(st, t0, t1):
            return _run_segment(st, t0, t1, m, neg_limbs, prep)
    run_segmented(seg, st, max(m - 2, 0))
    with timing.phase("tree/records"):
        if scan == "batch" and timing.enabled():
            timing.count("tree/scan_passes", int(st["stats"][0]))
        return (_host(st["I"]), _host(st["J"]), _host(st["LI"]),
                _host(st["LJ"]), float(D[1, 0]), D)


# ---------------------------------------------------------------------
# quantized storage: u16 (as int16 bit patterns) or u8 cells


def _qmax(store) -> int:
    return 255 if store == torch.uint8 else 65535


def _inv(bytescale: float, dtype) -> float:
    """1 / ByteScale, rounded in the compute precision."""
    f = _np_float(dtype)
    return float(f(1) / f(bytescale))


def _deq(q, dtype, inv: float):
    """Cells -> distances in `dtype`."""
    if q.dtype == torch.int16:
        q = q.to(torch.int32) & 0xFFFF
    return q.to(dtype) * inv


def _quant(d, bs: float, rnd: float, store):
    """dtouc(d, rnd) = (uint)(d*ByteScale + rnd): C float->uint
    truncation; clamped instead of wrapping (complete matrices with a
    sane ByteScale never reach the cap)."""
    v = torch.floor(d * bs + rnd).clamp(0, _qmax(store)).to(torch.int32)
    if store == torch.int16:
        v = ((v + 0x8000) & 0xFFFF) - 0x8000  # the u16 value's bit pattern
    return v.to(store)


def quant_cells(Dq: np.ndarray) -> torch.Tensor:
    """A uint16 or uint8 host matrix as the engine's cell tensor (u16 as
    int16 bit patterns), on the CPU."""
    if Dq.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(Dq).view(np.int16))
    if Dq.dtype != np.uint8:
        raise ValueError(f"cells must be uint16 or uint8, not {Dq.dtype}")
    return torch.from_numpy(np.ascontiguousarray(Dq))


def _dnj_init_q(Dq, m: int, bytescale: float, compute_dtype):
    """Quantized-engine init (complete matrix: N_k = m every row).
    Returns (sD, Q, P, seed)."""
    n, dev, dtype = Dq.shape[0], Dq.device, compute_dtype
    big = _big(dtype)
    inv = _inv(bytescale, dtype)
    idx = torch.arange(n, device=dev)
    sD = torch.zeros(n, dtype=dtype, device=dev)
    Q = torch.full((n,), big, dtype=dtype, device=dev)
    P = torch.zeros(n, dtype=torch.int32, device=dev)
    cols = idx[:m]
    for r0, r1 in _row_chunks(m):
        Dr = _deq(Dq[r0:r1, :m], dtype, inv)
        v = idx[r0:r1, None] != cols[None, :]
        sD[r0:r1] = torch.cumsum(torch.where(v, Dr, 0), dim=1)[:, -1]
    for r0, r1 in _row_chunks(m):
        Dr = _deq(Dq[r0:r1, :m], dtype, inv)
        lv = cols[None, :] < idx[r0:r1, None]
        Qm = torch.where(lv, (m - 2) * Dr - sD[r0:r1, None]
                         - sD[None, :m], big)
        Q[r0:r1], P[r0:r1] = _row_minima(Dr, Qm, lv, cols, big)
    return sD, Q, P, _seed0(Q, m, idx)


def _one_join_q(st, t: int, m: int, bytescale: float, neg_limbs: bool):
    """Join t of the quantized engine on `st`, in place.  Complete
    matrix: N_k = m_t for every row, so the Q coefficient is a scalar
    (m_t - 2 before updateD, m_t - 3 after its N decrement, matching
    updateDNJ, dnj.c:607+)."""
    Dq, sD, Q, P, idx = (st[k] for k in ("Dq", "sD", "Q", "P", "idx"))
    dtype = sD.dtype
    big = _big(dtype)
    inv = _inv(bytescale, dtype)
    m_t = m - t
    last = m_t - 1

    def block_q(r):
        q = (m_t - 2) * _deq(Dq[r, :m_t], dtype, inv) - sD[r][:, None] \
            - sD[None, :m_t]
        return torch.where(idx[None, :m_t] < r[:, None], q, big)

    i, j = _batch_scan(block_q, Q, P, st["seed"], m_t, idx, big)
    if i == 0 and j == 0:
        return _no_pair(st, t, last, big)

    rowi = _deq(Dq[i, :m_t], dtype, inv)
    rowj = _deq(Dq[j, :m_t], dtype, inv)
    vals = [rowi[j], sD[i], sD[j]]
    if "exact" in st:
        vals.append(st["exact"].to(dtype))
    D_ij, sDi, sDj, *ok = torch.stack(vals).tolist()
    if ok and not ok[0]:
        raise InexactSums(t)
    Li, Lj = _limb_lengths(D_ij, sDi, sDj, m_t - 2, m_t - 2, neg_limbs,
                           _np_float(dtype))
    _record(st, t, i, j, Li, Lj)

    # updateD, complete-matrix both-path only (nj.c:893-948): sD
    # bookkeeping on the unquantized updates (nj.c:907-911), later reads
    # see the quantized cells
    valid_k = torch.ones(m_t, dtype=torch.bool, device=Dq.device)
    valid_k[i] = False
    valid_k[j] = False
    d_new = ((rowi + rowj - D_ij) / 2).clamp_min(0.0)
    sa = sD[:m_t]
    sa.copy_(torch.where(valid_k, sa - (rowi + rowj - d_new), sa))
    summand = torch.where(valid_k, d_new, 0)
    if "exact" in st:
        st["exact"] &= sums_exact(summand)
    sD[j] = torch.cumsum(summand, 0)[-1]
    cells = torch.where(valid_k, _quant(d_new, bytescale, 0.25, Dq.dtype),
                        Dq[j, :m_t])
    Dq[j, :m_t] = cells
    Dq[:m_t, j] = cells

    # cache repair for the fresh row j and column j
    qj = (m_t - 3) * _deq(cells, dtype, inv) - sD[j] - sa
    Qj, Pj = _row_cache(qj[:j], idx, big)
    Q[j] = Qj
    P[j] = Pj
    s = slice(j + 1, m_t)
    mi_cand = _repair_rows(qj[s], valid_k[s], Q, P, s, j, Qj, idx, big)

    # popArrange: move last into slot i
    if i != last:
        cells = Dq[last, :m_t].clone()
        cells[i] = 0
        Dq[i, :m_t] = cells
        Dq[:m_t, i] = cells
        sD[i] = sD[last]
        qi = (m_t - 3) * _deq(cells, dtype, inv) - sD[i] - sa
        Qi, Pi = _row_cache(qi[:i], idx, big)
        Q[i] = Qi
        P[i] = Pi
        mj_cand = idx.new_full((1,), i)
        if i + 1 < last:
            s2 = slice(i + 1, last)
            mj_cand = _repair_rows(qi[s2], torch.ones_like(valid_k[s2]),
                                   Q, P, s2, i, Qi, idx, big)
    else:
        mj_cand = idx.new_zeros(1)
    Q[last] = big
    st["seed"] = _chain_seed(Q, mi_cand, mj_cand, last)


def _dnj_segment_q(st, t0: int, t1: int, m: int, bytescale: float,
                   neg_limbs=False):
    """Joins [t0, t1) of the quantized engine, in place on `st`."""
    for t in range(t0, t1):
        _one_join_q(st, t, m, bytescale, neg_limbs)
    return st


def dnj_joins_q(Dq, m: int, bytescale: float, neg_limbs=False,
                compute_dtype=torch.float32, exact_sums=False):
    """Quantized-storage DNJ: D lives on the device as u16 (int16 bit
    patterns, see `quant_cells`) or u8 cells with the reference's
    ByteScale quantization (bytescale.h:22-23), compute in
    `compute_dtype`: a half or a quarter of float32 state's memory per
    cell.

    The matrix must be complete (the reference's quantized modes cannot
    represent missing cells either: dtouc of a negative wraps,
    matrix.h:23-33 storage + bytescale.h macros).  Updates quantize
    exactly like the C: the both-sides updateD path stores
    trunc(d*scale + 0.25) (nj.c:905); sD bookkeeping uses the
    unquantized update values (nj.c:907-911), later reads see the
    quantized cells.  The scan is the batch scan of `dnj_joins`.
    Returns (I, J, LI, LJ, d_last, Dq), as `dnj_joins`; exact_sums as
    there.
    """
    if Dq.dtype not in (torch.int16, torch.uint8):
        raise ValueError(f"cells must be int16 (u16 bit patterns) or "
                         f"uint8, not {Dq.dtype}")
    m = int(m)
    n = Dq.shape[0]
    bytescale = float(bytescale)
    with timing.phase("tree/init"):
        sD, Q, P, seed = _dnj_init_q(Dq, m, bytescale, compute_dtype)
        st = {"Dq": Dq, "sD": sD, "Q": Q, "P": P, "seed": seed,
              "idx": torch.arange(n, device=Dq.device),
              **_records(n, compute_dtype)}
        if exact_sums:
            inv = _inv(bytescale, compute_dtype)
            track_sums(st, m, lambda r0, r1: _deq(Dq[r0:r1, :m],
                                                  compute_dtype, inv))
    run_segmented(
        lambda st, t0, t1: _dnj_segment_q(st, t0, t1, m, bytescale,
                                          neg_limbs),
        st, max(m - 2, 0))
    with timing.phase("tree/records"):
        d_last = float(_deq(Dq[1, 0], compute_dtype,
                            _inv(bytescale, compute_dtype)))
    return st["I"], st["J"], st["LI"], st["LJ"], d_last, Dq


# ---------------------------------------------------------------------


def state_from_numpy(d, device) -> dict:
    """Engine state from a mapping of the JAX float, quantized or hclust
    engine's state names (D or Dq, sD, N, Q, P, seed, I, J, LI, LJ) to
    numpy arrays; names the mapping lacks are left out."""
    st = {}
    for k in ("D", "sD", "Q"):
        if k in d:
            st[k] = torch.from_numpy(np.array(d[k])).to(device)
    if "Dq" in d:
        st["Dq"] = quant_cells(np.array(d["Dq"])).to(device)
    for k in ("N", "P"):
        if k in d:
            st[k] = torch.from_numpy(np.array(d[k], np.int32)).to(device)
    if "seed" in d:
        st["seed"] = torch.tensor([int(d["seed"])], dtype=torch.long,
                                  device=device)
    for k in ("I", "J"):
        st[k] = np.array(d[k], np.int32)
    for k in ("LI", "LJ"):
        st[k] = np.array(d[k])
    st["idx"] = torch.arange(len(st["I"]), device=device)
    return st


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _records_to_newick(I, J, LI, LJ, d_last, n, names, flag, precision):
    """Shared host-side Newick assembly from the join records."""
    I = _host(I)
    J = _host(J)
    m = n
    for t in range(max(n - 2, 0)):
        i, j = int(I[t]), int(J[t])
        if i == 0 and j == 0:
            break  # no joinable pair left (missing data)
        form_node(names[j], names[i], float(LJ[t]), float(LI[t]),
                  precision)
        m -= 1
        names[i], names[m] = names[m], names[i]
    last = form_last_bi_node if (flag & 1) else form_last_node
    if m == 2:
        last(names[0], names[1], float(d_last), precision)
    else:
        while m > 1:
            m -= 1
            last(names[0], names[m], -1.0, precision)
    byteshift_fix(names[0])
    return names[0].data


def square_matrix(flat64: np.ndarray, n: int, fill: float = -1.0):
    """The (n, n) float64 host matrix of a loaded ltd matrix, diagonal
    0: row i's cells 0..i-1 copied from the flat triangle, then mirrored
    into the upper triangle a (_TILE, _TILE) tile at a time.  Contiguous
    copies only: scattering through the n(n-1)/2 index pairs of
    np.tril_indices takes a minute and more at n = 32768."""
    D = np.full((n, n), fill, np.float64)
    flat = np.asarray(flat64, np.float64)
    at = 0
    for i in range(1, n):
        D[i, :i] = flat[at:at + i]
        at += i
    for r0 in range(0, n, _TILE):
        r1 = min(r0 + _TILE, n)
        for c0 in range(0, r0, _TILE):
            D[c0:c0 + _TILE, r0:r1] = D[r0:r1, c0:c0 + _TILE].T
        tile = D[r0:r1, r0:r1]
        up = np.triu_indices(r1 - r0, 1)
        tile[up] = tile.T[up]
    np.fill_diagonal(D, 0.0)
    return D


def build_tree_q(flat64: np.ndarray, n: int, names: list,
                 flag: int = 0, precision: int = 9,
                 bytescale: float = 1.0, store: str = "u16",
                 compute_dtype=torch.float32, device=None,
                 exact_sums=False) -> bytes:
    """Device DNJ with quantized (u16/u8 ByteScale) matrix storage;
    Newick bytes (no ';').

    Loads quantize like loadPhy -s/-b (round 0.5, phy.c:473-475);
    requires a complete matrix (no negative cells).  Spans (see
    `build_tree_float`): tree/quantize, tree/square, tree/upload,
    tree/engine, tree/newick."""
    dev = default_device() if device is None else torch.device(device)
    npdt = {"u16": np.uint16, "u8": np.uint8}[store]
    with timing.phase("tree/quantize"):
        qv = np.floor(np.asarray(flat64, np.float64) * bytescale + 0.5)
        qv = np.clip(qv, 0, np.iinfo(npdt).max)
    with timing.phase("tree/square"):
        Dq = square_matrix(qv, n, 0.0).astype(npdt)
    with timing.phase("tree/upload"):
        Dq = quant_cells(Dq).to(dev)
    with timing.phase("tree/engine"):
        I, J, LI, LJ, d_last, _ = dnj_joins_q(
            Dq, n, bytescale, neg_limbs=bool(flag & 2),
            compute_dtype=compute_dtype, exact_sums=exact_sums)
    with timing.phase("tree/newick"):
        return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                                  precision)


def build_tree_float(flat64: np.ndarray, n: int, names: list,
                     flag: int = 0, precision: int = 9,
                     dtype=torch.float32, scan: str = "batch",
                     device=None, exact_sums=False) -> bytes:
    """Device DNJ over a loaded ltd matrix; Newick bytes (no ';').

    Its spans (utils/timing.py), in order: tree/square (the host's
    square matrix), tree/upload (its copy to the device), tree/engine
    (`dnj_joins`: tree/init, a tree/segment per segment, tree/records,
    the records' copy to the host) and tree/newick."""
    dev = default_device() if device is None else torch.device(device)
    with timing.phase("tree/square"):
        D = square_matrix(flat64, n)
    with timing.phase("tree/upload"):
        D = torch.from_numpy(D).to(dev, dtype)
    with timing.phase("tree/engine"):
        I, J, LI, LJ, d_last, _ = dnj_joins(
            D, n, neg_limbs=bool(flag & 2), scan=scan,
            exact_sums=exact_sums)
    with timing.phase("tree/newick"):
        return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                                  precision)
