"""Device engines for the heuristic/UPGMA join family (counterpart of
tree/hclust_engine.py).

Device-resident counterparts of the reference's hclust machinery
(hclust.c:56-1720, dnj.c:217-293, nj.c:297-362), sharing the skeleton
of tree/torch_engine.py: state on the torch device updated in place, a
host-driven join loop under tree/segmenting.py, the picked pair read to
the host once per join (once per pass of a scan), limbs on the host:

  mode 'd' (upgma, ff)  -- per-row raw-distance caches (initDmin,
      hclust.c:205-277) revalidated by UPGMApair's descending scan
      (dnj.c:217-293; only rows marked stale P < 0 recompute), update
      rules updateUPGMA / updateFF (hclust.c:665-1100),
      UPGMA_popArrange (hclust.c:1559-1669), DNJ-style seed chaining.
  mode 'h' (cf, hnj)    -- global cache pick minQ (hclust.c:353-381),
      update rules updateCF (hclust.c:1102-1306) / updateHNJ
      (hclust.c:452-561, incl. updatePrevQ hclust.c:413-450),
      UPGMA_/HNJ_popArrange.
  mode 'e' (nj, mn)     -- full masked Q scan per join (initQ
      nj.c:182-247 with its ``min > 1.0`` early-out; initQ_MN
      nj.c:297-362 max variant), updateD (nj.c:836-1044), plain
      compaction (matrix.c:518-602).

All tie rules ("last-wins" ``<=`` scans, UPGMApair's running min, the
update trackers' ``min <= dist`` running max) reproduce the host exact
engine (tree/exact.py): with float64 compute the join records are
bit-identical to it, and to the JAX engine's, on integer (SNP-pipeline)
distances while every value stays within the mantissa (see the
exactness note of tree/torch_engine.py); missing cells (D < 0) are
fully supported, including the non-advancing sD/N walker and the
nj.c:1022 garbage read (torch_engine._update_d_exact).

Float-data scope: the device's reductions are not the C's sequential
sums, so on non-integer matrices sD carries ulp differences that can
flip exact Q ties.  upgma and cf pick on raw distances and follow the
host engine's picks there; ff can differ in a limb's last printed
digit; hnj and nj can flip tied picks, as the device DNJ engine can;
mn joins the largest Q first, which drives the updated distances of a
complete matrix to 0; the row sums are then rounding noise, and the
order of the sums decides the picks (tests/test_torch_hclust_engine.py
shows one).  The host
engine remains the byte-parity path for arbitrary float inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.select import topk_mask_indices
from ..utils.torchconfig import device as default_device
from .segmenting import run_segmented
from .torch_engine import (KBATCH, _big, _chain_seed, _col_q, _init_caches,
                           _last_min, _limbs, _move_last, _no_pair, _record,
                           _records, _records_to_newick, _row_cache,
                           _row_chunks, _row_q, _scan_start,
                           _update_d_exact, _walker_targets, square_matrix,
                           sums_exact, track_sums)

METHODS = ("upgma", "ff", "cf", "hnj", "nj", "mn")
_COMBINE = {"upgma": "avg", "ff": "max", "cf": "min"}


def _last_eq(mask, vals, target, idx):
    """LAST index where mask & (vals == target), -1 if none."""
    return torch.where(mask & (vals == target), idx, -1).max()


def _raw_row_min(drow, idx, big):
    """Raw-distance cache of a row from its cells over partners
    0..len(drow)-1: min over d >= 0 (initDmin, hclust.c:205-277;
    last-wins).  (big, 0) for empty."""
    ok = drow >= 0
    dv = torch.where(ok, drow, big)
    m = dv.min()
    p = _last_eq(ok, dv, m, idx[:drow.numel()])
    return m, p.clamp_min(0)


def _ff_row_min(newD, j: int, idx, big):
    """FF row-j rebuild (hclust.c:984): plain ``d < Q`` first-wins with
    NO validity check: missing (-1) cells participate."""
    if j == 0:
        return newD.new_full((), big), idx.new_zeros(())
    dv = newD[:j]
    m = dv.min()
    return m, torch.where(dv == m, idx[:j], j).min()


def _update_d_comb(D, sD, N, i: int, j: int, m_t: int, idx, combine: str,
                   exact=None):
    """Shared D/sD/N update for updateUPGMA/FF/CF (hclust.c:665-1306),
    in place: D(k,new) = combine(D_ik, D_kj); one-sided cells keep the
    surviving value with no sD adjustment; N drops for both/only_j.
    sD/N deltas target walker slots (torch_engine._walker_targets).
    Returns (valid_k, newD); `exact` as in torch_engine._update_d_exact."""
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
    if combine == "avg":
        d2 = (D_ik + D_kj) / 2
    elif combine == "max":
        d2 = torch.maximum(D_ik, D_kj)
    else:
        d2 = torch.minimum(D_ik, D_kj)
    newD = torch.where(both, d2,
                       torch.where(only_i, D_ik,
                                   torch.where(only_j, D_kj, -1.0)))
    adv = both | only_i | only_j
    tgt, _ = _walker_targets(adv, i, j, idx)
    sD.index_add_(0, tgt, torch.where(both, -(D_ik + D_kj - d2), 0))
    N.index_add_(0, tgt, (both | only_j).to(torch.int32).neg())
    summand = torch.where(adv, newD, 0)
    if exact is not None:
        exact &= sums_exact(summand)
    sD[j] = torch.cumsum(summand, 0)[-1]
    N[j] = 1 + adv.sum()
    newrow = torch.where(valid_k, newD, D_kj)
    D[j, :m_t] = newrow
    D[:m_t, j] = newrow
    return valid_k, torch.where(valid_k, newD, -1.0)


def _running_max_p(ev, d, min0, p0: int, idx):
    """The ``if (min <= dist) { min = dist; p = k; }`` tracker shared by
    the update rules (hclust.c:835-880 and twins): p ends at the LAST
    event whose distance equals max(min0, all event distances).  (1,)
    int64."""
    M = torch.where(ev, d, -torch.inf).max()
    hit = ev.any() & (M >= min0)
    return torch.where(hit, _last_eq(ev, d, M, idx), p0).view(1)


def _upgma_scan(D, Q, P, seed, m_t: int, idx, big):
    """UPGMApair (dnj.c:217-293) as fused batches: candidate rows
    (cached Q < running min, descending) either accept their exact
    cache (P >= 0) or recompute the raw row minimum (P < 0).  The
    shifted prefix-min recovers the C's running min at every visit (see
    torch_engine._batch_scan: post-visit values can never undercut
    their cached lower bounds).  One host read per pass; returns the
    pair (i, j) as integers."""
    minv, pi, pj = _scan_start(Q, P, seed, big)
    while True:
        cm = Q[1:m_t] < minv
        cnt, i, j = torch.cat([cm.sum().view(1), pi, pj]).tolist()
        if cnt == 0:
            return i, j
        r = topk_mask_indices(cm, idx[1:m_t], min(cnt, KBATCH)).long()
        Qr, Pr = Q[r], P[r].long()
        stale = Pr < 0
        Dr = D[r, :m_t]
        ok = (idx[None, :m_t] < r[:, None]) & (Dr >= 0)
        dv = torch.where(ok, Dr, big)
        rmin = dv.min(dim=1).values
        rarg = torch.where(ok & (dv == rmin[:, None]), idx[None, :m_t], -1) \
            .max(dim=1).values.clamp_min(0)
        # post-visit value: fresh min for stale rows, cache otherwise
        v = torch.where(stale, rmin, Qr)
        varg = torch.where(stale, rarg, Pr)
        rm = torch.cummin(torch.cat([minv, v[:-1]]), dim=0).values
        visit = Qr < rm
        wr = visit & stale
        Q[r] = torch.where(wr, rmin, Qr)
        P[r] = torch.where(wr, rarg, Pr).to(P.dtype)
        bvals = torch.where(visit, v, big)
        bmin = bvals.min()
        atmin = bvals == bmin
        bi = torch.where(atmin, r, -1).max()
        karg = torch.where(atmin & (r == bi), varg, 0).max()
        better = bmin < minv
        minv = torch.where(better, bmin, minv)
        pi = torch.where(better, bi, pi)
        pj = torch.where(better, karg, pj)


def _one_join_h(st, t: int, m: int, neg_limbs: bool, method: str):
    """Join t for upgma/ff (mode 'd') and cf/hnj (mode 'h'), in place."""
    D, sD, N, Q, P, idx = (st[k] for k in ("D", "sD", "N", "Q", "P", "idx"))
    big = _big(D.dtype)
    mode_d = method in ("upgma", "ff")
    hnj = method == "hnj"
    m_t = m - t
    last = m_t - 1

    if mode_d:
        # ---- UPGMApair(seed) (dnj.c:217-293)
        i, j = _upgma_scan(D, Q, P, st["seed"], m_t, idx, big)
    else:
        # ---- minQ (hclust.c:353-381): global cache pick, ``<=``
        # last-wins over rows 1..m_t-1
        pi = _last_min(Q[1:m_t], idx[1:m_t])[1]
        i, j = torch.stack([pi, P[pi].long()]).tolist()
    if i == 0 and j == 0:
        return _no_pair(st, t, last, big)

    Li, Lj = _limbs(D, sD, N, i, j, neg_limbs, st, t)
    _record(st, t, i, j, Li, Lj)

    # ---- update (method-specific)
    if hnj:
        valid_k, newD = _update_d_exact(D, sD, N, i, j, Li, Lj, m_t, idx,
                                        st.get("exact"))
        # updatePrevQ (hclust.c:413-450): refresh every cached Q via its
        # cached partner under the updated sD/N
        prt = P[:m_t].long().clamp_min(0)
        dprev = D[idx[:m_t], prt]
        rows_ok = (idx[:m_t] >= 1) & (dprev >= 0)
        coefp = ((N[:m_t] + N[prt] - 4) >> 1).to(D.dtype)
        Qa = Q[:m_t]
        Qa.copy_(torch.where(rows_ok,
                             coefp * dprev - sD[:m_t] - sD[prt], Qa))
    else:
        valid_k, newD = _update_d_comb(D, sD, N, i, j, m_t, idx,
                                       _COMBINE[method], st.get("exact"))

    # ---- row-j cache rebuild
    if hnj:
        Qj, Pj = _row_cache(_row_q(D, sD, N, j, big), idx, big)
    elif method == "ff":
        Qj, Pj = _ff_row_min(newD, j, idx, big)
    elif j == 0:
        Qj, Pj = newD.new_full((), big), idx.new_zeros(())
    else:
        Qj, Pj = _raw_row_min(newD[:j], idx, big)
    Q[j] = Qj
    P[j] = Pj

    # ---- column-j cache pass (k > j, k != i, active)
    s = slice(j + 1, m_t)
    col_d = newD[s]
    vc = valid_k[s] & (col_d >= 0)
    Qold, Pold, ks = Q[s], P[s], idx[s]
    if hnj:
        # updateHNJ (hclust.c:452-561)
        qcol, _ = _col_q(D, sD, N, j, s)
        brA = vc & ((Pold == i) | (Pold == j))
        brB = vc & ~brA & (qcol <= Qold)
        Q[s] = torch.where(brA | brB, qcol, Qold)
        P[s] = torch.where(brA | (brB & (Pold < j)), j, Pold)
        hits = (brA | brB) & (qcol <= Qj)
        mi_cand = torch.where(hits.any(), torch.where(hits, ks, -1).max(),
                              j).view(1)
    elif method == "cf":
        # updateCF (hclust.c:1102-1306)
        acc = vc & (col_d <= Qold) & ((col_d < Qold) | (Pold == i)
                                      | (Pold == ks) | (Pold < j))
        Q[s] = torch.where(acc, col_d, Qold)
        P[s] = torch.where(acc, j, Pold)
        mi_cand = _running_max_p(acc, col_d, Qj, j, ks)
    else:
        # updateUPGMA / updateFF (hclust.c:665-1100)
        brA = vc & (col_d < Qold)
        stale_p = (Pold == i) | (Pold == j)
        brEq = vc & ~brA & stale_p & (col_d == Qold)
        brStale = vc & ~brA & stale_p & (col_d != Qold)
        Q[s] = torch.where(brA, col_d, Qold)
        P[s] = torch.where(brStale, -1, torch.where(brA | brEq, j, Pold))
        mi_cand = _running_max_p(brA | brEq, col_d, Qj, j, ks)

    # ---- popArrange (UPGMA_ hclust.c:1559-1669 / HNJ_ :1308-1432)
    if i != last:
        _move_last(D, sD, N, i, m_t)
        if hnj:
            Qi, Pi = _row_cache(_row_q(D, sD, N, i, big), idx, big)
        else:
            Qi, Pi = _raw_row_min(D[i, :i], idx, big)
        Q[i] = Qi
        P[i] = Pi
        mj_cand = idx.new_full((1,), i)
        if i + 1 < last:
            s2 = slice(i + 1, last)
            dcol = D[s2, i]
            colv = _col_q(D, sD, N, i, s2)[0] if hnj else dcol
            Q2, P2 = Q[s2], P[s2]
            u2 = (dcol >= 0) & (colv <= Q2) & ((P2 < i) | (colv < Q2))
            Q[s2] = torch.where(u2, colv, Q2)
            P[s2] = torch.where(u2, i, P2)
            mq2 = torch.where(u2, colv, big).min()
            mj_cand = torch.where(u2.any() & (mq2 <= Qi),
                                  _last_eq(u2, colv, mq2, idx[s2]),
                                  i).view(1)
    else:
        mj_cand = idx.new_zeros(1)
    Q[last] = big
    if mode_d:
        st["seed"] = _chain_seed(Q, mi_cand, mj_cand, last)


def _scan_pair(D, sD, N, m_t: int, idx, big, method: str):
    """Full masked Q scan (initQ nj.c:182-247 / initQ_MN :297-362) over
    the active taxa, in row chunks: last-wins in ltd flat order =
    largest i, then largest j.  Returns (gi, gj), 0-d, both 0 when no
    pair is found."""
    dtype = D.dtype
    mn = method == "mn"
    fill = -big if mn else big
    cols = idx[:m_t]
    rb = torch.full((m_t,), fill, dtype=dtype, device=D.device)
    ra = torch.zeros(m_t, dtype=torch.long, device=D.device)
    rh = torch.zeros(m_t, dtype=torch.bool, device=D.device)
    for r0, r1 in _row_chunks(m_t):
        Dr = D[r0:r1, :m_t]
        lv = (cols[None, :] < idx[r0:r1, None]) & (Dr >= 0)
        coef = ((N[r0:r1, None] + N[None, :m_t] - 4) >> 1).to(dtype)
        qm = torch.where(lv, coef * Dr - sD[r0:r1, None] - sD[None, :m_t],
                         fill)
        rbest = qm.max(dim=1).values if mn else qm.min(dim=1).values
        rb[r0:r1] = rbest
        ra[r0:r1] = torch.where(qm == rbest[:, None], cols[None, :], -1) \
            .max(dim=1).values
        rh[r0:r1] = lv.any(dim=1)
    rbm = torch.where(rh, rb, fill)
    gb = rbm.max() if mn else rbm.min()
    gi = _last_eq(rh, rb, gb, cols)
    found = rh.any()
    if not mn:
        # initQ early-out (nj.c:232-235): no pair when min > 1.0
        found = found & (gb <= 1.0)
    gi = torch.where(found, gi, 0)
    return gi, torch.where(found, ra[gi], 0)


def _one_join_e(st, t: int, m: int, neg_limbs: bool, method: str):
    """Join t of the 'e'-mode full-scan engines (nj, mn), in place."""
    D, sD, N, idx = (st[k] for k in ("D", "sD", "N", "idx"))
    m_t = m - t
    i, j = torch.stack(_scan_pair(D, sD, N, m_t, idx, _big(D.dtype),
                                  method)).tolist()
    if i == 0 and j == 0:
        return _no_pair(st, t, m_t - 1, None)
    Li, Lj = _limbs(D, sD, N, i, j, neg_limbs, st, t)
    _record(st, t, i, j, Li, Lj)
    _update_d_exact(D, sD, N, i, j, Li, Lj, m_t, idx, st.get("exact"))
    if i != m_t - 1:
        _move_last(D, sD, N, i, m_t)


def _hclust_init(D, m: int, method: str = "upgma"):
    """sD/N (initSummaD, nj.c:111-180) + per-row caches: raw-distance
    minima (initDmin, hclust.c:205-277) for upgma/ff/cf, Q minima with
    the initHNJ tie rule (hclust.c:56-130) for hnj; plus the mode-'d'
    seed (the host loop's initial min_q pick).  D is (n, n) with n >= m
    and is only read.  Returns (sD, N, Q, P, seed) as
    torch_engine._dnj_init does."""
    return _init_caches(D, m, hnj=method == "hnj")


def _h_segment(st, t0: int, t1: int, m: int, neg_limbs=False,
               method="upgma"):
    """Joins [t0, t1) of upgma/ff/cf/hnj, in place on `st`."""
    for t in range(t0, t1):
        _one_join_h(st, t, m, neg_limbs, method)
    return st


def _e_segment(st, t0: int, t1: int, m: int, neg_limbs=False, method="nj"):
    """Joins [t0, t1) of nj/mn, in place on `st`."""
    for t in range(t0, t1):
        _one_join_e(st, t, m, neg_limbs, method)
    return st


def _new_state(D, m: int, method: str):
    """The state of the m active taxa of D before the first join of
    `method`, and the function that runs a segment of its joins."""
    sD, N, Q, P, seed = _hclust_init(D, m, method)
    st = {"D": D, "sD": sD, "N": N,
          "idx": torch.arange(D.shape[0], device=D.device),
          **_records(D.shape[0], D.dtype)}
    if method in ("nj", "mn"):
        return st, _e_segment
    st.update(Q=Q, P=P, seed=seed)
    return st, _h_segment


def hclust_joins(D, m: int, method: str = "upgma", neg_limbs=False,
                 exact_sums=False):
    """Run all m-2 joins of one heuristic-family method on the device
    of D, in place.

    D: (n, n) square distance matrix (missing < 0, diagonal 0), n >= m;
    m: active count.  method in METHODS.  Returns (I, J, LI, LJ,
    d_last, D) as torch_engine.dnj_joins does; records with I == J == 0
    mean "no joinable pair left".  exact_sums as there.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, not {method!r}")
    m = int(m)
    st, seg = _new_state(D, m, method)
    if exact_sums:
        track_sums(st, m)
    run_segmented(
        lambda st, t0, t1: seg(st, t0, t1, m, neg_limbs, method),
        st, max(m - 2, 0))
    return st["I"], st["J"], st["LI"], st["LJ"], float(D[1, 0]), D


def build_tree_hclust(flat64: np.ndarray, n: int, names: list,
                      method: str = "upgma", flag: int = 0,
                      precision: int = 9, dtype=torch.float32,
                      device=None, exact_sums=False) -> bytes:
    """Device join loop for the heuristic/UPGMA family; Newick bytes
    (no ';').  Missing cells supported."""
    dev = default_device() if device is None else torch.device(device)
    D = torch.from_numpy(square_matrix(flat64, n)).to(dev, dtype)
    I, J, LI, LJ, d_last, _ = hclust_joins(D, n, method=method,
                                           neg_limbs=bool(flag & 2),
                                           exact_sums=exact_sums)
    return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                              precision)
