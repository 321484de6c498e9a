"""Row-block-sharded Dynamic Neighbor-Joining on torch.distributed
(counterpart of parallel/sharded_dnj.py): the engine for matrices
beyond one card.

Each rank holds one row block of the square distance matrix (missing
< 0) and its slices of the DNJ row caches (Q, P), which cover partners
j < i only, as in the C (dnj.c:43-128).  The row sums sD and pair
counts N are whole on every rank: every rank applies the same updates
to them, so no join gathers them (the JAX engine gathers its slices
each join).  The join loop is driven from the host, the same on every
rank, and every cross-device step is a collective
(parallel/multihost.py):

  1. *sharded candidate revalidation*: each rank recomputes the rows of
     its block whose cached bound beats the running global minimum,
     KBATCH at a time, in the global descending row order of the C's
     scan: a shared row threshold (an all_reduce MAX of each rank's
     KBATCH-th candidate) orders the passes across ranks, and each
     rank's running-min gating is seeded with the batch minima of the
     higher ranks.  Candidate picks merge with an all-gather and the
     rule of the single-card batch engine (value min, larger row wins a
     tie).  One host read per pass: the candidate counts and the pair.
  2. *join application*: the two merged rows are broadcast from their
     owners; every rank computes the reference's updateD bookkeeping
     (walker-slot targets, the nj.c:1022 out-of-row read, whose cell may
     live on another rank) on the full-row vectors, updates its own
     rows' column entries and sD/N/Q/P; the owners of the merged and
     moved slots rebuild their rows; the updateDNJ cache repair and
     popArrange (dnj.c:607-975) pick their seed candidates by global
     last-wins minima over the ranks.  Owner writes are host branches.

The limbs are computed on the host from one read, in the state's
precision.  The join records equal the single-card batch engine's
(tree/torch_engine.py ``scan="batch"``) and the JAX engine's for any
world size.  Missing data follows nj.c:836-1044, including the early
stop when no joinable pair remains.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.select import topk_mask_indices
from ..tree import torch_engine as te
from ..tree.segmenting import run_segmented
from ..utils.torchconfig import device as default_device
from . import multihost as mh

# candidate rows revalidated per rank per pass: the single-card batch
# engine's (the JAX engine takes 32 a device); the records do not depend
# on it
KBATCH = 128
_CH = 512    # rows per chunk of the init: temporaries stay (CH, npad)


def _pad_to(n: int, mult: int) -> int:
    return max(-(-n // mult) * mult, mult)


class _Axis:
    """This rank's place on the row axis and the constants of a run."""

    def __init__(self, st):
        self.rank, self.world = mh.row_axis()
        self.R, self.npad = st["Dl"].shape
        if self.R * self.world != self.npad:
            raise ValueError(f"a row block of {self.R} rows does not "
                             f"split {self.npad} rows over "
                             f"{self.world} ranks")
        self.r0 = self.rank * self.R
        self.dtype = st["Dl"].dtype
        self.dev = st["Dl"].device
        self.big = te._big(self.dtype)
        self.cols = torch.arange(self.npad, device=self.dev)
        self.gi = self.cols[self.r0:self.r0 + self.R]
        self.ranks = torch.arange(self.world, device=self.dev)

    def owns(self, r: int) -> bool:
        return self.r0 <= r < self.r0 + self.R

    def rows(self, Dl, rs):
        """Global rows `rs` (ascending) of the live matrix on every rank:
        one broadcast from each owner, of its rows side by side."""
        assert list(rs) == sorted(rs), rs
        out = torch.empty((len(rs), self.npad), dtype=self.dtype,
                          device=self.dev)
        owner = [r // self.R for r in rs]
        for src in sorted(set(owner)):
            a, b = owner.index(src), len(owner) - owner[::-1].index(src)
            if src == self.rank:
                out[a:b] = Dl[[r - self.r0 for r in rs[a:b]]]
            mh.broadcast(out[a:b], src)
        return out

    def values(self, pairs):
        """[v[r] for (v, r) in pairs] as float64 on every rank, r a
        device index: each owner contributes its entry, the others 0."""
        vals = torch.stack([
            torch.where(r // self.R == self.rank,
                        v[r % self.R].double(), 0.0) for v, r in pairs])
        return mh.all_reduce(vals)

    def last_min(self, vals, rows):
        """The global last-wins minimum of `vals` (a vector over this
        rank's rows `rows`): (value, row), replicated."""
        lm = vals.min()
        lr = torch.where(vals == lm, rows, -1).max()
        cs = mh.gather_rows(torch.stack([lm.double(), lr.double()])) \
            .view(self.world, 2)
        gm = cs[:, 0].min()
        return gm.to(self.dtype), \
            torch.where(cs[:, 0] == gm, cs[:, 1], -1.0).max().long()


def _init_state(Dl, n: int):
    """initSummaD + initHNJ row caches + the initial seed on the row
    block Dl (R, npad) of this rank."""
    st = {"Dl": Dl}
    ax = _Axis(st)
    R, dt, big = ax.R, ax.dtype, ax.big
    cols, gi = ax.cols, ax.gi
    act0 = cols < n
    chunks = [(a, min(a + _CH, R)) for a in range(0, R, _CH)]
    sDl = torch.zeros(R, dtype=dt, device=ax.dev)
    Nl = torch.ones(R, dtype=torch.int32, device=ax.dev)
    for a, b in chunks:
        v = act0[gi[a:b], None] & act0[None, :] & (Dl[a:b] >= 0) \
            & (gi[a:b, None] != cols[None, :])
        # cumsum: the C's left-to-right order where the device's cumsum
        # is sequential (tree/torch_engine.py)
        sDl[a:b] = torch.cumsum(torch.where(v, Dl[a:b], 0), dim=1)[:, -1]
        Nl[a:b] = 1 + v.sum(dim=1)
    sD = mh.gather_rows(sDl)
    N = mh.gather_rows(Nl)
    Ql = torch.full((R,), big, dtype=dt, device=ax.dev)
    Pl = torch.zeros(R, dtype=torch.int32, device=ax.dev)
    for a, b in chunks:
        Dr = Dl[a:b]
        lv = act0[gi[a:b], None] & act0[None, :] & (Dr >= 0) \
            & (cols[None, :] < gi[a:b, None])
        coef = ((N[gi[a:b], None] + N[None, :] - 4) >> 1).to(dt)
        Qm = torch.where(lv, coef * Dr - sD[gi[a:b], None] - sD[None, :],
                         big)
        Ql[a:b], Pl[a:b] = te._row_minima(Dr, Qm, lv, cols, big)
    Ql = torch.where(act0[gi], Ql, big)
    # the initial seed: the global last row >= 1 at the smallest Q
    _, seed = ax.last_min(torch.where((gi >= 1) & act0[gi], Ql, big), gi)
    st.update(sD=sD, N=N, Ql=Ql, Pl=Pl, seed=seed.clamp_min(0))
    return st


def _scan(st, ax, m_t: int, stats):
    """The seeded minQpair scan over every rank's candidate rows;
    returns the pair (i, j) as integers."""
    Dl, sD, N, Ql, Pl = (st[k] for k in ("Dl", "sD", "N", "Ql", "Pl"))
    dt, big, gi, cols, r0 = ax.dtype, ax.big, ax.gi, ax.cols, ax.r0
    sDl, Nl = sD[r0:r0 + ax.R], N[r0:r0 + ax.R]
    seed = st["seed"]
    seed_q = st["seed_qp"][0].to(dt)
    seed_ok = (seed != 0) & (seed_q != big)
    minv = torch.where(seed_ok, seed_q, big)
    pi = torch.where(seed_ok, seed, 0)
    pj = torch.where(seed_ok, st["seed_qp"][1].long(), 0)
    while True:
        cm = (gi >= 1) & (gi < m_t) & (Ql < minv)
        # this rank's candidates, its KBATCH largest descending, and the
        # KBATCH-th of them (-1 when it has fewer)
        top = topk_mask_indices(cm, gi - r0, KBATCH).long()
        kth = torch.where(top[-1] >= 0, r0 + top[-1], -1)
        counts = mh.gather_rows(torch.stack([cm.sum(), kth]))
        read = torch.cat([counts, pi.view(1), pj.view(1)]).tolist()
        stats["host_reads"] += 1
        i, j = read[-2:]
        if not any(read[0:-2:2]):
            return i, j
        stats["passes"] += 1
        k = min(read[2 * ax.rank], KBATCH)
        # global-descending batch selection: a shared row threshold, the
        # largest over ranks of each rank's KBATCH-th candidate row; only
        # candidates at or above it are processed this pass, so every row
        # of pass p precedes every row of pass p+1 in the C's descending
        # visit order (dnj.c:43-128) and folding pass minima into minv
        # keeps its running min exact
        thr = max(read[1:-2:2])
        rows = top[:k]
        grow = r0 + rows
        valid = grow >= thr
        Drows = Dl[rows]                                   # (k, npad)
        c_ = ((Nl[rows][:, None] + N[None, :] - 4) >> 1).to(dt)
        q = c_ * Drows - sDl[rows][:, None] - sD[None, :]
        q = torch.where((cols[None, :] < grow[:, None]) & (Drows >= 0), q,
                        big)
        rmin = q.min(dim=1).values
        rarg = torch.where(q == rmin[:, None], cols[None, :], -1) \
            .max(dim=1).values
        # local best (value min, larger global row wins a tie); a rank
        # with no candidate offers (big, -1, 0), which never wins
        bvals = torch.where(valid, rmin, big)
        if k:
            bmin = bvals.min()
            bi = torch.where(bvals == bmin, grow, -1).max()
            bj = torch.where((bvals == bmin) & (grow == bi), rarg, 0).max()
            cand = torch.stack([bmin.double(), bi.double(), bj.double()])
        else:
            cand = torch.tensor([big, -1.0, 0.0], dtype=torch.float64,
                                device=ax.dev)
        cs = mh.gather_rows(cand).view(ax.world, 3)
        csv = cs[:, 0].to(dt)
        # C-exact cache gating across the global descending sweep: every
        # row of a higher rank precedes this rank's rows, so the running
        # min at this batch starts from min(minv, higher ranks' batch
        # minima); a shifted prefix-min threads it through the batch
        rm_seed = torch.minimum(minv, torch.where(ax.ranks > ax.rank, csv,
                                                  big).min())
        rm = torch.cummin(torch.cat([rm_seed.view(1), bvals[:-1]]),
                          dim=0).values
        Qr = Ql[rows]
        reval = valid & (Qr < rm)
        Ql[rows] = torch.where(reval, rmin, Qr)
        Pl[rows] = torch.where(reval, rarg.to(Pl.dtype), Pl[rows])
        gmin = csv.min()
        gim = torch.where(csv == gmin, cs[:, 1], -1.0).max()
        gjm = torch.where((csv == gmin) & (cs[:, 1] == gim), cs[:, 2],
                          0.0).max()
        better = gmin < minv
        minv = torch.where(better, gmin, minv)
        pi = torch.where(better, gim.long(), pi)
        pj = torch.where(better, gjm.long(), pj)
        if thr < 0:
            # every candidate of every rank was in this pass, and none
            # can qualify again (a fresh row minimum or a skipped cache
            # is >= the new running min): no count to gather
            stats["host_reads"] += 1
            return tuple(torch.stack([pi, pj]).tolist())


def _garbage(st, ax, i: int, j: int, stored, adv_c):
    """The nj.c:1022 out-of-row read of the column-part one-sided D_kj
    branch: ltd flat cell off(j)+k, which may alias a column-j cell
    stored earlier in this sweep, or an old cell of any rank (each
    owner contributes its cells, the others 0)."""
    Dl, cols, R = st["Dl"], ax.cols, ax.R
    kk = cols.clamp_min(j + 1)
    r_g = te._ltd_row_of(kk, j)
    c_g = kk - (r_g - j) * (r_g + j - 1) // 2
    colj_old = mh.gather_rows(Dl[:, j])
    seen = (r_g < cols) & (r_g != i) & adv_c[r_g]
    garb_cj = torch.where(r_g == cols, stored,
                          torch.where(seen, stored[r_g], colj_old[r_g]))
    other = mh.all_reduce(torch.where(r_g // R == ax.rank,
                                      Dl[r_g % R, c_g], 0.0))
    return torch.where(c_g == j, garb_cj, other)


def _repair(ax, Ql, Pl, q, ok, c: int):
    """Cache repair of this rank's rows through their fresh cell in
    column c: Q values `q` (valid where `ok`) replace the cached minima
    they tie or beat.  Returns this rank's (smallest replaced value, last
    row at it), (big, -1)-like when none."""
    upd = ok & (q <= Ql)
    Ql.copy_(torch.where(upd, q, Ql))
    Pl.copy_(torch.where(upd, c, Pl))
    mq = torch.where(upd, q, ax.big)
    lm = mq.min()
    return lm, torch.where(mq == lm, ax.gi, -1).max()


def _join(st, ax, t: int, n: int, neg: bool, missing: bool, stats):
    """Join t of the sharded DNJ loop, in place on this rank's `st`.
    sD and N are whole on every rank, which all apply the same updates
    to them (what a gather of the slices would bring)."""
    Dl, sD, N, Ql, Pl = (st[k] for k in ("Dl", "sD", "N", "Ql", "Pl"))
    dt, big, gi, cols, R, r0 = (ax.dtype, ax.big, ax.gi, ax.cols, ax.R,
                                ax.r0)
    sDl, Nl = sD[r0:r0 + R], N[r0:r0 + R]
    m_t = n - t
    last = m_t - 1
    i, j = _scan(st, ax, m_t, stats)
    if i == 0 and j == 0:
        # no joinable pair left (missing-data early stop, dnj.c:1009)
        st["I"][t] = st["J"][t] = 0
        st["LI"][t] = st["LJ"][t] = -1.0
        if ax.owns(last):
            Ql[last - r0] = big
        st["seed"] = torch.zeros_like(st["seed"])
        return

    # rows j, i and, for popArrange, `last`, before the update changes
    # last's cell in column j
    rowj, rowi, *moved = ax.rows(Dl, [j, i] + ([last] if i != last else []))
    D_ij, sDi, sDj, Ni, Nj = torch.stack([
        rowi[j].double(), sD[i].double(), sD[j].double(),
        N[i].double(), N[j].double()]).tolist()
    stats["host_reads"] += 1
    Li, Lj = te._limb_lengths(D_ij, sDi, sDj, int(Ni) - 2, int(Nj) - 2,
                              neg, te._np_float(dt))
    st["I"][t], st["J"][t], st["LI"][t], st["LJ"][t] = i, j, Li, Lj

    # updateD (nj.c:836-1044) on the replicated full rows, with the
    # reference's bookkeeping (tree/torch_engine._update_d_exact)
    validk = (cols < m_t) & (cols != i) & (cols != j)
    vi, vj = rowi >= 0, rowj >= 0
    both = validk & vi & vj
    only_i = validk & vi & ~vj
    only_j = validk & ~vi & vj
    dboth = ((rowi + rowj - rowi[j]) / 2).clamp_min(0.0)
    stored = torch.where(both, dboth,
                         torch.where(only_i, rowi - Li,
                                     torch.where(only_j, rowj - Lj, rowj)))
    adv = both | only_i | only_j
    tgt, adv_c = te._walker_targets(adv, i, j, cols)
    contrib = stored
    if missing:  # a complete matrix has no one-sided cell
        contrib = torch.where(only_j & (cols > j),
                              stored - _garbage(st, ax, i, j, stored, adv_c),
                              stored)
    sd_src = torch.where(both, -(rowi + rowj - dboth),
                         torch.where(only_i, -Li,
                                     torch.where(only_j & (cols < j), -Lj,
                                                 contrib)))
    # walker targets; the non-advancing cells' sink is j, set right after
    sD.index_add_(0, tgt, torch.where(adv, sd_src, 0.0))
    N.index_add_(0, tgt, (both | only_j).to(torch.int32).neg())
    sD[j] = torch.cumsum(torch.where(adv, contrib, 0.0), 0)[-1]
    N[j] = 1 + adv.sum(dtype=torch.int32)
    rowj_new = torch.where(validk, stored, rowj)
    # column j for my rows; row j for its owner
    validk_l = validk[r0:r0 + R]
    Dl[:, j] = torch.where(validk_l, stored[r0:r0 + R], Dl[:, j])
    if ax.owns(j):
        Dl[j - r0] = rowj_new

    # updateDNJ cache repair (dnj.c:607-710): a fresh cache for row j,
    # then the rows below j through their new cell in column j
    qj = ((N[j] + N - 4) >> 1).to(dt) * rowj_new - sD[j] - sD
    qj = torch.where((cols < j) & (rowj_new >= 0), qj, big)
    Qj, Pj = te._last_min(qj, cols)
    if ax.owns(j):
        Ql[j - r0] = Qj
        Pl[j - r0] = torch.where(Qj == big, 0, Pj)
    colj = Dl[:, j]
    qcol = ((N[j] + Nl - 4) >> 1).to(dt) * colj - sD[j] - sDl
    cand = list(_repair(ax, Ql, Pl, qcol,
                        validk_l & (gi > j) & (colj >= 0), j))

    # DNJ_popArrange (dnj.c:817-975): move row `last` into slot i
    if i != last:
        moved = moved[0]
        moved[j] = stored[last]
        moved[i] = 0.0
        moved[last] = -1.0
        if ax.owns(i):
            Dl[i - r0] = moved
        Dl[:, i] = moved[r0:r0 + R]
        sD[i] = sD[last]
        N[i] = N[last]
        qi = ((N[i] + N - 4) >> 1).to(dt) * moved - sD[i] - sD
        qi = torch.where((cols < i) & (moved >= 0), qi, big)
        Qi, Pi = te._last_min(qi, cols)
        if ax.owns(i):
            Ql[i - r0] = Qi
            Pl[i - r0] = torch.where(Qi == big, 0, Pi)
        # column pass: rows i < k < last see cell (k, i)
        coli = Dl[:, i]
        qc = ((N[i] + Nl - 4) >> 1).to(dt) * coli - sD[i] - sDl
        cand += _repair(ax, Ql, Pl, qc,
                        (gi > i) & (gi < last) & (coli >= 0), i)
    # the repair candidates: global last-wins minima over the ranks
    cs = mh.gather_rows(torch.stack([c.double() for c in cand])) \
        .view(ax.world, -1, 2)
    gmq = cs[:, :, 0].min(dim=0).values
    at = cs[:, :, 0] == gmq
    gmr = torch.where(at, cs[:, :, 1], -1.0).max(dim=0).values.long()
    gmq = gmq.to(dt)
    mi_cand = torch.where((gmq[0] < big) & (gmq[0] <= Qj), gmr[0], j)
    if i != last:
        mj_cand = torch.where((gmq[1] < big) & (gmq[1] <= Qi), gmr[1], i)
    else:
        mj_cand = torch.zeros_like(mi_cand)
    if ax.owns(last):  # retire the vacated slot
        Ql[last - r0] = big

    # seed chaining (dnj.c:1026-1032), with the new seed's cache
    v = ax.values([(Ql, mi_cand), (Pl, mi_cand), (Ql, mj_cand),
                   (Pl, mj_cand)]).view(2, 2)
    Qmi, Qmj = v[0, 0], v[1, 0]
    to_j = torch.where(
        mj_cand == last, False,
        torch.where(mi_cand == last, True,
                    (Qmj < Qmi) | ((mi_cand < mj_cand) & (Qmj == Qmi))))
    st["seed"] = torch.where(to_j, mj_cand, mi_cand)
    st["seed_qp"] = torch.where(to_j, v[1], v[0])


def dnj_segment(st, t0: int, t1: int, n: int, neg: bool = False):
    """Joins [t0, t1) of the sharded DNJ loop, in place on this rank's
    state `st` (from `dnj_state` or interop.sharded_state_from_jax).
    Every rank calls it with the same arguments."""
    ax = _Axis(st)
    stats = st.setdefault("stats", {"passes": 0, "host_reads": 0})
    if "seed_qp" not in st:  # the seed row's cache (Q, P)
        st["seed_qp"] = ax.values([(st["Ql"], st["seed"]),
                                   (st["Pl"], st["seed"])])
    # no active cell ever becomes missing: a complete start stays
    # complete
    if "missing" not in st:
        m0 = n - t0
        local = (st["Dl"][ax.gi < m0, :m0] < 0).any().to(torch.int32)
        st["missing"] = bool(mh.all_reduce(local.view(1)))
    for t in range(t0, t1):
        _join(st, ax, t, n, neg, st["missing"], stats)
    return st


def _records(T: int, dtype):
    f = te._np_float(dtype)
    return {"I": np.zeros(T, np.int32), "J": np.zeros(T, np.int32),
            "LI": np.zeros(T, f), "LJ": np.zeros(T, f)}


def dnj_state(D: np.ndarray, n: int, dtype=torch.float32, device=None):
    """This rank's state before the first join: its row block of the
    (n, n) host matrix D (missing < 0, diag 0), which every rank holds,
    on its device, with sD, N, the row caches and the seed."""
    if n < 3:
        raise ValueError("need at least 3 taxa")
    dev = default_device() if device is None else torch.device(device)
    rank, world = mh.row_axis()
    npad = _pad_to(n, world)
    R = npad // world
    Dl = np.full((R, npad), -1.0, te._np_float(dtype))
    rows = np.arange(rank * R, min((rank + 1) * R, n))
    Dl[:len(rows), :n] = D[rows, :n]
    Dl[np.arange(len(rows)), rows] = 0.0
    st = _init_state(torch.from_numpy(Dl).to(dev), n)
    st.update(_records(max(n - 2, 1), dtype))
    return st


def dnj_records(st):
    """(I, J, LI, LJ, d_last) of a finished state, on every rank:
    d_last is cell (1, 0), broadcast from its owner."""
    ax = _Axis(st)
    d = st["Dl"][1 - ax.r0, 0].reshape(1).clone() if ax.owns(1) \
        else torch.empty(1, dtype=ax.dtype, device=ax.dev)
    d_last = mh.broadcast(d, 1 // ax.R).cpu().numpy()[0]
    return st["I"], st["J"], st["LI"], st["LJ"], d_last


def sharded_dnj_records(D: np.ndarray, n: int, dtype=torch.float32,
                        neg: bool = False, device=None):
    """Run the sharded DNJ loop; returns host (I, J, LI, LJ, d_last),
    the same on every rank.

    D: (n, n) square distance matrix (missing < 0, diag 0) that every
    rank holds on the host; each rank copies its row block to its
    device.  Join records use the engines' swap-with-last slot
    convention (tree/torch_engine.py).  The run's passes, host reads and
    collectives are left in `sharded_dnj_records.last`.
    """
    mh.counts["collectives"] = 0
    st = run_segmented(lambda st, t0, t1: dnj_segment(st, t0, t1, n, neg),
                       dnj_state(D, n, dtype, device), max(n - 2, 0))
    out = dnj_records(st)
    sharded_dnj_records.last = dict(st.get("stats", {}), joins=n - 2,
                                    **mh.counts)
    return out


def build_tree_sharded_dnj(flat64: np.ndarray, n: int, names: list,
                           flag: int = 0, precision: int = 9,
                           dtype=torch.float32, device=None) -> bytes:
    """Newick bytes (no ';') via the sharded DNJ engine."""
    I, J, LI, LJ, d_last = sharded_dnj_records(
        te.square_matrix(flat64, n), n, dtype, neg=bool(flag & 2),
        device=device)
    return te._records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                                 precision)
