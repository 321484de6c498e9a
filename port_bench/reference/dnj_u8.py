"""Plain reference of `ccphylo tree -m dnj -b` on a complete matrix of
u8 cells, on the device, for matrices too large for `reference/dnj.py`.

It has `reference/dnj.py`'s semantics for complete `-b` matrices: the
row caches of the Q criterion, rows revalidated where their cached
bound beats the running minimum, the reference's tie rules, updated
cells rounded to u8 (dtouc(d, 0.25)), the compaction that moves the last
row into the joined slot, the limbs in float64, and the Newick text with
its buffer capacities (`dnj.form_node`, `dnj.form_last_node`).  It holds
the cells as one dense symmetric (n, n) uint8 matrix on the device and
every other quantity as an exact integer (int64) in units of
u = 1 / (2 ByteScale): a row sum is twice the sum of its cells, and an
updated distance before its rounding is a whole number of u.  On a
complete matrix every active row has the same N (the number of active
rows after the last join), so the Q coefficient is one number.  At a
dyadic ByteScale, such as the configuration's 1, every float of
`reference/dnj.py` is one of these integers times u exactly, so the two
build the same tree.

A join is two parts.  The search (`pair`) evaluates the sequential scan
of `dnj.py::_DNJ.pair` (from the last row down, recompute a row whose
cached Q is below the running minimum) a batch of rows at a time: the
last rows whose cache is below the running minimum (at most `batch` in
a join's first batch, at most four times as many in each next one, up
to `_MAX_ROWS`) are recomputed together with plain tensor ops, then
walked in order on the host, each taken only if its cache is still below
the minimum the walk has reached (a row the walk skips keeps its cache),
and the next batch starts below them if a row there has a cache below
the walk's minimum.  That is the sequential scan's result
and its cache updates exactly.  The update (`step`: the rows the search
took written into the caches, the join, the compaction, the next seed
and the next join's first batch) runs the same tensor ops on every
join, over all n columns with the inactive ones masked, on device
scalars.  On a card the update and each size of batch are captured once
as CUDA graphs and replayed: a join is then one upload, one replay and
one host read, unless its search needs more than the first batch.

Imports nothing of the program under test.  `qmax` is the largest cell
(255; 15 is the control's 4-bit cells: loaded cells are clipped to it,
as updated ones are).
"""

from __future__ import annotations

import numpy as np
import torch

from .dnj import RefName, form_last_node, form_node

BIG = 2 ** 62
_BIG32 = 2 ** 31 - 1
_ROWS = 512         # rows laid out and uploaded, or summed, at a time
_INIT_ROWS = 32     # rows of the row caches' first search at a time
_STEP_COLS = 8192   # a step's columns are the active ones rounded up to this
_MAX_ROWS = 1024    # rows of a search's largest batch


def square_u8(cells: np.ndarray, n: int, dev) -> torch.Tensor:
    """The dense symmetric (n, n) uint8 matrix of the lower triangle
    `cells` (row i: cells (i, 0..i-1)), zero diagonal, built on `dev`
    a block of rows at a time."""
    D = torch.zeros((n, n), dtype=torch.uint8, device=dev)
    at = 0
    for r0 in range(0, n, _ROWS):
        r1 = min(r0 + _ROWS, n)
        blk = np.zeros((r1 - r0, r1), np.uint8)
        for i in range(r0, r1):
            blk[i - r0, :i] = cells[at:at + i]
            at += i
        D[r0:r1, :r1] = torch.from_numpy(blk).to(dev)
    for r0 in range(0, n, _ROWS):
        r1 = min(r0 + _ROWS, n)
        D[r0:r1, r1:] = D[r1:, r0:r1].t()
        tile = D[r0:r1, r0:r1]
        tile += tile.t().clone()
    return D


class _DNJ8:
    """State of one run: D (dense, symmetric, uint8), sD2 (twice the row
    sums), the row caches Q/P (Q in u; one slot past the last row takes
    the padding of `inp`), m active rows, N the active rows' common
    count; `head` (seed row, its Q and P) for the next search; `rec` the
    joins' records (D_ij, sD2_i and sD2_j before the join).  Device
    inputs: `inp` (i, j, m before the join, t, then the rows the search
    took, their Q and their P, `batch` each, padded with row n) and
    `cin` (a further batch's top row, bound and coefficient); output
    `out` (the head, the count of rows below the bound and the least
    cache of those below the batch, then a batch's rows, their least
    values and columns, cached Q and own sums)."""

    def __init__(self, cells, n: int, bytescale: float, dev, qmax: int,
                 batch: int):
        if n > 2 ** 18:
            raise ValueError("the u8 reference's batches hold values in "
                             "int32: n <= 2**18")
        self.dev = dev
        self.n = n
        self.D = square_u8(np.asarray(cells, np.uint8), n, dev)
        if qmax < 255:
            self.D.clamp_(max=qmax)
        self.qmax = qmax
        self.bs = float(bytescale)
        self.batch = batch
        self.m = self.N = n
        self.sD2 = torch.cat([2 * self.D[r0:r0 + _ROWS].sum(
            dim=1, dtype=torch.int64) for r0 in range(0, n, _ROWS)])
        self.Q = torch.full((n + 1,), BIG, dtype=torch.int64, device=dev)
        self.P = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        self.ar = torch.arange(n, device=dev)
        # a key orders cells as (Q, -column): Q above the column's kb bits
        self.kb = max(17, n.bit_length())
        self.low = (1 << self.kb) - 1
        self.rec = torch.zeros((max(n - 2, 1), 3), dtype=torch.int64,
                               device=dev)
        self.head = torch.zeros(3, dtype=torch.int64, device=dev)
        self.inp = torch.zeros(4 + 3 * batch, dtype=torch.int64, device=dev)
        self.cin = torch.zeros(3, dtype=torch.int64, device=dev)
        self.out = torch.zeros(5 + 5 * max(_MAX_ROWS, batch),
                               dtype=torch.int64, device=dev)
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle() \
            if dev.type == "cuda" else None

    def coef(self) -> int:
        """(N_i + N_k - 4) >> 1 with every N equal, times 2 (cells to u)."""
        return 2 * (self.N - 2)

    def keys(self, q: torch.Tensor) -> torch.Tensor:
        """The keys of values q at the first len(q) columns: the least
        key is the least value at its last column (|q| < 2**(62 - kb))."""
        return (q << self.kb) + (self.low - self.ar[:q.shape[-1]])

    def unkey(self, k: torch.Tensor):
        """(value, column) of a key."""
        return k >> self.kb, self.low - (k & self.low)

    def init_rows(self) -> None:
        """Row caches: the row's minimum; among equal minima the least
        distance, the last of those.  One int64 key a cell orders the
        cells of a row as (Q, distance, -column): Q above the distance's
        8 bits and the column's `kb` bits.  Blocks of `_INIT_ROWS` rows
        keep the keys in the card's L2.  Then the first seed: the last
        row at the least cached Q."""
        n, kb, low = self.m, self.kb, self.low
        mult = self.coef() << (kb + 8) | 1 << kb
        base = (self.sD2 << (kb + 8)) - (low - self.ar)
        top = torch.iinfo(torch.int64).max
        for r0 in range(1, n, _INIT_ROWS):
            r1 = min(r0 + _INIT_ROWS, n)
            key = torch.add(-base[:r1], self.D[r0:r1, :r1], alpha=mult)
            key.masked_fill_(self.ar[None, :r1] >= self.ar[r0:r1, None],
                             top)
            kmin = key.min(dim=1).values
            self.Q[r0:r1] = (kmin >> (kb + 8)) - self.sD2[r0:r1]
            self.P[r0:r1] = low - (kmin & low)
        q = self.Q[1:n]
        seed = 1 + torch.where(q == q.min(), self.ar[:n - 1], -1).max()
        self.head.copy_(torch.stack([seed, self.Q[seed], self.P[seed]]))
        m = torch.tensor(n, device=self.dev)
        self._first_batch(self._width(), m, m.new_tensor(self.coef()))

    def _up(self, rows: list) -> torch.Tensor:
        """Small int64 host rows to the device: through a pinned buffer
        without waiting on a card (each is read by the card before the
        next host read returns, so the buffer is free again by then)."""
        if self.dev.type != "cuda":
            return torch.tensor(rows, device=self.dev)
        t = torch.tensor(rows).pin_memory()
        return t.to(self.dev, non_blocking=True)

    def _set(self, buf: torch.Tensor, rows: list) -> None:
        """Host ints into the device buffer `buf`, as `_up` sends them."""
        if self.dev.type != "cuda":
            buf.copy_(torch.tensor(rows))
            return
        buf.copy_(torch.tensor(rows).pin_memory(), non_blocking=True)

    def _width(self) -> int:
        """The columns of a step or batch: the active rows rounded up to
        `_STEP_COLS`."""
        return min(self.n, -(-self.m // _STEP_COLS) * _STEP_COLS)

    def _replay(self, key, fn) -> None:
        """fn(); on a card captured as a CUDA graph under `key` after its
        first, eager, run, and replayed from then on."""
        g = self.graphs.get(key)
        if g is not None:
            g.replay()
            return
        fn()
        if self.dev.type == "cuda":
            g = self.graphs[key] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=self.pool):
                fn()

    def _batch(self, w: int, k: int, top, bound, coef) -> None:
        """One batch of the search over the first w columns: the count
        of rows 1..top whose cache is below `bound`, the least cache of
        those below the batch, and the last k of them (descending; -1
        where there are fewer), each with its recomputed row's least
        value of Q less the row's own sum over its cells c < row and
        the last column at it, its cached Q and its own sum, into `out`
        after the head.  top, bound and coef (the Q coefficient in u)
        are device scalars.  The values fit int32 (|v| < 2**28 for
        n <= 2**18); the columns are reversed, so that the first least
        value `min` returns (its documented rule for ties) is the last
        column's."""
        ar, Q, sD2 = self.ar[:w], self.Q[:w], self.sD2[:w]
        below = (ar >= 1) & (ar <= top) & (Q < bound)
        rows = torch.where(below, ar, -1).topk(min(k, w)).values
        rest = torch.where(below & (ar < rows[-1]), Q, BIG).min()
        rc = rows.clamp(min=0)
        v = self.D[rc, :w].flip(1) * coef.to(torch.int32).view(1)
        v -= sD2.flip(0).to(torch.int32)
        v.masked_fill_(ar[None, :] <= (w - 1 - rows)[:, None], _BIG32)
        least = v.min(dim=1)
        self.out[3:5 + 5 * len(rows)].copy_(torch.cat([
            below.sum()[None], rest[None], rows, least.values,
            w - 1 - least.indices, Q.index_select(0, rc),
            sD2.index_select(0, rc)]))

    def _first_batch(self, w: int, m, coef) -> None:
        """The head and a join's first batch, from the last of the m
        active rows down, bounded by the seed's Q; `k0` its rows."""
        self.k0 = min(self.batch, w)
        h = self.head
        self.out[:3].copy_(h)
        bound = torch.where((h[0] > 0) & (h[1] != BIG), h[1], BIG)
        self._batch(w, self.batch, m - 1, bound, coef)

    def _walk(self, vals: list, k: int, minv: int, pos, taken: list):
        """Walk a batch of `out` (`vals` from its count on) in order:
        a row is taken if its cache is still below the walk's minimum
        `minv`; its recomputed (Q, P) joins `taken`.  Returns (minv,
        pos, the batch's lowest row)."""
        for r, v, cr, qo, sr in zip(*(vals[2 + a * k:2 + (a + 1) * k]
                                      for a in range(5))):
            if r < 1:
                break
            if qo < minv:
                vr = v - sr
                taken.append((r, vr, cr))
                if vr < minv:
                    minv, pos = vr, (r, cr)
        return minv, pos, r

    def pair(self):
        """The next pair (i, j), j < i, host ints: `dnj.py::_DNJ.pair`
        from the seed in `head`, the first batch already in `out`
        (`_first_batch`).  A further batch runs only while a row below
        the last batch has a cache below the walk's minimum; it takes
        the rows that may be left, at most four times the last batch's
        limit, rounded up to a power of two, over the columns below its
        top rounded up to `_STEP_COLS`.  The rows it takes are kept in
        `taken` for the next `step`."""
        k = self.k0
        vals = self.out[:5 + 5 * k].cpu().tolist()
        seed, qs, ps = vals[:3]
        minv, pos = BIG, (0, 0)
        if seed and qs != BIG:
            minv, pos = qs, (seed, ps)
        self.taken = taken = []
        count, rest = vals[3:5]
        if not count:
            return pos
        minv, pos, low = self._walk(vals[3:], k, minv, pos, taken)
        cap, coef = self.batch, self.coef()
        while rest < minv:
            cap = min(4 * cap, _MAX_ROWS)
            w = min(self.n, -(-low // _STEP_COLS) * _STEP_COLS)
            k = min(1 << (min(cap, count - k) - 1).bit_length(), cap, w)
            self._set(self.cin, [low - 1, minv, coef])
            c = self.cin
            self._replay(("batch", w, k),
                         lambda: self._batch(w, k, c[0], c[1], c[2]))
            vals = self.out[3:5 + 5 * k].cpu().tolist()
            count, rest = vals[:2]
            if not count:
                break
            minv, pos, low = self._walk(vals, k, minv, pos, taken)
        return pos

    def step(self, t: int, i: int, j: int) -> None:
        """Join t on the pair (i, j): the search's cache updates, its
        record, the join, the compaction, the next seed and the next
        first batch (`_step`) over the first w columns (`_width`); on a
        card replayed from a CUDA graph of that width after its first
        step.  Cache updates beyond `batch` rows are written before."""
        w = self._width()
        taken, b, n = self.taken, self.batch, self.n
        if len(taken) > b:
            t_ = self._up(taken)
            self.Q[t_[:, 0]] = t_[:, 1]
            self.P[t_[:, 0]] = t_[:, 2]
            taken = []
        pad = [(n, BIG, 0)] * (b - len(taken))
        rows, qs, ps = zip(*(taken + pad)) if b else ((), (), ())
        self._set(self.inp, [i, j, self.m, t, *rows, *qs, *ps])
        self._replay(w, lambda: self._step(w))
        self.k0 = min(self.batch, w)
        self.m -= 1
        self.N = self.m

    def _lower(self, q, valid, j, Qj):
        """dnj.py's `_update_col`: lower the caches of the rows `valid`
        (of the first len(q)) through their Q `q` with row j; the row of
        the best lowered cache if it beats row j's own Qj, else j."""
        w = len(q)
        Q, P = self.Q[:w], self.P[:w]
        q = torch.where(valid, q, BIG)
        upd = valid & (q <= Q)
        torch.minimum(Q, q, out=Q)
        P.copy_(torch.where(upd, j, P))
        least = torch.where(upd, self.keys(q), BIG).min()
        mq, best = self.unkey(least)
        return torch.where((least < BIG) & (mq <= Qj), best, j)

    def _row_cache(self, r, rr, q):
        """Row r's cache from `q` (its Q less its own sum at each of the
        first len(q) columns): the minimum over its cells k < r and the
        last column at it; (BIG, 0) for row 0.  Returns (Q_r, own sum)."""
        w = len(q)
        v, c = self.unkey(torch.where(self.ar[:w] < r, self.keys(q),
                                      BIG).min())
        sr = self.sD2.index_select(0, rr)[0]
        Qr = torch.where(r > 0, v - sr, BIG)
        self.Q.index_copy_(0, rr, Qr.view(1))
        self.P.index_copy_(0, rr, torch.where(r > 0, c, 0).view(1))
        return Qr, sr

    def _step(self, w: int) -> None:
        """dnj.py's join(i, j), pop(i) and the next seed, over the first
        w >= m columns: a column k >= m is inactive, and the join
        computes nothing there.  At columns i and j the new distance is
        0 (s = D_ij there), the diagonal's at j; column i, and the sums
        of rows i and j, are rewritten before they are read again."""
        D, sD2, ar = self.D[:w, :w], self.sD2[:w], self.ar[:w]
        Q, b = self.Q, self.batch
        i, j, m = self.inp[0], self.inp[1], self.inp[2]
        ii, jj, tt = self.inp[0:1], self.inp[1:2], self.inp[3:4]
        took = self.inp[4:4 + b]
        Q.index_copy_(0, took, self.inp[4 + b:4 + 2 * b])
        self.P.index_copy_(0, took, self.inp[4 + 2 * b:4 + 3 * b])
        act = ar < m
        Di = D.index_select(0, ii)[0].long()
        qij = Di.index_select(0, jj)
        self.rec.index_copy_(0, tt, torch.cat(
            [qij, sD2.index_select(0, ii), sD2.index_select(0, jj)])[None])
        # the join: row i folds into row j
        s = Di + D.index_select(0, jj)[0]
        d2 = torch.where(act, (s - qij).clamp(min=0), 0)  # 2 ByteScale d2
        sD2 -= 2 * s - d2
        new = ((2 * d2 + 1) >> 2).clamp(max=self.qmax).to(torch.uint8)
        D.index_copy_(0, jj, new[None])
        D.index_copy_(1, jj, new[:, None])
        sD2.index_copy_(0, jj, d2.sum()[None])
        coef = 2 * (m - 3)             # N = m - 1 once row i is folded
        q = coef * new.long() - sD2
        Qj, sj = self._row_cache(j, jj, q)
        mi = self._lower(q - sj, (ar > j) & act & (ar != i), j, Qj)
        # the compaction: the last row moves into row i
        last = m - 1
        rowl = D.index_select(0, last[None])[0]
        rowl = torch.where(ar == i, 0, rowl).to(torch.uint8)
        D.index_copy_(0, ii, rowl[None])
        D.index_copy_(1, ii, rowl[:, None])
        sD2.index_copy_(0, ii, sD2.index_select(0, last[None]))
        q = coef * rowl.long() - sD2
        Qi, si = self._row_cache(i, ii, q)
        mj = self._lower(q - si, (ar > i) & (ar < last), i, Qi)
        mj = torch.where(i != last, mj, 0)
        # the next seed
        qi, qj = Q.index_select(0, mi[None]), Q.index_select(0, mj[None])
        pick = torch.where((qj < qi) | ((mi < mj) & (qj == qi)), mj, mi)
        seed = torch.where(mj == last, mi, torch.where(mi == last, mj, pick))
        self.head.copy_(torch.cat([seed, Q.index_select(0, seed),
                                   self.P.index_select(0, seed)]))
        self._first_batch(w, m - 1, coef)


def newick(cells, n: int, names: list, bytescale: float = 1.0, dev="cpu",
           qmax: int = 255, batch: int = 16) -> bytes:
    """The Newick text (without the closing ';') of `ccphylo tree -m dnj
    -b` at its defaults (flag 0: a trifurcating root, limbs clipped at 0;
    precision 9) on the complete lower triangle of n taxa's u8 cells
    `cells` (ByteScale applied, as the -b loader stores them), the
    matrix on the device `dev`.  `names` is a list of RefName and is
    rearranged as the reference rearranges it."""
    st = _DNJ8(cells, n, bytescale, torch.device(dev), qmax, batch)
    st.init_rows()
    T = n - 2
    IJ = []
    for t in range(T):
        i, j = st.pair()
        IJ.append((i, j))
        st.step(t, i, j)
    d_last = int(st.D[1, 0]) / st.bs
    # limbLength (nj.c:42-79, dnj.py::_DNJ.limbs) in float64, a join a row
    r = st.rec[:T].cpu().numpy().astype(np.float64)
    u = 1.0 / (2.0 * st.bs)
    Dij = r[:, 0] / st.bs
    sDi, sDj = r[:, 1] * u, r[:, 2] * u
    Nm = np.arange(n, n - T, -1, dtype=np.float64) - 2.0
    delta = (sDi - Dij) / Nm - (sDj - Dij) / Nm
    Li = (Dij + delta) / 2.0
    Lj = (Dij - delta) / 2.0
    neg_i = Li < 0
    neg_j = ~neg_i & (Lj < 0)
    Li, Lj = (np.where(neg_i, 0.0, np.where(neg_j, Dij, Li)),
              np.where(neg_i, Dij, np.where(neg_j, 0.0, Lj)))
    m = n
    for t, (i, j) in enumerate(IJ):
        form_node(names[j], names[i], Lj[t], Li[t])
        m -= 1
        names[i], names[m] = names[m], names[i]
    form_last_node(names[0], names[1], d_last)
    if not names[0].data.startswith(b"("):
        names[0].data = b"(" + names[0].data
    return names[0].data


__all__ = ["RefName", "newick", "square_u8"]
