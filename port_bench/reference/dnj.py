"""Plain reference of `ccphylo tree -m dnj` on a complete matrix.

A straightforward NumPy rewrite of the dynamic neighbour-joining of
ccphylo (Clausen, Bioinformatics 2023, btac774; the C reference's dnj.c,
nj.c and nwck.c): per-row cached minima of the Q criterion, rows
revalidated only where their cached bound beats the running minimum,
the reference's tie rules, limb lengths, the compaction that moves the
last row into the joined slot, and the Newick text with its buffer
capacities.  It works on a dense symmetric matrix and knows complete
matrices only (every benchmark matrix is complete).

It imports nothing of the program under test.  `ftype` sets the
precision of every stored value and every sum (float64 is the
configuration's; float32 is the control's), `qmax` the largest cell of
a quantized (`-b`) matrix (255 for u8 cells; 15 is the control's 4-bit
cells).
"""

from __future__ import annotations

import numpy as np


class RefName:
    """A Newick buffer: its text and the capacity the reference's
    buffer has, which decides which operand a node is built into."""

    __slots__ = ("data", "cap")

    def __init__(self, data: bytes, cap: int):
        self.data = data
        self.cap = cap


def _fmt(L) -> bytes:
    return b"%.9f" % float(L)


def _swap_if_smaller(a: RefName, b: RefName) -> bool:
    if a.cap < b.cap:
        a.data, b.data = b.data, a.data
        a.cap, b.cap = b.cap, a.cap
        return True
    return False


def _grow(a: RefName, b: RefName) -> None:
    need = len(a.data) + len(b.data) + 32
    if a.cap < need:
        a.cap = need


def form_node(a: RefName, b: RefName, La, Lb) -> None:
    if _swap_if_smaller(a, b):
        La, Lb = Lb, La
    _grow(a, b)
    a.data = (b"(" + a.data + b":" + _fmt(La) + b","
              + b.data + b":" + _fmt(Lb) + b")")


def form_last_node(a: RefName, b: RefName, L) -> None:
    _swap_if_smaller(a, b)
    _grow(a, b)
    a.data = a.data[:-1] + b"," + b.data + b":" + _fmt(L) + b")"


class _DNJ:
    """State of one run: D (dense, symmetric), sD, N, the row caches
    Q/P, and m, the active rows 0..m-1."""

    def __init__(self, flat, n: int, dtype: str, bytescale: float,
                 ftype, qmax: int):
        self.f = ftype
        self.big = np.finfo(ftype).max
        self.quant = dtype == "b"
        self.bs = ftype(bytescale)
        self.qmax = qmax
        D = np.zeros((n, n), np.float64)
        D[np.tril_indices(n, -1)] = np.asarray(flat, np.float64)
        D = D + D.T
        if self.quant:
            # loading rounds half up into an unsigned byte
            D = np.clip(np.floor(D * bytescale + 0.5), 0, qmax) / bytescale
            np.fill_diagonal(D, 0.0)
        self.D = D.astype(ftype)
        self.m = n
        off = ~np.eye(n, dtype=bool)
        # each row summed left to right, as the reference accumulates
        self.sD = np.cumsum(self.D[off].reshape(n, n - 1), axis=1)[:, -1] \
            .astype(ftype)
        self.N = np.full(n, n, np.int64)
        self.Q = np.full(n, self.big, ftype)
        self.P = np.zeros(n, np.int64)

    def store(self, d2):
        """A new cell as the matrix keeps it (u8 cells truncate d + 1/4)."""
        if not self.quant:
            return d2
        q = np.clip(np.floor(d2 * self.bs + self.f(0.25)), 0, self.qmax)
        return (q / self.bs).astype(self.f)

    def row_q(self, i: int):
        """Q of row i's cells k < i."""
        coef = ((self.N[i] + self.N[:i] - 4) >> 1).astype(self.f)
        return coef * self.D[i, :i] - self.sD[i] - self.sD[:i]

    def col_q(self, j: int, ks):
        coef = ((self.N[j] + self.N[ks] - 4) >> 1).astype(self.f)
        return coef * self.D[ks, j] - self.sD[j] - self.sD[ks]

    def row_min_last(self, i: int):
        """(row minimum, last column that attains it); (big, 0) if the
        row has no cell."""
        if i == 0:
            return self.big, 0
        q = self.row_q(i)
        v = q.min()
        return v, int(np.flatnonzero(q == v)[-1])

    def init_rows(self) -> None:
        """Row caches: the row's minimum; among equal minima the least
        distance, the last of those."""
        m = self.m
        for i in range(1, m):
            q = self.row_q(i)
            v = q.min()
            cand = np.flatnonzero(q == v)
            d = self.D[i, cand]
            self.Q[i] = v
            self.P[i] = int(cand[np.flatnonzero(d == d.min())[-1]])

    def first_seed(self) -> int:
        q = self.Q[1:self.m]
        return 1 + int(np.flatnonzero(q == q.min())[-1])

    def pair(self, seed: int):
        """The next pair (i, j), j < i: from the last row down, each row
        whose cached bound beats the running minimum is recomputed."""
        pos = (0, 0)
        minv = self.big
        if seed and self.Q[seed] != self.big:
            minv = self.Q[seed]
            pos = (seed, int(self.P[seed]))
        i = self.m - 1
        while i >= 1:
            below = np.flatnonzero(self.Q[1:i + 1] < minv)
            if below.size == 0:
                break
            i = 1 + int(below[-1])
            v, c = self.row_min_last(i)
            self.Q[i] = v
            self.P[i] = c
            if v < minv:
                minv = v
                pos = (i, c)
            i -= 1
        return pos

    def limbs(self, i: int, j: int):
        f = self.f
        Dij = self.D[i, j]
        Ni = f(self.N[i] - 2)
        Nj = f(self.N[j] - 2)
        delta = (self.sD[i] - Dij) / Ni - (self.sD[j] - Dij) / Nj
        Li = (Dij + delta) / f(2)
        Lj = (Dij - delta) / f(2)
        if Li < 0:
            Li, Lj = f(0), Dij
        elif Lj < 0:
            Li, Lj = Dij, f(0)
        return Li, Lj

    def _update_col(self, j: int, ks) -> int:
        """Lower the caches of rows ks through their cell (k, j); the
        row of the best lowered cache if it beats row j's own."""
        p = j
        if len(ks):
            q = self.col_q(j, ks)
            upd = q <= self.Q[ks]
            if upd.any():
                self.Q[ks[upd]] = q[upd]
                self.P[ks[upd]] = j
                mq = q[upd].min()
                if mq <= self.Q[j]:
                    p = int(ks[upd & (q == mq)][-1])
        return p

    def join(self, i: int, j: int) -> int:
        """Fold row i into row j; returns the seed row of the update."""
        m, D = self.m, self.D
        f = self.f
        ks = np.concatenate([np.arange(j), np.arange(j + 1, i),
                             np.arange(i + 1, m)])
        s = D[i, ks] + D[j, ks]
        d2 = (s - D[i, j]) / f(2)
        d2 = np.where(d2 < 0, f(0), d2).astype(f)
        self.sD[ks] = self.sD[ks] - (s - d2)
        self.N[ks] -= 1
        new = self.store(d2)
        D[j, ks] = new
        D[ks, j] = new
        self.N[j] = m - 1
        self.sD[j] = np.cumsum(d2)[-1] if len(d2) else f(0)
        self.Q[j], self.P[j] = self.row_min_last(j)
        return self._update_col(j, ks[ks > j])

    def pop(self, pos: int) -> int:
        """Drop row pos: the last row moves into it."""
        self.m -= 1
        last = self.m
        if pos == last:
            return 0
        D = self.D
        self.sD[pos] = self.sD[last]
        self.N[pos] = self.N[last]
        ks = np.concatenate([np.arange(pos), np.arange(pos + 1, last)])
        D[pos, ks] = D[last, ks]
        D[ks, pos] = D[last, ks]
        self.Q[pos], self.P[pos] = self.row_min_last(pos)
        return self._update_col(pos, np.arange(pos + 1, last))


def newick(flat, n: int, names: list, dtype: str = "d",
           bytescale: float = 1.0, ftype=np.float64, qmax: int = 255) -> bytes:
    """The Newick text (without the closing ';') of `ccphylo tree -m dnj`
    at its defaults (flag 0: a trifurcating root, limbs clipped at 0;
    precision 9) on the complete lower triangle `flat` of n taxa.
    `names` is a list of RefName and is rearranged as the reference
    rearranges it."""
    st = _DNJ(flat, n, dtype, bytescale, ftype, qmax)
    st.init_rows()
    j = st.first_seed()
    while st.m != 2:
        i, j = st.pair(j)
        Li, Lj = st.limbs(i, j)
        form_node(names[j], names[i], Lj, Li)
        mi = st.join(i, j)
        mj = st.pop(i)
        m = st.m
        names[i], names[m] = names[m], names[i]
        if mj == m:
            j = mi
        elif mi == m:
            j = mj
        else:
            Q = st.Q
            j = mj if (Q[mj] < Q[mi] or (mi < mj and Q[mj] == Q[mi])) \
                else mi
    form_last_node(names[0], names[1], st.D[1, 0])
    if not names[0].data.startswith(b"("):
        names[0].data = b"(" + names[0].data
    return names[0].data
