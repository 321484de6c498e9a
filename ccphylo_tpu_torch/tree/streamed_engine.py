"""Row-cache packed DNJ: the engine for a matrix that does not fit the
card (counterpart of tree/streamed_engine.py).

The reference implementation reaches a million taxa on one node by
keeping the quantized matrix on disk behind mmap (matrix.c:116-231,
dnj.c:985-1162).  Here the canonical u8 matrix lives in HOST memory (an
ndarray or an np.memmap), and the card holds a CACHE of X rows,
(X, n/4) int32 words (four u8 cells each), addressed through
`slotof[row] -> slot` and `rowof[slot] -> row`.  Resident rows are kept
current in place: every join writes its two changed rows in full and,
by the matrix's symmetry, the matching byte column into every slot, so
a cached row is simply always current and scans are pure reads.

Join arithmetic is the packed engine's (tree/packed_engine.py), cell
for cell, in the same exact int32 u-units, so the records
(I, J, DIJ2, SDI2, SDJ2, d_last2) and the final host matrix equal the
packed engine's at any cache size: the cache decides WHEN a row is
read, never what it holds.

Design for a host-driven join loop.  The reference runs its joins
inside a device loop and aborts a segment at the first missing row,
because a dispatch and a read from its device cost it dearly.  The
port's join loop is driven from the host, which reads the device once
per scan pass anyway, so the host keeps the authoritative
`slotof`/`rowof` and tests residency BEFORE a pass or a join runs:

- a scan pass reads its candidate rows to the host (the pass's one
  host read), installs the missing ones, then runs the row minima on
  the card: `ops/scan.py::qrow_mins` with the slot argument, the
  hand-written kernel reading row r at cache[slotof[r]].  A scan is
  never interrupted, so its revalidations of Q and P always come from
  one pass over pristine gating;
- the pick rows i, j and the popArrange source `last` are made
  resident before the join writes anything.

A miss therefore costs one upload, not a redone segment.  The host
matrix is brought up to date by an exact-integer replay of each join
(`_replay_join`, two rows and two strided byte columns of the n x n
matrix), which also mirrors the sD2/Q/P caches for the residency
policy.  The replay runs right after its join is queued on the card,
so the host matrix is current whenever an upload reads rows of it.

Residency policy, as in the reference: free slots first, then the
highest-Q residents outside a protect set (the rows needed now, the
recently missed rows, the next popArrange sources); with the missing
rows go the rows whose bound the last repairs lowered (the next joins'
candidates and seeds) and, now and then, a bottom-Q slab.  A working
set that cannot fit the cache raises (the livelock guard).

Not carried over, as workarounds of the reference's device: per-row
dynamic slices and update loops, the 128-word tile-stripe
read-modify-write of a byte column (here a strided byte write through
the cache's uint8 view), upload batches bucketed against recompiles,
zero-join dispatches for the initial fill, and segment retuning.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from ..native import get_lib
from ..ops.join import _last_min
from ..ops.scan import dnj_scan_passes, qrow_mins
from ..ops.select import IBIG, consts
from ..utils.torchconfig import device as default_device
from .segmenting import run_segmented

STAGE_ROWS = 1024  # rows of one upload copy (a pinned staging buffer each)
SPEC_EVERY = 64    # joins between speculative pushes without a miss

_STATE_KEYS = ("cache", "slotof", "rowof", "sD2", "Q", "P", "seed", "I",
               "J", "DIJ2", "SDI2", "SDJ2", "stats")


# ---------------------------------------------------------------------
# host side: init and replay


def _host_init(Dq: np.ndarray, m: int, chunk: int = 4096):
    """sD2 / Q / P / seed in exact int32 u-units from the host matrix
    (the numpy twin of packed_engine._packed_init).  Prefers the native
    single-pass routine (init_hnj_u8, one sequential read of the
    matrix); bit-exact either way."""
    n = Dq.shape[0]
    if Dq.flags["C_CONTIGUOUS"]:
        lib = get_lib()
        if lib is not None:
            sD2 = np.zeros(n, np.int32)
            Q = np.zeros(n, np.int32)
            P = np.zeros(n, np.int32)
            p_i32 = ctypes.POINTER(ctypes.c_int32)
            seed = lib.init_hnj_u8(
                Dq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n, int(m),
                sD2.ctypes.data_as(p_i32), Q.ctypes.data_as(p_i32),
                P.ctypes.data_as(p_i32))
            return sD2, Q, P, max(int(seed), 0)
    return _host_init_np(Dq, m, chunk)


def _host_init_np(Dq: np.ndarray, m: int, chunk: int = 4096):
    """Pure-numpy form (and the native routine's parity oracle)."""
    n = Dq.shape[0]
    big = np.int32(IBIG)
    idx = np.arange(n, dtype=np.int64)
    act = idx < m
    sD2 = np.zeros(n, np.int32)
    for r0 in range(0, m, chunk):
        r1 = min(r0 + chunk, m)
        blk = Dq[r0:r1].astype(np.int32)
        v = act[None, :] & (idx[r0:r1, None] != idx[None, :])
        sD2[r0:r1] = 2 * np.where(v, blk, 0).sum(axis=1, dtype=np.int32)
    Q = np.full(n, big, np.int32)
    P = np.zeros(n, np.int32)
    co0 = 2 * (m - 2)
    for r0 in range(0, m, chunk):
        r1 = min(r0 + chunk, m)
        blk = Dq[r0:r1].astype(np.int32)
        rows = idx[r0:r1]
        lv = act[None, :] & (idx[None, :] < rows[:, None])
        Qm = np.where(lv, co0 * blk - sD2[r0:r1, None] - sD2[None, :], big)
        Qc = Qm.min(axis=1)
        cand = lv & (Qm == Qc[:, None])
        dmask = np.where(cand, blk, big)
        prefmin = np.minimum.accumulate(dmask, axis=1)
        sel = cand & (dmask == prefmin)
        Pc = np.where(sel, idx[None, :], -1).max(axis=1)
        Q[r0:r1] = Qc
        P[r0:r1] = np.maximum(Pc, 0)
    qrows = np.where((idx >= 1) & act, Q, big)
    mn0 = qrows.min()
    seed0 = int(np.where(qrows == mn0, idx, -1).max()) if m > 1 else 0
    return sD2, Q, P, max(seed0, 0)


def _replay_join_mirrored(Dq, sD2, Q, P, i, j, m_t, idx, big):
    """Replay ONE join on the host matrix and mirror the device join's
    exact int32 cache updates in the device's order: sD2 deltas from
    the pre-join rows, the matrix row/column writes, the fresh row-j /
    moved-row-i minima, and the column repair tests.  Returns the rows
    whose bound the repairs LOWERED: the next joins' scan candidates
    and seeds, i.e. the speculative upload set.  Q drifts low against
    the device (scan revalidations, which only raise bounds, are not
    mirrored): policy only, resynced at refreshes.  int32 arithmetic
    wraps as the device's does."""
    with np.errstate(over="ignore"):
        co = np.int32(2 * (m_t - 3))
        last = m_t - 1
        ci = Dq[i].astype(np.int32)
        cj = Dq[j].astype(np.int32)
        cij = np.int32(ci[j])
        valid_k = (idx < m_t) & (idx != i) & (idx != j)
        d_new = np.maximum(ci + cj - cij, 0).astype(np.int32)
        sD2 -= np.where(valid_k,
                        (2 * ci + 2 * cj - d_new).astype(np.int32), 0)
        sD2[j] = np.where(valid_k, d_new, 0).sum(dtype=np.int32)
        q_new = np.minimum((2 * d_new + 1) >> 2, 255).astype(np.uint8)
        rowj8 = np.where(valid_k, q_new, Dq[j])
        Dq[j, :] = rowj8
        Dq[:, j] = rowj8
        rowj = rowj8.astype(np.int32)
        qj = co * rowj - sD2[j] - sD2
        qj = np.where(idx < j, qj, big)
        Qj = qj.min()
        Pj = int(np.where(qj == Qj, idx, -1).max())
        Q[j] = Qj
        P[j] = 0 if Qj == big else Pj
        qcol = co * rowj - sD2[j] - sD2
        upd = valid_k & (idx > j) & (qcol <= Q)
        Q[upd] = qcol[upd]
        P[upd] = j
        hot = [int(r) for r in np.nonzero(upd)[0]]
        if i != last:
            moved = Dq[last].copy()
            moved[i] = 0
            Dq[i, :] = moved
            Dq[:, i] = moved
            sD2[i] = sD2[last]
            rowi = moved.astype(np.int32)
            qi = co * rowi - sD2[i] - sD2
            qi = np.where(idx < i, qi, big)
            Qi = qi.min()
            Pi = int(np.where(qi == Qi, idx, -1).max())
            Q[i] = Qi
            P[i] = 0 if Qi == big else Pi
            qc = co * rowi - sD2[i] - sD2
            u2 = (idx > i) & (idx < last) & (qc <= Q)
            Q[u2] = qc[u2]
            P[u2] = i
            hot += [int(r) for r in np.nonzero(u2)[0]]
        Q[last] = big
    return hot


def _replay_join(Dq, sD2, Q, P, i, j, m_t, idx, hot=None, scratch=None):
    """`_replay_join_mirrored` through the native routine
    (replay_join_u8: one pass in C) where the library is there and the arrays are contiguous; the numpy
    form otherwise.  Bit-exact either way; returns the lowered rows as
    an int64 array.  `hot` (n int32) and `scratch` (2n int32) are work
    space."""
    lib = get_lib()
    mirrors = (sD2, Q, P)
    if lib is None or Dq.dtype != np.uint8 \
            or not all(a.flags["C_CONTIGUOUS"] for a in (Dq, *mirrors)) \
            or not all(a.dtype == np.int32 and a.shape == Dq.shape[:1]
                       for a in mirrors):
        return np.asarray(_replay_join_mirrored(
            Dq, sD2, Q, P, i, j, m_t, idx, np.int32(IBIG)), np.int64)
    n = Dq.shape[0]
    hot = np.empty(n, np.int32) if hot is None else hot
    scratch = np.empty(2 * n, np.int32) if scratch is None else scratch
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    k = lib.replay_join_u8(
        Dq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, int(i),
        int(j), int(m_t), *(a.ctypes.data_as(p_i32)
                            for a in (sD2, Q, P, hot, scratch)))
    return hot[:k].astype(np.int64)


def _ordered_unique(rows) -> np.ndarray:
    """The distinct values of `rows` in the order of their first
    appearance, int64."""
    a = np.asarray(rows, np.int64).ravel()
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def _host_replay_shift(Dq, I_h, J_h, off, t1, m):
    """Replay the records I_h/J_h of joins off..t1 on the host matrix
    (matrix only, no cache mirrors)."""
    n = Dq.shape[0]
    idx = np.arange(n)
    for k in range(t1 - off):
        t = off + k
        i, j = int(I_h[k]), int(J_h[k])
        if i == 0 and j == 0:
            continue
        m_t = m - t
        ci = Dq[i].astype(np.int32)
        cj = Dq[j].astype(np.int32)
        cij = int(ci[j])
        active = idx < m_t
        valid_k = active & (idx != i) & (idx != j)
        d_new = np.maximum(ci + cj - cij, 0)
        q_new = np.minimum((2 * d_new + 1) >> 2, 255).astype(np.uint8)
        rowj = np.where(valid_k, q_new, Dq[j])
        Dq[j, :] = rowj
        Dq[:, j] = rowj
        last = m_t - 1
        if i != last:
            moved = Dq[last].copy()
            moved[i] = 0
            Dq[i, :] = moved
            Dq[:, i] = moved
    return Dq


# ---------------------------------------------------------------------
# the engine


class StreamedDNJ:
    """The row-cache packed DNJ: host loop, cache and residency policy.

    Parameters
    ----------
    Dq : (npad, npad) uint8 host matrix (ndarray or np.memmap), padded
         with zero rows/cols beyond `m` (use `packed_engine.pad_packed`);
         updated in place by the replay.
    m  : active taxa.
    X  : cache rows (device memory ~ X * npad bytes).
    F  : accepted for compatibility with the reference; unused.
    kbatch : candidate rows per scan pass.
    prefetch, horizon : sizes of the policy's bottom-Q slab and of its
         popArrange window.
    device : torch device, default that of utils/torchconfig.py (the
         card).

    After `run`: `uploaded_rows`, `uploaded_bytes`, `aborts` (the miss
    events: a pass or a join that had to wait for an upload), `stats`
    (passes, rows whose Q changed, miss events), and `times`, the host
    seconds of the run, of its uploads and of the replay.
    """

    def __init__(self, Dq: np.ndarray, m: int, X: int = 4096,
                 F: int = 512, kbatch: int = 128, prefetch: int = 1024,
                 horizon: int = 2048, verbose: bool = False, device=None):
        n = Dq.shape[0]
        if Dq.shape != (n, n) or Dq.dtype != np.uint8:
            raise ValueError("Dq must be a square uint8 matrix")
        if n % 16 or not 1 <= X <= n:
            raise ValueError(f"need n % 16 == 0 and 1 <= X <= n, got "
                             f"n={n}, X={X}")
        self.Dq = Dq
        self.n, self.m = n, int(m)
        self.X, self.F = X, F
        self.kbatch = kbatch
        self.dev = default_device() if device is None \
            else torch.device(device)
        # optional (non-protected) residency headroom, clamped so the
        # policy rows can never crowd out the required working set
        self.prefetch = min(prefetch, X // 4)
        self.horizon = min(horizon, X // 2)
        self.verbose = verbose
        self.W = n // 4
        self.uploaded_rows = 0
        self.uploaded_bytes = 0
        self.aborts = 0
        self.times = {"run_s": 0.0, "upload_s": 0.0, "replay_s": 0.0}
        # the authoritative residency maps
        self.slotof_h = np.full(n, -1, np.int64)
        self.rowof_h = np.full(X, -1, np.int64)
        # host mirrors of the device's caches: POLICY ONLY (eviction
        # order, prefetch slabs); staleness cannot affect the records
        self.Qh = np.zeros(n, np.int32)
        self.Ph = np.zeros(n, np.int32)
        self.sD2h = None
        # recently missed rows, protected from eviction: uploading only
        # the current miss can evict rows the next passes still need
        self._recent = []
        self._spec = []   # arrays of rows whose bound the repairs lowered
        self._idx = np.arange(n)
        self._hot = np.empty(n, np.int32)          # work space of the
        self._scratch = np.empty(2 * n, np.int32)  # native replay
        self._t = 0
        self.st = None

    # -- the host matrix ----------------------------------------------
    def _replay(self, i, j, m_t):
        t0 = time.perf_counter()
        hot = _replay_join(self.Dq, self.sD2h, self.Qh, self.Ph, i, j, m_t,
                           self._idx, self._hot, self._scratch)
        self._spec.append(hot)
        self.times["replay_s"] += time.perf_counter() - t0

    # -- residency ----------------------------------------------------
    def _policy_rows(self, Q_h, P_h, seed, t_now):
        """The speculative residency set from a Q snapshot: the scan
        candidate prefix of the next join, a bottom-Q slab (late-pass
        candidates and likely seeds) with its partners, and the
        popArrange horizon.  Required rows first."""
        m_t = self.m - t_now
        idx = self._idx
        seed_ok = (seed != 0) and (Q_h[seed] != IBIG)
        minv0 = Q_h[seed] if seed_ok else IBIG
        rows = [m_t - 1]
        if seed_ok:
            rows += [seed, int(P_h[seed])]
        cand = np.nonzero((idx >= 1) & (idx < m_t) & (Q_h < minv0))[0]
        cap = min(max(self.X // 8 - len(rows), 0), 2048)
        rows.extend(int(r) for r in cand[::-1][:cap])
        act = np.arange(1, m_t)
        order = act[np.argsort(Q_h[1:m_t], kind="stable")]
        slab = order[:self.prefetch]
        rows.extend(int(r) for r in slab)
        # the partners of the slab: the next joins' seeds come from it
        # and each join needs (seed, P[seed])
        rows.extend(int(r) for r in np.unique(P_h[slab]) if r >= 1)
        rows.extend(range(max(m_t - self.horizon, 0), m_t))
        return rows

    def _policy_refresh(self, t_now):
        """Resync the Q/P mirrors from the device (one read) and return
        the policy's residency set."""
        st = self.st
        snap = torch.cat([st["Q"], st["P"], st["seed"].to(torch.int32)]) \
            .cpu().numpy()
        n = self.n
        self.Qh, self.Ph = snap[:n].copy(), snap[n:2 * n].copy()
        return self._policy_rows(self.Qh, self.Ph, int(snap[2 * n]), t_now)

    def _plan_upload(self, rows_needed, protect, max_new=None):
        """Give `rows_needed` (required rows first) cache slots: free
        slots first, then those of the highest-Q residents outside
        `protect`; rows that find no slot are dropped.  Updates the
        host maps and returns (rows, slots, evicted rows)."""
        rowof_h, slotof_h = self.rowof_h, self.slotof_h
        m_t = self.m - self._t
        want = _ordered_unique(rows_needed)
        want = want[(want >= 0) & (want < m_t)]
        want = want[slotof_h[want] < 0][:max_new].tolist()
        if not want:
            return [], [], []
        free = np.nonzero(rowof_h < 0)[0][:len(want)]
        slots = [int(s) for s in free]
        short = len(want) - len(slots)
        evicted = []
        if short > 0:
            prot = np.zeros(self.n, bool)
            prot[np.fromiter(protect, np.int64)] = True
            prot[want] = True
            res_rows = rowof_h[rowof_h >= 0]
            keep = res_rows[~prot[res_rows]]
            if len(keep) > short:
                top = np.argpartition(self.Qh[keep], len(keep) - short)
                keep = keep[top[len(keep) - short:]]
            evicted = [int(r) for r in keep]
            slots += [int(slotof_h[r]) for r in evicted]
        rows = want[:len(slots)]
        for r in evicted:
            slotof_h[r] = -1
        for r, s in zip(rows, slots):
            rowof_h[s] = r
            slotof_h[r] = s
        return rows, slots, evicted

    def _install(self, rows, slots, evicted):
        """Copy the planned rows from the host matrix into their slots
        and bring the device's maps up to date: rows gathered into a
        pinned staging buffer, one copy per STAGE_ROWS rows."""
        if not rows:
            return
        st, dev, n = self.st, self.dev, self.n
        C8 = st["cache"].view(torch.uint8)
        meta = np.full((3, max(len(rows), len(evicted))), n, np.int64)
        meta[0, :len(rows)] = rows
        meta[1, :len(rows)] = slots
        meta[2, :len(evicted)] = evicted
        meta = torch.from_numpy(meta).to(dev)
        full = self._slotof_full  # slot n: the sink of the padding
        full.index_fill_(0, meta[2], -1)
        r_t, s_t = meta[0, :len(rows)], meta[1, :len(rows)]
        full.index_copy_(0, r_t, s_t.to(torch.int32))
        self._rowidx.index_copy_(0, s_t, r_t)
        for c0 in range(0, len(rows), STAGE_ROWS):
            rs = rows[c0:c0 + STAGE_ROWS]
            buf, view, done = self._stage[self._stage_turn]
            self._stage_turn ^= 1
            if done is not None:
                done.synchronize()  # the buffer's last copy has left it
            np.take(self.Dq, rs, axis=0, out=view[:len(rs)], mode="clip")
            C8.index_copy_(0, s_t[c0:c0 + len(rs)],
                           buf[:len(rs)].to(dev, non_blocking=True))
            if done is not None:
                done.record()
        self.uploaded_rows += len(rows)
        self.uploaded_bytes += len(rows) * n

    def _ensure(self, rows):
        """Make `rows` (ints; negative = padding) resident, all at
        once.  Raises when they cannot all be in the cache together."""
        need = np.asarray(rows, np.int64)
        need = need[need >= 0]
        missing = need[self.slotof_h[need] < 0]
        if len(missing) == 0:
            return
        t0 = time.perf_counter()
        self.aborts += 1
        missing = [int(r) for r in dict.fromkeys(missing.tolist())]
        need = need.tolist()
        # with the missing rows: the repair-lowered rows and, throttled,
        # a fresh policy set
        req = [missing, self._take_spec(1024)]
        if self.aborts % 64 == 1:
            req.append(self._policy_refresh(self._t))
        req = np.concatenate([np.asarray(r, np.int64) for r in req])
        win = min(4 * self.kbatch, self.X // 2)
        self._recent = (self._recent + missing)[-win:]
        # the next popArrange sources: idle rows carry a high Q, so
        # highest-Q-first eviction would pick exactly the rows every
        # coming join must touch
        m_t = self.m - self._t
        hz = range(max(m_t - min(512, self.X // 8), 0), m_t)
        self._install(*self._plan_upload(
            req, protect=[*need, *self._recent, *hz], max_new=2048))
        if (self.slotof_h[missing] < 0).any():
            # the wider protect set left too little to evict
            self._install(*self._plan_upload(missing, protect=need))
        if (self.slotof_h[need] < 0).any():
            raise RuntimeError(
                "streamed DNJ livelock: the rows one step needs at once "
                f"({len(set(need))}) exceed the cache (X={self.X}); rerun "
                "with a larger X")
        self.times["upload_s"] += time.perf_counter() - t0
        if self.verbose:
            print(f"  miss@{self._t}: {len(missing)} rows "
                  f"(last={m_t - 1}), uploaded so far "
                  f"{self.uploaded_rows}", flush=True)

    def _take_spec(self, limit):
        """The lowered rows gathered since the last call that are not
        resident, oldest first, at most `limit`."""
        if not self._spec:
            return np.zeros(0, np.int64)
        spec = _ordered_unique(np.concatenate(self._spec))
        self._spec = []
        return spec[self.slotof_h[spec] < 0][:limit]

    def _push_spec(self):
        """Without a miss: install the rows whose bound the last
        repairs lowered, ahead of the scans that will ask for them."""
        if not self._spec:
            return
        t0 = time.perf_counter()
        spec = self._take_spec(1024)
        if len(spec):
            m_t = self.m - self._t
            hz = range(max(m_t - min(512, self.X // 8), 0), m_t)
            self._install(*self._plan_upload(
                spec, protect=[*self._recent, *hz], max_new=1024))
        self.times["upload_s"] += time.perf_counter() - t0

    # -- one join -----------------------------------------------------
    def _col_write(self, C8, col, slot):
        """Write row `col`'s cells (storage row `slot`) down byte column
        `col` of every slot: the symmetric half of a row write.  Empty
        slots receive a stray byte: their content is dead until a
        full-row upload rebinds them."""
        C8[:, col] = C8[slot][self._rowidx]

    def _one_join(self, t):
        """Join t on the cache: ops/join.py::dnj_join_plain cell for cell,
        rows read and written through their slots, columns written to
        every slot."""
        st, m = self.st, self.m
        cache, sD2, Q, P = st["cache"], st["sD2"], st["Q"], st["P"]
        C8 = cache.view(torch.uint8)
        dev = self.dev
        BIG, ZERO, NEG1 = consts(dev)
        idx = self._idx_d
        self._t = t
        m_t = m - t
        co = 2 * (m_t - 2)
        last = m_t - 1

        res = dnj_scan_passes(cache, sD2, Q, P, st["seed"], m_t, co,
                              self.kbatch, qrow=self._qrow,
                              ensure=self._ensure)
        i, j = res[:2].tolist()
        st["stats"][:2] += res[2:]
        st["I"][t], st["J"][t] = i, j
        if i == 0 and j == 0:  # no joinable pair
            st["DIJ2"][t] = st["SDI2"][t] = st["SDJ2"][t] = 0
            Q[last] = IBIG
            st["seed"] = torch.zeros_like(st["seed"])
            return

        # the pick rows and the popArrange source are resident before
        # the join writes anything
        self._ensure([i, j, last])
        si, sj, sl = (int(self.slotof_h[r]) for r in (i, j, last))
        ci = C8[si, :m_t].to(torch.int32)
        cj = C8[sj, :m_t].to(torch.int32)
        cij = ci[j]
        st["DIJ2"][t] = 2 * cij
        st["SDI2"][t] = sD2[i]
        st["SDJ2"][t] = sD2[j]

        valid_k = torch.ones(m_t, dtype=torch.bool, device=dev)
        valid_k[i] = False
        valid_k[j] = False
        d_new = (ci + cj - cij).clamp_min(0)
        sa = sD2[:m_t]
        sa.copy_(torch.where(valid_k, sa - (2 * ci + 2 * cj - d_new), sa))
        sD2[j] = torch.where(valid_k, d_new, ZERO).sum(dtype=torch.int32)
        q_new = ((2 * d_new + 1) >> 2).clamp_max(255)
        rowj = torch.where(valid_k, q_new, cj)
        C8[sj, :m_t] = rowj.to(torch.uint8)
        self._col_write(C8, j, sj)

        co_post = 2 * (m_t - 3)
        qj = co_post * rowj - sD2[j] - sD2[:m_t]
        Qj, Pj = _last_min(qj[:j], idx)
        Q[j] = Qj
        P[j] = torch.where(Qj == IBIG, ZERO, Pj)
        s = slice(j + 1, m_t)
        qc, Qk = qj[s], Q[s]
        upd = qc <= Qk
        upd[i - j - 1] = False  # row i leaves with this join
        Qk.copy_(torch.where(upd, qc, Qk))
        P[s].masked_fill_(upd, j)
        mq = torch.where(upd, qc, BIG).min()
        hit = torch.where(upd & (qc == mq), idx[s], NEG1).max()
        mi_cand = torch.where(upd.any() & (mq <= Qj), hit, j).long()

        # popArrange: row `last` moves into row i.  Its cells are read
        # after row j's column write, which has set its cell j.
        if i != last:
            newrow = C8[sl].to(torch.int32)
            newrow[i] = 0
            C8[si] = newrow.to(torch.uint8)
            self._col_write(C8, i, si)
            sD2[i] = sD2[last]
            qi = co_post * newrow[:last] - sD2[i] - sD2[:last]
            Qi, Pi = _last_min(qi[:i], idx)
            Q[i] = Qi
            P[i] = torch.where(Qi == IBIG, ZERO, Pi)
            mj_cand = torch.full((1,), i, dtype=torch.long, device=dev)
            if i + 1 < last:
                s2 = slice(i + 1, last)
                qc2, Qk2 = qi[s2], Q[s2]
                u2 = qc2 <= Qk2
                Qk2.copy_(torch.where(u2, qc2, Qk2))
                P[s2].masked_fill_(u2, i)
                mq2 = torch.where(u2, qc2, BIG).min()
                hit2 = torch.where(u2 & (qc2 == mq2), idx[s2], NEG1).max()
                mj_cand = torch.where(u2.any() & (mq2 <= Qi), hit2,
                                      mj_cand)
        else:
            mj_cand = torch.zeros(1, dtype=torch.long, device=dev)
        Q[last] = IBIG
        # row `last` is gone either way: its slot is free
        self.rowof_h[sl] = -1
        self.slotof_h[last] = -1
        st["slotof"][last] = -1
        self._rowidx[sl] = 0

        Qmj, Qmi = Q[mj_cand], Q[mi_cand]
        st["seed"] = torch.where(
            mj_cand == last, mi_cand,
            torch.where(mi_cand == last, mj_cand,
                        torch.where((Qmj < Qmi)
                                    | ((mi_cand < mj_cand) & (Qmj == Qmi)),
                                    mj_cand, mi_cand)))

        # the same join on the host matrix, while the card works
        # through this one
        self._replay(i, j, m_t)
        if (t + 1) % SPEC_EVERY == 0:
            self._push_spec()

    # -- the run ------------------------------------------------------
    def _new_state(self):
        n, X, dev = self.n, self.X, self.dev
        sD2, Q, P, seed = _host_init(self.Dq, self.m)
        z = torch.zeros(n, dtype=torch.int32, device=dev)
        return {
            "cache": torch.zeros((X, self.W), dtype=torch.int32, device=dev),
            "slotof": torch.full((n,), -1, dtype=torch.int32, device=dev),
            "rowof": torch.full((X,), -1, dtype=torch.int64, device=dev),
            "sD2": torch.from_numpy(sD2).to(dev),
            "Q": torch.from_numpy(Q).to(dev),
            "P": torch.from_numpy(P).to(dev),
            "seed": torch.tensor([seed], dtype=torch.long, device=dev),
            "I": np.zeros(n, np.int32), "J": np.zeros(n, np.int32),
            "DIJ2": z, "SDI2": z.clone(), "SDJ2": z.clone(),
            "stats": torch.zeros(4, dtype=torch.int32, device=dev)}

    def _adopt(self, st):
        """Take `st` (a dict of _STATE_KEYS) as the run's state: build
        the host maps and mirrors and the device-side helpers from it."""
        n, X, dev = self.n, self.X, self.dev
        self.st = st
        self.slotof_h = st["slotof"].cpu().numpy().astype(np.int64)
        self.rowof_h = st["rowof"].cpu().numpy().astype(np.int64)
        self.sD2h = st["sD2"].cpu().numpy().copy()
        self.Qh = st["Q"].cpu().numpy().copy()
        self.Ph = st["P"].cpu().numpy().copy()
        # the kernel's slot map with one sink entry behind it, and the
        # gather index of a column write (empty slots read row 0)
        self._slotof_full = torch.cat(
            [st["slotof"], st["slotof"].new_full((1,), -1)])
        st["slotof"] = self._slotof_full[:n]
        self._rowidx = st.pop("rowof").clamp_min(0)
        self._idx_d = torch.arange(n, dtype=torch.int32, device=dev)
        self._qrow = functools.partial(qrow_mins, slots=st["slotof"])
        cuda = dev.type == "cuda"
        self._stage = []
        for _ in range(2):
            buf = torch.empty((min(STAGE_ROWS, X), n), dtype=torch.uint8,
                              pin_memory=cuda)
            self._stage.append((buf, buf.numpy(),
                                torch.cuda.Event() if cuda else None))
        self._stage_turn = 0

    def run(self, state=None, start: int = 0, stop: int | None = None,
            hooks=None):
        """Joins [start, stop) (default: all m-2).  `state`: a dict of
        _STATE_KEYS to go on from (interop.streamed_state_from_jax);
        the host matrix must then hold the joins before `start`.
        Returns (I, J, DIJ2, SDI2, SDJ2, d_last2): int32 numpy records
        in u = 1/(2*ByteScale) units, as packed_engine.dnj_joins_packed
        gives them; d_last2 is None when the run stops early."""
        t_run = time.perf_counter()
        total = max(self.m - 2, 0)
        stop = total if stop is None else min(stop, total)
        fresh = state is None
        self._adopt(self._new_state() if fresh else state)
        self._t = start
        if fresh and start < stop:
            # initial fill: the policy's set, required rows first
            t0 = time.perf_counter()
            req0 = self._policy_rows(self.Qh, self.Ph,
                                     int(self.st["seed"]), start)
            while True:
                plan = self._plan_upload(req0, protect=req0[:3],
                                         max_new=2048)
                if not plan[0]:
                    break
                self._install(*plan)
            self.times["upload_s"] += time.perf_counter() - t0

        def seg_call(st, t0, t1):
            for t in range(t0, t1):
                self._one_join(t)
            return st

        run_segmented(seg_call, self.st, stop, hooks=hooks, start=start)
        st = self.st
        stats = np.zeros(8, np.int64)
        stats[:2] = st["stats"][:2].cpu().numpy()
        stats[2] = self.aborts
        self.stats = stats
        self.times["run_s"] += time.perf_counter() - t_run
        d_last2 = 2 * int(self.Dq[1, 0]) if stop == total else None
        return (st["I"], st["J"], st["DIJ2"].cpu().numpy(),
                st["SDI2"].cpu().numpy(), st["SDJ2"].cpu().numpy(), d_last2)

    def state(self) -> dict:
        """The state after `run`, as a dict of _STATE_KEYS that a later
        `run(state=...)` goes on from."""
        st = dict(self.st)
        st["slotof"] = st["slotof"].clone()
        st["rowof"] = torch.from_numpy(self.rowof_h.copy()).to(self.dev)
        return st


def dnj_joins_streamed(Dq: np.ndarray, m: int, X: int = 4096,
                       F: int = 512, kbatch: int = 128,
                       verbose: bool = False, device=None, **kw):
    """Run all m-2 joins with the row-cache engine; returns
    (I, J, DIJ2, SDI2, SDJ2, d_last2), the same exact-int32 records as
    packed_engine.dnj_joins_packed, as numpy arrays.  The engine that
    ran is left in `dnj_joins_streamed.last`."""
    eng = StreamedDNJ(Dq, m, X=X, F=F, kbatch=kbatch, verbose=verbose,
                      device=device, **kw)
    dnj_joins_streamed.last = eng
    return eng.run()
