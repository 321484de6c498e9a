"""Single-buffer, u32-packed, exact-integer DNJ (counterpart of
tree/packed_engine.py) — the port's large-n tree engine.

The quantized (u8) distance matrix lives on the device as one
(npad, npad/4) int32 buffer, four cells per word in little-endian byte
lanes (n^2 bytes in all).  Viewed as uint8 it is the (npad, npad) byte
matrix itself, so a row or a column of cells is read and written
directly; the scan kernel reads the same storage as u32 words.  The
engine updates this buffer in place: where the JAX engine donated it to
each device segment so that XLA would alias it, the port simply writes
into the caller's tensor.

Every quantity is an int32 multiple of u = 1/(2*ByteScale), so the join
trajectory is exact on any device: records are bit-identical to the JAX
engine and, after the float64 limb replay on the host (`limbs_host`),
the Newick bytes equal the host exact -b engine's.

The join loop runs on the device between the fences of
tree/segmenting.py (every SEG joins), the counterpart of the reference's
device loop `_packed_segment`.  On a card, by default (`scan="segment"`),
a segment is one launch of `dnj_segment` (ops/segment.py), every scan
pass and join body of the segment in one persistent kernel; the join
records stay on the device and the host does nothing between fences.
`scan="fused"` keeps the loop of two launches a join: the batch scan
`dnj_scan` (ops/scan.py), which writes the picked pair (i, j) to a
device buffer, and the join body `dnj_join` (ops/join.py), which reads
it there, both enqueued by a Python loop.  The plain versions
(`scan="plain"`, `body="plain"`) read (i, j) on the host once per join,
and so does every route on a CPU tensor, where that read is free.  Two
TPU workarounds of the reference are not carried over: compile-cache
shape bucketing (rows are padded to a multiple of 512 only) and the
sibling-row rebuild of a word column (a byte column is written
directly).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..ops.join import dnj_join, dnj_join_plain, dnj_join_prepare
from ..ops.scan import dnj_scan, dnj_scan_passes, dnj_scan_plain, \
    dnj_scan_prepare
from ..ops.segment import dnj_segment, dnj_segment_plain, \
    dnj_segment_prepare
from ..ops.select import IBIG
from ..utils import timing
from ..utils.torchconfig import device as default_device
from .segmenting import run_segmented
from .torch_engine import _host, _records_to_newick

_CH = 512  # init row chunk

# the batch scan of a join, by name: "segment" runs each segment's
# scans and bodies together, as SEGMENTS[body]; one launch per join;
# the host-driven loop of passes over the qrow_mins kernel; the plain
# PyTorch version (the reference of the tests and of the smoke run)
SCANS = {"segment": None, "fused": dnj_scan, "passes": dnj_scan_passes,
         "plain": dnj_scan_plain}
# the join body, by name: the dnj_join kernel (its plain version on a
# CPU tensor); the plain PyTorch version
BODIES = {"kernel": dnj_join, "plain": dnj_join_plain}
# the joins of a segment under scan="segment", by the body's name: one
# dnj_segment launch (its plain version on a CPU tensor); the plain
# loop of dnj_scan_plain and dnj_join_plain
SEGMENTS = {"kernel": dnj_segment, "plain": dnj_segment_plain}
# the kernel wrappers, with the step that checks their arguments and
# allocates their buffers once per run
_PREPARE = {dnj_scan: dnj_scan_prepare, dnj_join: dnj_join_prepare,
            dnj_segment: dnj_segment_prepare}

_STATE_KEYS = ("words", "sD2", "Q", "P", "seed", "I", "J", "DIJ2",
               "SDI2", "SDJ2", "stats")


def pad_packed(n: int) -> int:
    """Rows padded to a multiple of 512 (the reference's layout below
    its bucketing threshold, so checkpoints interchange)."""
    return max(-(-n // 512) * 512, 512)


def pack_words(Dq_bytes: np.ndarray, device) -> torch.Tensor:
    """(npad, npad) uint8 host matrix -> (npad, npad/4) int32 words on
    `device` (little-endian byte lanes)."""
    npad = Dq_bytes.shape[0]
    assert npad % 4 == 0 and Dq_bytes.dtype == np.uint8
    return torch.from_numpy(np.ascontiguousarray(Dq_bytes)).to(device) \
        .view(torch.int32)


# ---------------------------------------------------------------------
# init: initSummaD + initHNJ + seed, in row chunks


def _packed_init(words: torch.Tensor, m: int):
    """Returns (sD2, Q, P) int32 (n,) and the seed row, (1,) int64."""
    n = words.shape[0]
    D8 = words.view(torch.uint8)
    idx = torch.arange(n, dtype=torch.int32, device=words.device)
    active = idx < m
    sD2 = torch.empty(n, dtype=torch.int32, device=words.device)
    Q = torch.empty_like(sD2)
    P = torch.empty_like(sD2)
    for r0 in range(0, n, _CH):
        rows = idx[r0:r0 + _CH]
        cells = D8[r0:r0 + _CH].to(torch.int32)
        v = active[None, :] & (rows[:, None] != idx[None, :])
        sD2[r0:r0 + _CH] = 2 * torch.where(v, cells, 0).sum(
            dim=1, dtype=torch.int32)
    co0 = 2 * (m - 2)
    for r0 in range(0, n, _CH):
        rows = idx[r0:r0 + _CH]
        cells = D8[r0:r0 + _CH].to(torch.int32)
        lv = (active[r0:r0 + _CH, None] & active[None, :]
              & (idx[None, :] < rows[:, None]))
        Qm = torch.where(lv, co0 * cells - sD2[r0:r0 + _CH, None]
                         - sD2[None, :], IBIG)
        Qc = Qm.min(dim=1).values
        # initHNJ tie rule (hclust.c:110-116): among equal-Q candidates
        # ascending, accept while the raw distance is a running minimum
        cand = lv & (Qm == Qc[:, None])
        dmask = torch.where(cand, cells, IBIG)
        sel = cand & (dmask == torch.cummin(dmask, dim=1).values)
        Pc = torch.where(sel, idx[None, :], -1).max(dim=1).values
        Q[r0:r0 + _CH] = Qc
        P[r0:r0 + _CH] = Pc.clamp_min(0)
    Q = torch.where(active, Q, IBIG)
    qrows = torch.where((idx >= 1) & active, Q, IBIG)
    seed = torch.where(qrows == qrows.min(), idx, -1).max().view(1).long()
    if min(m, n) <= 1:
        seed = torch.zeros_like(seed)
    return sD2, Q, P, seed


# ---------------------------------------------------------------------
# one join


def _one_join(st: dict, t: int, m: int, kbatch: int, scan, body):
    """Join t (reference one_join, tree/packed_engine.py:151-345) on
    state `st`, in place: the batch scan `scan` (ops/scan.py), then the
    join body `body` (ops/join.py) on the scan's result."""
    m_t = m - t
    co = 2 * (m_t - 2)  # Q row coefficient on raw cells
    # revalidate the best candidate rows until no row's cached Q
    # undercuts the current minimum; the result holds the pair (i, j)
    res = scan(st["words"], st["sD2"], st["Q"], st["P"], st["seed"], m_t,
               co, kbatch)
    body(*(st[k] for k in _STATE_KEYS), res, t, m_t)


# ---------------------------------------------------------------------
# checkpoints: the reference's npz format (_STATE_KEYS + meta)


def _ckpt_config():
    d = os.environ.get("CCPHYLO_TORCH_CKPT", "")
    if not d:
        return None, 0.0
    try:
        every = float(os.environ.get("CCPHYLO_TORCH_CKPT_EVERY_S", "300"))
    except ValueError:
        every = 300.0
    return d, every


def _state_to_numpy(st: dict) -> dict:
    out = {k: np.asarray(st[k].cpu() if isinstance(st[k], torch.Tensor)
                         else st[k]) for k in _STATE_KEYS}
    out["words"] = out["words"].view(np.uint32)
    out["seed"] = out["seed"].astype(np.int32).reshape(())
    return out


def state_from_npz(d, device) -> dict:
    """Engine state from the arrays of a checkpoint npz (the reference
    engine's or the port's)."""
    words = np.ascontiguousarray(np.asarray(d["words"], np.uint32))
    st = {"words": torch.from_numpy(words.view(np.int32)).to(device)}
    for k in ("sD2", "Q", "P", "DIJ2", "SDI2", "SDJ2", "stats"):
        st[k] = torch.from_numpy(np.array(d[k], np.int32)).to(device)
    st["seed"] = torch.tensor([int(d["seed"])], dtype=torch.long,
                              device=device)
    for k in ("I", "J"):
        st[k] = torch.from_numpy(np.array(d[k], np.int32)).to(device)
    return st


def _ckpt_save(path, st, done, n, m, kbatch):
    payload = _state_to_numpy(st)
    payload["meta"] = np.array([done, n, m, kbatch], np.int64)
    tmp = path + ".tmp.npz"  # .npz suffix: savez must not append one
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _ckpt_load(path, n, m, kbatch, device):
    try:
        d = np.load(path)
    except (OSError, ValueError):
        return None, 0
    meta = d["meta"]
    if int(meta[1]) != n or int(meta[2]) != m or int(meta[3]) != kbatch:
        return None, 0
    return state_from_npz(d, device), int(meta[0])


# ---------------------------------------------------------------------


def dnj_joins_packed(words: torch.Tensor, m: int, kbatch: int = 128,
                     hooks=None, scan: str = "segment",
                     body: str | None = None):
    """All m-2 DNJ joins over the packed u8 matrix, in place.

    words: (npad, npad/4) int32 (use `pack_words`); m: active taxa.
    Returns (I, J, DIJ2, SDI2, SDJ2, d_last2, words): int32 join records
    in u = 1/(2*ByteScale) units (convert limbs with `limbs_host`) on
    the device of `words`, and the final words buffer.  `hooks`, if
    given, is passed to run_segmented; `scan` names the batch scan, one
    of SCANS, and `body` the join body, one of BODIES (identical
    records): with scan="segment" (the default) a segment runs as
    SEGMENTS[body], one dnj_segment launch for "kernel".  `body`
    defaults to "kernel", and to "plain" with scan="plain": the
    all-plain run, the oracle of the kernels.

    CCPHYLO_TORCH_CKPT=/path/file.npz snapshots the state every
    CCPHYLO_TORCH_CKPT_EVERY_S seconds (default 300) at a fenced segment
    boundary, in the reference engine's npz format; a later call with
    matching (npad, m, kbatch) resumes from it — also from a snapshot
    the JAX engine wrote — and gives records identical to an
    uninterrupted run."""
    n, W = words.shape
    assert 4 * W == n, "words must tile a square byte matrix"
    if body is None:
        body = "plain" if scan == "plain" else "kernel"
    bodies = SEGMENTS if scan == "segment" else BODIES
    for name, val, table in (("scan", scan, SCANS), ("body", body, bodies)):
        if val not in table:
            raise ValueError(f"{name} must be one of {sorted(table)}, not "
                             f"{val!r}")
    m = int(m)
    dev = words.device
    ckpt_path, ckpt_every = _ckpt_config()
    st, start = None, 0
    with timing.phase("tree/init"):
        if ckpt_path and os.path.exists(ckpt_path):
            st, start = _ckpt_load(ckpt_path, n, m, kbatch, dev)
        if st is None:
            sD2, Q, P, seed = _packed_init(words, m)
            z = torch.zeros(n, dtype=torch.int32, device=dev)
            st = {"words": words, "sD2": sD2, "Q": Q, "P": P, "seed": seed,
                  "I": z, "J": z.clone(), "DIJ2": z.clone(),
                  "SDI2": z.clone(), "SDJ2": z.clone(),
                  "stats": torch.zeros(4, dtype=torch.int32, device=dev)}
            start = 0
        scan_fn, body_fn = SCANS[scan], BODIES.get(body)
        seg_fn = SEGMENTS[body] if scan == "segment" else None
        if dev.type == "cuda":  # arguments checked, buffers made, once a run
            if seg_fn in _PREPARE:
                seg_fn = functools.partial(seg_fn, prep=_PREPARE[seg_fn](
                    *(st[k] for k in _STATE_KEYS), kbatch))
            if scan_fn in _PREPARE:
                scan_fn = functools.partial(scan_fn, prep=_PREPARE[scan_fn](
                    *(st[k] for k in _STATE_KEYS[:5]), kbatch))
            if body_fn in _PREPARE and seg_fn is None:
                body_fn = functools.partial(body_fn, prep=_PREPARE[body_fn](
                    *(st[k] for k in _STATE_KEYS)))

    def seg_call(st, t0, t1):
        if seg_fn is not None:
            seg_fn(*(st[k] for k in _STATE_KEYS), t0, t1, m, kbatch)
            return st
        for t in range(t0, t1):
            _one_join(st, t, m, kbatch, scan_fn, body_fn)
        return st

    last_ckpt = [time.perf_counter()]

    def _hooks(st, done, total):
        if ckpt_path and done < total \
                and time.perf_counter() - last_ckpt[0] >= ckpt_every:
            _ckpt_save(ckpt_path, st, done, n, m, kbatch)
            last_ckpt[0] = time.perf_counter()
        if hooks is not None:
            hooks(st, done, total)

    st = run_segmented(seg_call, st, max(m - 2, 0), hooks=_hooks,
                       start=start)
    words = st["words"]
    d_last2 = 2 * words.view(torch.uint8)[1, 0].to(torch.int32)
    dnj_joins_packed.last_stats = st["stats"].cpu().numpy()
    timing.count("tree/scan_passes", int(dnj_joins_packed.last_stats[0]))
    if ckpt_path and os.path.exists(ckpt_path):
        try:
            os.remove(ckpt_path)  # completed: snapshot no longer valid
        except OSError:
            pass
    return (st["I"], st["J"], st["DIJ2"], st["SDI2"], st["SDJ2"], d_last2,
            words)


def limbs_host(I, J, DIJ2, SDI2, SDJ2, m: int, bytescale: float,
               neg_limbs: bool = False):
    """Replay limbLength (nj.c:42-79) in float64 from the exact integer
    join observables (complete matrices: N_i = N_j = m_t at join t)."""
    T = max(m - 2, 0)
    inv = 1.0 / (2.0 * float(bytescale))
    Dij = _host(DIJ2)[:T].astype(np.float64) * inv
    sDi = _host(SDI2)[:T].astype(np.float64) * inv
    sDj = _host(SDJ2)[:T].astype(np.float64) * inv
    m_t = float(m) - np.arange(T, dtype=np.float64)
    Ni = m_t - 2.0
    pos = Ni > 0
    delta = np.where(pos, (sDi - Dij) / np.maximum(Ni, 1.0)
                     - (sDj - Dij) / np.maximum(Ni, 1.0), 0.0)
    Li = np.where(pos, (Dij + delta) / 2.0, Dij / 2.0)
    Lj = np.where(pos, (Dij - delta) / 2.0, Dij / 2.0)
    if not neg_limbs:
        Li_c = np.where(Li < 0, 0.0, np.where(Lj < 0, Dij, Li))
        Lj_c = np.where(Li < 0, Dij, np.where(Lj < 0, 0.0, Lj))
        Li, Lj = Li_c, Lj_c
    return Li, Lj


def build_tree_packed(flat64: np.ndarray, n: int, names: list,
                      flag: int = 0, precision: int = 9,
                      bytescale: float = 1.0, device=None,
                      scan: str = "segment",
                      body: str | None = None) -> bytes:
    """Packed-u8 DNJ on the device; Newick bytes (no ';').

    Loads quantize like loadPhy -b (round 0.5, phy.c:473-475); complete
    matrices only (quantized storage cannot hold missing cells).
    Its spans (utils/timing.py) are its steps: tree/quantize (the u8
    matrix and its upload), tree/engine (`dnj_joins_packed`: tree/init,
    a tree/segment per segment, then a host read), tree/limbs
    (`limbs_host`, the records' copy to the host included) and
    tree/newick; `build_tree_packed.last_times` holds each one's host
    clock seconds of the last call under "quantize", "engine", "limbs"
    and "newick"."""
    dev = default_device() if device is None else torch.device(device)
    times = build_tree_packed.last_times = {}
    with timing.phase("tree/quantize", into=times):
        npad = pad_packed(n)
        Dq = np.zeros((npad, npad), np.uint8)
        iu = np.tril_indices(n, -1)
        qv = np.floor(np.asarray(flat64, np.float64) * bytescale + 0.5)
        qv = np.clip(qv, 0, 255).astype(np.uint8)
        Dq[(iu[0], iu[1])] = qv
        Dq[(iu[1], iu[0])] = qv
        words = pack_words(Dq, dev)
    with timing.phase("tree/engine", into=times):
        I, J, DIJ2, SDI2, SDJ2, d_last2, _ = dnj_joins_packed(
            words, n, scan=scan, body=body)
    with timing.phase("tree/limbs", into=times):
        LI, LJ = limbs_host(I, J, DIJ2, SDI2, SDJ2, n, bytescale,
                            neg_limbs=bool(flag & 2))
        d_last = float(int(d_last2)) / (2.0 * float(bytescale))
    with timing.phase("tree/newick", into=times):
        return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                                  precision)
