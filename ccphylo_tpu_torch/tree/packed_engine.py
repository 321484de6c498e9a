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

The join loop is driven from the host.  The batch scan of a join is one
kernel launch (ops/scan.py::dnj_scan) and one host read, which brings
the picked pair (i, j) to the host, so the rest of the join indexes
rows and columns with plain integers.  Two TPU workarounds
of the reference are not carried over: compile-cache shape bucketing
(rows are padded to a multiple of 512 only) and the sibling-row rebuild
of a word column (a byte column is written directly).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.scan import dnj_scan, dnj_scan_passes, dnj_scan_plain
from ..ops.select import IBIG, consts
from ..utils.torchconfig import device as default_device
from .segmenting import run_segmented
from .torch_engine import _host, _records_to_newick

_CH = 512  # init row chunk

# the batch scan of a join, by name: one launch per join; the
# host-driven loop of passes over the qrow_mins kernel; the plain
# PyTorch version (the reference of the tests and of the smoke run)
SCANS = {"fused": dnj_scan, "passes": dnj_scan_passes,
         "plain": dnj_scan_plain}

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


def _last_min(q: torch.Tensor, idx: torch.Tensor):
    """(min, largest index at the min) of q over idx[:len(q)], as (1,)
    tensors; (IBIG, 0) for an empty q."""
    if q.numel() == 0:
        z = torch.zeros(1, dtype=torch.int32, device=q.device)
        return z + IBIG, z
    mn = q.min().view(1)
    neg1 = consts(q.device)[2]
    return mn, torch.where(q == mn, idx[:q.numel()], neg1).max().view(1)


def _one_join(st: dict, t: int, m: int, kbatch: int, scan, idx):
    """Join t (reference one_join, tree/packed_engine.py:151-345) on
    state `st`, in place.  `scan` is the batch scan (ops/scan.py)."""
    words, sD2, Q, P = st["words"], st["sD2"], st["Q"], st["P"]
    D8 = words.view(torch.uint8)
    dev = words.device
    BIG, ZERO, NEG1 = consts(dev)
    m_t = m - t
    co = 2 * (m_t - 2)  # Q row coefficient on raw cells

    # batch scan: revalidate the best candidate rows until no row's
    # cached Q undercuts the current minimum; the join's one host read
    res = scan(words, sD2, Q, P, st["seed"], m_t, co, kbatch)
    i, j = res[:2].tolist()
    st["stats"][:2] += res[2:]

    last = m_t - 1
    st["I"][t], st["J"][t] = i, j
    if i == 0 and j == 0:  # no joinable pair
        st["DIJ2"][t] = st["SDI2"][t] = st["SDJ2"][t] = 0
        Q[last] = IBIG
        st["seed"] = torch.zeros_like(st["seed"])
        return

    ci = D8[i, :m_t].to(torch.int32)
    cj = D8[j, :m_t].to(torch.int32)
    cij = ci[j]
    # limb observables (limbLength runs on PRE-update sD, nj.c:42)
    st["DIJ2"][t] = 2 * cij
    st["SDI2"][t] = sD2[i]
    st["SDJ2"][t] = sD2[j]

    # updateD, complete-matrix both-path only (nj.c:893-948):
    # d_new = max((D_ik + D_kj - D_ij)/2, 0) = (ci+cj-cij)*u
    valid_k = torch.ones(m_t, dtype=torch.bool, device=dev)
    valid_k[i] = False
    valid_k[j] = False
    d_new = (ci + cj - cij).clamp_min(0)
    # sD bookkeeping on UNQUANTIZED updates (nj.c:907-911)
    sa = sD2[:m_t]
    sa.copy_(torch.where(valid_k, sa - (2 * ci + 2 * cj - d_new), sa))
    sD2[j] = torch.where(valid_k, d_new, ZERO).sum(dtype=torch.int32)
    # dtouc(d, 0.25) (bytescale.h:22): floor(d_u/2 + 1/4)
    q_new = ((2 * d_new + 1) >> 2).clamp_max(255)
    rowj = torch.where(valid_k, q_new, cj)
    rowj8 = rowj.to(torch.uint8)
    D8[j, :m_t] = rowj8
    D8[:m_t, j] = rowj8

    # cache repair for the fresh row j and column j (reads see quantized;
    # post-updateD N = m_t - 1 -> (N_j + N_k - 4) >> 1 = m_t - 3)
    co_post = 2 * (m_t - 3)
    qj = co_post * rowj - sD2[j] - sD2[:m_t]
    Qj, Pj = _last_min(qj[:j], idx)
    Q[j] = Qj
    P[j] = torch.where(Qj == IBIG, ZERO, Pj)
    s = slice(j + 1, m_t)  # rows k > j see row j's cell in their prefix
    qc, Qk = qj[s], Q[s]
    upd = qc <= Qk
    upd[i - j - 1] = False  # row i leaves with this join
    Qk.copy_(torch.where(upd, qc, Qk))
    P[s].masked_fill_(upd, j)
    mq = torch.where(upd, qc, BIG).min()
    hit = torch.where(upd & (qc == mq), idx[s], NEG1).max()
    mi_cand = torch.where(upd.any() & (mq <= Qj), hit, j).long()

    # popArrange: move row `last` into slot i (dnj.c:817-975)
    if i != last:
        newrow = D8[last].to(torch.int32)
        newrow[i] = 0
        newrow8 = newrow.to(torch.uint8)
        D8[i] = newrow8
        D8[:, i] = newrow8
        sD2[i] = sD2[last]
        qi = co_post * newrow[:last] - sD2[i] - sD2[:last]
        Qi, Pi = _last_min(qi[:i], idx)
        Q[i] = Qi
        P[i] = torch.where(Qi == IBIG, ZERO, Pi)
        mj_cand = torch.full((1,), i, dtype=torch.long, device=dev)
        if i + 1 < last:
            s2 = slice(i + 1, last)  # rows i < k < last see row i's cell
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

    # seed chaining (dnj.c:1026-1032)
    Qmj, Qmi = Q[mj_cand], Q[mi_cand]
    st["seed"] = torch.where(
        mj_cand == last, mi_cand,
        torch.where(mi_cand == last, mj_cand,
                    torch.where((Qmj < Qmi)
                                | ((mi_cand < mj_cand) & (Qmj == Qmi)),
                                mj_cand, mi_cand)))


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
    st["I"] = np.array(d["I"], np.int32)
    st["J"] = np.array(d["J"], np.int32)
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
                     hooks=None, scan: str = "fused"):
    """All m-2 DNJ joins over the packed u8 matrix, in place.

    words: (npad, npad/4) int32 (use `pack_words`); m: active taxa.
    Returns (I, J, DIJ2, SDI2, SDJ2, d_last2, words): int32 join records
    in u = 1/(2*ByteScale) units (convert limbs with `limbs_host`) on
    the device of `words`, and the final words buffer.  `hooks`, if
    given, is passed to run_segmented; `scan` names the batch scan, one
    of SCANS (identical records).

    CCPHYLO_TORCH_CKPT=/path/file.npz snapshots the state every
    CCPHYLO_TORCH_CKPT_EVERY_S seconds (default 300) at a fenced segment
    boundary, in the reference engine's npz format; a later call with
    matching (npad, m, kbatch) resumes from it — also from a snapshot
    the JAX engine wrote — and gives records identical to an
    uninterrupted run."""
    n, W = words.shape
    assert 4 * W == n, "words must tile a square byte matrix"
    if scan not in SCANS:
        raise ValueError(f"scan must be one of {sorted(SCANS)}, not "
                         f"{scan!r}")
    scan_fn = SCANS[scan]
    m = int(m)
    dev = words.device
    ckpt_path, ckpt_every = _ckpt_config()
    st, start = None, 0
    if ckpt_path and os.path.exists(ckpt_path):
        st, start = _ckpt_load(ckpt_path, n, m, kbatch, dev)
    if st is None:
        sD2, Q, P, seed = _packed_init(words, m)
        z = torch.zeros(n, dtype=torch.int32, device=dev)
        st = {"words": words, "sD2": sD2, "Q": Q, "P": P, "seed": seed,
              "I": np.zeros(n, np.int32), "J": np.zeros(n, np.int32),
              "DIJ2": z, "SDI2": z.clone(), "SDJ2": z.clone(),
              "stats": torch.zeros(4, dtype=torch.int32, device=dev)}
        start = 0
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    def seg_call(st, t0, t1):
        for t in range(t0, t1):
            _one_join(st, t, m, kbatch, scan_fn, idx)
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
    if ckpt_path and os.path.exists(ckpt_path):
        try:
            os.remove(ckpt_path)  # completed: snapshot no longer valid
        except OSError:
            pass
    I = torch.from_numpy(st["I"]).to(dev)
    J = torch.from_numpy(st["J"]).to(dev)
    return I, J, st["DIJ2"], st["SDI2"], st["SDJ2"], d_last2, words


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
                      scan: str = "fused") -> bytes:
    """Packed-u8 DNJ on the device; Newick bytes (no ';').

    Loads quantize like loadPhy -b (round 0.5, phy.c:473-475); complete
    matrices only (quantized storage cannot hold missing cells)."""
    dev = default_device() if device is None else torch.device(device)
    npad = pad_packed(n)
    Dq = np.zeros((npad, npad), np.uint8)
    iu = np.tril_indices(n, -1)
    qv = np.floor(np.asarray(flat64, np.float64) * bytescale + 0.5)
    qv = np.clip(qv, 0, 255).astype(np.uint8)
    Dq[(iu[0], iu[1])] = qv
    Dq[(iu[1], iu[0])] = qv
    I, J, DIJ2, SDI2, SDJ2, d_last2, _ = dnj_joins_packed(
        pack_words(Dq, dev), n, scan=scan)
    LI, LJ = limbs_host(I, J, DIJ2, SDI2, SDJ2, n, bytescale,
                        neg_limbs=bool(flag & 2))
    d_last = float(int(d_last2)) / (2.0 * float(bytescale))
    return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                              precision)
