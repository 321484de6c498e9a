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
device loop `_packed_segment`.  A segment is one call of `dnj_segment`
(ops/segment.py): on a card, one launch of the dnj_segment kernel runs
every scan pass and join body of the segment, the join records stay on
the device and the host does nothing between fences; on a CPU tensor
its plain version runs, reading the pair (i, j) on the host once per
join, where that read is free.  Two TPU workarounds of the reference
are not carried over: compile-cache shape bucketing (rows are padded to
a multiple of 512 only) and the sibling-row rebuild of a word column (a
byte column is written directly).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..io.phylip import dtouc_cells
from ..ops.segment import dnj_segment, dnj_segment_prepare
from ..ops.select import IBIG
from ..utils import timing
from ..utils.torchconfig import device as default_device
from .segmenting import run_segmented
from .torch_engine import _host, _records_to_newick

_CH = 512  # init row chunk
_PACK_ROWS = 512  # rows of the triangle laid out and uploaded at a time

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


def pack_cells(cells: np.ndarray, n: int, device) -> torch.Tensor:
    """The lower triangle of n taxa as uint8 cells, row by row (row i:
    cells (i, 0..i-1)) -> the engine's (npad, npad/4) int32 words on
    `device`: the symmetric byte matrix, zero diagonal and padding.

    A block of `_PACK_ROWS` rows is laid out on the host (each row's
    cells, zeros to the block's last column), uploaded into its rows,
    and mirrored on the device into the columns of the rows above it, so
    only the cells, one block and the words are ever held."""
    cells = np.asarray(cells)
    if cells.dtype != np.uint8 or cells.shape != (n * (n - 1) // 2,):
        raise ValueError(f"pack_cells takes the {n * (n - 1) // 2} uint8 "
                         f"cells of {n} taxa, not {cells.dtype} "
                         f"{cells.shape}")
    npad = pad_packed(n)
    words = torch.zeros((npad, npad // 4), dtype=torch.int32, device=device)
    D8 = words.view(torch.uint8)
    buf = np.empty(min(_PACK_ROWS, n) * n, np.uint8)
    for r0 in range(0, n, _PACK_ROWS):
        r1 = min(r0 + _PACK_ROWS, n)
        blk = buf[:(r1 - r0) * r1].reshape(r1 - r0, r1)
        at = r0 * (r0 - 1) // 2
        for i in range(r0, r1):
            blk[i - r0, :i] = cells[at:at + i]
            blk[i - r0, i:] = 0
            at += i
        D8[r0:r1, :r1] = torch.from_numpy(blk).to(device)
        D8[:r0, r0:r1] = D8[r0:r1, :r0].t()
        tile = D8[r0:r1, r0:r1]
        tile += tile.t().clone()
    return words


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
                     hooks=None):
    """All m-2 DNJ joins over the packed u8 matrix, in place.

    words: (npad, npad/4) int32 (use `pack_words`); m: active taxa.
    Returns (I, J, DIJ2, SDI2, SDJ2, d_last2, words): int32 join records
    in u = 1/(2*ByteScale) units (convert limbs with `limbs_host`) on
    the device of `words`, and the final words buffer.  Each segment is
    one `dnj_segment` call with `kbatch` candidate rows a scan pass;
    `hooks`, if given, is passed to run_segmented.

    CCPHYLO_TORCH_CKPT=/path/file.npz snapshots the state every
    CCPHYLO_TORCH_CKPT_EVERY_S seconds (default 300) at a fenced segment
    boundary, in the reference engine's npz format; a later call with
    matching (npad, m, kbatch) resumes from it — also from a snapshot
    the JAX engine wrote — and gives records identical to an
    uninterrupted run."""
    n, W = words.shape
    assert 4 * W == n, "words must tile a square byte matrix"
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
        # on a card: arguments checked, buffers made, once a run
        prep = dnj_segment_prepare(*(st[k] for k in _STATE_KEYS), kbatch) \
            if dev.type == "cuda" else None

    def seg_call(st, t0, t1):
        dnj_segment(*(st[k] for k in _STATE_KEYS), t0, t1, m, kbatch,
                    prep=prep)
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


def build_tree_packed(cells: np.ndarray, n: int, names: list,
                      flag: int = 0, precision: int = 9,
                      bytescale: float = 1.0, device=None) -> bytes:
    """Packed-u8 DNJ on the device; Newick bytes (no ';').

    `cells` is the complete lower triangle, row by row: uint8 cells as
    the -b loader stores them (`PhylipStream.load(u8_scale=)`), or
    float64 distances, which load quantizes like loadPhy -b (round 0.5,
    phy.c:473-475; `dtouc_cells`).  Quantized storage cannot hold
    missing cells.
    Its spans (utils/timing.py) are its steps: tree/pack (u8 cells: the
    words made and uploaded by `pack_cells`) or tree/quantize (float64:
    the u8 cells, then the same), tree/engine (`dnj_joins_packed`:
    tree/init, a tree/segment per segment, then a host read), tree/limbs
    (`limbs_host`, the records' copy to the host included) and
    tree/newick; `build_tree_packed.last_times` holds each one's host
    clock seconds of the last call under "pack" or "quantize", "engine",
    "limbs" and "newick"."""
    dev = default_device() if device is None else torch.device(device)
    times = build_tree_packed.last_times = {}
    cells = np.asarray(cells)
    if cells.dtype == np.uint8:
        with timing.phase("tree/pack", into=times):
            words = pack_cells(cells, n, dev)
    else:
        with timing.phase("tree/quantize", into=times):
            words = pack_cells(dtouc_cells(cells, bytescale), n, dev)
    with timing.phase("tree/engine", into=times):
        I, J, DIJ2, SDI2, SDJ2, d_last2, _ = dnj_joins_packed(
            words, n)
    with timing.phase("tree/limbs", into=times):
        LI, LJ = limbs_host(I, J, DIJ2, SDI2, SDJ2, n, bytescale,
                            neg_limbs=bool(flag & 2))
        d_last = float(int(d_last2)) / (2.0 * float(bytescale))
    with timing.phase("tree/newick", into=times):
        return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                                  precision)
