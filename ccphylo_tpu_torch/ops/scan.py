"""Batch scan of the packed DNJ engine (counterpart of
ops/scan_pallas.py and of the batch-scan while_loop of
tree/packed_engine.py:157-214).

Two kernels, each with its plain PyTorch version beside it; a wrapper
launches its kernel on a CUDA tensor and takes the plain version only
for a CPU tensor:

- `qrow_mins` (csrc/qrow_mins.cu): the row minima of one pass.  Plain
  version `qrow_mins_plain`, the jnp expression of
  tree/packed_engine.py:183-189.  With `slots` the matrix is a cache of
  rows (tree/streamed_engine.py:209-229): row r is read from storage
  row slots[r].
- `dnj_scan` (csrc/dnj_scan.cu): the whole scan of one join, every pass
  of it, in one cooperative launch.  Plain version `dnj_scan_plain`,
  the host-driven loop of passes `dnj_scan_passes` over
  `qrow_mins_plain`.
"""

from __future__ import annotations

import torch

from . import build
from .select import IBIG, consts, topk_mask_indices

_max_blocks: dict = {}  # device -> co-resident blocks of dnj_scan


def qrow_mins_plain(rows: torch.Tensor, co: int, words: torch.Tensor,
                    sd2: torch.Tensor, slots: torch.Tensor | None = None):
    """(rmin, rarg) int32 (K,): for each row r of `rows`, the minimum of
    q[c] = co*cell[r, c] - sd2[r] - sd2[c] over c < r (IBIG elsewhere)
    and the largest c at that minimum.  With `slots` (n,) int32, `words`
    is a cache of rows, (X, n/4): the cells of row r lie in storage row
    slots[r], and a row with slots[r] < 0 has no columns."""
    n = sd2.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=words.device)
    rl = rows.long()
    bound = rows
    if slots is not None:
        srow = slots[rl]
        bound = torch.where(srow >= 0, rows, 0)
        rl, srow = bound.long(), srow.clamp_min(0).long()
    else:
        srow = rl
    # the u32 words viewed as bytes are the u8 cells (little-endian lanes)
    cells = words.view(torch.uint8)[srow].to(torch.int32)    # (K, n)
    q = co * cells - sd2[rl][:, None] - sd2[None, :]
    q = torch.where(idx[None, :] < bound[:, None], q, IBIG)
    rmin = q.min(dim=1).values
    rarg = torch.where(q == rmin[:, None], idx[None, :], -1).max(dim=1)
    return rmin, rarg.values


def qrow_mins(rows: torch.Tensor, co: int, words: torch.Tensor,
              sd2: torch.Tensor, slots: torch.Tensor | None = None):
    """`qrow_mins_plain`'s contract.  rows: (K,) int32 in [0, n), may
    repeat, 0 is padding; co: int; words: (n, n/4) int32 (u32 words,
    four u8 cells each), or with `slots` (n,) int32 a cache of X rows,
    (X, n/4), slots[r] < X; sd2: (n,) int32.  On a CUDA tensor: the
    qrow_mins kernel, which needs n % 16 == 0 and 16-byte aligned
    words and sd2."""
    if words.device.type == "cpu":
        return qrow_mins_plain(rows, co, words, sd2, slots)
    X, W = words.shape
    n = 4 * W
    for name, t in (("rows", rows), ("words", words), ("sd2", sd2),
                    ("slots", slots)):
        if t is not None and (t.dtype != torch.int32
                              or not t.is_contiguous()
                              or t.device != words.device):
            raise ValueError(f"{name}: expected a contiguous int32 tensor "
                             f"on {words.device}")
    if (slots is None and X != n) or n % 16 or sd2.shape != (n,) \
            or rows.dim() != 1 or (slots is not None
                                   and slots.shape != (n,)):
        raise ValueError(f"bad shapes: words {tuple(words.shape)}, sd2 "
                         f"{tuple(sd2.shape)}, rows {tuple(rows.shape)}"
                         + ("" if slots is None
                            else f", slots {tuple(slots.shape)}"))
    if words.data_ptr() % 16 or sd2.data_ptr() % 16:
        raise ValueError("words and sd2 must be 16-byte aligned")
    K = rows.shape[0]
    rmin = torch.empty(K, dtype=torch.int32, device=words.device)
    rarg = torch.empty(K, dtype=torch.int32, device=words.device)
    build.launch("qrow_mins", "qrow_mins", rows.data_ptr(), K, int(co),
                 words.data_ptr(), n, sd2.data_ptr(),
                 None if slots is None else slots.data_ptr(),
                 rmin.data_ptr(), rarg.data_ptr(), device=words.device,
                 count=None if slots is None else "qrow_mins_slots")
    return rmin, rarg


def dnj_scan_passes(words: torch.Tensor, sD2: torch.Tensor,
                    Q: torch.Tensor, P: torch.Tensor, seed: torch.Tensor,
                    m_t: int, co: int, K: int, qrow=qrow_mins,
                    ensure=None):
    """The batch scan of one join as a host-driven loop of passes
    (reference bcond/bbody, tree/packed_engine.py:157-214).

    words: (n, n/4) int32; sD2, Q, P: (n,) int32; seed: (1,) int64;
    m_t: rows still active; co: Q row coefficient on raw cells; K:
    candidate rows per pass.  Starting from the seed row's cached
    minimum, revalidates the K best candidate rows per pass (`qrow`
    gives their true minima) until no row's cached Q undercuts the
    current minimum; Q and P are updated in place.  Each pass costs one
    host read.  `ensure`, if given, is called before each pass's `qrow`
    with the pass's rows as a list of ints (descending, -1 padding): the
    host read of the pass then brings the rows themselves, and a caller
    whose `words` is a cache of rows makes them resident there.
    Returns (4,) int32 on the device of `words`: the picked pair
    (i, j), the passes made, the rows whose Q changed."""
    dev = words.device
    BIG, ZERO, NEG1 = consts(dev)
    Qs = Q[seed]
    seed_ok = (seed != 0) & (Qs != IBIG)
    minv = torch.where(seed_ok, Qs, BIG)
    pi = torch.where(seed_ok, seed, ZERO)
    pj = torch.where(seed_ok, P[seed].long(), ZERO)
    Q_pre = Q.clone()
    cols = torch.arange(1, m_t, dtype=torch.int32, device=dev)
    npass = 0
    while True:
        cm = Q[1:m_t] < minv
        if ensure is None:
            if not bool(cm.any()):
                break
            rows = topk_mask_indices(cm, cols, K)
        else:
            rows = topk_mask_indices(cm, cols, K)
            host_rows = rows.tolist()
            if host_rows[0] < 0:
                break
            ensure(host_rows)
        valid = rows >= 1
        r = rows.clamp_min(0)
        rmin, rarg = qrow(r, co, words, sD2)
        rminv = torch.where(valid, rmin, BIG)
        # C-exact cache gating: a row is revalidated only while it beats
        # the running minimum of everything scanned before it
        rm = torch.cummin(torch.cat([minv, rminv[:-1]]), dim=0).values
        rl = r.long()
        Qr = Q[rl]
        reval = valid & (Qr < rm)
        # padding entries all target row 0 and write back its own value
        Q.scatter_(0, rl, torch.where(reval, rmin, Qr))
        P.scatter_(0, rl, torch.where(reval, rarg, P[rl]))
        bmin = rminv.min()
        atmin = rminv == bmin
        bi = torch.where(atmin, rows, NEG1).max()
        karg = torch.where(atmin & (rows == bi), rarg, ZERO).max()
        better = bmin < minv
        minv = torch.where(better, bmin, minv)
        pi = torch.where(better, bi.long(), pi)
        pj = torch.where(better, karg.long(), pj)
        npass += 1
    return torch.cat([pi, pj, torch.full_like(pi, npass),
                      (Q != Q_pre).sum().view(1)]).to(torch.int32)


def dnj_scan_plain(words, sD2, Q, P, seed, m_t: int, co: int, K: int):
    """Plain version of `dnj_scan`: `dnj_scan_passes` over
    `qrow_mins_plain`."""
    return dnj_scan_passes(words, sD2, Q, P, seed, m_t, co, K,
                           qrow=qrow_mins_plain)


def dnj_scan_prepare(words: torch.Tensor, sD2: torch.Tensor,
                     Q: torch.Tensor, P: torch.Tensor, seed: torch.Tensor,
                     K: int) -> torch.Tensor:
    """Check the arguments of a run of `dnj_scan` launches once and
    allocate their buffer: 4 int32 for the result, then the 6 K of the
    kernel's scratch.  Returns `prep` for `dnj_scan`.  The kernel needs
    n % 128 == 0, 16-byte aligned words, sD2 and Q, and K within what
    the card holds at once."""
    dev = words.device
    n, W = words.shape
    for name, t in (("words", words), ("sD2", sD2), ("Q", Q), ("P", P)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name}: expected a contiguous int32 tensor "
                             f"on {dev}")
    if seed.dtype != torch.int64 or seed.shape != (1,) or seed.device != dev:
        raise ValueError(f"seed: expected a (1,) int64 tensor on {dev}")
    if 4 * W != n or n % 128 or not (sD2.shape == Q.shape == P.shape
                                     == (n,)):
        raise ValueError(f"bad shapes: words {tuple(words.shape)}, sD2 "
                         f"{tuple(sD2.shape)}, Q {tuple(Q.shape)}, P "
                         f"{tuple(P.shape)}")
    if words.data_ptr() % 16 or sD2.data_ptr() % 16 or Q.data_ptr() % 16:
        raise ValueError("words, sD2 and Q must be 16-byte aligned")
    if dev not in _max_blocks:
        with torch.cuda.device(dev):
            _max_blocks[dev] = build.query("dnj_scan", "dnj_scan_max_blocks")
    if not 1 <= K <= _max_blocks[dev]:
        raise ValueError(
            f"K = {K}: a cooperative launch of dnj_scan holds 1 to "
            f"{_max_blocks[dev]} blocks on {dev} (a value <= 0 is a CUDA "
            "error code or a card without cooperative launch)")
    return torch.empty(4 + 6 * K, dtype=torch.int32, device=dev)


def dnj_scan(words: torch.Tensor, sD2: torch.Tensor, Q: torch.Tensor,
             P: torch.Tensor, seed: torch.Tensor, m_t: int, co: int,
             K: int, prep: torch.Tensor | None = None) -> torch.Tensor:
    """`dnj_scan_passes`'s contract, in one launch and with no host read.
    On a CUDA tensor: the dnj_scan kernel, K co-resident blocks in a
    cooperative launch.  `prep` (from `dnj_scan_prepare` on the same
    tensors and K) skips the checks and the allocation; the result is
    then a view of it, overwritten by the next launch."""
    if words.device.type == "cpu":
        return dnj_scan_plain(words, sD2, Q, P, seed, m_t, co, K)
    if prep is None:
        prep = dnj_scan_prepare(words, sD2, Q, P, seed, K)
    n = words.shape[0]
    if not 1 <= m_t <= n:
        raise ValueError(f"m_t = {m_t} outside [1, {n}]")
    out = prep[:4]
    build.launch("dnj_scan", "dnj_scan", words.data_ptr(), sD2.data_ptr(),
                 n, Q.data_ptr(), P.data_ptr(), seed.data_ptr(), int(m_t),
                 int(co), K, prep[4:].data_ptr(), out.data_ptr(),
                 device=words.device)
    return out
