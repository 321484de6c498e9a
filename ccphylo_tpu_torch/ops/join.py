"""Join body of the packed DNJ engine (counterpart of the jnp join body of
tree/packed_engine.py:215-345, which XLA compiles into the device loop
of joins `_packed_segment`, :450-458).

After the batch scan of a join (ops/scan.py) has picked the pair (i, j)
into its result `out`, the body writes the join's records and updates
the state in place: updateD of row and column j, the cache repair of
row and column j, popArrange (row `last` into row and column i) with
the repair of row and column i, and the seed of the next join.

`dnj_join_plain` is that body in plain PyTorch, with one host read of
(i, j) (free on the CPU) that its slices and branches need; it is the
body of ops/segment.py's `dnj_segment_plain`, whose kernel runs the
same body on the card.  It takes the engine's state tensors in the
order of the engine's state keys (words, sD2, Q, P, seed, I, J, DIJ2,
SDI2, SDJ2, stats), then the scan's result, the join's index t and the
active rows m_t.
"""

from __future__ import annotations

import torch

from .select import IBIG, consts

_aranges: dict = {}  # (n, device) -> arange(n) int32


def _arange(n: int, dev) -> torch.Tensor:
    key = (n, dev)
    if key not in _aranges:
        _aranges[key] = torch.arange(n, dtype=torch.int32, device=dev)
    return _aranges[key]


def _last_min(q: torch.Tensor, idx: torch.Tensor):
    """(min, largest index at the min) of q over idx[:len(q)], as (1,)
    tensors; (IBIG, 0) for an empty q."""
    if q.numel() == 0:
        z = torch.zeros(1, dtype=torch.int32, device=q.device)
        return z + IBIG, z
    mn = q.min().view(1)
    neg1 = consts(q.device)[2]
    return mn, torch.where(q == mn, idx[:q.numel()], neg1).max().view(1)


def dnj_join_plain(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats,
                   out: torch.Tensor, t: int, m_t: int) -> None:
    """The join body in plain PyTorch: join t with m_t active rows, the
    pair (i, j) and the scan's counts read from `out` (4,) int32."""
    D8 = words.view(torch.uint8)
    dev = words.device
    BIG, ZERO, NEG1 = consts(dev)
    i, j = out[:2].tolist()
    stats[:2] += out[2:]
    last = m_t - 1
    I[t], J[t] = i, j
    if i == 0 and j == 0:  # no joinable pair
        DIJ2[t] = SDI2[t] = SDJ2[t] = 0
        Q[last] = IBIG
        seed.zero_()
        return
    idx = _arange(words.shape[0], dev)

    ci = D8[i, :m_t].to(torch.int32)
    cj = D8[j, :m_t].to(torch.int32)
    cij = ci[j]
    # limb observables (limbLength runs on PRE-update sD, nj.c:42)
    DIJ2[t] = 2 * cij
    SDI2[t] = sD2[i]
    SDJ2[t] = sD2[j]

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
            mj_cand = torch.where(u2.any() & (mq2 <= Qi), hit2, mj_cand)
    else:
        mj_cand = torch.zeros(1, dtype=torch.long, device=dev)
    Q[last] = IBIG

    # seed chaining (dnj.c:1026-1032)
    Qmj, Qmi = Q[mj_cand], Q[mi_cand]
    seed.copy_(torch.where(
        mj_cand == last, mi_cand,
        torch.where(mi_cand == last, mj_cand,
                    torch.where((Qmj < Qmi)
                                | ((mi_cand < mj_cand) & (Qmj == Qmi)),
                                mj_cand, mi_cand))))


def check_join_args(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
                    stats) -> None:
    """Raise ValueError unless the state suits the engine's kernels:
    words (n, n/4) int32 with n % 4 == 0, the records and sD2, Q, P
    (n,) int32, seed (1,) int64, stats (4,) int32, all contiguous on one
    device."""
    dev = words.device
    named = (("words", words), ("sD2", sD2), ("Q", Q), ("P", P), ("I", I),
             ("J", J), ("DIJ2", DIJ2), ("SDI2", SDI2), ("SDJ2", SDJ2),
             ("stats", stats))
    for name, x in named:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: expected a contiguous int32 tensor "
                             f"on {dev}")
    if seed.dtype != torch.int64 or seed.shape != (1,) or seed.device != dev:
        raise ValueError(f"seed: expected a (1,) int64 tensor on {dev}")
    n = words.shape[0]
    if words.dim() != 2 or 4 * words.shape[1] != n or stats.shape != (4,) \
            or any(x.shape != (n,) for _, x in named[1:-1]):
        raise ValueError("bad shapes: words " + str(tuple(words.shape))
                         + "".join(f", {k} {tuple(x.shape)}"
                                   for k, x in named[1:]))
