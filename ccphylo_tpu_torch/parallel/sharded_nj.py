"""Row-block-sharded neighbor-joining / UPGMA join loops on
torch.distributed (counterpart of parallel/sharded_nj.py).

The full square distance matrix is split into row blocks, one per rank
(parallel/multihost.py); every join does

  1. a local first-wins argmin over the rank's block,
  2. an all-gather of one (value, row, col) triple per rank and a
     first-wins argmin over them: the lowest rank wins a tie, so the
     pick is the flat first-wins minimum of the whole matrix and does
     not depend on the world size,
  3. the rank-1 update: every rank refreshes the joined column for its
     own rows; the owner of the merged row rebuilds it from the
     all-gathered column.

The loop is driven from the host, the same on every rank, with one host
read per join (the picked pair); records address original matrix slots
and come out on every rank.  For complete matrices the criterion matches
the reference (see the JAX module); the byte-parity engines replicate
the reference's tie-break chains, this one targets scale.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tree.newick_build import (byteshift_fix, form_last_bi_node,
                                 form_last_node, form_node)
from ..utils.torchconfig import device as default_device
from . import multihost as mh


def _pad_to(n: int, mult: int) -> int:
    return max(-(-n // mult) * mult, mult)


def sharded_join_records(D: np.ndarray, n: int, method: str = "nj",
                         dtype=torch.float32, neg: bool = False,
                         device=None):
    """Run the sharded join loop on a full square distance matrix that
    every rank holds on the host.

    Returns host arrays (I, J, LI, LJ, a, b, d_last): n-2 join records
    (cluster j merged into slot i) and the two surviving slots with
    their distance, the same on every rank."""
    if n < 3:
        raise ValueError("need at least 3 taxa")
    if method not in ("nj", "upgma"):
        raise ValueError(f"method must be nj or upgma, not {method!r}")
    dev = default_device() if device is None else torch.device(device)
    rank, world = mh.row_axis()
    npad = _pad_to(n, world)
    R = npad // world
    r0 = rank * R
    npdt = np.float64 if dtype == torch.float64 else np.float32
    Dp = np.zeros((npad, npad), npdt)
    Dp[:n, :n] = D[:n, :n]
    sD = Dp[:, :n].sum(axis=1, dtype=np.float64).astype(npdt)
    Dl = torch.from_numpy(Dp[r0:r0 + R]).to(dev)
    sDl = torch.from_numpy(sD[r0:r0 + R]).to(dev)
    del Dp

    BIG = torch.finfo(dtype).max / 4
    cols = torch.arange(npad, device=dev)
    gi = cols[r0:r0 + R]
    act = cols < n
    act_h = np.arange(npad) < n
    I = np.zeros(n - 2, np.int32)
    J = np.zeros(n - 2, np.int32)
    LI = torch.zeros(n - 2, dtype=dtype, device=dev)
    LJ = torch.zeros(n - 2, dtype=dtype, device=dev)
    for t in range(n - 2):
        m2 = float(max(n - t - 2, 1))
        actl = act[r0:r0 + R]
        sDg = mh.gather_rows(sDl)
        Q = m2 * Dl - sDl[:, None] - sDg[None, :] if method == "nj" else Dl
        valid = actl[:, None] & act[None, :] & (gi[:, None] > cols[None, :])
        Qm = torch.where(valid, Q, BIG).view(-1)
        k = torch.argmin(Qm)
        cand = torch.stack([Qm[k].double(), (r0 + k // npad).double(),
                            (k % npad).double()])
        cands = mh.gather_rows(cand).view(world, 3)
        b = torch.argmin(cands[:, 0])
        i, j = (int(v) for v in cands[b, 1:].tolist())  # the host read
        qv = cands[b, 0].to(dtype)

        colI = Dl[:, i].clone()
        colJ = Dl[:, j].clone()
        if method == "nj":
            Dij = (qv + sDg[i] + sDg[j]) / m2
            # updateD clamps new distances at >= 0 (nj.c:836+)
            dnew_l = ((colI + colJ - Dij) / 2).clamp_min(0.0)
        else:
            Dij = qv
            # updateUPGMA: unweighted average (hclust.c:665+)
            dnew_l = (colI + colJ) / 2
        # limbLength with its clamps (nj.c:42-79), for every method
        delta = (sDg[i] - sDg[j]) / m2
        Li = (Dij + delta) / 2
        Lj = (Dij - delta) / 2
        if not neg:
            Li, Lj = (torch.where(Li < 0, 0.0, torch.where(Lj < 0, Dij, Li)),
                      torch.where(Li < 0, Dij, torch.where(Lj < 0, 0.0, Lj)))

        dnew = mh.gather_rows(dnew_l)
        # column i for my rows; the dead column j is masked by act
        upd = actl & (gi != i) & (gi != j)
        act[j] = False
        act_h[j] = False
        Dl[:, i] = torch.where(upd, dnew_l, colI)
        sDl += torch.where(upd, dnew_l - colI - colJ, 0.0)
        if r0 <= i < r0 + R:  # the owner rebuilds row i
            newrow = torch.where(act, dnew, 0.0)
            newrow[i] = 0.0
            newrow[j] = 0.0
            Dl[i - r0] = newrow
            sDl[i - r0] = torch.where(act & (cols != i), dnew, 0.0).sum()
        I[t], J[t] = i, j
        LI[t], LJ[t] = Li, Lj

    # the two survivors and their distance, from the owner of row b
    a, b = np.flatnonzero(act_h)[:2]
    d = Dl[b - r0, a].reshape(1).clone() if r0 <= b < r0 + R \
        else torch.empty(1, dtype=dtype, device=dev)
    d_last = mh.broadcast(d, int(b) // R)
    return (I, J, LI.cpu().numpy(), LJ.cpu().numpy(), np.int32(a),
            np.int32(b), d_last.cpu().numpy()[0])


def build_tree_sharded(D: np.ndarray, n: int, names: list,
                       method: str = "nj", flag: int = 0,
                       precision: int = 9, dtype=torch.float32,
                       device=None) -> bytes:
    """Newick bytes (no ';') from the sharded join loop.

    Join records address original matrix slots (no compaction), so the
    host just merges Name buffers in record order.
    """
    I, J, LI, LJ, a, b, d_last = sharded_join_records(
        D, n, method, dtype, neg=bool(flag & 2), device=device)
    for t in range(n - 2):
        i, j = int(I[t]), int(J[t])
        form_node(names[i], names[j], float(LI[t]), float(LJ[t]),
                  precision)
    a, b = int(a), int(b)
    last = form_last_bi_node if (flag & 1) else form_last_node
    last(names[a], names[b], float(d_last), precision)
    root = names[a]
    byteshift_fix(root)
    return root.data
