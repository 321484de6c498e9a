"""Device selection primitives of the join engines (counterpart of
ops/select.py)."""

from __future__ import annotations

import torch

IBIG = 2 ** 31 - 1
_CONSTS: dict = {}


def consts(dev):
    """0-d int32 (IBIG, 0, -1) on `dev`: torch.where with a Python
    scalar launches one more kernel to materialize it."""
    if dev not in _CONSTS:
        _CONSTS[dev] = tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                             for v in (IBIG, 0, -1))
    return _CONSTS[dev]


def topk_mask_indices(mask: torch.Tensor, idx: torch.Tensor,
                      K: int) -> torch.Tensor:
    """The K largest values of `idx` where `mask` is set, descending,
    padded with -1 — `idx` must be ascending.

    A suffix-count rank compaction: one cumsum and one K-wide scatter,
    deterministic and free of host syncs.  Unselected entries scatter
    into a sink slot K that is cut off."""
    cmi = mask.to(torch.int32)
    # rank of a set position = number of set positions after it
    r = cmi.sum() - torch.cumsum(cmi, 0, dtype=torch.int32)
    slot = torch.where(mask & (r < K), r, K).long()
    out = torch.full((K + 1,), -1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, slot, idx.to(torch.int32))
    return out[:K]
