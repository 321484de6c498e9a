"""Batch-scan row minima of the packed DNJ engine (counterpart of
ops/scan_pallas.py).

`qrow_mins` launches the hand-written CUDA kernel csrc/qrow_mins.cu on
a CUDA tensor and takes its plain PyTorch version, `qrow_mins_plain`
(the jnp expression of tree/packed_engine.py:183-189), on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import build

IBIG = 2 ** 31 - 1


def qrow_mins_plain(rows: torch.Tensor, co: int, words: torch.Tensor,
                    sd2: torch.Tensor):
    """(rmin, rarg) int32 (K,): for each row r of `rows`, the minimum of
    q[c] = co*cell[r, c] - sd2[r] - sd2[c] over c < r (IBIG elsewhere)
    and the largest c at that minimum."""
    n = words.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=words.device)
    rl = rows.long()
    # the u32 words viewed as bytes are the u8 cells (little-endian lanes)
    cells = words.view(torch.uint8)[rl].to(torch.int32)      # (K, n)
    q = co * cells - sd2[rl][:, None] - sd2[None, :]
    q = torch.where(idx[None, :] < rows[:, None], q, IBIG)
    rmin = q.min(dim=1).values
    rarg = torch.where(q == rmin[:, None], idx[None, :], -1).max(dim=1)
    return rmin, rarg.values


def qrow_mins(rows: torch.Tensor, co: int, words: torch.Tensor,
              sd2: torch.Tensor):
    """`qrow_mins_plain`'s contract.  rows: (K,) int32 in [0, n), may
    repeat, 0 is padding; co: int; words: (n, n/4) int32 (u32 words,
    four u8 cells each); sd2: (n,) int32.  On a CUDA tensor: the
    qrow_mins kernel, which needs n % 16 == 0 and 16-byte aligned
    words and sd2."""
    if words.device.type == "cpu":
        return qrow_mins_plain(rows, co, words, sd2)
    n, W = words.shape
    for name, t in (("rows", rows), ("words", words), ("sd2", sd2)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != words.device:
            raise ValueError(f"{name}: expected a contiguous int32 tensor "
                             f"on {words.device}")
    if 4 * W != n or n % 16 or sd2.shape != (n,) or rows.dim() != 1:
        raise ValueError(f"bad shapes: words {tuple(words.shape)}, sd2 "
                         f"{tuple(sd2.shape)}, rows {tuple(rows.shape)}")
    if words.data_ptr() % 16 or sd2.data_ptr() % 16:
        raise ValueError("words and sd2 must be 16-byte aligned")
    K = rows.shape[0]
    rmin = torch.empty(K, dtype=torch.int32, device=words.device)
    rarg = torch.empty(K, dtype=torch.int32, device=words.device)
    build.launch("qrow_mins", "qrow_mins", rows.data_ptr(), K, int(co),
                 words.data_ptr(), n, sd2.data_ptr(), rmin.data_ptr(),
                 rarg.data_ptr(), device=words.device)
    return rmin, rarg
