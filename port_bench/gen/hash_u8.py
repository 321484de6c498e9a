"""The synthetic hash matrix of the repository's 100,000-taxon parity
evidence (`benchmarks/evidence/`: n = 100,000, mod 97, lo 3), as the
lower triangle of u8 cells, made on the device.

A copy of the smoke script's `hash_cells` (not an import): cell (i, j)
is lo + h % mod of a uint32 hash of (max, min), 0 on the diagonal, the
uint32 wraparound done in int64 and masked after every step."""

from __future__ import annotations

import numpy as np
import torch

HASH_K = (2654435761, 40503, 2246822519)    # the hash's multipliers
M32 = 0xFFFFFFFF
_ROWS = 512


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for int64 x in [0, 2**32) and k < 2**32, in two
    16-bit halves of k: no intermediate reaches 2**49."""
    return (x * (k & 0xFFFF) + (((x * (k >> 16)) & 0xFFFF) << 16)) & M32


def hash_cells(i: torch.Tensor, j: torch.Tensor, mod: int = 97,
               lo: int = 3) -> torch.Tensor:
    """Cell (i, j) for int64 index tensors (broadcast), as uint8."""
    i, j = i & M32, j & M32
    h = (_mul32(torch.maximum(i, j), HASH_K[0])
         + _mul32(torch.minimum(i, j), HASH_K[1])) & M32
    h ^= h >> 15
    h = _mul32(h, HASH_K[2])
    h ^= h >> 13
    return torch.where(i == j, 0, h % mod + lo).to(torch.uint8)


def cells(n: int, dev, mod: int = 97, lo: int = 3) -> np.ndarray:
    """The lower triangle (row i: cells (i, 0..i-1)) on the host."""
    out = np.empty(n * (n - 1) // 2, np.uint8)
    for r0 in range(0, n, _ROWS):
        r1 = min(r0 + _ROWS, n)
        ar = torch.arange(r1, device=dev)
        rows = ar[r0:r1, None]
        blk = torch.masked_select(hash_cells(rows, ar[None, :], mod, lo),
                                  ar[None, :] < rows)
        torch.from_numpy(out[r0 * (r0 - 1) // 2:r1 * (r1 - 1) // 2]) \
            .copy_(blk)
    return out


def names(n: int) -> list:
    """(name, buffer capacity) of taxa T0000000 ...: 32 buffers of 4
    bytes, then 32, each grown for its 8 characters and separator."""
    out = []
    for i in range(n):
        cap = 4 if i < 32 else 32
        left = cap
        for _ in range(9):
            left -= 1
            if left == 0:
                left = cap
                cap <<= 1
        out.append((b"T%07d" % i, cap))
    return out
