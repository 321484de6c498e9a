"""Plain reference of `dist`'s SNP counts under a shared include mask.

From the loader's layout (u64 words, two bits a position, position k of
a word at bits 62-2k and 63-2k; u32 include words, position k at bit
31-k) it counts, for every pair of samples, the included positions at
which their bases differ: M - sum over the four bases of the products
of one-hot columns, M the included positions.  Plain torch on the
given device, a block of words at a time; `dtype` is the precision of
the one-hot products (float32, with TF32 off, is exact: every block's
sums stay under 2**24; bfloat16 is the control's).  Imports nothing of
the program under test."""

from __future__ import annotations

import numpy as np
import torch


def counts(seqs: np.ndarray, inc: np.ndarray, dev,
           dtype=torch.float32, words: int = 2048) -> np.ndarray:
    n, W = seqs.shape
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        sh64 = torch.arange(62, -1, -2, dtype=torch.int64, device=dev)
        sh32 = torch.arange(31, -1, -1, dtype=torch.int64, device=dev)
        E = torch.zeros((n, n), dtype=torch.int64, device=dev)
        M = 0
        s64 = seqs.view(np.int64)
        i32 = inc.astype(np.int64)
        for w0 in range(0, W, words):
            s = torch.from_numpy(np.ascontiguousarray(
                s64[:, w0:w0 + words])).to(dev)
            keep = ((torch.from_numpy(i32[w0:w0 + words]).to(dev)[:, None]
                     >> sh32) & 1).bool().reshape(-1)
            M += int(keep.sum())
            base = ((s[:, :, None] >> sh64) & 3).reshape(n, -1)
            for b in range(4):
                X = ((base == b) & keep).to(dtype)
                E += (X @ X.T).to(torch.int64)
        return (M - E).cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
