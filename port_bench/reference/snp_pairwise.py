"""Plain reference of `dist`'s SNP counts under per-sample include
masks (`-f 2`, no proximity pruning): for every pair of samples, the
positions both include (`shared`) and, among them, those at which their
bases differ (`dist`).

From the loader's layout (u64 words, two bits a position, position k of
a word at bits 62-2k and 63-2k; each sample's own u32 include words,
position k at bit 31-k): shared = sum over positions of the products of
the two include bits, dist = shared - sum over the four bases of the
products of one-hot columns restricted to each sample's included
positions.  Plain torch on the given device, a block of words at a
time; `dtype` is the precision of the products (float32, with TF32 off,
is exact: every block's sums stay under 2**24; bfloat16 is the
control's).  Imports nothing of the program under test."""

from __future__ import annotations

import numpy as np
import torch


def counts(seqs: np.ndarray, incs: np.ndarray, dev, dtype=torch.float32,
           words: int = 2048):
    """(dist, shared), each (n, n) int64 numpy: seqs (n, W) u64, incs
    (n, W) u32."""
    n, W = seqs.shape
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        sh64 = torch.arange(62, -1, -2, dtype=torch.int64, device=dev)
        sh32 = torch.arange(31, -1, -1, dtype=torch.int64, device=dev)
        E = torch.zeros((n, n), dtype=torch.int64, device=dev)
        S = torch.zeros((n, n), dtype=torch.int64, device=dev)
        s64 = seqs.view(np.int64)
        i64 = incs.astype(np.int64)
        for w0 in range(0, W, words):
            s = torch.from_numpy(np.ascontiguousarray(
                s64[:, w0:w0 + words])).to(dev)
            inc = torch.from_numpy(np.ascontiguousarray(
                i64[:, w0:w0 + words])).to(dev)
            keep = ((inc[:, :, None] >> sh32) & 1).bool().reshape(n, -1)
            base = ((s[:, :, None] >> sh64) & 3).reshape(n, -1)
            K = keep.to(dtype)
            S += (K @ K.T).to(torch.int64)
            for b in range(4):
                X = ((base == b) & keep).to(dtype)
                E += (X @ X.T).to(torch.int64)
        return (S - E).cpu().numpy(), S.cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
