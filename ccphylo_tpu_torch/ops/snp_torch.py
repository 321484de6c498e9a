"""All-pairs SNP counts over 2-bit packed sequences (counterpart of
ops/snp_jax.py and ops/snp_pallas.py).

The count is an int8 Gram product over a ±1 3-Gram expansion of the
bases (three planes per base, code(x).code(y) = 4*[x == y] - 1, see
csrc/snp_expand.cu), so dist = (3*npos - G) / 4 with npos the number of
included positions: the formulation of ops/snp_pallas.py.  The
expansion is a hand-written CUDA kernel (`expand_shared`,
`expand_pairwise`), with its plain PyTorch version beside it; the
contraction is a plain int8 product (`torch._int_mm`, int32
accumulation), as the JAX package leaves it to XLA.

The Gram is symmetric, so each genome chunk contracts only the
lower-triangular row blocks (block i against blocks 0..i, about half
the MACs of the full product) and the result is mirrored once at the
end, as in snp_pallas._tri_dot_acc / _mirror_tril.

u32 data is held as int32 bit patterns (CPU torch has no unsigned
shifts); bits are extracted with ``(x >> s) & mask``, identical under
arithmetic and logical shifts.  Counts are exact integers, bit-identical
to the JAX functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import multihost as mh
from . import build

BLK = 512        # row-block height of the triangular Gram dots
ROW_ALIGN = 128  # rows are padded to a multiple of this below BLK
WB = 512         # chunk widths are multiples of this many u32 words

# u32 word layout: base k of a word at bits (30-2k, 31-2k)
_SHIFTS = tuple(range(30, -1, -2))


def u64_to_u32(words64: np.ndarray) -> np.ndarray:
    """(..., W) u64 -> (..., 2W) u32 preserving base order (hi first)."""
    w = np.asarray(words64, np.uint64)
    hi = (w >> np.uint64(32)).astype(np.uint32)
    lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1).reshape(*w.shape[:-1],
                                               2 * w.shape[-1])


def inc32_to_pairmask(inc32: np.ndarray) -> np.ndarray:
    """(..., W) u32 include words (32 positions) -> (..., 2W) u32 pair
    masks aligned with the u32 sequence words (16 positions each, bit 2k
    = include)."""
    inc = np.asarray(inc32, np.uint32)
    hi = (inc >> np.uint32(16)).astype(np.uint32)
    lo = (inc & np.uint32(0xFFFF)).astype(np.uint32)
    x = np.stack([hi, lo], axis=-1).reshape(*inc.shape[:-1],
                                            2 * inc.shape[-1])
    x = (x | (x << np.uint32(8))) & np.uint32(0x00FF00FF)
    x = (x | (x << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    x = (x | (x << np.uint32(2))) & np.uint32(0x33333333)
    x = (x | (x << np.uint32(1))) & np.uint32(0x55555555)
    return x


def u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy u32 array -> int32 bit-pattern tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


# --- expansion: plain PyTorch versions and kernel wrappers -------------


def _planes_plain(seqs: torch.Tensor, masks: torch.Tensor):
    sh = torch.tensor(_SHIFTS, dtype=torch.int32, device=seqs.device)
    b = (seqs[..., None] >> sh) & 3                     # (n, W, 16)
    g = (masks[..., None] >> sh) & 1                    # (n|1, W, 16)
    p1 = (1 - 2 * ((b >> 1) & 1)) * g
    p0 = (1 - 2 * (b & 1)) * g
    X = torch.stack([p1, p0, p1 * p0], dim=-1).to(torch.int8)
    return X.reshape(seqs.shape[0], -1), g


def expand_shared_plain(seqs: torch.Tensor, pm: torch.Tensor):
    """Plain version of the shared-mask expansion: (n, W) int32 words
    and (W,) int32 pair mask -> X (n, 48W) int8 in the kernel's column
    order X[i, 48w + 3k + c]."""
    return _planes_plain(seqs, pm[None, :])[0]


def expand_pairwise_plain(seqs: torch.Tensor, masks: torch.Tensor):
    """Plain version of the per-sample-mask expansion: X (n, 48W) and
    include plane M (n, 16W) int8, M[i, 16w + k]."""
    X, g = _planes_plain(seqs, masks)
    return X, g.to(torch.int8).reshape(seqs.shape[0], -1)


def _check_words(name, t, ndim):
    if t.dtype != torch.int32 or t.dim() != ndim or t.stride(-1) != 1:
        raise ValueError(f"{name}: expected int32 words with unit stride "
                         f"in the last dim, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def expand_shared(seqs: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    """Shared-mask ±1 3-Gram expansion.  On a CUDA tensor: the
    snp_expand_shared kernel; on a CPU tensor: its plain version.
    seqs may be a column slice of a wider row-major matrix."""
    if seqs.device.type == "cpu":
        return expand_shared_plain(seqs, pm)
    _check_words("seqs", seqs, 2)
    _check_words("pm", pm, 1)
    n, W = seqs.shape
    if pm.shape[0] != W or pm.device != seqs.device:
        raise ValueError("pm must be (W,) on the same device as seqs")
    X = torch.empty((n, 48 * W), dtype=torch.int8, device=seqs.device)
    build.launch("snp_expand", "snp_expand_shared", seqs.data_ptr(),
                 seqs.stride(0), pm.data_ptr(), X.data_ptr(), n, W,
                 device=seqs.device)
    return X


def expand_pairwise(seqs: torch.Tensor, masks: torch.Tensor):
    """Per-sample-mask expansion: (X, M).  On a CUDA tensor: the
    snp_expand_pairwise kernel; on a CPU tensor: its plain version."""
    if seqs.device.type == "cpu":
        return expand_pairwise_plain(seqs, masks)
    _check_words("seqs", seqs, 2)
    _check_words("masks", masks, 2)
    n, W = seqs.shape
    if masks.shape != seqs.shape or masks.device != seqs.device:
        raise ValueError("masks must match seqs in shape and device")
    X = torch.empty((n, 48 * W), dtype=torch.int8, device=seqs.device)
    M = torch.empty((n, 16 * W), dtype=torch.int8, device=seqs.device)
    build.launch("snp_expand", "snp_expand_pairwise", seqs.data_ptr(),
                 seqs.stride(0), masks.data_ptr(), masks.stride(0),
                 X.data_ptr(), M.data_ptr(), n, W, device=seqs.device)
    return X, M


# --- triangular Gram and the two entry points --------------------------


def _tri_dot_acc(acc: torch.Tensor, X: torch.Tensor, B: int) -> None:
    """acc += lower-triangular row-block Gram of X, in place: block i
    contracts against blocks 0..i; the upper blocks stay untouched."""
    for r0 in range(0, X.shape[0], B):
        acc[r0:r0 + B, :r0 + B] += torch._int_mm(X[r0:r0 + B],
                                                 X[:r0 + B].t())


def _mirror_tril(G: torch.Tensor) -> torch.Tensor:
    return torch.tril(G) + torch.tril(G, -1).T


def _layout(n: int, W: int, wchunk: int | None):
    """(row block B, padded rows, words per chunk)."""
    B = BLK if n > BLK else max(ROW_ALIGN, -(-n // ROW_ALIGN) * ROW_ALIGN)
    npad = -(-n // B) * B
    if wchunk is not None:
        wc = max(WB, (wchunk // WB) * WB)
    else:
        # expanded X chunk (npad x 48*wc int8) around 512 MiB
        wc = (512 * 1024 * 1024) // (48 * npad)
        wc = int(max(WB, min(2048, (wc // WB) * WB)))
    return B, npad, wc


def _pad_rows(a: torch.Tensor, npad: int) -> torch.Tensor:
    if a.shape[0] == npad:
        return a
    return torch.nn.functional.pad(a, (0, 0, 0, npad - a.shape[0]))


def snp_matrix(seqs: torch.Tensor, paircmask: torch.Tensor,
               wchunk: int | None = None) -> torch.Tensor:
    """All-pairs SNP counts under a shared include mask.

    seqs: (n, W) int32 (u32 words); paircmask: (W,) int32 pair mask.
    Returns (n, n) int32 distances, bit-identical to
    ops/snp_jax.snp_matrix and ops/snp_pallas.snp_matrix."""
    n, W = seqs.shape
    B, npad, wc = _layout(n, W, wchunk)
    seqs = _pad_rows(seqs, npad)
    gram = torch.zeros((npad, npad), dtype=torch.int32, device=seqs.device)
    for w0 in range(0, W, wc):
        _tri_dot_acc(gram, expand_shared(seqs[:, w0:w0 + wc],
                                         paircmask[w0:w0 + wc]), B)
    # include bits sit at the even positions of the pair mask
    sh = torch.arange(0, 32, 2, dtype=torch.int32, device=seqs.device)
    npos = int(((paircmask[:, None] >> sh) & 1).sum())
    # G = 4*matches - npos  =>  dist = npos - matches = (3*npos - G) / 4
    return ((3 * npos - _mirror_tril(gram)) // 4)[:n, :n]


def sharded_snp_matrix(seqs: torch.Tensor, paircmask: torch.Tensor,
                       wchunk: int | None = None) -> torch.Tensor:
    """All-pairs SNP counts under a shared include mask, sample rows
    split over the ranks of the row axis (parallel/multihost.py).

    Every rank passes the same (n, W) int32 words and (W,) int32 pair
    mask, on its device.  Per genome chunk each rank expands its own
    rows (`expand_shared`), all-gathers the expanded blocks and takes
    its (R, npad) block of the int8 Gram; the blocks are all-gathered at
    the end.  Returns the (n, n) int32 distances on every rank,
    bit-identical to `snp_matrix` and to ops/snp_jax.sharded_snp_matrix.
    """
    rank, world = mh.row_axis()
    n, W = seqs.shape
    npad = -(-n // (ROW_ALIGN * world)) * ROW_ALIGN * world
    R = npad // world
    mine = _pad_rows(seqs, npad)[rank * R:(rank + 1) * R]
    wc = _layout(npad, W, wchunk)[2]
    gram = torch.zeros((R, npad), dtype=torch.int32, device=seqs.device)
    for w0 in range(0, W, wc):
        X = expand_shared(mine[:, w0:w0 + wc], paircmask[w0:w0 + wc])
        gram += torch._int_mm(X, mh.gather_rows(X).t())
    sh = torch.arange(0, 32, 2, dtype=torch.int32, device=seqs.device)
    npos = int(((paircmask[:, None] >> sh) & 1).sum())
    return mh.gather_rows((3 * npos - gram) // 4)[:n, :n]


def snp_matrix_pairwise(seqs: torch.Tensor, incmasks: torch.Tensor,
                        wchunk: int | None = None):
    """All-pairs (dist, shared) with per-sample pair masks (proxi == 0:
    the pair mask of two samples is the AND of theirs).

    seqs, incmasks: (n, W) int32.  Returns (dist, shared) (n, n) int32,
    bit-identical to ops/snp_jax.snp_matrix_pairwise and
    ops/snp_pallas.snp_matrix_pairwise."""
    n, W = seqs.shape
    B, npad, wc = _layout(n, W, wchunk)
    seqs = _pad_rows(seqs, npad)
    incmasks = _pad_rows(incmasks, npad)
    gram = torch.zeros((npad, npad), dtype=torch.int32, device=seqs.device)
    shared = torch.zeros_like(gram)
    for w0 in range(0, W, wc):
        X, M = expand_pairwise(seqs[:, w0:w0 + wc],
                               incmasks[:, w0:w0 + wc])
        _tri_dot_acc(gram, X, B)
        _tri_dot_acc(shared, M, B)
    shared = _mirror_tril(shared)
    dist = (3 * shared - _mirror_tril(gram)) // 4
    return dist[:n, :n], shared[:n, :n]
