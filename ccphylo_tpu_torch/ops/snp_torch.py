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

Sample words come in one of two layouts, told apart by the tensor's
dtype; the algorithm is the same, only the index of a word differs:

- int32: u32 words in base order (hi first, `u64_to_u32`): base k of
  word w at bits (30-2k, 31-2k).  `sharded_snp_matrix`, the dry run and
  the tests pass these.
- int64: the .fsa loader's u64 words as they are (`u64_tensor`, or row
  by row into a padded buffer by `padded_rows`; no host pass): base k
  of word j at bits (62-2k, 63-2k).  Read as u32 words, u64 word j is
  [lo, hi], so u32 word w of the int32 layout sits at index w ^ 1; the
  kernels read it there, the plain versions shift by 62..0.  Chunk
  bounds are multiples of WB u32 words, so a chunk holds whole u64
  words.  The CLI's fills pass these.

Per-sample masks come in one of two layouts too, told apart by their
width against the W u32 sample words (`_inc_words`):

- W columns: pair masks, int32 u32 words hi first (`inc32_to_pairmask`),
  base k of word w included by bit 30-2k.  The shared mask is always
  one; the dry run, interop and the tests pass these.
- W / 2 columns (W even): the loader's u32 include words as they are, one
  per u64 sample word, position p of its 32 at bit 31-p; u32 sample
  word w is the hi (w even) or lo (w odd) half of include word w >> 1.
  Chunk bounds are multiples of WB, so a chunk holds whole include
  words.  The CLI's per-sample fills pass these (`padded_rows`).

Words are held as signed bit patterns (CPU torch has no unsigned
shifts); bits are extracted with ``(x >> s) & mask``, identical under
arithmetic and logical shifts.  Counts are exact integers, bit-identical
to the JAX functions.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..parallel import multihost as mh
from ..utils import timing
from . import build

BLK = 512        # row-block height of the triangular Gram dots
ROW_ALIGN = 128  # rows are padded to a multiple of this below BLK
WB = 512         # chunk widths are multiples of this many u32 words
RING_SLOTS = 3   # pinned host blocks of `padded_rows`' upload ring
# bytes a ring block holds at most; a power of two, since PyTorch's
# caching host allocator rounds a pinned block up to one
SLOT_BYTES = 64 << 20
COPY_THREADS = 4  # host threads that copy a block's rows into its slot

# u32 word layout: base k of a word at bits (30-2k, 31-2k); u64: (62-2k,
# 63-2k)
_SHIFTS = tuple(range(30, -1, -2))
_SHIFTS64 = tuple(range(62, -1, -2))


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


def u64_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy u64 sample words (the loader's layout) -> int64 bit-pattern
    tensor on `device`, uploaded as they are (no copy of a contiguous
    u64 array on the host)."""
    a = np.ascontiguousarray(np.asarray(a, np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def padded_rows(rows, device) -> torch.Tensor:
    """Sample rows -> one (npad, w) bit-pattern tensor on `device`, with
    npad the padded row count of `_layout` (rows n..npad zero, as
    `_pad_rows` pads), ready for `_snp_matrix` / `_snp_matrix_pairwise`.

    `rows` is a sequence of n 1-d integer arrays of one width w and one
    dtype: u64 sample words (an int64 tensor) or u32 include words
    (int32); each is read as a separate array, never through a base
    buffer rows may share.  On a CUDA device the rows cross through a
    ring of RING_SLOTS pinned host blocks of at most SLOT_BYTES: the
    host copies a block's rows into a free slot (COPY_THREADS threads,
    each a share of the rows: numpy's copies release the GIL, and one
    thread copies at a fraction of the DMA's rate), one non-blocking copy
    moves the slot into those rows of the buffer on the current stream,
    and an event on the slot marks when it may be refilled, so the host
    copy of a block overlaps the transfer of the one before.  The last
    transfers may still run when this returns (the stream orders them
    before later work; the caching host allocator keeps a slot until
    its copy is done).  Each block counts one `dist/ring_blocks`
    (utils/timing.py).  On another device the rows are copied straight
    into the buffer."""
    n = len(rows)
    first = np.asarray(rows[0])
    w, item = first.shape[0], first.dtype.itemsize
    dtype = {8: torch.int64, 4: torch.int32}[item]
    buf = torch.empty((_padded(n)[1], w), dtype=dtype, device=device)
    buf[n:].zero_()
    if buf.device.type != "cuda":
        _copy_rows(buf.numpy().view(first.dtype), rows, 0, n)
        return buf
    R = max(1, SLOT_BYTES // (w * item))
    slots, done = [], [None] * RING_SLOTS
    stream = torch.cuda.current_stream(buf.device)
    with ThreadPoolExecutor(COPY_THREADS) as pool:
        for b, r0 in enumerate(range(0, n, R)):
            s, r1 = b % RING_SLOTS, min(n, r0 + R)
            if b < RING_SLOTS:
                slots.append(torch.empty((min(R, n), w), dtype=dtype,
                                         pin_memory=True))
            else:
                done[s].synchronize()
            out = slots[s].numpy().view(first.dtype)
            step = -(-(r1 - r0) // COPY_THREADS)
            list(pool.map(lambda a: _copy_rows(out[a - r0:], rows, a,
                                               min(r1, a + step)),
                          range(r0, r1, step)))
            buf[r0:r1].copy_(slots[s][:r1 - r0], non_blocking=True)
            done[s] = torch.cuda.Event()
            done[s].record(stream)
            timing.count("dist/ring_blocks")
    return buf


def _copy_rows(out: np.ndarray, rows, r0: int, r1: int) -> None:
    """out[j - r0] = rows[j] for j in r0..r1, each of out's row shape and
    dtype."""
    for j in range(r0, r1):
        row = rows[j]
        if row.shape != out.shape[1:]:
            raise ValueError(f"row {j}: shape {row.shape}, the rows "
                             f"before it {out.shape[1:]}")
        np.copyto(out[j - r0], row, casting="no")


def _u32_per_col(seqs: torch.Tensor) -> int:
    """u32 words a column of sample words holds: 2 in the int64 (u64)
    layout, 1 in the int32 one."""
    return 2 if seqs.dtype == torch.int64 else 1


# --- expansion: plain PyTorch versions and kernel wrappers -------------


def _bases(seqs: torch.Tensor) -> torch.Tensor:
    """(n, W, 16) int32 bases of either layout, W u32 words hi first."""
    if seqs.dtype == torch.int64:
        sh = torch.tensor(_SHIFTS64, dtype=torch.int64, device=seqs.device)
        b = ((seqs[..., None] >> sh) & 3).to(torch.int32)   # (n, W/2, 32)
        return b.reshape(seqs.shape[0], -1, 16)
    sh = torch.tensor(_SHIFTS, dtype=torch.int32, device=seqs.device)
    return (seqs[..., None] >> sh) & 3


def _inc_words(masks: torch.Tensor, W: int) -> bool:
    """Whether masks of W u32 sample words are include words (W / 2
    columns) rather than pair masks (W columns)."""
    if masks.shape[-1] == W:
        return False
    if W % 2 == 0 and masks.shape[-1] == W // 2:
        return True
    raise ValueError(f"masks of {W} u32 sample words need {W} columns "
                     f"(pair masks) or, W even, {W // 2} (include "
                     f"words), got {tuple(masks.shape)}")


def _include_bits(masks: torch.Tensor, W: int) -> torch.Tensor:
    """(n|1, W, 16) include bits of either mask layout."""
    if _inc_words(masks, W):
        sh = torch.arange(31, -1, -1, dtype=torch.int32, device=masks.device)
        return ((masks[..., None] >> sh) & 1).reshape(masks.shape[0], W, 16)
    sh = torch.tensor(_SHIFTS, dtype=torch.int32, device=masks.device)
    return (masks[..., None] >> sh) & 1


def _planes_plain(seqs: torch.Tensor, masks: torch.Tensor):
    b = _bases(seqs)                                    # (n, W, 16)
    g = _include_bits(masks, b.shape[1])                # (n|1, W, 16)
    p1 = (1 - 2 * ((b >> 1) & 1)) * g
    p0 = (1 - 2 * (b & 1)) * g
    X = torch.stack([p1, p0, p1 * p0], dim=-1).to(torch.int8)
    return X.reshape(seqs.shape[0], -1), g


def expand_shared_plain(seqs: torch.Tensor, pm: torch.Tensor):
    """Plain version of the shared-mask expansion: (n, W) int32 words
    (or (n, W/2) int64 u64 words) and (W,) int32 pair mask -> X (n,
    48W) int8 in the kernel's column order X[i, 48w + 3k + c]."""
    return _planes_plain(seqs, pm[None, :])[0]


def expand_pairwise_plain(seqs: torch.Tensor, masks: torch.Tensor):
    """Plain version of the per-sample-mask expansion: X (n, 48W) and
    include plane M (n, 16W) int8, M[i, 16w + k]; masks are (n, W) pair
    masks or (n, W/2) include words."""
    X, g = _planes_plain(seqs, masks)
    return X, g.to(torch.int8).reshape(seqs.shape[0], -1)


def _check_words(name, t, ndim, dtypes=(torch.int32,)):
    if t.dtype not in dtypes or t.dim() != ndim or t.stride(-1) != 1:
        raise ValueError(f"{name}: expected {ndim}-d words of "
                         f"{'/'.join(map(str, dtypes))} with unit stride "
                         f"in the last dim, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _kernel_words(seqs: torch.Tensor):
    """The kernels' view of sample words: (int32 view, its row stride
    in u32 words, u32 words a row, swap); int64 (u64) words are read
    through their int32 view at index w ^ 1 (swap = 1)."""
    _check_words("seqs", seqs, 2, (torch.int32, torch.int64))
    swap = _u32_per_col(seqs) - 1
    v = seqs.view(torch.int32) if swap else seqs
    return v, v.stride(0), v.shape[1], swap


def expand_shared(seqs: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    """Shared-mask ±1 3-Gram expansion of int32 or int64 sample words
    (the module's two layouts).  On a CUDA tensor: the snp_expand_shared
    kernel; on a CPU tensor: its plain version.  seqs may be a column
    slice of a wider row-major matrix."""
    if seqs.device.type == "cpu":
        return expand_shared_plain(seqs, pm)
    s, ld, W, swap = _kernel_words(seqs)
    _check_words("pm", pm, 1)
    n = s.shape[0]
    if pm.shape[0] != W or pm.device != seqs.device:
        raise ValueError("pm must be (W,) u32 words on the same device "
                         "as seqs")
    X = torch.empty((n, 48 * W), dtype=torch.int8, device=seqs.device)
    build.launch("snp_expand", "snp_expand_shared", s.data_ptr(), ld, swap,
                 pm.data_ptr(), X.data_ptr(), n, W, device=seqs.device)
    return X


def expand_pairwise(seqs: torch.Tensor, masks: torch.Tensor):
    """Per-sample-mask expansion: (X, M) of int32 or int64 sample words
    and int32 masks, (n, W) pair masks or (n, W/2) include words (the
    module's two mask layouts).  On a CUDA tensor: the
    snp_expand_pairwise kernel; on a CPU tensor: its plain version."""
    if seqs.device.type == "cpu":
        return expand_pairwise_plain(seqs, masks)
    s, ld, W, swap = _kernel_words(seqs)
    _check_words("masks", masks, 2)
    inc = _inc_words(masks, W)
    n = s.shape[0]
    if masks.shape[0] != n or masks.device != seqs.device:
        raise ValueError("masks must be n rows of u32 words on the same "
                         "device as seqs")
    X = torch.empty((n, 48 * W), dtype=torch.int8, device=seqs.device)
    M = torch.empty((n, 16 * W), dtype=torch.int8, device=seqs.device)
    build.launch("snp_expand", "snp_expand_pairwise", s.data_ptr(), ld,
                 swap, masks.data_ptr(), masks.stride(0), int(inc),
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


def _padded(n: int):
    """(row block B, padded rows) of n rows."""
    B = BLK if n > BLK else max(ROW_ALIGN, -(-n // ROW_ALIGN) * ROW_ALIGN)
    return B, -(-n // B) * B


def _layout(n: int, W: int, wchunk: int | None):
    """(row block B, padded rows, words per chunk)."""
    B, npad = _padded(n)
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

    seqs: (n, W) int32 (u32 words) or (n, W/2) int64 (the loader's u64
    words); paircmask: (W,) int32 pair mask.  Returns (n, n) int32
    distances, bit-identical to ops/snp_jax.snp_matrix and
    ops/snp_pallas.snp_matrix."""
    return _snp_matrix(seqs, paircmask, seqs.shape[0], wchunk)


def _snp_matrix(seqs: torch.Tensor, paircmask: torch.Tensor, n: int,
                wchunk: int | None = None) -> torch.Tensor:
    """`snp_matrix` of the first n rows of seqs, which holds n rows or
    the layout's padded count with zero rows after n (`padded_rows`:
    then no padded copy is made)."""
    k = _u32_per_col(seqs)
    W = k * seqs.shape[1]
    B, npad, wc = _layout(n, W, wchunk)
    seqs = _pad_rows(seqs, npad)
    gram = torch.zeros((npad, npad), dtype=torch.int32, device=seqs.device)
    for w0 in range(0, W, wc):
        _tri_dot_acc(gram, expand_shared(seqs[:, w0 // k:(w0 + wc) // k],
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
    """All-pairs (dist, shared) with per-sample masks (proxi == 0: the
    pair mask of two samples is the AND of theirs).

    seqs: (n, W) int32 or (n, W/2) int64 (as `snp_matrix`); incmasks:
    int32, (n, W) pair masks or (n, W/2) include words.  Returns (dist,
    shared) (n, n) int32, bit-identical to ops/snp_jax.snp_matrix_pairwise
    and ops/snp_pallas.snp_matrix_pairwise."""
    return _snp_matrix_pairwise(seqs, incmasks, seqs.shape[0], wchunk)


def _snp_matrix_pairwise(seqs: torch.Tensor, incmasks: torch.Tensor,
                         n: int, wchunk: int | None = None):
    """`snp_matrix_pairwise` of the first n rows of seqs and incmasks,
    each holding n rows or the layout's padded count (as
    `_snp_matrix`)."""
    k = _u32_per_col(seqs)
    W = k * seqs.shape[1]
    m = 2 if _inc_words(incmasks, W) else 1   # u32 words a mask column covers
    B, npad, wc = _layout(n, W, wchunk)
    seqs = _pad_rows(seqs, npad)
    incmasks = _pad_rows(incmasks, npad)
    gram = torch.zeros((npad, npad), dtype=torch.int32, device=seqs.device)
    shared = torch.zeros_like(gram)
    for w0 in range(0, W, wc):
        X, M = expand_pairwise(seqs[:, w0 // k:(w0 + wc) // k],
                               incmasks[:, w0 // m:(w0 + wc) // m])
        _tri_dot_acc(gram, X, B)
        _tri_dot_acc(shared, M, B)
        del X, M   # free this chunk before the next one is allocated
    shared = _mirror_tril(shared)
    dist = (3 * shared - _mirror_tril(gram)) // 4
    return dist[:n, :n], shared[:n, :n]
