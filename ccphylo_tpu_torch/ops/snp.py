"""SNP/Hamming kernels over packed 2-bit sequences (host/numpy path).

Parity sources:
- fsacmp.c:552-585 (fsacmp), fsacmp.c:587-633 (fsacmpair),
  fsacmp.c:646-737 (fsacmprint / fsacmpairint — per-SNP diff listing),
  fsacmp.c:487-503 (getNpos), fsacmp.c:355-485 (maskProxi).

The bit-serial C loops become XOR + pair-OR + popcount vector ops.  The
device path reformulates the same counts as int8 Gram products
(ops/snp_torch.py, with the CUDA expansion kernels of
csrc/snp_expand.cu); results are integer-identical.
"""

from __future__ import annotations

import numpy as np

from .pack2bit import bits_to_mask_words, mask_words_to_bits, n_words

U32 = np.uint32
U64 = np.uint64
PAIR_LO = U64(0x5555555555555555)


def expand_bits(inc32: np.ndarray) -> np.ndarray:
    """u32 include words -> u64 masks with include bit k at bit pair 2k
    (aligning the per-position include bit with its 2-bit base)."""
    x = inc32.astype(U64)
    x = (x | (x << U64(16))) & U64(0x0000FFFF0000FFFF)
    x = (x | (x << U64(8))) & U64(0x00FF00FF00FF00FF)
    x = (x | (x << U64(4))) & U64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << U64(2))) & U64(0x3333333333333333)
    x = (x | (x << U64(1))) & PAIR_LO
    return x


def diff_pairs(seq1: np.ndarray, seq2: np.ndarray) -> np.ndarray:
    """Per-word u64 mask with bit 2k set where base pair k differs."""
    x = seq1 ^ seq2
    return (x | (x >> U64(1))) & PAIR_LO


def get_npos(inc: np.ndarray) -> int:
    """getNpos (fsacmp.c:487-503): popcount of the include mask."""
    return int(np.bitwise_count(inc).sum())


def fsacmp(seq1, seq2, inc) -> int:
    """fsacmp (fsacmp.c:552-585): #differences under a shared mask."""
    d = diff_pairs(seq1, seq2) & expand_bits(inc)
    return int(np.bitwise_count(d).sum())


def fsacmpair(seq1, seq2, inc):
    """fsacmpair (fsacmp.c:587-633): (#differences, #shared positions)."""
    e = expand_bits(inc)
    d = diff_pairs(seq1, seq2) & e
    return int(np.bitwise_count(d).sum()), int(np.bitwise_count(inc).sum())


def mask_proxi(inc1, inc2, seq1, seq2, length: int, proxi: int):
    """maskProxi (fsacmp.c:355-485): pair mask = AND of both includes,
    then pairwise proximity pruning over the pair's own SNPs.

    The reference scans positions descending with a 1-based cursor; for
    consecutive SNPs at 0-based positions p_low < p_high with
    p_high - p_low <= proxi it masks 0-based [p_low, p_high] (validated
    against the oracle).  An initial virtual SNP sits past the end
    (lastSNP = len + proxi, fsacmp.c:365), which never triggers for
    proxi < len."""
    inc = inc1 & inc2
    if proxi and len(inc):
        d = diff_pairs(seq1, seq2) & expand_bits(inc)
        if d.any():
            snp_words = np.bitwise_count(d)
            bits = mask_words_to_bits(inc, length)
            diffbits = np.zeros(length, bool)
            # positions of differing included bases
            widx = np.flatnonzero(snp_words)
            for w in widx:
                word = int(d[w])
                base = w * 32
                while word:
                    k = (word & -word).bit_length() - 1  # lowest set bit
                    diffbits[base + 31 - (k >> 1)] = True
                    word &= word - 1
            events = np.flatnonzero(diffbits)
            if len(events) > 1:
                prev = events[:-1]
                cur = events[1:]
                close = (cur - prev) <= proxi
                if close.any():
                    # the reference's descending 1-based cursor masks
                    # 0-based [p_low+1, p_high+1] for each close pair
                    # (fsacmp.c:389-457, verified against the oracle)
                    out = np.zeros(length + 2, np.int32)
                    np.add.at(out, prev[close] + 1, 1)
                    np.add.at(out, np.minimum(cur[close] + 2, length + 1),
                              -1)
                    span = np.cumsum(out[:-2]) > 0
                    bits &= ~span
                    inc = inc & bits_to_mask_words(bits)
    return inc


def diff_positions(seq1, seq2, inc, length: int):
    """Included differing positions with the reference's printed labels.

    fsacmprint/fsacmpairint (fsacmp.c:646-737) label positions with a
    counter that follows the LSB-first bit scan, so within each 32-block
    the label runs backwards, and words whose scan exits early leave the
    counter short.  Returns [(printed_pos, base1, base2)] in scan order.
    """
    out = []
    pos = 1
    W = len(seq1)
    for w in range(W):
        incw = int(inc[w])
        if incw and seq1[w] != seq2[w]:
            k1 = int(seq1[w])
            k2 = int(seq2[w])
            k = 0
            while incw:
                if incw & 1 and ((k1 >> (2 * k)) & 3) != ((k2 >> (2 * k)) & 3):
                    out.append((pos, (k1 >> (2 * k)) & 3,
                                (k2 >> (2 * k)) & 3))
                incw >>= 1
                k += 1
                pos += 1
        else:
            pos += 32
    return out


# --- all-pairs batch kernels (numpy host path) -----------------------------


def pairwise_masked(seqs: np.ndarray, incs: np.ndarray):
    """All-pairs (dist, shared) with per-sample include masks and no
    proximity pruning (fsacmpair under pair mask = AND of both includes,
    fsacmpthrd.c:409-416 with proxi == 0).

    seqs: (n, W64) u64; incs: (n, W32) u32.  Returns (D, N) int64.
    """
    n = seqs.shape[0]
    W = seqs.shape[1]
    Dm = np.zeros((n, n), np.int64)
    Nm = np.zeros((n, n), np.int64)
    jc = _col_chunk(W)

    def fill(i):
        for j0 in range(0, i, jc):
            j1 = min(i, j0 + jc)
            pinc = incs[j0:j1] & incs[i]
            x = seqs[j0:j1] ^ seqs[i]
            d = (x | (x >> U64(1))) & PAIR_LO
            cnt = np.bitwise_count(d & expand_bits(pinc)).sum(axis=1)
            nsh = np.bitwise_count(pinc).sum(axis=1)
            Dm[i, j0:j1] = cnt
            Dm[j0:j1, i] = cnt
            Nm[i, j0:j1] = nsh
            Nm[j0:j1, i] = nsh

    _row_parallel(fill, n)
    return Dm, Nm


def cross_block(seqs_a: np.ndarray, seqs_b: np.ndarray,
                inc: np.ndarray) -> np.ndarray:
    """SNP counts between every row of A and every row of B under one
    shared mask (checkpointable tile of the all-pairs fill).

    seqs_a: (a, W) u64; seqs_b: (b, W) u64; inc: (W,) u32.
    Returns (a, b) int64.
    """
    e = expand_bits(inc)
    out = np.zeros((seqs_a.shape[0], seqs_b.shape[0]), np.int64)
    for k in range(seqs_a.shape[0]):
        x = seqs_b ^ seqs_a[k]
        d = (x | (x >> U64(1))) & PAIR_LO
        out[k] = np.bitwise_count(d & e).sum(axis=1)
    return out


def pairwise_shared(seqs: np.ndarray, inc: np.ndarray) -> np.ndarray:
    """All-pairs SNP counts under one shared include mask.

    seqs: (n, W) u64; inc: (W,) u32.  Returns (n, n) int64 distances.
    """
    n = seqs.shape[0]
    W = seqs.shape[1]
    e = expand_bits(inc)
    D = np.zeros((n, n), np.int64)
    jc = _col_chunk(W)

    def fill(i):
        for j0 in range(0, i, jc):
            j1 = min(i, j0 + jc)
            x = seqs[j0:j1] ^ seqs[i]
            d = (x | (x >> U64(1))) & PAIR_LO
            cnt = np.bitwise_count(d & e).sum(axis=1)
            D[i, j0:j1] = cnt
            D[j0:j1, i] = cnt

    _row_parallel(fill, n)
    return D


def _col_chunk(W: int) -> int:
    """Rows per inner block so one task's temporaries stay ~128 MB
    (several O(block*W) u64 arrays live at once)."""
    return max(1, (16 << 20) // max(1, W))


def _row_parallel(fill, n: int) -> None:
    """Run fill(i) for i in 1..n-1, threaded for large n — the numpy
    bitwise kernels release the GIL and rows write disjoint slices, so
    results are deterministic (this replaces the reference's spinlock
    work cursor, fsacmpthrd.c:183-256)."""
    import os
    if n <= 64:
        for i in range(1, n):
            fill(i)
        return
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(32, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(1, n)))
