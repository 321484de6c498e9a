"""Least bytes one `dist` fill under per-sample include masks must move
to or from device memory: the 2-bit alignment (the loader's
W = ceil(L / 32) u64 words a sample) and each sample's W u32 include
words read once, the n x n int32 SNP counts and the n x n int32 shared
position counts written once.  From the shapes alone, as
`dist_bytes.py`."""


def fill_bytes(n: int, genome_bp: int) -> int:
    W = -(-genome_bp // 32)
    return n * W * 8 + n * W * 4 + 2 * n * n * 4
