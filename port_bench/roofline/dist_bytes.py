"""Least bytes one `dist` fill under a shared mask must move to or from
device memory: the 2-bit alignment (the loader's W = ceil(L / 32) u64
words a sample) and its W u32 include words read once, the n x n int32
count matrix written once.  From the shapes alone, so no implementation
can lower its own bound; there is no operations bound, since a
bit-parallel count can beat any fixed count of operations."""


def fill_bytes(n: int, genome_bp: int) -> int:
    W = -(-genome_bp // 32)
    return n * W * 8 + W * 4 + n * n * 4
