"""Least bytes one DNJ tree of n taxa must move to or from device
memory: at each join with m active taxa the two joined rows read once
and the new row written once, 3 * m cells of the route's storage
(`cell_bytes`: 8 on the float64 route, 1 on the packed u8 route), and
the join's record (two indices of 4 bytes, two limbs of 8) written
once; m runs from n down to 3.  A floor from the shapes alone: it
leaves out the scan, whose work depends on the data, so latency-bound
kernels read far under 1% of it."""


def tree_bytes(n: int, cell_bytes: int) -> int:
    if n < 3:
        return 0
    cells = 3 * (n * (n + 1) // 2 - 3)      # 3 * sum of m for m = 3..n
    return cells * cell_bytes + 24 * (n - 2)
