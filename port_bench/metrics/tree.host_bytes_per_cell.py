"""Bytes of the distance matrix the tree seam held on the host per cell
of it: the program's counter `tree/host_cell_bytes` (the loaded
triangle's bytes, added by cli/tree_cmd.py::_dispatch_build each call)
over the calls' n (n - 1) / 2 cells.  1 where the loader's u8 cells go
to the packed engine, 8 for a float64 triangle."""

from port_bench.program import counters


def read(ctx):
    held = counters().get("tree/host_cell_bytes")
    n = ctx.cfg["n"]
    calls = sum(1 for c in ctx.calls if "joins" in c)
    if held is None or not calls:
        return None
    return held / (calls * n * (n - 1) / 2), "B/cell"
