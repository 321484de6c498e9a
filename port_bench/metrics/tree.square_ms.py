"""Host milliseconds a tree of the float route's square matrix (span
`tree/square`, tree/torch_engine.py::build_tree_float: the float64
(n, n) matrix made from the loaded triangle), one span a call."""

from port_bench.program import ms_per_span


def read(ctx):
    ms = ms_per_span("tree/square")
    return None if ms is None else (ms, "ms/tree")
