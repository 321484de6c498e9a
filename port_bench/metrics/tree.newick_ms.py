"""Host milliseconds a tree of the Newick bytes made from the join
records (span `tree/newick` of build_tree_float and build_tree_packed:
`_records_to_newick`), one span a call."""

from port_bench.program import ms_per_span


def read(ctx):
    ms = ms_per_span("tree/newick")
    return None if ms is None else (ms, "ms/tree")
