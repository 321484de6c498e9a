"""Host milliseconds a tree of the packed route's u8 cells laid into the
engine's words and uploaded (span `tree/pack` of build_tree_packed:
`pack_cells` on the -b loader's uint8 triangle), one span a call that
hands u8 cells (its record carries `pack_s`); nothing where no call
of the window does."""

from port_bench.program import ms_per_span


def read(ctx):
    ms = ms_per_span("tree/pack")
    if ms is None or not any("pack_s" in c for c in ctx.calls):
        return None
    return ms, "ms/tree"
