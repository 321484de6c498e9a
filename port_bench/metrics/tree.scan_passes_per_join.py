"""Scan passes of the DNJ segment kernels per join the card made: the
program's counter `tree/scan_passes` (each engine's count on the card,
`stats[0]`, read once a tree) over the calls' `card_joins`."""

from port_bench.program import counters


def read(ctx):
    passes = counters().get("tree/scan_passes")
    joins = sum(c.get("card_joins", 0) for c in ctx.calls)
    if passes is None or not joins:
        return None
    return passes / joins, "passes/join"
