"""The DNJ segment kernels' share of their byte roofline: the least
bytes (roofline/tree_bytes.py, from n and the traffic's `cell_bytes`)
of the trees the card built, at its peak bandwidth, over the kernels'
device time.  Calls handed to another route (`card_joins` 0) launch no
segment kernel and are left out."""

from port_bench.roofline.tree_bytes import tree_bytes


def read(ctx):
    trees = sum(1 for c in ctx.calls if c.get("card_joins"))
    us = sum(d for name, cat, _, d in ctx.device
             if cat == "kernel" and "dnj_segment" in name)
    if not trees or not us:
        return None
    nbytes = trees * tree_bytes(ctx.cfg["n"], ctx.traffic["cell_bytes"])
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / (us * 1e-6), "%"
