"""The fills' kernels' share of their byte roofline: each fill's least
bytes (roofline/dist_bytes.py, from n and L) at the card's peak
bandwidth, over the device time of every kernel of the window; every
call of a dist cell is one fill."""

from port_bench.roofline.dist_bytes import fill_bytes


def read(ctx):
    us = sum(d for _, cat, _, d in ctx.device if cat == "kernel")
    if not ctx.calls or not us:
        return None
    nbytes = len(ctx.calls) * fill_bytes(ctx.cfg["n"], ctx.cfg["genome_bp"])
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / (us * 1e-6), "%"
