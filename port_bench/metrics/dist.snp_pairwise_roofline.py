"""The fills' kernels' share of their byte roofline under per-sample
masks: each fill's least bytes (roofline/dist_pairwise_bytes.py, from n
and L) at the card's peak bandwidth, over the device time of every
kernel of the window.  Only the calls of a per-sample-mask cell (their
records carry `masks`) count; elsewhere it reads nothing."""

from port_bench.roofline.dist_pairwise_bytes import fill_bytes


def read(ctx):
    fills = sum(1 for c in ctx.calls if c.get("masks") == "per-sample")
    us = sum(d for _, cat, _, d in ctx.device if cat == "kernel")
    if not fills or not us:
        return None
    nbytes = fills * fill_bytes(ctx.cfg["n"], ctx.cfg["genome_bp"])
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / (us * 1e-6), "%"
