"""Device milliseconds of the copies between host and card (the seam's
uploads and its n x n copy back) per fill: every call of a dist cell
is one fill."""


def read(ctx):
    us = sum(d for _, cat, _, d in ctx.device if cat == "gpu_memcpy")
    if not ctx.calls or not us:
        return None
    return us * 1e-3 / len(ctx.calls), "ms/fill"
