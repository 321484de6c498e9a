"""Device microseconds of the DNJ segment kernels (`dnj_segment*`:
csrc/dnj_segment_float.cu on the float route, csrc/dnj_segment.cu on the
packed one) per join the card made (`card_joins`: calls handed to the
host engine are left out)."""


def read(ctx):
    joins = sum(c.get("card_joins", 0) for c in ctx.calls)
    us = sum(d for name, cat, _, d in ctx.device
             if cat == "kernel" and "dnj_segment" in name)
    if not joins or not us:
        return None
    return us / joins, "us/join"
