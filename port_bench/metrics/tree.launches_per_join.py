"""Every kernel, copy and memset the card ran in the traced window, per
join the card made (`card_joins`: calls handed to the host engine are
left out)."""


def read(ctx):
    joins = sum(c.get("card_joins", 0) for c in ctx.calls)
    if not joins or not ctx.device:
        return None
    return len(ctx.device) / joins, "launches/join"
