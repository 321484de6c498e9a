"""The packed route's host quantization and upload
(`build_tree_packed.last_times["quantize"]`), milliseconds a tree, the
mean over the traced window's calls that took that route."""


def read(ctx):
    qs = [c["quantize_s"] for c in ctx.calls if "quantize_s" in c]
    if not qs:
        return None
    return 1e3 * sum(qs) / len(qs), "ms/tree"
