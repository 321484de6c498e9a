"""Host milliseconds a fill of the samples' preparation before their
upload (spans `dist/stack` and `dist/convert` of
cli/dist_cmd.py::_batch_shared: the u64 words stacked, then turned
into u32 words and pair masks), one of each a call."""

from port_bench.program import ms_per_span


def read(ctx):
    ms = ms_per_span("dist/stack", "dist/convert")
    return None if ms is None else (ms, "ms/fill")
