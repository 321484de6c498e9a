"""Share of the traced window of a tree cell in which no kernel, copy or
memset ran on the card."""

from port_bench.trace import idle_pct as read  # noqa: F401
