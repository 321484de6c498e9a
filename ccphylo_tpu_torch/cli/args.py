"""Minimal reference-compatible argv handling (cmdline.c:23-240).

The reference mixes short options (``-i x``, clustered flags like
``-gH``), long options (``--input x`` / ``--input=x``), and a trailing
non-option input filename.  This helper normalizes that surface for the
per-subcommand parsers without pulling in argparse (whose conventions
differ in ways that would break byte-level CLI compatibility).
"""

from __future__ import annotations

import sys


class ArgError(SystemExit):
    def __init__(self, msg: str):
        print(msg, file=sys.stderr)
        super().__init__(1)


class Args:
    def __init__(self, argv: list[str]):
        self.argv = argv
        self.i = 0

    def next_value(self, name: str) -> str:
        """getArgDie (cmdline.c): the following argv entry."""
        self.i += 1
        if self.i >= len(self.argv):
            raise ArgError(f'Missing argument at {name}.')
        return self.argv[self.i]

    def next_num(self, name: str) -> int:
        v = self.next_value(name)
        try:
            return int(v)
        except ValueError:
            raise ArgError(f'Invalid value parsed at {name}.')

    def next_float(self, name: str) -> float:
        v = self.next_value(name)
        try:
            return float(v)
        except ValueError:
            raise ArgError(f'Invalid value parsed at {name}.')

    def next_char(self, name: str) -> str:
        v = self.next_value(name)
        if v.startswith("\\"):
            return {"\\t": "\t", "\\n": "\n", "\\0": "\0",
                    "\\s": " "}.get(v, v[-1])
        return v[0] if v else "\0"

    def opt_float(self, default: float) -> float:
        """getdDefArg: consume a number if the next arg parses as one."""
        if self.i + 1 < len(self.argv):
            try:
                val = float(self.argv[self.i + 1])
            except ValueError:
                return default
            self.i += 1
            return val
        return default
