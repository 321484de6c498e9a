"""Top-level dispatch of the port (counterpart of ccphylo_tpu/cli/main.py).

Usage: ``python -m ccphylo_tpu_torch <subcommand> [options]``.  `dist`
and `tree` run through the port's own seams (device kernels behind
CCPHYLO_TORCH_DIST / CCPHYLO_TORCH_ENGINE); the other twelve host-only
subcommands are the reference package's own.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    cmd, rest = (argv[0], argv[1:]) if argv else ("", [])
    if cmd == "dist":
        from .dist_cmd import main_dist
        return main_dist(rest)
    if cmd == "tree":
        from .tree_cmd import main_tree
        return main_tree(rest)
    from ccphylo_tpu.cli.main import main as host_main
    return host_main(argv)


if __name__ == "__main__":
    sys.exit(main())
