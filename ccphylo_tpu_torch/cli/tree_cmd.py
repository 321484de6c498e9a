"""`tree` subcommand of the port.

The reference CLI (ccphylo_tpu.cli.tree_cmd) parses the arguments and
streams the matrices; its `form_tree` looks the engine dispatcher
`_dispatch_build` up as a module global at call time, so the port runs
it with the dispatcher rebound to its own (`engine_seam`) and restored
on exit.

CCPHYLO_TORCH_ENGINE=packed with ``-m dnj -b`` builds the tree on the
port's packed u8 engine (tree/packed_engine.py).  A matrix with missing
(negative) cells goes to the host engine, as in the reference: u8
storage cannot hold them.  Every other method and dtype runs on the
host exact engine.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from ccphylo_tpu.cli import tree_cmd as host_tree
from ccphylo_tpu.tree.exact import build_tree


def _dispatch_build(flat, n, names, method, flag, precision, dtype,
                    bytescale, threads=1):
    if os.environ.get("CCPHYLO_TORCH_ENGINE", "exact") == "packed" \
            and method == "dnj" and dtype == "b" \
            and not (np.asarray(flat) < 0).any():
        from ..tree.packed_engine import build_tree_packed
        return build_tree_packed(flat, n, names, flag, precision,
                                 bytescale=bytescale)
    return build_tree(flat, n, names, method, flag, precision, dtype,
                      bytescale, threads)


@contextlib.contextmanager
def engine_seam():
    saved = host_tree._dispatch_build
    host_tree._dispatch_build = _dispatch_build
    try:
        yield
    finally:
        host_tree._dispatch_build = saved


def main_tree(argv: list[str]) -> int:
    with engine_seam():
        return host_tree.main_tree(argv)
