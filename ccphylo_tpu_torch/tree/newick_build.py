"""Newick node assembly with byte parity to nwck.c.

The reference merges nodes *in place* over byte strings, always keeping
the larger-capacity buffer as the destination (nwck.c:45-50).  Branch
lengths print as ``%.*f`` (default precision 9).  These functions operate
on :class:`ccphylo_tpu_torch.io.qseqs.Name` objects and reproduce both content
and capacity evolution.
"""

from __future__ import annotations

from ..io.qseqs import Name


def _fmt(L: float, precision: int) -> bytes:
    return ("%.*f" % (precision, L)).encode()


def _maybe_swap(node1: Name, node2: Name):
    """nwck.c:45-50 — move the larger-capacity qseq into node1."""
    if node1.cap < node2.cap:
        node1.data, node2.data = node2.data, node1.data
        node1.cap, node2.cap = node2.cap, node1.cap
        return True
    return False


def form_node(node1: Name, node2: Name, L1: float, L2: float,
              precision: int = 9) -> None:
    """formNode (nwck.c:35-77): node1 <- '(' node1 ':'L1 ',' node2 ':'L2 ')'.

    If both limbs are negative the limbs are omitted.  Swaps operands
    (including limbs) when node2's buffer is larger.
    """
    if _maybe_swap(node1, node2):
        L1, L2 = L2, L1
    newsize = len(node1.data) + len(node2.data) + 32
    if node1.cap < newsize:
        node1.cap = newsize
    if L1 < 0 and L2 < 0:
        node1.data = b"(" + node1.data + b"," + node2.data + b")"
    else:
        node1.data = (b"(" + node1.data + b":" + _fmt(L1, precision)
                      + b"," + node2.data + b":" + _fmt(L2, precision) + b")")


def form_last_node(node1: Name, node2: Name, L: float,
                   precision: int = 9) -> None:
    """formLastNode (nwck.c:79-112): trifurcate the root.

    Truncates node1's final byte (assumed ')') and splices node2 in:
    '(X)' -> '(X,node2:L)'.
    """
    _maybe_swap(node1, node2)
    newsize = len(node1.data) + len(node2.data) + 32
    if node1.cap < newsize:
        node1.cap = newsize
    base = node1.data[:-1]  # node1->seq[--node1->len] = 0
    if L < 0:
        node1.data = base + b"," + node2.data + b")"
    else:
        node1.data = base + b"," + node2.data + b":" + _fmt(L, precision) + b")"


def form_last_bi_node(node1: Name, node2: Name, L: float,
                      precision: int = 9) -> None:
    """formLastBiNode (nwck.c:114-155): strictly bifurcating root; the
    joining distance is split evenly on both limbs."""
    _maybe_swap(node1, node2)
    newsize = len(node1.data) + len(node2.data) + 32
    if node1.cap < newsize:
        node1.cap = newsize
    if L < 0:
        node1.data = b"(" + node1.data + b"," + node2.data + b")"
    else:
        half = _fmt(L / 2, precision)
        node1.data = (b"(" + node1.data + b":" + half
                      + b"," + node2.data + b":" + half + b")")


def byteshift_fix(node: Name) -> None:
    """str.c:51-63 byteshift as used by the engines (nj.c:1605-1607):
    if the finished tree doesn't start with '(', shift the string right
    and prepend one."""
    if not node.data.startswith(b"("):
        node.data = b"(" + node.data
