"""Newick stream parsing + recursive splitting (reference nwck.c
load side: getNwck/getSizeNwck/getLimbNwck/stripNwck/splitNwck,
nwck.c:157-359).

The reference manipulates NUL-split C strings with a separate ``len``
field, and split tails carry ``len = true_length - 1``
(nwck.c:329 ``node_j->len = node_i->len - len - 2``).  getLimbNwck
interprets len literally, so single-character tail limbs are missed
(the ':x' stays in the printed name with limb -1 -> 0) and tails
ending in ')' can dodge the no-limb check.  These quirks are
reproduced with an explicit (string, len) node representation;
behavior validated against the compiled reference.

Counterpart of ccphylo_tpu/io/newick_parse.py: the port's own copy.
"""

from __future__ import annotations

import re

_FLOAT_RE = re.compile(rb"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")


class NwckNode:
    """A C-string (full bytes up to the NUL) plus the C len field."""

    __slots__ = ("s", "len")

    def __init__(self, s: bytes, length: int | None = None):
        self.s = s
        self.len = len(s) if length is None else length

    def __repr__(self):
        return f"NwckNode({self.s!r}, len={self.len})"


def iter_nwck(data: bytes):
    """getNwck (nwck.c:157-230): per line, header = text before the
    first '(', tree = content between the first '(' and the last ')'
    (both parens stripped)."""
    pos = 0
    n = len(data)
    while pos < n:
        op = data.find(b"(", pos)
        if op < 0:
            return
        nl = data.find(b"\n", op)
        if nl < 0:
            nl = n
        header = data[pos:op]
        line = data[op + 1:nl]
        cp = line.rfind(b")")
        tree = line[:cp] if cp >= 0 else line
        yield header, NwckNode(tree)
        pos = nl + 1


def get_size_nwck(node: NwckNode) -> int:
    """getSizeNwck (nwck.c:232-247): 1 + #commas."""
    return 1 + node.s.count(b",")


def get_limb(node: NwckNode) -> float:
    """getLimbNwck (nwck.c:249-282): in-place limb strip under the C
    len convention.  Returns the limb or -1."""
    ln = node.len
    s = node.s
    if ln == 0:
        return -1.0
    if ln - 1 < len(s) and s[ln - 1:ln] == b")":
        return -1.0
    # search ':' at indices ln-2 .. 1 (seq and len move in lockstep)
    ln -= 1
    seq = ln
    while True:
        ln -= 1
        if ln == 0:
            return -1.0
        seq -= 1
        if s[seq:seq + 1] == b":":
            break
    limbstr = s[seq + 1:]
    node.s = s[:seq]
    node.len = ln
    # strtod semantics: parse the longest leading float
    m = _FLOAT_RE.match(limbstr)
    if not m or m.end() != len(limbstr):
        raise SystemExit("Invalid limb length at node:\t"
                         + node.s.decode(errors="replace"))
    return float(m.group(0))


def strip_nwck(node: NwckNode) -> int:
    """stripNwck (nwck.c:284-294): drop wrapping parens; the NUL write
    truncates any hidden bytes past the old ')' position."""
    s = node.s
    if s[:1] == b"(" and 0 < node.len <= len(s) \
            and s[node.len - 1:node.len] == b")":
        node.len -= 2
        node.s = s[1:node.len + 1]
        return node.len
    return 0


def split_nwck(node_i: NwckNode):
    """splitNwck (nwck.c:296-359): split off the LAST top-level
    sub-node in place.  Returns (node_j, Li, Lj) or None."""
    s = node_i.s
    ln = node_i.len
    if not ln:
        return None
    # backward scan for the split point
    stop = 0
    seq = ln
    while stop <= 0 and ln > 0:
        ln -= 1
        seq -= 1
        c = s[seq:seq + 1]
        if c == b")":
            stop -= 1
        elif c == b"(":
            stop += 1
        elif c == b"," and stop == 0:
            stop += 1
    if stop == 0:
        if strip_nwck(node_i):
            return split_nwck(node_i)
        return None
    # truncate org node, tail becomes the new node
    node_j = NwckNode(s[seq + 1:], node_i.len - ln - 2)
    old_len = node_i.len
    node_i.s = s[:seq]
    node_i.len = ln
    # check whether the head still splits at top level
    stop = 0
    while stop <= 0 and ln > 0:
        ln -= 1
        seq -= 1
        c = s[seq:seq + 1]
        if c == b")":
            stop -= 1
        elif c == b"(":
            stop += 1
        elif c == b"," and stop == 0:
            stop += 1
    if stop != 0:
        Li = 0.0
        Lj = get_limb(node_j)
    else:
        Li = get_limb(node_i)
        Lj = get_limb(node_j)
        if Lj < 0 <= Li:
            Lj = 0.0
    return node_j, Li, Lj
