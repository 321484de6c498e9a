"""Faithful replica of the reference's string hashmap (hashmapstr.c).

union's output order is the hash table's bucket/chain iteration order,
so byte parity requires the same djb2+minimalStandard hash, the same
mask-based bucketing, LIFO chains, and the same growth/rehash walk
(hashmapstr.c:24-140).

Counterpart of ccphylo_tpu/io/hashmapstr.py: the port's own copy."""

from __future__ import annotations


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _c_div(a: int, b: int) -> int:
    q = abs(a) // b
    return -q if a < 0 else q


def _c_mod(a: int, b: int) -> int:
    return a - _c_div(a, b) * b


def minimal_standard(rand: int) -> int:
    """minimalStandard (hashmapstr.c:26-34), int32 wraparound."""
    rand = _i32(rand)
    val = _i32(_i32(16807 * _c_mod(rand, 127773))
               - _i32(2836 * _c_div(rand, 127773)))
    if val <= 0:
        val = _i32(val + 0x7FFFFFFF)
    return val


def djb2(s: bytes) -> int:
    """djb2 (hashmapstr.c:36-48): 64-bit accumulate, then
    minimalStandard of the int32 truncation."""
    h = 5381
    for c in s:
        h = ((h << 5) + h + c) & 0xFFFFFFFFFFFFFFFF
    return minimal_standard(h)


class _Node:
    __slots__ = ("key", "hash", "ulist", "next")

    def __init__(self, key, h, first, nxt):
        self.key = key
        self.hash = h
        self.ulist = [first]
        self.next = nxt


class HashMapStr:
    """str -> sample-index list with C-identical iteration order."""

    def __init__(self, size: int = 128):
        p = 1
        while p < size:
            p <<= 1
        self.mask = p - 1
        self.table: list[_Node | None] = [None] * p
        self.n = 0

    def add(self, key: bytes, idx: int) -> int:
        h = djb2(key)
        pos = h & self.mask
        node = self.table[pos]
        while node is not None:
            if node.hash == h and node.key == key:
                node.ulist.append(idx)
                return len(node.ulist) - 1
            node = node.next
        self.n += 1
        if self.n == self.mask:
            self._grow()
            pos = h & self.mask
        self.table[pos] = _Node(key, h, idx, self.table[pos])
        return 0

    def _grow(self):
        """HashMapStr_grow (hashmapstr.c:88-114): double, rehash buckets
        top-down with chain prepend."""
        oldsize = self.mask + 1
        self.mask = 2 * oldsize - 1
        self.table = self.table + [None] * oldsize
        for b in range(oldsize - 1, -1, -1):
            node = self.table[b]
            self.table[b] = None
            while node is not None:
                nxt = node.next
                pos = node.hash & self.mask
                node.next = self.table[pos]
                self.table[pos] = node
                node = nxt

    def items_in_print_order(self):
        """HashMapStr_print order (hashmapstr.c:187-210): bucket 0..mask,
        chain head-first; only nodes seen more than once."""
        for b in range(self.mask + 1):
            node = self.table[b]
            while node is not None:
                if len(node.ulist) > 1:
                    yield node.key, node.ulist
                node = node.next

    def pop(self, key: bytes):
        """HashMapStr_get (hashmapstr.c:156-184): find AND unlink."""
        h = djb2(key)
        pos = h & self.mask
        prev = None
        node = self.table[pos]
        while node is not None:
            if node.hash == h and node.key == key:
                if prev is not None:
                    prev.next = node.next
                else:
                    self.table[pos] = node.next
                self.n -= 1
                return node.ulist
            prev = node
            node = node.next
        return None
