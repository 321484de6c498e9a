"""Anchors the u8 plain reference (`reference/dnj_u8.py`) to the C
reference: its tree of the 100,000-taxon hash matrix (`gen/hash_u8.py`)
against the C reference's Newick checked in as
`benchmarks/evidence/parity100k.c.nwck.gz`, byte for byte.

    python3 port_bench/anchor_dnj_u8.py [--n 100000] [--device cuda]

At another n it prints the tree's size and digest only.  Prints the
seconds of the matrix and of the tree, and exits 1 where the bytes
differ.  Imports nothing of the program under test."""

import argparse
import gzip
import hashlib
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from port_bench.gen import hash_u8  # noqa: E402
from port_bench.reference import dnj_u8  # noqa: E402

EVIDENCE = os.path.join(os.path.dirname(HERE), "benchmarks", "evidence",
                        "parity100k.c.nwck.gz")


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="port_bench/anchor_dnj_u8.py")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda":
        print("# card:", torch.cuda.get_device_name(dev), flush=True)
    t = time.perf_counter()
    cells = hash_u8.cells(a.n, dev)
    t_cells = time.perf_counter() - t
    names = [dnj_u8.RefName(d, c) for d, c in hash_u8.names(a.n)]
    t = time.perf_counter()
    nwk = dnj_u8.newick(cells, a.n, names, 1.0, dev) + b";\n"
    t_tree = time.perf_counter() - t
    print(f"# n {a.n}: matrix {t_cells:.2f} s, reference tree "
          f"{t_tree:.2f} s, Newick {len(nwk):,} bytes, sha256 "
          f"{hashlib.sha256(nwk).hexdigest()}", flush=True)
    if a.n != 100_000:
        return 0
    with open(EVIDENCE, "rb") as fh:
        want = gzip.decompress(fh.read())
    same = nwk == want
    print(f"# the C reference's Newick ({len(want):,} bytes): "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
