"""`nwck2phy` subcommand: Newick -> Phylip distance matrices
(reference nwck2phy.c:33-379).

Counterpart of ccphylo_tpu/cli/nwck2phy_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

import numpy as np

from ..io import fileio
from ..io.newick_parse import iter_nwck, get_size_nwck, split_nwck, \
    NwckNode
from ..io.phylip import print_phy
from ..tree.exact import LtdMatrix, off
from .args import Args, ArgError

HELP = """\
#CCPhylo nwck2phy converts newick files to phylip distance files.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -x, --print_precision \tFloating point print precision  \t9
#    -f, --flag            \tOutput flags                    \t1
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -p, --float_precision \tFloat precision on distance matrix\tFalse / double
#    -s, --short_precision \tShort precision on distance matrix\tFalse / double / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tFalse / double / 1e0
#    -H, --mmap            \tAllocate matrix on the disk     \tFalse
#    -T, --tmp             \tSet directory for temporary files\t
#    -h, --help            \tShows this helpmessage          \t
"""


def newick_to_matrix(tree: bytes, dtype: str, bytescale: float):
    """The accumulating limb-length decomposition (nwck2phy.c:92-355):
    each split appends the new node's row = distance to the originating
    node's partners + Lj, and adds Li onto the originating node's
    row/column.  Missing limbs (-1) poison the affected cells."""
    n = get_size_nwck(tree)
    lt = LtdMatrix(np.zeros(n * (n - 1) // 2 + 1, np.float64), n, dtype,
                   bytescale)
    names: list[NwckNode] = [tree] + [NwckNode(b"")
                                      for _ in range(n - 1)]
    cur = 1
    org = 0

    def get(i, j):
        return float(lt.get(off(i) + j))

    quant = lt.quantized
    npdt = lt.flat.dtype.type

    def dtouc0(x: float):
        """dtouc(x, 0) with C's double->unsigned truncation/wrap."""
        v = int(np.float64(x) * lt.bs)
        return npdt(v & (0xFFFF if lt.dtype == "s" else 0xFF))

    while cur != n:
        res = split_nwck(names[org])
        if res is None:
            org += 1
            continue
        tail, Li, Lj = res
        names[cur] = tail
        orow = off(cur)
        if quant:
            # integer-domain updates (nwck2phy.c:226-355)
            fl = lt.flat
            if Lj < 0:
                fl[orow:orow + cur] = dtouc0(Lj)
            else:
                for k in range(org):
                    fl[orow + k] = npdt(dtouc0(Lj) + fl[off(org) + k])
                # dtouc(Lj + Li, 0) expands unparenthesized to
                # Lj + Li*ByteScale (bytescale.h:22, nwck2phy.c:247)
                fl[orow + org] = npdt(int(Lj + Li * lt.bs)
                                      & (0xFFFF if lt.dtype == "s"
                                         else 0xFF))
                for j in range(org + 1, cur):
                    fl[orow + j] = dtouc0(Lj + float(lt.get(off(j) + org)))
            if Li < 0:
                for k in range(org):
                    fl[off(org) + k] = dtouc0(Li)
                for j in range(org + 1, cur):
                    fl[off(j) + org] = dtouc0(Li)
            else:
                inc = dtouc0(Li)
                for k in range(org):
                    fl[off(org) + k] = npdt(fl[off(org) + k] + inc)
                for j in range(org + 1, cur):
                    fl[off(j) + org] = npdt(fl[off(j) + org] + inc)
        else:
            if Lj < 0:
                lt.store(slice(orow, orow + cur), np.full(cur, Lj), 0.0)
            else:
                for k in range(org):
                    d = get(org, k)
                    lt.store(orow + k, -1.0 if d < 0 else Lj + d, 0.0)
                lt.store(orow + org, Lj + Li, 0.0)
                for j in range(org + 1, cur):
                    d = get(j, org)
                    lt.store(orow + j, -1.0 if d < 0 else Lj + d, 0.0)
            if Li < 0:
                for k in range(org):
                    lt.store(off(org) + k, Li, 0.0)
                for j in range(org + 1, cur):
                    lt.store(off(j) + org, Li, 0.0)
            else:
                for k in range(org):
                    if get(org, k) >= 0:
                        lt.store(off(org) + k, get(org, k) + Li, 0.0)
                for j in range(org + 1, cur):
                    if get(j, org) >= 0:
                        lt.store(off(j) + org, get(j, org) + Li, 0.0)
        cur += 1
    return lt, names, n


def main_nwck2phy(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    precision = 9
    flag = 1
    dtype = "d"
    bytescale = 1.0

    a = Args(argv)
    while a.i < len(a.argv):
        arg = a.argv[a.i]
        if arg.startswith("--"):
            name, eq, val = arg[2:].partition("=")
            if eq:
                a.argv.insert(a.i + 1, val)
            if name == "":
                break
            elif name == "input":
                inputfile = a.next_value("input")
            elif name == "output":
                outputfile = a.next_value("output")
            elif name == "print_precision":
                precision = a.next_num("print_precision")
            elif name == "flag":
                flag = a.next_num("flag")
            elif name == "flag_help":
                flag = -1
            elif name == "float_precision":
                dtype = "f"
            elif name == "short_precision":
                dtype = "s"
                bytescale = a.opt_float(bytescale)
            elif name == "byte_precision":
                dtype = "b"
                bytescale = a.opt_float(bytescale)
            elif name == "mmap":
                pass
            elif name == "tmp":
                a.next_value("tmp")
            elif name == "help":
                sys.stdout.write(HELP)
                return 0
            else:
                raise ArgError(f'Unknown argument or option: "{arg}"')
        elif arg.startswith("-") and arg != "-":
            for opt in arg[1:]:
                if opt == "i":
                    inputfile = a.next_value("i")
                elif opt == "o":
                    outputfile = a.next_value("o")
                elif opt == "x":
                    precision = a.next_num("x")
                elif opt == "f":
                    flag = a.next_num("f")
                elif opt == "F":
                    flag = -1
                elif opt == "p":
                    dtype = "f"
                elif opt == "s":
                    dtype = "s"
                    bytescale = a.opt_float(bytescale)
                elif opt == "b":
                    dtype = "b"
                    bytescale = a.opt_float(bytescale)
                elif opt == "H":
                    pass
                elif opt == "T":
                    a.next_value("T")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            inputfile = arg
        a.i += 1

    if flag == -1:
        sys.stdout.write("# Format flags output, add them to combine "
                         "them.\n#\n#   1:\tRelaxed Phylip\n"
                         "#   4:\tInclude template name in phylip "
                         "file\n#\n")
        return 0

    data = fileio.read_bytes(inputfile)
    out = fileio.open_out(outputfile)
    for header, tree in iter_nwck(data):
        lt, names, n = newick_to_matrix(tree, dtype, bytescale)
        print_phy(out, n, lt.get(slice(0, n * (n - 1) // 2)),
                  [nd.s for nd in names], flag, precision,
                  comment=header)
    fileio.close_out(out)
    return 0
