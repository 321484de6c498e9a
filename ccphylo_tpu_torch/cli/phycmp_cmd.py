"""`phycmp` subcommand: compare two Phylip matrices (reference
phycmp.c).

Counterpart of ccphylo_tpu/cli/phycmp_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

from ..io import fileio
from ..io.phylip import PhylipStream
from ..ops import distcmp
from ..tree.exact import LtdMatrix
from .args import Args, ArgError

HELP = """\
# CCPhylo phycmp compares two distance matrices in phylip format.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file(s)                   \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -S, --separator       \tSeparator                       \t\\t
#    -f, --flag            \tOutput flags                    \t1
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -p, --float_precision \tFloat precision on distance matrix\tFalse / double
#    -s, --short_precision \tShort precision on distance matrix\tFalse / double / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tFalse / double / 1e0
#    -h, --help            \tShows this helpmessage          \t
"""

FLAG_HELP = """\
# Format flags output, add them to combine them.
#
#   1:\tCos distance
#   2:\tChi-square distance
#   4:\tBray-Curtis dissimilarity
#   8:\tl1 norm
#  16:\tl2 norm
#  32:\tl-infinity norm
#  64:\tPearson correlation
#
"""


def main_phycmp(argv: list[str]) -> int:
    inputfiles: list[str] = []
    outputfile = "-"
    sep = "\t"
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
                while (a.i + 1 < len(a.argv)
                       and not a.argv[a.i + 1].startswith("-")):
                    inputfiles.append(a.next_value("input"))
            elif name == "output":
                outputfile = a.next_value("output")
            elif name == "separator":
                sep = a.next_char("separator")
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
            elif name == "help":
                sys.stdout.write(HELP)
                return 0
            else:
                raise ArgError(f'Unknown argument or option: "{arg}"')
        elif arg.startswith("-") and arg != "-":
            for opt in arg[1:]:
                if opt == "i":
                    while (a.i + 1 < len(a.argv)
                           and not a.argv[a.i + 1].startswith("-")):
                        inputfiles.append(a.next_value("i"))
                elif opt == "o":
                    outputfile = a.next_value("o")
                elif opt == "S":
                    sep = a.next_char("S")
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
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            inputfiles.append(arg)
        a.i += 1

    if flag == -1:
        sys.stdout.write(FLAG_HELP)
        return 0
    if not inputfiles:
        inputfiles = ["-"]

    data1 = fileio.read_bytes(inputfiles[0])
    s1 = PhylipStream(data1, sep=sep.encode())
    m1 = s1.load()
    if len(inputfiles) > 1:
        s2 = PhylipStream(fileio.read_bytes(inputfiles[1]),
                          sep=sep.encode())
    else:
        s2 = s1
    m2 = s2.load()

    if m1 is None or m2 is None or not m1[0] or not m2[0]:
        print("Missing matrix", file=sys.stderr)
        sys.exit(1)
    n1, flat1, names1, _ = m1
    n2, flat2, names2, _ = m2
    if n1 != n2:
        print("Matrices differ in size.", file=sys.stderr)
        sys.exit(1)
    if any(names1[i].data != names2[i].data for i in range(n1)):
        print("Matrices has different entries.", file=sys.stderr)
        sys.exit(1)

    lt1 = LtdMatrix(flat1, n1, dtype, bytescale)
    lt2 = LtdMatrix(flat2, n2, dtype, bytescale)
    out = fileio.open_out(outputfile)
    for bit, label, fn in ((1, b"cos", distcmp.coscmp),
                           (2, b"chi2", distcmp.chi2cmp),
                           (4, b"bc", distcmp.bccmp),
                           (8, b"l1", distcmp.l1cmp),
                           (16, b"l2", distcmp.l2cmp),
                           (32, b"linf", distcmp.linfcmp),
                           (64, b"p", distcmp.pearcmp)):
        if flag & bit:
            d = fn(lt1.flat, lt2.flat, dtype, bytescale)
            out.write(label + b":\t" + (b"%f" % d) + b"\n")
    fileio.close_out(out)
    return 0
