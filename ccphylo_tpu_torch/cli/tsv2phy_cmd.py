"""`tsv2phy` subcommand: tsv rows -> Phylip via dense-vector metrics
(reference tsv2phy.c).

Counterpart of ccphylo_tpu/cli/tsv2phy_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

from ..io import fileio
from ..io.tsv import load_tsv
from ..ops.distcmp import get_distcmp
from .args import Args, ArgError

HELP = """\
#CCPhylo tsv2phy converts tsv files to phylip distance files.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -S, --separator       \tSeparator                       \t\\t
#    -x, --print_precision \tFloating point print precision  \t9
#    -d, --distance        \tDistance method                 \tcos
#    -D, --distance_help   \tHelp on option "-d"             \t
#    -f, --flag            \tOutput flags                    \t1
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -p, --float_precision \tFloat precision on distance matrix\tFalse / double
#    -s, --short_precision \tShort precision on distance matrix\tFalse / double / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tFalse / double / 1e0
#    -H, --mmap            \tAllocate matrix on the disk     \tFalse
#    -T, --tmp             \tSet directory for temporary files\t
#    -h, --help            \tShows this helpmessage          \t
"""

DIST_HELP = """\
# Distance calculation methods:
#
# cos:\tCalculate distance between the vectors as the angle between them.
# chi2:\tCalculate the chi square distance
# bc:\tCalculate the Bray-Curtis dissimilarity between the vectors.
# ln:\tCalculate distance between the vectors as the n-norm distance between the count vectors. Replace "n" with the waned norm
# linf:\tCalculate distance between the vectors as the l_infinity distance between the count vectors.
# p:\tCalculate the Pearson correlation between the vectors.
#
"""


def main_tsv2phy(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    sep = "\t"
    precision = 9
    method = "cos"
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
            elif name == "separator":
                sep = a.next_char("separator")
            elif name == "print_precision":
                precision = a.next_num("print_precision")
            elif name == "distance":
                method = a.next_value("distance")
            elif name == "distance_help":
                method = None
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
                elif opt == "S":
                    sep = a.next_char("S")
                elif opt == "x":
                    precision = a.next_num("x")
                elif opt == "d":
                    method = a.next_value("d")
                elif opt == "D":
                    method = None
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
        sys.stdout.write("Format flags output format, add them to "
                         "combine them.\n#\n# 1:\tRelaxed Phylip\n#\n")
        return 0
    if method is None:
        sys.stdout.write(DIST_HELP)
        return 0
    fn = get_distcmp(method)
    if fn is None:
        raise ArgError('Invalid value parsed at "--distance".')

    dat = load_tsv(fileio.read_bytes(inputfile), sep.encode(), dtype,
                   bytescale)
    if dat is None:
        print("Input matrix contained zero rows.", file=sys.stderr)
        return 0
    out = fileio.open_out(outputfile)
    out.write(b"%10d" % dat.m)
    for i in range(dat.m):
        if flag & 1:
            out.write(b"\n%d" % i)
        else:
            out.write(("\n%-10d" % i).encode())
        for j in range(i):
            d = fn(dat.mat[i], dat.mat[j], dtype, bytescale)
            out.write(("\t%.*g" % (precision, d)).encode())
    out.write(b"\n")
    fileio.close_out(out)
    return 0
