"""`fullphy` subcommand: lower-triangular -> full square Phylip
(reference fullphy.c).

Counterpart of ccphylo_tpu/cli/fullphy_cmd.py: the port's own copy."""

from __future__ import annotations

import sys
import time

from ..io import fileio
from ..io.phylip import PhylipStream, print_full_phy
from ..tree.exact import LtdMatrix
from .args import Args, ArgError

HELP = """\
#CCPhylo fullphy converts phylip distance matrices to full matrices.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -S, --separator       \tSeparator                       \t\\t
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


def main_fullphy(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    sep = "\t"
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
            elif name == "separator":
                sep = a.next_char("separator")
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
            elif name in ("mmap",):
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
                         "them.\n#\n#   1:\tRelaxed Phylip\n#\n")
        return 0

    data = fileio.read_bytes(inputfile)
    stream = PhylipStream(data, sep=sep.encode())
    out = fileio.open_out(outputfile)
    t0 = time.process_time()
    while True:
        loaded = stream.load()
        if loaded is None or loaded[0] == 0:
            break
        n, flat, names, header = loaded
        t1 = time.process_time()
        print(f"# Total time used loading matrix: {t1 - t0:.2f} s.",
              file=sys.stderr)
        t0 = t1
        lt = LtdMatrix(flat, n, dtype, bytescale)
        print_full_phy(out, n, lt.get(slice(0, len(lt.flat))),
                       [nm.data for nm in names[:n]], flag, precision)
        t1 = time.process_time()
        print(f"# Total time outputting full matrix: {t1 - t0:.2f} s.",
              file=sys.stderr)
        t0 = t1
    fileio.close_out(out)
    return 0
