"""`rarify` subcommand: downsample KMA count matrices (reference
rarify.c).

Counterpart of ccphylo_tpu/cli/rarify_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

from ..io import fileio
from .args import Args, ArgError

HELP = """\
#CCPhylo rarify rarifies an KMA matrix.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -A, --fragment_amount \tTotal number of fragments in sample\t0
#    -R, --rarification_factor\tRarification factor          \t10000000
#    -h, --help            \tShows this helpmessage          \t
"""


def main_rarify(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    nf = 0
    rf = 10000000

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
            elif name == "fragment_amount":
                nf = a.next_num("fragment_amount")
            elif name == "rarification_factor":
                rf = a.next_num("rarification_factor")
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
                elif opt == "A":
                    nf = a.next_num("A")
                elif opt == "R":
                    rf = a.next_num("R")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            inputfile = arg
        a.i += 1

    if not nf:
        print("Missing fragment amount (-A).", file=sys.stderr)
        return 1

    data = fileio.read_bytes(inputfile)
    out = fileio.open_out(outputfile)
    remainder = 0
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines = lines[:-1]
        # a blank row immediately before EOF is swallowed by the
        # parser's rebuffer-at-EOF check (matparse.c:64-70)
        if lines and lines[-1] == b"":
            lines = lines[:-1]
    else:
        # a final row without newline is dropped mid-parse
        lines = lines[:-1]
    for line in lines:
        if line.startswith(b"#"):
            out.write(line + b"\n")
            continue
        if not line:
            # blank entry separators are re-emitted (rarify.c:79-81)
            out.write(b"\n")
            continue
        parts = line.split(b"\t")
        ref = parts[0]
        # parse file order A C G T N -, store [A C G T - N]; the parser
        # holds u16 counts (matparse.c:111-135)
        vals = [int(x) & 0xFFFF for x in parts[1:7]]
        counts = [vals[0], vals[1], vals[2], vals[3], vals[5], vals[4]]
        # walk counts[5] down to counts[0] (rarify.c:55-73)
        for i in range(5, -1, -1):
            count = counts[i]
            if count:
                count *= rf
                remainder += count % nf
                count //= nf
                if rf <= remainder:
                    count += remainder // rf
                    remainder %= rf
                counts[i] = count & 0xFFFF  # stored as u16
        # output in STORAGE order (A C G T - N) like the reference
        out.write(ref + b"\t" + b"\t".join(b"%d" % c for c in counts)
                  + b"\n")
    fileio.close_out(out)
    return 0
