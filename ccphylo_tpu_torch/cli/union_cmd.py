"""`union` subcommand: templates shared between KMA .res files
(reference union.c).

Counterpart of ccphylo_tpu/cli/union_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

from ..io import fileio, kma, kmadb
from ..io.hashmapstr import HashMapStr
from .args import Args, ArgError

HELP = """\
#CCPhylo union finds the union between templates in res files created by e.g. KMA.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file(s)                   \tNone
#    -o, --output          \tOutput file                     \tstdout
#    -B, --database        \tPrint ordered wrt. template DB filename\tNone
#    -r, --reference_file  \tCreate reference fasta file     \tNone
#    -E, --min_depth       \tMinimum depth                   \t15
#    -C, --min_cov         \tMinimum coverage                \t50.0%
#    -L, --min_len         \tMinimum overlapping length      \t1
#    -h, --help            \tShows this helpmessage          \t
"""

RES_HEADER = (b"#Template\tScore\tExpected\tTemplate_length\t"
              b"Template_Identity\tTemplate_Coverage\tQuery_Identity\t"
              b"Query_Coverage\tDepth\tq_value\tp_value")


def union_res(filenames, min_cov, min_depth, min_length):
    """unionRes (union.c:32-64)."""
    entries = HashMapStr(128)
    min_length *= 100
    for n, fn in enumerate(filenames):
        data = fileio.read_bytes(fn)
        first = data.split(b"\n", 1)[0].rstrip(b"\r")
        if first != RES_HEADER:
            print(f"Malformed res file:\t{fn}", file=sys.stderr)
            sys.exit(1)
        for e in kma.iter_res(data):
            if (min_cov <= e.template_coverage
                    and min_depth <= e.depth
                    and min_length <= e.template_length
                    * e.template_coverage):
                entries.add(e.template, n)
    return entries


def main_union(argv: list[str]) -> int:
    filenames: list[str] = []
    outputfile = "-"
    dbfilename = None
    reffilename = None
    min_depth = 1.0
    min_cov = 50.0
    min_length = 1

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
                    filenames.append(a.next_value("input"))
            elif name == "output":
                outputfile = a.next_value("output")
            elif name == "database":
                dbfilename = a.next_value("database")
            elif name == "reference_file":
                reffilename = a.next_value("reference_file")
            elif name == "min_depth":
                min_depth = a.next_float("min_depth")
            elif name == "min_cov":
                min_cov = a.next_float("min_cov")
            elif name == "min_len":
                min_length = a.next_num("min_len")
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
                        filenames.append(a.next_value("i"))
                elif opt == "o":
                    outputfile = a.next_value("o")
                elif opt == "B":
                    dbfilename = a.next_value("B")
                elif opt == "r":
                    reffilename = a.next_value("r")
                elif opt == "E":
                    min_depth = a.next_float("E")
                elif opt == "C":
                    min_cov = a.next_float("C")
                elif opt == "L":
                    min_length = a.next_num("L")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            filenames.append(arg)
        a.i += 1

    if not filenames:
        print("Missing arguments, printing helpmessage.", file=sys.stderr)
        sys.stderr.write(HELP)
        return 1
    if reffilename and not dbfilename:
        print("Database is needed in order to reconstruct the "
              "reference(s).", file=sys.stderr)
        sys.exit(1)

    entries = union_res(filenames, min_cov, min_depth, min_length)
    if dbfilename:
        # unionResOrderPrint tests for "--" as its stdout sentinel
        # (union.c:111), so the default "-" becomes a literal file
        # named "-" in the cwd
        out = (sys.stdout.buffer if outputfile == "--"
               else open(outputfile, "wb"))
    else:
        out = fileio.open_out(outputfile)

    if dbfilename:
        # DB-ordered output (unionResOrderPrint, union.c:100-188)
        names = kmadb.read_names(dbfilename)
        reffile = open(reffilename, "wb") if reffilename else None
        if reffile is not None:
            out.write(b"%d\t%s" % (len(filenames) + 1,
                                   reffilename.encode()))
        else:
            out.write(b"%d" % len(filenames))
        for fn in filenames:
            out.write(b"\t" + fn.encode())
        out.write(b"\n")
        tnum = 0
        ref_indices = []
        for name in names:
            tnum += 1
            if entries.n == 0:
                break
            ulist = entries.pop(name)
            # only templates shared by >1 sample print (union.c:148)
            if ulist and len(ulist) > 1:
                if reffile is not None:
                    ref_indices.append(tnum)
                    # count = samples + the reference entry (union.c:154)
                    out.write(name + b"\t%d\t0" % (len(ulist) + 1))
                    for u in ulist:
                        out.write(b"\t%d" % (u + 1))
                else:
                    out.write(name + b"\t%d" % len(ulist))
                    for u in ulist:
                        out.write(b"\t%d" % u)
                out.write(b"\n")
        if reffile is not None:
            for nm, seq in kmadb.iter_fastas(dbfilename, ref_indices):
                reffile.write(b">" + nm + b"\n" + seq + b"\n")
            reffile.close()
    else:
        # plain union (unionResPrint, union.c:66-98)
        out.write(b"%d" % len(filenames))
        for fn in filenames:
            out.write(b"\t" + fn.encode())
        out.write(b"\n")
        for key, ulist in entries.items_in_print_order():
            out.write(key + b"\t%d" % len(ulist))
            for u in ulist:
                out.write(b"\t%d" % u)
            out.write(b"\n")
    fileio.close_out(out)
    return 0
