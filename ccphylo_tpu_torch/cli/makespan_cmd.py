"""`makespan` subcommand: cluster/partition scheduling (reference
makespan.c:340-757, tsv.c:154-684 job loaders).

Counterpart of ccphylo_tpu/cli/makespan_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

from ..io import fileio
from ..schedule.makespan import (Job, Methods, apply_weight,
                                 init_machines, print_makespan,
                                 print_stats, run_method, trade)
from .args import Args, ArgError

HELP = """\
#CCPhylo makespan clusters jobs into partitions.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -O, --machine_output  \tMachine output file             \tstdout
#    -S, --separator       \tSeparator                       \t\\t
#    -k, --key             \tField containing cluster number \t3
#    -c, --classes         \tField(s) containing class weights\tFalse
#    -m, --method          \tMakespan initial method         \tDBF
#    -M, --method_help     \tHelp on option "-m"             \t
#    -t, --tabu            \tMakespan tabu search method     \tBB
#    -T, --tabu_help       \tHelp on option "-t"             \t
#    -w, --weight          \tWeighing method                 \tnone
#    -W, --weight_help     \tHelp on option "-w"             \t
#    -l, --loads           \tLoad on machines double[,double...]\t5
#    -h, --help            \tShows this helpmessage          \t
"""


def _skip_header(lines):
    """loadJobs/loadTsv header convention: the first line plus following
    '#' lines are skipped; the column count comes from the last skipped
    line."""
    k = 1
    dim = lines[0].count(b"\t") + 1
    while k < len(lines) and lines[k][:1] == b"#":
        dim = lines[k].count(b"\t") + 1
        k += 1
    return k, dim


def load_jobs(data: bytes, sep: bytes, col: int):
    """loadJobs (tsv.c:154-304)."""
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines = lines[:-1]
    if not lines:
        return [], 0
    k, dim = _skip_header(lines)
    if dim < col:
        print("Invalid target column", file=sys.stderr)
        sys.exit(1)
    counts: dict[int, int] = {}
    maxi = -1
    for entry, line in enumerate(lines[k:], 1):
        parts = line.split(sep)
        try:
            i = int(parts[col - 1])
        except (ValueError, IndexError):
            print(f"Malformatted cluster at:\t{entry}", file=sys.stderr)
            sys.exit(1)
        counts[i] = counts.get(i, 0) + 1
        maxi = max(maxi, i)
    jobs = []
    for i in range(maxi + 1):
        if counts.get(i, 0) > 0:
            J = Job(i)
            J.size = counts[i]
            jobs.append(J)
    return jobs, len(jobs)


def load_mv_jobs(data: bytes, sep: bytes, col: int, mv_cols: list[int]):
    """loadMVJobs (tsv.c:305-494): class weights summed per cluster,
    class order following the SORTED column order."""
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines = lines[:-1]
    k, dim = _skip_header(lines)
    allcols = sorted([col] + mv_cols)
    if allcols[0] < 1 or dim < allcols[-1] \
            or len(set(allcols)) != len(allcols):
        print("Invalid target column", file=sys.stderr)
        sys.exit(1)
    mv = len(mv_cols)
    acc: dict[int, list] = {}
    counts: dict[int, int] = {}
    maxi = -1
    for entry, line in enumerate(lines[k:], 1):
        parts = line.split(sep)
        classes = []
        J_i = 0
        try:
            for c in allcols:
                if c == col:
                    J_i = int(parts[c - 1])
                else:
                    classes.append(float(parts[c - 1]))
        except (ValueError, IndexError):
            print(f"Malformatted cluster at:\t{entry}", file=sys.stderr)
            sys.exit(1)
        counts[J_i] = counts.get(J_i, 0) + 1
        w = acc.setdefault(J_i, [0.0] * mv)
        for i in range(mv):
            w[i] += classes[i]
        maxi = max(maxi, J_i)
    jobs = []
    for i in range(maxi + 1):
        if counts.get(i, 0) > 0:
            J = Job(i)
            J.size = counts[i]
            J.Weights = acc[i]
            jobs.append(J)
    return jobs, len(jobs), mv


def load_mve_jobs(data: bytes, sep: bytes, col: int, class_col: int):
    """loadMVEJobs (tsv.c:495-684): one column holds a class number;
    Weights[class] counts rows."""
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines = lines[:-1]
    k, dim = _skip_header(lines)
    cols = sorted([col, class_col])
    if cols[0] < 1 or cols[0] == cols[1] or dim < cols[1]:
        print("Invalid target column", file=sys.stderr)
        sys.exit(1)
    acc: dict[int, dict] = {}
    counts: dict[int, int] = {}
    maxi = -1
    mv = 0
    for entry, line in enumerate(lines[k:], 1):
        parts = line.split(sep)
        try:
            J_i = int(parts[col - 1])
            c_i = int(parts[class_col - 1])
        except (ValueError, IndexError):
            print(f"Malformatted cluster at:\t{entry}", file=sys.stderr)
            sys.exit(1)
        counts[J_i] = counts.get(J_i, 0) + 1
        acc.setdefault(J_i, {})
        acc[J_i][c_i] = acc[J_i].get(c_i, 0) + 1
        mv = max(mv, c_i + 1)
        maxi = max(maxi, J_i)
    jobs = []
    for i in range(maxi + 1):
        if counts.get(i, 0) > 0:
            J = Job(i)
            J.size = counts[i]
            J.Weights = [float(acc[i].get(c, 0)) for c in range(mv)]
            jobs.append(J)
    return jobs, len(jobs), mv


def main_makespan(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    moutputfile = "-"
    sep = "\t"
    col = 3
    m = 5
    method = "DBF"
    tabu = "BB"
    weight = "none"
    str_loads = None
    str_mv = None

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
            elif name == "machine_output":
                moutputfile = a.next_value("machine_output")
            elif name == "separator":
                sep = a.next_char("separator")
            elif name == "key":
                col = a.next_num("key")
            elif name == "classes":
                str_mv = a.next_value("classes")
            elif name == "method":
                method = a.next_value("method")
            elif name == "method_help":
                method = None
            elif name == "tabu":
                tabu = a.next_value("tabu")
            elif name == "tabu_help":
                tabu = None
            elif name == "weight":
                weight = a.next_value("weight")
            elif name == "weight_help":
                weight = None
            elif name == "loads":
                str_loads = a.next_value("loads")
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
                elif opt == "O":
                    moutputfile = a.next_value("O")
                elif opt == "S":
                    sep = a.next_char("S")
                elif opt == "k":
                    col = a.next_num("k")
                elif opt == "c":
                    str_mv = a.next_value("c")
                elif opt == "m":
                    method = a.next_value("m")
                elif opt == "M":
                    method = None
                elif opt == "t":
                    tabu = a.next_value("t")
                elif opt == "T":
                    tabu = None
                elif opt == "w":
                    weight = a.next_value("w")
                elif opt == "W":
                    weight = None
                elif opt == "l":
                    str_loads = a.next_value("l")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            inputfile = arg
        a.i += 1

    if method is None:
        sys.stderr.write(
            "Makespan initial methods:\nDBF:\tDecreasing Best First / "
            "Longest Processing Time (LPT)\nDFF:\tDecreasing First Fit\n"
            "DBE:\tDecreasing Best First with equal number of jobs\n"
            "DFE:\tDecreasing First First with equal number of jobs\n")
        return 0
    if method not in ("DBF", "DFF", "DBE", "DFE"):
        raise ArgError("Invalid value parsed at method.")
    if tabu is None:
        sys.stderr.write(
            "Tabu search methods:\nBB:\tBabettes buckets, local search "
            "+ job trade\nDBEB:\tTrades has to be with two jobs\n"
            "None:\tNo trading\n")
        return 0
    if tabu not in ("BB", "DBEB", "None"):
        raise ArgError("Invalid value parsed at tabu.")
    if weight is None:
        sys.stderr.write(
            "Weight methods:\nnone:\tDo not weigh clusters\nlogX:\t"
            "Weigh one plus logarithmicly with base X\npowX:\tWeigh "
            "polynomial with exponent X\nexpX:\tWeigh exponential with "
            "exponential base X\n")
        return 0

    # loads (makespan.c:679-692)
    loads = None
    if str_loads:
        vals = str_loads.split(",")
        if len(vals) == 1:
            m = int(float(vals[0]))
        else:
            loads = [float(x) for x in vals]
            if any(x <= 0 for x in loads):
                raise ArgError("Invalid value parsed at loads.")
            m = len(loads)
        if m <= 0:
            raise ArgError("Invalid value parsed at loads.")

    # classes (makespan.c:694-716)
    mv = 0
    mv_cols = None
    class_col = None
    if str_mv:
        vals = [int(x) for x in str_mv.split(",")]
        if any(x <= 0 for x in vals):
            raise ArgError("Invalid value parsed at classes.")
        if len(vals) == 1:
            class_col = vals[0]
        else:
            mv_cols = vals
            mv = len(vals)

    # weight method
    base = 1.0
    wmethod = "none"
    if weight != "none":
        for pre in ("log", "pow", "exp"):
            if weight.startswith(pre):
                wmethod = pre
                rest = weight[3:]
                base = (math_e() if rest == "e" else float(rest))
                break
        else:
            raise ArgError("Invalid value parsed at weight.")

    data = fileio.read_bytes(inputfile)
    sepb = sep.encode()
    if mv_cols is not None:
        jobs, n, mv = load_mv_jobs(data, sepb, col, mv_cols)
    elif class_col is not None:
        jobs, n, mv = load_mve_jobs(data, sepb, col, class_col)
    else:
        jobs, n = load_jobs(data, sepb, col)
    if not n:
        print("No jobs parsed.", file=sys.stderr)
        return 1

    apply_weight(jobs, n, wmethod, base, mv)
    machines = init_machines(m, n, mv, jobs, loads)
    meth = Methods(mv > 1)
    M = run_method(method, machines, jobs, m, n, meth)
    if tabu != "None":
        ntr = trade(M, tabu, mv > 1)
        print(f"## Trades:\t{ntr}", file=sys.stderr)
    print_stats(M)

    out = fileio.open_out(outputfile)
    if moutputfile == "-":
        mout = sys.stdout.buffer if outputfile != "-" else out
        if outputfile == "-":
            mout = out
        else:
            mout = fileio.open_out("-")
    elif moutputfile == outputfile:
        mout = out
    else:
        mout = fileio.open_out(moutputfile)
    print_makespan(M, out, mout)
    fileio.close_out(out)
    if mout is not out:
        fileio.close_out(mout)
    return 0


def math_e() -> float:
    return 2.71828182845904523536028747135266
