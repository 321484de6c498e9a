"""Makespan scheduling suite (reference jobs.c, machines.c, makespan.c,
tabusearch.c, mvjobs.c, mvmakespan.c, mvtabusearch.c).

Clusters (jobs) are balanced onto partitions (machines) with the
DBF/DFF/DBE/DFE init heuristics and improved with the BB/DBEB tabu
trades.  Linked-list mechanics, merge tie-breaks and scan orders follow
the C exactly so the printed partitioning is byte-identical.

Counterpart of ccphylo_tpu/schedule/makespan.py: the port's own copy.
"""

from __future__ import annotations

import math
import sys


class Job:
    __slots__ = ("num", "size", "weight", "Weights", "next")

    def __init__(self, num=0):
        self.num = num
        self.size = 0
        self.weight = 0.0
        self.Weights = None
        self.next = None


class Machine:
    __slots__ = ("num", "n", "m", "avail", "Avails", "jobs", "next")

    def __init__(self):
        self.num = 0
        self.n = 0
        self.m = 0
        self.avail = 0.0
        self.Avails = None
        self.jobs = None
        self.next = None


# --- linked-list sorts (jobs.c:115-209, machines.c:24-82) -----------------


def jobmerge(L1, L2):
    """Descending by weight; head tie prefers L1, loop tie prefers L1
    (jobs.c:115-149)."""
    if L1 is None:
        return L2
    if L2 is None:
        return L1
    if L1.weight < L2.weight:
        dest = L2
        L2 = L2.next
    else:
        dest = L1
        L1 = L1.next
    ptr = dest
    while L1 is not None and L2 is not None:
        if L1.weight < L2.weight:
            ptr.next = L2
            L2 = L2.next
        else:
            ptr.next = L1
            L1 = L1.next
        ptr = ptr.next
    ptr.next = L1 if L1 is not None else L2
    return dest


def jobmerge_inc(L1, L2):
    """Ascending by weight (jobs.c:151-185)."""
    if L1 is None:
        return L2
    if L2 is None:
        return L1
    if L2.weight < L1.weight:
        dest = L2
        L2 = L2.next
    else:
        dest = L1
        L1 = L1.next
    ptr = dest
    while L1 is not None and L2 is not None:
        if L2.weight < L1.weight:
            ptr.next = L2
            L2 = L2.next
        else:
            ptr.next = L1
            L1 = L1.next
        ptr = ptr.next
    ptr.next = L1 if L1 is not None else L2
    return dest


def jobsort(jobs: list, lo: int, n: int):
    """jobsort (jobs.c:187-209): array-position mergesort."""
    if n <= 1:
        if n == 1:
            jobs[lo].next = None
            return jobs[lo]
        return None
    mid = n >> 1
    L1 = jobsort(jobs, lo, mid)
    L2 = jobsort(jobs, lo + mid, n - mid)
    return jobmerge(L1, L2)


def machinemerge(L1, L2):
    """Descending by avail; head tie prefers L1, loop tie prefers L2
    (machines.c:24-58)."""
    if L1 is None:
        return L2
    if L2 is None:
        return L1
    if L1.avail < L2.avail:
        dest = L2
        L2 = L2.next
    else:
        dest = L1
        L1 = L1.next
    ptr = dest
    while L1 is not None and L2 is not None:
        if L2.avail < L1.avail:
            ptr.next = L1
            L1 = L1.next
        else:
            ptr.next = L2
            L2 = L2.next
        ptr = ptr.next
    ptr.next = L1 if L1 is not None else L2
    return dest


def machinesort(machines: list, lo: int, m: int):
    if m <= 1:
        if m == 1:
            machines[lo].next = None
            return machines[lo]
        return None
    mid = m >> 1
    L1 = machinesort(machines, lo, mid)
    L2 = machinesort(machines, lo + mid, m - mid)
    return machinemerge(L1, L2)


# --- weights (jobs.c:290-346, mvjobs.c:96-177) ----------------------------


def apply_weight(jobs, n, method: str, base: float, mv: int):
    if mv:
        for J in jobs[:n]:
            w = 0.0
            for i in range(mv):
                v = J.Weights[i]
                if method == "none":
                    w += v
                elif v:
                    if method == "log":
                        J.Weights[i] = 1 + math.log(v) / math.log(base)
                    elif method == "pow":
                        J.Weights[i] = v ** base
                    else:  # exp
                        J.Weights[i] = base ** v
                    w += J.Weights[i]
            J.weight = w
    else:
        for J in jobs[:n]:
            if method == "none":
                J.weight = float(J.size)
            elif method == "log":
                if not J.size:
                    print("Invalid weight for log-transformation:\t0",
                          file=sys.stderr)
                    sys.exit(1)
                J.weight = 1 + math.log(J.size) / math.log(base)
            elif method == "pow":
                J.weight = float(J.size) ** base
            else:
                J.weight = base ** float(J.size)


# --- machines init (machines.c:84-170) ------------------------------------


def init_machines(m, n, mv, jobs, loads):
    tot = jobs[0].weight
    for J in jobs[1:n]:
        tot += J.weight
    mtargets = None
    if mv:
        mtargets = [0.0] * mv
        for J in jobs[:n]:
            for i in range(mv):
                mtargets[i] += J.Weights[i]
    machines = [Machine() for _ in range(m)]
    if loads is not None:
        totL = loads[0]
        for x in loads[1:]:
            totL += x
        m_target = tot / totL
        for k in range(m):
            M = machines[k]
            M.num = m - k
            M.m = mv
            M.avail = m_target * loads[k]
            if mtargets is not None:
                M.Avails = [t * loads[k] / totL for t in mtargets]
            M.next = machines[k + 1] if k + 1 < m else None
    else:
        m_target = tot / m
        if mtargets is not None:
            mtargets = [t / m for t in mtargets]
        for k in range(m):
            M = machines[k]
            M.num = m - k
            M.m = mv
            M.avail = m_target
            if mtargets is not None:
                M.Avails = list(mtargets)
            M.next = machines[k + 1] if k + 1 < m else None
    return machines


# --- multivariate helpers (mvjobs.c:29-95) --------------------------------


def add_value(M, J):
    e = 0.0
    for i in range(M.m):
        jw = J.Weights[i]
        ma = M.Avails[i]
        if jw <= ma:
            e += jw
        elif ma <= 0:
            e -= jw
        else:
            e += ma + ma - jw
    return e


def rm_mvjob(M, J):
    for i in range(M.m):
        M.Avails[i] += J.Weights[i]


def add_mvjob(M, J):
    for i in range(M.m):
        M.Avails[i] -= J.Weights[i]


def add_mvjob_to_machine(M, J):
    M.n += 1
    J.next = M.jobs
    M.jobs = J
    M.avail -= J.weight


# --- init heuristics (makespan.c:39-284, mvmakespan.c:26-180) -------------


class Methods:
    """Bundles the univariate/multivariate function-pointer choices."""

    def __init__(self, mv_mode: bool):
        self.mv = mv_mode

    def add_dbf(self, M, J):
        if self.mv:
            B = M
            prev = None
            prevB = None
            Mptr = M
            mx = (M.avail - J.weight if M.avail < 0
                  else -M.avail - J.weight)
            while Mptr is not None:
                test = add_value(Mptr, J)
                if mx < test:
                    mx = test
                    prevB = prev
                    B = Mptr
                    if mx == J.weight:
                        break
                prev = Mptr
                Mptr = Mptr.next
            add_mvjob_to_machine(B, J)
            add_mvjob(B, J)
            if prevB is not None:
                prevB.next = B.next
            else:
                M = B.next
            B.next = None
            return machinemerge(M, B)
        M.n += 1
        J.next = M.jobs
        M.jobs = J
        M.avail -= J.weight
        nextM = M.next
        M.next = None
        return machinemerge(nextM, M)

    def add_dbe(self, M, E, J, m, n):
        if self.mv:
            B = M
            prev = None
            prevB = None
            Mptr = M
            mx = (M.avail - J.weight if M.avail < 0
                  else -M.avail - J.weight)
            while Mptr is not None:
                test = add_value(Mptr, J)
                if mx < test:
                    mx = test
                    prevB = prev
                    B = Mptr
                    if mx == J.weight:
                        break
                prev = Mptr
                Mptr = Mptr.next
            add_mvjob_to_machine(B, J)
            add_mvjob(B, J)
            if prevB is not None:
                prevB.next = B.next
            else:
                M = B.next
            B.next = None
            if B.n < n // m:
                M = machinemerge(M, B)
            else:
                E = machinemerge(E, B)
            return M, E
        M.n += 1
        J.next = M.jobs
        M.jobs = J
        M.avail -= J.weight
        nextM = M.next
        M.next = None
        if M.n < n // m:
            M2 = machinemerge(nextM, M)
        else:
            E = machinemerge(E, M)
            M2 = nextM
        return M2, E

    def first_fit(self, M, J, m):
        if self.mv:
            weight = J.weight
            best = (M.avail - weight if M.avail < 0
                    else -M.avail - weight)
            F = M
            while m:
                test = add_value(M, J)
                if test == weight:
                    add_mvjob_to_machine(M, J)
                    add_mvjob(M, J)
                    return M
                if best < test:
                    best = test
                    F = M
                M = M.next
                m -= 1
            add_mvjob_to_machine(F, J)
            add_mvjob(F, J)
            return F
        weight = J.weight
        best = M.avail
        F = M
        while m:
            if weight <= M.avail:
                M.n += 1
                J.next = M.jobs
                M.jobs = J
                M.avail -= weight
                return M
            if best < M.avail:
                best = M.avail
                F = M
            M = M.next
            m -= 1
        F.n += 1
        J.next = F.jobs
        F.jobs = J
        F.avail -= weight
        return F

    def first_fet(self, M, J):
        if self.mv:
            weight = J.weight
            best = (M.avail - weight if M.avail < 0
                    else -M.avail - weight)
            F = M
            prev = None
            prevF = None
            while M is not None:
                test = add_value(M, J)
                if test == weight:
                    add_mvjob_to_machine(M, J)
                    add_mvjob(M, J)
                    return prev
                if best < test:
                    best = test
                    prevF = prev
                    F = M
                prev = M
                M = M.next
            add_mvjob_to_machine(F, J)
            add_mvjob(F, J)
            return prevF
        weight = J.weight
        best = M.avail
        F = M
        prev = None
        prevF = None
        while M is not None:
            if weight <= M.avail:
                M.n += 1
                J.next = M.jobs
                M.jobs = J
                M.avail -= weight
                return prev
            if best < M.avail:
                best = M.avail
                prevF = prev
                F = M
            prev = M
            M = M.next
        F.n += 1
        J.next = F.jobs
        F.jobs = J
        F.avail -= weight
        return prevF


def run_method(method, machines, jobs, m, n, meth: Methods):
    """DBF/DFF/DBE/DFE (makespan.c:69-284)."""
    if method == "DBF":
        M = machinesort(machines, 0, m)
        J = jobsort(jobs, 0, n)
        while J is not None:
            nextJ = J.next
            M = meth.add_dbf(M, J)
            J = nextJ
        return M
    if method == "DFF":
        machines[m - 1].next = machines[0]
        for k in range(m - 1):
            machines[k].next = machines[k + 1]
        M = machines[0]
        J = jobsort(jobs, 0, n)
        while J is not None:
            nextJ = J.next
            M = meth.first_fit(M, J, m)
            J = nextJ
        nextM = M.next
        M.next = None
        return nextM
    if method == "DBE":
        M = machinesort(machines, 0, m)
        J = jobsort(jobs, 0, n)
        E = None
        while J is not None:
            nextJ = J.next
            if M is None:
                M = E
                E = None
            M, E = meth.add_dbe(M, E, J, m, n)
            J = nextJ
        return machinemerge(M, E)
    if method == "DFE":
        J = jobsort(jobs, 0, n)
        M = machinesort(machines, 0, m) if False else machines[0]
        for k in range(m - 1):
            machines[k].next = machines[k + 1]
        machines[m - 1].next = None
        E = None
        while J is not None:
            nextJ = J.next
            if M is None:
                M = E
                E = None
            F = meth.first_fet(M, J)
            if F is not None:
                if n // m <= F.next.n:
                    nextM = F.next
                    F.next = F.next.next
                    nextM.next = None
                    E = machinemerge(E, nextM)
            else:
                if n // m <= M.n:
                    nextM = M
                    M = M.next
                    nextM.next = None
                    E = machinemerge(E, nextM)
            J = nextJ
        return machinemerge(M, E)
    raise ValueError(method)


# --- tabu search (tabusearch.c, mvtabusearch.c) ---------------------------


def _abs(x):
    return -x if x < 0 else x


def cmp_j(Jm, Jn, m):
    if Jm.weight != Jn.weight:
        return 1 if Jm.weight < Jn.weight else -1
    for i in range(m):
        if Jm.Weights[i] != Jn.Weights[i]:
            return 1 if Jm.Weights[i] < Jn.Weights[i] else -1
    return 0


def exchange_jobs(Mm, Mn, Jm, Jn):
    """exchangeJobs (tabusearch.c:138-178)."""
    if Jm is not None:
        J = Jm.next
        Jm.next = J.next
    else:
        J = Mm.jobs
        Mm.jobs = J.next
    J.next = None
    Jm = J
    if Jn is not None:
        J = Jn.next
        Jn.next = J.next
    else:
        J = Mn.jobs
        Mn.jobs = J.next
    J.next = None
    Jn = J
    Mn.jobs = jobmerge_inc(Mn.jobs, Jm)
    Mm.jobs = jobmerge_inc(Mm.jobs, Jn)
    Mm.avail += Jm.weight - Jn.weight
    Mn.avail += Jn.weight - Jm.weight
    if Mm.m:
        rm_mvjob(Mm, Jm)
        add_mvjob(Mm, Jn)
        rm_mvjob(Mn, Jn)
        add_mvjob(Mn, Jm)
    return cmp_j(Jm, Jn, Mm.m)


def negotiate(Mm, Mn, mv_mode):
    """negotiateM / negotiateMVM.  Returns (gain, JmPrev, JnPrev)."""
    if mv_mode:
        return _negotiate_mv(Mm, Mn)
    if Mm.avail == Mn.avail or (Mm.n <= 1 and Mn.n <= 1):
        return 0.0, None, None
    balance = (Mm.avail < 0 < Mn.avail) or (Mn.avail < 0 < Mm.avail)
    if balance:
        base = _abs(Mm.avail) + _abs(Mn.avail)
    else:
        w1 = _abs(Mm.avail)
        w2 = _abs(Mn.avail)
        base = w2 if w1 < w2 else w1
    best = base
    Jmbest = None
    Jnbest = None
    Jm = Mm.jobs
    JmPrev = None
    Jn = Mn.jobs
    JnPrev = None
    while Jm is not None:
        Jmw = Jm.weight
        Mmj = Mm.avail + Jmw
        Mnj = Mn.avail
        w1 = Mmj - Jn.weight
        w2 = Mnj + Jn.weight - Jmw
        if balance:
            mn = _abs(w1) + _abs(w2)
        else:
            w1 = _abs(w1)
            w2 = _abs(w2)
            mn = w2 if w1 < w2 else w1
        Jmin = JnPrev
        nxt = Jn.next
        while nxt is not None:
            if Jm.weight != nxt.weight:
                w1 = Mmj - nxt.weight
                w2 = Mnj + nxt.weight - Jmw
                if balance:
                    test = _abs(w1) + _abs(w2)
                else:
                    w1 = _abs(w1)
                    w2 = _abs(w2)
                    test = w2 if w1 < w2 else w1
                if test < mn:
                    mn = test
                    Jmin = Jn
                    JnPrev = Jn
                    Jn = nxt
                    nxt = nxt.next
                elif test == mn:
                    JnPrev = Jn
                    Jn = nxt
                    nxt = nxt.next
                else:
                    nxt = None
                if mn == 0:
                    nxt = None
            else:
                JnPrev = Jn
                Jn = nxt
                nxt = nxt.next
        if mn < best:
            best = mn
            Jmbest = JmPrev
            Jnbest = Jmin
        JmPrev = Jm
        Jm = None if best == 0 else Jm.next
    Jm = Jmbest.next if Jmbest is not None else Mm.jobs
    Jn = Jnbest.next if Jnbest is not None else Mn.jobs
    if best != base and Jm.weight != Jn.weight:
        best -= base
    else:
        best = 0.0
    return best, Jmbest, Jnbest


def _base_value(Mm, Mn):
    base = 0.0
    for i in range(Mm.m):
        a = Mm.Avails[i]
        b = Mn.Avails[i]
        if (a < 0 < b) or (b < 0 < a):
            base += _abs(a) + _abs(b)
        elif a < 0:
            base -= a if a < b else b
        else:
            base += b if a < b else a
    return base


def _opt_value(Mm, Mn):
    opt = 0.0
    for i in range(Mm.m):
        a = Mm.Avails[i]
        b = Mn.Avails[i]
        diff = a + b
        if (a < 0 < b) or (b < 0 < a):
            opt += _abs(diff)
        else:
            opt += 0.5 * _abs(diff)
    return opt


def _trade_value(Mm, Mn, Jm, Jn):
    post = 0.0
    for i in range(Mm.m):
        a = Mm.Avails[i]
        b = Mn.Avails[i]
        tm = a + Jm.Weights[i] - Jn.Weights[i]
        tn = b + Jn.Weights[i] - Jm.Weights[i]
        if (a < 0 < b) or (b < 0 < a):
            post += _abs(tm) + _abs(tn)
        else:
            tm = _abs(tm)
            tn = _abs(tn)
            post += tn if tm < tn else tm
    return post


def _negotiate_mv(Mm, Mn):
    if Mm.n <= 1 and Mn.n <= 1:
        return 0.0, None, None
    base = _base_value(Mm, Mn)
    opt = _opt_value(Mm, Mn)
    best = base
    Jmbest = None
    Jnbest = None
    Jm = Mm.jobs
    JmPrev = None
    while Jm is not None:
        Jn = Mn.jobs
        JnPrev = None
        mn = _trade_value(Mm, Mn, Jm, Jn)
        Jmin = JnPrev
        JnPrev = Jn
        nxt = Jn.next
        while nxt is not None:
            test = _trade_value(Mm, Mn, Jm, nxt)
            if test < mn:
                mn = test
                Jmin = JnPrev
            JnPrev = nxt
            nxt = None if mn == opt else nxt.next
        if mn < best:
            best = mn
            Jmbest = JmPrev
            Jnbest = Jmin
        JmPrev = Jm
        Jm = None if best <= opt else Jm.next
    if best != base:
        best -= base
    else:
        best = 0.0
    return best, Jmbest, Jnbest


def test_handover(Mm, Mn, J):
    """testHandover (tabusearch.c:375-395) — the C declares int, so the
    error truncates toward zero before the comparison."""
    if Mn.avail < Mm.avail:
        e = Mn.avail - Mm.avail
    elif Mm.avail < 0 < Mn.avail:
        e = _abs(Mm.avail) + _abs(Mn.avail)
        e -= _abs(Mm.avail + J.weight)
        e -= _abs(Mn.avail - J.weight)
    else:
        e = Mn.avail - J.weight - Mm.avail
    return int(e)


def _test_mv_handover(Mm, Mn, J):
    prev = 0.0
    post = 0.0
    for i in range(Mm.m):
        a = Mm.Avails[i]
        b = Mn.Avails[i]
        w = J.Weights[i]
        if (a < 0 < b) or (b < 0 < a):
            prev += _abs(a) + _abs(b)
            post += _abs(a + w) + _abs(b - w)
        elif a < 0:
            prev -= a if a < b else b
            t1 = a + w
            t1 = t1 if t1 < 0 else -t1
            t2 = b - w
            post -= t1 if t1 < t2 else t2
        else:
            prev += b if a < b else a
            t1 = _abs(b - w)
            t2 = a + w
            post += t2 if t1 < t2 else t1
    return prev - post


def handover(Mm, Mn, mv_mode):
    """handover / mvhandover."""
    if mv_mode:
        if Mn.avail < Mm.avail:
            Mm, Mn = Mn, Mm
        cnt = 0
        J = Mm.jobs
        while J is not None and Mm.avail + J.weight < Mn.avail - J.weight:
            if 0 < _test_mv_handover(Mm, Mn, J):
                Mm.n -= 1
                Mn.n += 1
                Mm.avail += J.weight
                Mn.avail -= J.weight
                rm_mvjob(Mm, J)
                add_mvjob(Mn, J)
                Mm.jobs = J.next
                J.next = None
                Mn.jobs = jobmerge_inc(Mn.jobs, J)
                cnt += 1
                J = Mm.jobs
            else:
                J = J.next
        return cnt
    if Mn.avail < Mm.avail:
        Mm, Mn = Mn, Mm
    elif Mm.avail == Mn.avail:
        return 0
    cnt = 0
    J = Mm.jobs
    while J is not None and 0 < test_handover(Mm, Mn, J):
        Mm.n -= 1
        Mn.n += 1
        Mm.avail += J.weight
        Mn.avail -= J.weight
        Mm.jobs = J.next
        J.next = None
        Mn.jobs = jobmerge_inc(Mn.jobs, J)
        cnt += 1
        J = Mm.jobs
    return cnt


def machine_mse(M):
    m = 1
    mse = M.avail * M.avail
    M = M.next
    while M is not None:
        mse += M.avail * M.avail
        m += 1
        M = M.next
    return mse / m


def machine_imse(M):
    m = 0
    imse = 0.0
    while M is not None:
        for i in range(M.m):
            imse += M.Avails[i] * M.Avails[i]
        m += 1
        M = M.next
    return imse / m


def trade(M, method: str, mv_mode: bool) -> int:
    """tradeBB / tradeDBEB (tabusearch.c:317-497)."""
    test = machine_imse(M) if M.m else machine_mse(M)
    print(f"## Pre-tabu MSE:\t{test:f}", file=sys.stderr)
    if test == 0:
        return 0
    with_handover = method == "BB"
    trades = 0
    while True:
        null_trades = trades
        Mm = M
        while Mm is not None:
            mn = 0.0
            JmBest = None
            JnBest = None
            Mbest = None
            Mn = Mm.next
            while Mn is not None:
                if with_handover:
                    trades += handover(Mm, Mn, mv_mode)
                t, Jm, Jn = negotiate(Mm, Mn, mv_mode)
                if t < mn:
                    mn = t
                    JmBest = Jm
                    JnBest = Jn
                    Mbest = Mn
                Mn = Mn.next
            if mn < 0 and exchange_jobs(Mm, Mbest, JmBest, JnBest):
                trades += 1
            else:
                Mm = Mm.next
        if null_trades == trades:
            break
    return trades


# --- stats + output (machines.c:210-276, makespan.c:286-338) --------------


def print_stats(M):
    m = 0
    mse = 0.0
    imse = 0.0
    Cmax = M.avail
    Cmin = M.avail
    L1 = 0.0
    L1imse = 0.0
    Jmax = M.jobs.weight if M.jobs is not None else 0.0
    has_w = False
    OPT = 0.0
    Mp = M
    while Mp is not None:
        if Cmax < Mp.avail:
            Cmax = Mp.avail
        elif Mp.avail < Cmin:
            Cmin = Mp.avail
        L1 += _abs(Mp.avail)
        mse += Mp.avail * Mp.avail
        m += 1
        for i in range(Mp.m):
            has_w = True
            w = Mp.Avails[i]
            imse += w * w
            L1imse += _abs(w)
        J = Mp.jobs
        while J is not None:
            OPT += J.weight
            if Jmax < J.weight:
                Jmax = J.weight
            J = J.next
        Mp = Mp.next
    mse /= m
    imse /= m
    OPT /= m
    Cmax += OPT
    Cmin += OPT
    OPT = Jmax if OPT < Jmax else OPT
    print(f"## MSE:\t{mse:f}", file=sys.stderr)
    if has_w:
        print(f"## Imbalance MSE:\t{imse:f}", file=sys.stderr)
    print(f"## L1:\t{L1:f}", file=sys.stderr)
    if has_w:
        print(f"## Imbalance L1:\t{L1imse:f}", file=sys.stderr)
    print(f"## OPT:\t{OPT:f}", file=sys.stderr)
    print(f"## Cmax:\t{Cmax:f}", file=sys.stderr)
    print(f"## Cmin:\t{Cmin:f}", file=sys.stderr)


def print_makespan(M, out, mout):
    same = out is mout
    if not same:
        out.write(b"#Cluster\tCluster_size\tCluster_weight\tPartition\n")
        mout.write(b"#Partition\tCluster_quantity\tPartition_size\t"
                   b"Partition_weight\tPartition_error\n")
        Mp = M
        while Mp is not None:
            size = 0
            weight = 0.0
            J = Mp.jobs
            while J is not None:
                out.write(b"%d\t%d\t%f\t%d\n"
                          % (J.num, J.size, J.weight, Mp.num))
                size += J.size
                weight += J.weight
                J = J.next
            mout.write(b"%d\t%d\t%d\t%f\t%f\n"
                       % (Mp.num, Mp.n, size, weight, Mp.avail))
            Mp = Mp.next
    else:
        mout.write(b"#Partition\tCluster_quantity\tPartition_size\t"
                   b"Partition_weight\tPartition_error\n")
        Mp = M
        while Mp is not None:
            size = 0
            weight = 0.0
            J = Mp.jobs
            while J is not None:
                size += J.size
                weight += J.weight
                J = J.next
            mout.write(b"%d\t%d\t%d\t%f\t%f\n"
                       % (Mp.num, Mp.n, size, weight, Mp.avail))
            Mp = Mp.next
        out.write(b"#Cluster\tCluster_size\tCluster_weight\tPartition\n")
        Mp = M
        while Mp is not None:
            J = Mp.jobs
            while J is not None:
                out.write(b"%d\t%d\t%f\t%d\n"
                          % (J.num, J.size, J.weight, Mp.num))
                J = J.next
            Mp = Mp.next
