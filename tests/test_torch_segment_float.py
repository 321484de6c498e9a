"""A segment of joins of the port's float DNJ engine (ccphylo_tpu_torch/
ops/segment_float.py, plain version on the CPU).

`dnj_segment_float_plain` over segments [t0, t1) of a run, from the JAX
float engine's state at t0 (ccphylo_tpu.tree.jax_engine, scan="batch",
its matrix padded to 128 rows, so n > m), gives the JAX engine's state
at t1: records and the active part of every state array, bit for bit,
on an integer SNP-like matrix, random integers in [0, 25) (dense in
ties), in float32 and with negative limbs.  On a matrix with 12% of its
cells missing the picks are equal and the limbs and sums within 1e-12
of max(|x|, 1): a one-sided update stores D_ik - L_i, which is not
dyadic, and JAX's cumsum on the CPU does not add left to right.

A numpy model of csrc/dnj_segment_float.cu (the CUDA kernel cannot run
here) runs the kernel's G blocks as generators that stop at every grid
barrier, the blocks in a random order between barriers and the threads
of a block in a random order within a phase, with the kernel's chunks of
cells, its scan buffers by a parity that runs on across joins, its sums
in the order of its block reductions, and phase C reduced in every
block. It models both designs of the scan, and every case runs in each:
the first (block k scans the row of rank k) and the candidate list (a
list of the join's candidate rows from each block's copy of Q or from
slices of Q after a barrier, filtered after each pass or refilled from Q
where it overflowed; each pass's rows split over the blocks into pieces
by their cells and a cost a piece, the pieces merged after the pass
barrier), whose invariant (no row at or above the next pass's bound is a
candidate, every row below it keeps its listed Q) it checks; its list
holds the kernel's LIST_K G rows unless a case sets another capacity. On
complete matrices it equals the plain loop bit for bit (every sum of
these matrices is exact, so the order of a sum cannot matter); with
missing cells the picks are equal and the limbs within 1e-12 of max(|x|,
1). With one grid barrier taken out, with a list that keeps the row at
the bound, a merge that breaks the tie rule, or a list too small taken
for the whole, it differs from the plain loop (or fails the invariant)
on some seeded state. On a caterpillar, where the row sums leave
float64's exact range, both stop at the same join, and the records
before it equal the JAX engine's. The wrapper's argument checks refuse
what the kernel does not take."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccphylo_tpu.tree.jax_engine as je
import ccphylo_tpu_torch.tree.torch_engine as te
from ccphylo_tpu_torch.ops import segment_float as sf

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)

JAX_KEYS = ("D", "sD", "N", "Q", "P", "seed", "I", "J", "LI", "LJ")
THREADS = 256  # threads of a block of dnj_segment_float_kernel
# the kernel's constants (csrc/dnj_segment_float.cu's kListK and
# kPieceUnits): the candidate list holds LIST_K G rows, a piece of a row
# costs PIECE_UNITS units beside its cells; the model takes others too
LIST_K, PIECE_UNITS = 1, 2048
DESIGNS = ("stage", "rows", "slices")  # the model's designs of the scan
NEG = -(1 << 30)  # the binary places of 0: below any bound


def int_matrix(n, seed, lo=0, hi=500, drop=0.0):
    rng = np.random.RandomState(seed)
    flat = rng.randint(lo, hi, n * (n - 1) // 2).astype(np.float64)
    if drop:
        flat[rng.rand(len(flat)) < drop] = -1.0
    return flat


def snp_matrix(n, seed, per_branch=4.0):
    """Integer SNP distances of taxa on a random tree: each new taxon
    copies the mutations of a random earlier one and adds a Poisson
    number of its own; the distance is the size of the symmetric
    difference (a near-additive matrix, as an outbreak's)."""
    rng = np.random.RandomState(seed)
    new = rng.poisson(per_branch, n) + 1
    total = int(new.sum())
    muts = np.zeros((n, total), np.int32)
    at = 0
    for k in range(n):
        if k:
            muts[k] = muts[rng.randint(k)]
        muts[k, at:at + new[k]] = 1
        at += new[k]
    D = (muts[:, None, :] != muts[None, :, :]).sum(axis=2)
    return D[np.tril_indices(n, -1)].astype(np.float64)


def caterpillar(n, seed=7):
    """D_ij = |i - j| plus integer noise in [0, 2]: joins along a chain,
    whose fractional bits pile up with depth."""
    rng = np.random.RandomState(seed)
    i, j = np.tril_indices(n, -1)
    return (i - j + rng.randint(0, 3, len(i))).astype(np.float64)


def padded(flat, n, dtype):
    npad = je._pad(n)
    D = np.full((npad, npad), -1.0, np.float64)
    D[:n, :n] = te.square_matrix(flat, n)
    return D.astype(dtype)


def jax_states(flat, n, dtype, neg_limbs, cuts):
    """The JAX engine's state (its padded arrays, as numpy) at every cut
    of a run on `flat`: {t: {name: array}}."""
    D = jnp.asarray(padded(flat, n, dtype))
    mj = jnp.int32(n)
    npad = D.shape[0]
    state = (D, *je._dnj_init(D, mj), jnp.zeros(npad, jnp.int32),
             jnp.zeros(npad, jnp.int32), jnp.zeros(npad, dtype),
             jnp.zeros(npad, dtype))
    out, done = {0: {k: np.array(v) for k, v in zip(JAX_KEYS, state)}}, 0
    for t in cuts:
        state = je._dnj_segment(*state, jnp.int32(done), jnp.int32(t), mj,
                                neg_limbs=neg_limbs, scan="batch")
        out[t] = {k: np.array(v) for k, v in zip(JAX_KEYS, state)}
        done = t
    return out


def port_state(d, exact=None):
    """The port's segment state (STATE_KEYS) on copies of the arrays of a
    JAX state `d`."""
    st = {k: torch.from_numpy(np.array(d[k])) for k in ("D", "sD", "Q")}
    for k in ("N", "P", "I", "J"):
        st[k] = torch.from_numpy(np.array(d[k], np.int32))
    for k in ("LI", "LJ"):
        st[k] = torch.from_numpy(np.array(d[k], np.asarray(d["D"]).dtype))
    st["seed"] = torch.tensor([int(d["seed"])], dtype=torch.int64)
    st["exact"] = exact
    st["first_inexact"] = torch.full((1,), -1, dtype=torch.int32)
    st["stats"] = torch.zeros(2, dtype=torch.int64)
    return st


def new_state(flat, n, dtype=torch.float64, exact_sums=False):
    """The port's own state after its init (te._new_state), with the
    exact range tracked if asked."""
    D = torch.from_numpy(te.square_matrix(flat, n)).to(dtype)
    st = te._new_state(D, n)
    st["exact"] = None
    if exact_sums:
        te.track_sums(st, n)
    return st


def run_plain(st, t0, t1, m, neg_limbs=False):
    sf.dnj_segment_float_plain(*(st[k] for k in sf.STATE_KEYS), t0, t1, m,
                               neg_limbs)


def bits(x):
    x = np.asarray(x)
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


def assert_like_jax(st, ref, t, m, rtol=0.0):
    """Records 0..t-1 and the active part of the state after join t-1
    (m - t active rows) against the JAX state `ref`: picks, N, P and the
    seed equal, every float bit-equal (within rtol of max(|x|, 1) if
    given)."""
    m_t = m - t

    def close(name, a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        if rtol:
            err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
            assert err.max(initial=0.0) <= rtol, (name, err.max())
        else:
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)

    for k in ("I", "J"):
        np.testing.assert_array_equal(st[k].numpy()[:t], ref[k][:t],
                                      err_msg=k)
    for k in ("LI", "LJ"):
        close(k, st[k].numpy()[:t], ref[k][:t])
    close("D", st["D"].numpy()[:m_t, :m_t], ref["D"][:m_t, :m_t])
    for k in ("sD", "Q"):
        close(k, st[k].numpy()[:m_t], ref[k][:m_t])
    np.testing.assert_array_equal(st["N"].numpy()[:m_t], ref["N"][:m_t])
    has = ref["Q"][:m_t] != np.finfo(ref["Q"].dtype).max
    np.testing.assert_array_equal(st["P"].numpy()[:m_t][has],
                                  ref["P"][:m_t][has])
    assert int(st["seed"]) == int(ref["seed"])


def _cuts(rng, m):
    """Random segment boundaries over [0, m - 2), one empty segment."""
    inner = sorted(set(rng.choice(np.arange(1, m - 2), 3).tolist()))
    return inner + [inner[-1], m - 2]


# ---------------------------------------------------------------------
# the plain loop against the JAX engine

CASES = {
    "snp": lambda: (snp_matrix(200, 1), 200),
    "ties": lambda: (int_matrix(150, 97, 0, 25), 150),
    "missing": lambda: (int_matrix(120, 31, 1, 60, drop=0.12), 120),
}


@pytest.mark.parametrize("case,dtype,neg_limbs", [
    ("snp", np.float64, False), ("ties", np.float64, False),
    ("missing", np.float64, False), ("ties", np.float64, True),
    ("ties", np.float32, False)])
def test_plain_matches_jax_engine(case, dtype, neg_limbs):
    """`dnj_segment_float_plain` over random segments of a run, from the
    JAX engine's state at each segment's start (padded: n = 256 or 128
    rows, m active), gives its state at the segment's end."""
    flat, m = CASES[case]()
    if dtype == np.float32:  # small cells: every float32 sum stays exact
        flat = np.minimum(flat, 20.0)
    rng = np.random.RandomState(m)
    cuts = _cuts(rng, m)
    states = jax_states(flat, m, dtype, neg_limbs, cuts)
    rtol = 1e-12 if case == "missing" else 0.0
    t0 = 0
    for t1 in cuts:
        st = port_state(states[t0])
        run_plain(st, t0, t1, m, neg_limbs)
        assert_like_jax(st, states[t1], t1, m, rtol)
        assert int(st["first_inexact"]) == -1
        t0 = t1
    if neg_limbs:
        LI, LJ = states[m - 2]["LI"], states[m - 2]["LJ"]
        assert min(LI[:m - 2].min(), LJ[:m - 2].min()) < 0


def test_state_carried_from_jax_mid_run(n=90, k=30, k2=70):
    """The JAX engine's state after k joins (128 rows, 90 active) runs on
    in one plain segment to k2, equal to the JAX engine's own."""
    flat = int_matrix(n, 44, 0, 40)
    states = jax_states(flat, n, np.float64, False, [k, k2])
    st = port_state(states[k])
    assert st["D"].shape[0] > n
    run_plain(st, k, k2, n)
    assert_like_jax(st, states[k2], k2, n)


# ---------------------------------------------------------------------
# a model of the kernel


class _Diverged(Exception):
    """The blocks reached different barriers: the card would hang."""


class _Broken(Exception):
    """An invariant of the kernel's design failed in the model."""


def _places(x, mant):
    """b with x = odd * 2**-b: the binary places x needs; NEG for 0."""
    if x == 0:
        return NEG
    frac, e = np.frexp(x)
    whole = int(abs(float(frac)) * 2.0 ** (mant + 1))
    return (mant + 1) - int(e) - ((whole & -whole).bit_length() - 1)


def _warp_tree(v, add):
    """Lane 0's value after the shuffle-down tree of 32 lanes."""
    v = list(v)
    for off in (16, 8, 4, 2, 1):
        v = [add(v[x], v[x + off]) for x in range(off)]
    return v[0]


def _block_part(parts, f):
    """block_part over the THREADS (sum, abs, places, count) partials of
    a block: the shuffle tree in each warp, then the warps in order."""
    add = lambda a, b: f(a + b)
    warps = [parts[w * 32:(w + 1) * 32] for w in range(THREADS // 32)]
    out = None
    for w in warps:
        p = (_warp_tree([x[0] for x in w], add),
             _warp_tree([x[1] for x in w], add),
             max(x[2] for x in w), sum(x[3] for x in w))
        out = p if out is None else (add(out[0], p[0]), add(out[1], p[1]),
                                     max(out[2], p[2]), out[3] + p[3])
    return out


def _best(pairs, big):
    """(min, largest index at it) of (value, index) pairs; (big, -1) for
    none."""
    v, x = big, -1
    for ov, ox in pairs:
        if ov < v or (ov == v and ox > x):
            v, x = ov, ox
    return v, x


def _row_min(D, sD, N, r, f, big, m_t):
    d = D[r, :r]
    ok = d >= 0
    if not ok.any():
        return big, m_t - 1
    coef = ((N[r] + N[:r] - 4) >> 1).astype(f)
    q = np.where(ok, (coef * d - sD[r]) - sD[:r], big)
    mn = q[ok].min()
    return mn, int(np.flatnonzero(ok & (q == mn)).max())


def _ltd_row(f):
    r = int((1 + np.sqrt(8.0 * f + 1)) / 2)
    while r > 1 and r * (r - 1) // 2 > f:
        r -= 1
    while (r + 1) * r // 2 <= f:
        r += 1
    return r


def _piece(D, sD, N, r, c0, c1, f, big):
    """(min, largest column at it) of row r's Q values over its cells
    [c0, c1); (big, -1) where none is present."""
    d = D[r, c0:c1]
    ok = d >= 0
    if not ok.any():
        return big, -1
    coef = ((N[r] + N[c0:c1] - 4) >> 1).astype(f)
    q = np.where(ok, (coef * d - sD[r]) - sD[c0:c1], big)
    mn = q[ok].min()
    return mn, c0 + int(np.flatnonzero(ok & (q == mn)).max())


def _scan_rows(k, S, sh, G, m_t, minv, pi, pj, cnt, drop):
    """The first design's passes (kRows): every block selects the row of
    rank k from Q and scans it whole.  Yields at the pass barrier;
    returns the pair and the running minimum."""
    D, sD, N, Q, P = S["D"], S["sD"], S["N"], S["Q"], S["P"]
    f = D.dtype.type
    big = np.finfo(f).max
    hi = m_t
    while True:
        h = max(hi, 1)
        rows = np.arange(1, h)[Q[1:h] < minv][::-1]
        total = len(rows)
        if total == 0:
            break
        valid = k < total
        r = int(rows[k]) if valid else -1
        qr = Q[r] if valid else big
        rmin, rarg = _row_min(D, sD, N, r, f, big, m_t) if valid \
            else (big, -1)
        par = cnt["par"]
        bv, bx, brow = sh["scan_v"][par], sh["scan_x"][par], \
            sh["scan_r"][par]
        bv[k], bx[k], brow[k] = rmin, rarg, r
        if drop != "pass":
            yield "pass"
        cnt["par"] ^= 1
        before = min([minv] + list(bv[:k]))
        best, bi, bj = big, -1, 0
        for b in range(G):
            if bv[b] < best or (bv[b] == best and brow[b] > bi):
                best, bi, bj = bv[b], int(brow[b]), int(bx[b])
        if valid and qr < before:
            Q[r], P[r] = rmin, rarg
            cnt["nreval"] += 1
        if best < minv:
            minv, pi, pj = best, bi, bj
        cnt["npass"] += 1
        if total <= G:
            break
        hi = int(brow[G - 1])
    return minv, pi, pj


def _scan_list(k, S, sh, G, m_t, minv, pi, pj, cnt, drop, design, cap,
               pw, mutant):
    """The default design's passes: the join's candidate list (from the
    block's copy of Q, or from every block's slice of Q after a barrier),
    each pass's rows split evenly over the blocks into pieces (a row
    weighs pw units, then one a cell), merged by every block after the
    pass barrier.  `mutant`: "hi" keeps the
    row at the next pass's bound in the list, "tie" merges a row's
    pieces first-wins, "overflow" takes a truncated list for the whole.
    Yields at the barriers; returns the pair and the running minimum."""
    D, sD, N, Q, P = S["D"], S["sD"], S["N"], S["Q"], S["P"]
    f = D.dtype.type
    big = np.finfo(f).max
    src = sh["Qs"][k] if design == "stage" else Q

    def candidates(q, hi):
        return [(r, q[r]) for r in range(hi - 1, 0, -1) if q[r] < minv]

    if design == "slices":
        top = m_t - 1
        sl = -(-top // G)
        ktop = top - k * sl
        sh["slices"][k] = [(r, Q[r]) for r in range(ktop, max(ktop - sl, 0),
                                                     -1) if Q[r] < minv]
        if drop != "list":
            yield "list"
        full = [e for b in range(G) for e in sh["slices"][b]]
    else:
        full = candidates(src, m_t)
    total, lst = len(full), full[:cap]
    over = total > cap and mutant != "overflow"
    while total:
        R = min(G, total)
        rows = [r for r, _ in lst[:R]]
        cum = [0]
        for r in rows:
            cum.append(cum[-1] + pw + r)
        lo, hk = k * cum[-1] // G, (k + 1) * cum[-1] // G
        tag, slots = cnt["tag"], sh["pieces"][cnt["par"]]
        for x in range(R):
            at = cum[x] + pw  # the unit of the row's cell 0
            a, b = max(lo, at), min(hk, cum[x + 1])
            if a < b:
                v, c = _piece(D, sD, N, rows[x], a - at, b - at, f, big)
                slots[x + k] = (v, c, rows[x], tag)
        if drop != "pass":
            yield "pass"
        myr = rows[k] if k < R else None
        bv, brow, bcol, mv, mcol, before = big, -1, 0, big, -1, minv
        for v, c, r, tg in slots[:R + G - 1]:
            if tg != tag:
                continue
            if v < bv or (v == bv and (r > brow or (r == brow and c > bcol))):
                bv, brow, bcol = v, r, c
            if r == myr:
                if v < mv or (v == mv and c > mcol and mutant != "tie"):
                    mv, mcol = v, c
            elif myr is not None and r > myr:
                before = min(before, v)
        if k < R and lst[k][1] < before:
            Q[myr], P[myr] = mv, (mcol if mv != big else m_t - 1)
            cnt["nreval"] += 1
        if bv < minv:
            minv, pi, pj = bv, brow, bcol
        cnt["npass"] += 1
        cnt["tag"] += 1
        cnt["par"] ^= 1
        if total <= G:
            break
        hi = rows[G - 1]
        # the kernel's argument that the list needs no row at or above hi
        # and no new Q: the row of rank k, written back or not, is no
        # candidate of the next pass, nor is a row at or above hi that the
        # pass did not scan; every row below hi keeps its listed Q
        if mutant is None and not (
                (k >= R or Q[rows[k]] >= minv)
                and all(Q[r] >= minv for r in range(hi, m_t)
                        if r not in rows)
                and all(Q[r] == q for r, q in full if r < hi)):
            raise _Broken(f"the list's invariant at hi = {hi}, block {k}")
        if not over:
            keep = lst[G - 1:] if mutant == "hi" else lst[G:]
            lst = [(r, q) for r, q in keep if q < minv]
            total = len(lst)
        else:  # the list held the first cap only: Q again below hi
            full = candidates(src, hi)
            total, lst = len(full), full[:cap]
            over = total > cap
            if k == 0:
                sh["refills"] += 1
    return minv, pi, pj


def _block(k, S, sh, t0, t1, m, G, neg_limbs, complete, rng, drop,
           design, cap, pw, mutant):
    """The program of block k of dnj_segment_float_kernel on the numpy
    state S (shared by the blocks, as device memory is; sh holds the
    scratch and each block's copy of Q), in the design `design` ("rows",
    "stage" or "slices") with a list of `cap` rows and pieces of `pw`
    units.  Yields the name of
    each grid barrier it reaches; `drop` names one to leave out;
    `mutant` (see `_scan_list`) changes the list's rules."""
    D, sD, N, Q, P = S["D"], S["sD"], S["N"], S["Q"], S["P"]
    f = D.dtype.type
    mant = 52 if f == np.float64 else 23
    big = np.finfo(f).max
    two = f(2)
    lead = k == 0
    track = S["exact"] is not None
    exact = bool(S["exact"]) if track else True
    stop = -1
    seed = int(S["seed"][0])
    qs = Q[seed]
    nxt = (qs, seed, int(P[seed])) if seed != 0 and qs != big \
        else (big, 0, 0)
    cnt = {"par": 0, "npass": 0, "nreval": 0, "tag": 1}
    if design == "stage":  # the launch's first copy of Q
        sh["Qs"][k] = Q.copy()

    def threads(lo, hi):
        """The cells of each thread of the chunk [lo, hi), tiles
        ascending, the threads in a random order."""
        own = {}
        for kk in range(lo, hi):
            own.setdefault((kk - lo) % THREADS, []).append(kk)
        keys = list(own)
        return [own[keys[x]] for x in rng.permutation(len(keys))]

    for t in range(t0, t1):
        m_t = m - t
        last = m_t - 1
        minv, pi, pj = nxt

        # ---- the scan's passes
        if design == "rows":
            minv, pi, pj = yield from _scan_rows(k, S, sh, G, m_t, minv, pi,
                                                 pj, cnt, drop)
        else:
            minv, pi, pj = yield from _scan_list(k, S, sh, G, m_t, minv, pi,
                                                 pj, cnt, drop, design, cap,
                                                 pw, mutant)

        i, j = pi, pj
        if i == 0 and j == 0:  # no joinable pair
            if lead:
                S["I"][t] = S["J"][t] = 0
                S["LI"][t] = S["LJ"][t] = -1
            if drop != "nopair":
                yield "nopair"
            Q[last] = big
            if design == "stage":  # the next join's copy, patched
                sh["Qs"][k] = Q.copy()
                sh["Qs"][k][last] = big
            seed, nxt = 0, (big, 0, 0)
            continue

        # ---- limbs
        Dij, sDi, sDj = D[i, j], sD[i], sD[j]
        Ni, Nj = int(N[i]) - 2, int(N[j]) - 2
        if track and not exact:
            stop = t
            break
        if Ni > 0 and Nj > 0:
            delta = (sDi - Dij) / f(Ni) - (sDj - Dij) / f(Nj)
            Li, Lj = (Dij + delta) / two, (Dij - delta) / two
        elif Ni > 0:
            Li, Lj = f(0), Dij
        elif Nj > 0:
            Li, Lj = Dij, f(0)
        else:
            Li = Lj = Dij / two
        if not neg_limbs:
            if Li < 0:
                Li, Lj = f(0), Dij
            elif Lj < 0:
                Li, Lj = Dij, f(0)
        if lead:
            S["I"][t], S["J"][t], S["LI"][t], S["LJ"][t] = i, j, Li, Lj

        chunk = -(-m_t // G)
        lo = min(k * chunk, m_t)
        hk = min(lo + chunk, m_t)
        parts = [(f(0), f(0), NEG, 0)] * THREADS

        def d2_of(dik, dkj):
            d2 = ((dik + dkj) - Dij) / two
            return f(0) if d2 < 0 else d2

        if complete:
            # (A) both cells present everywhere
            for cells in threads(lo, hk):
                p = (f(0), f(0), NEG, 0)
                for kk in cells:
                    if kk in (i, j):
                        continue
                    dik, dkj = D[i, kk], D[j, kk]
                    d2 = d2_of(dik, dkj)
                    sD[kk] = sD[kk] + -((dik + dkj) - d2)
                    N[kk] -= 1
                    D[j, kk] = D[kk, j] = d2
                    p = (p[0] + d2, p[1] + abs(d2),
                         max(p[2], _places(d2, mant)), p[3] + 1)
                parts[(cells[0] - lo) % THREADS] = p
        else:
            # (A0) row j as it was; the advancing cells on each side of j
            oldj = sh["oldj"]
            cr = cc = 0
            for cells in threads(lo, hk):
                for kk in cells:
                    oldj[kk] = D[j, kk]
                    adv = kk not in (i, j) and (D[i, kk] >= 0
                                                 or oldj[kk] >= 0)
                    cr += adv and kk < j
                    cc += adv and kk > j
            sh["adv_r"][k], sh["adv_c"][k] = cr, cc
            if drop != "A0":
                yield "A0"

            # (A) updateD with its walker slots
            nr = int(sh["adv_r"].sum())
            wr = int(sh["adv_r"][:k].sum())
            wc = int(sh["adv_c"][:k].sum())
            slot = {}
            for kk in range(lo, hk):  # exclusive counts, in cell order
                ok = kk not in (i, j)
                adv = ok and (D[i, kk] >= 0 or oldj[kk] >= 0)
                slot[kk] = (wr, wc)
                wr += adv and kk < j
                wc += adv and kk > j
            offj = j * (j - 1) // 2

            def stored_of(rr):
                ri, oj = D[i, rr], oldj[rr]
                if ri >= 0 and oj >= 0:
                    return d2_of(ri, oj)
                return ri - Li if ri >= 0 else (oj - Lj if oj >= 0 else oj)

            for cells in threads(lo, hk):
                p = (f(0), f(0), NEG, 0)
                for kk in cells:
                    if kk in (i, j):
                        continue
                    dik, dkj = D[i, kk], oldj[kk]
                    vi, vj = dik >= 0, dkj >= 0
                    stored = stored_of(kk)
                    contrib = stored
                    if vj and not vi and kk > j:  # the garbage read
                        fl = offj + kk
                        rr = _ltd_row(fl)
                        c = fl - rr * (rr - 1) // 2
                        if c != j:
                            garb = D[rr, c]
                        elif rr == kk:
                            garb = stored
                        else:
                            garb = oldj[rr]
                            if rr < kk and rr != i and (D[i, rr] >= 0
                                                        or oldj[rr] >= 0):
                                garb = stored_of(rr)
                        contrib = stored - garb
                    if vi or vj:
                        wr_k, wc_k = slot[kk]
                        tgt = wr_k if kk < j else nr + 1 + (kk > i) + wc_k
                        if tgt != j:
                            if vi and vj:
                                delta = -((dik + dkj) - d2_of(dik, dkj))
                            elif vi:
                                delta = -Li
                            else:
                                delta = -Lj if kk < j else contrib
                            sD[tgt] = sD[tgt] + delta
                            if vj:
                                N[tgt] -= 1
                        p = (p[0] + contrib, p[1] + abs(contrib),
                             max(p[2], _places(contrib, mant)), p[3] + 1)
                    D[j, kk] = D[kk, j] = stored
                parts[(cells[0] - lo) % THREADS] = p
        sh["part"][k] = _block_part(parts, f)
        if drop != "A":
            yield "A"

        # (B) sD[j], N[j], the exact flag; repairs; popArrange
        tot = [(f(0), f(0), NEG, 0)] * THREADS
        for b in range(G):
            s, a, pl, c = sh["part"][b]
            tot[b] = (f(0) + s, f(0) + a, pl, c)
        sdj, sabs, places, count = _block_part(tot, f)
        nj = 1 + count
        if track:
            exact = exact and places <= mant - np.frexp(sabs + f(1))[1]
        pop = i != last
        sdl, nl = sD[last], int(N[last])
        if lead:
            sD[j], N[j] = sdj, nj
            if pop:
                sD[i], N[i] = sdl, nl
        red = [[] for _ in range(4)]  # row j, column j, row i, column i
        for cells in threads(lo, hk):
            for kk in cells:
                if kk == i:
                    if pop:
                        D[i, i] = 0
                    continue
                sk = sdj if kk == j else sD[kk]
                nk = nj if kk == j else int(N[kk])
                qk = big
                if kk != j:
                    cj = D[j, kk]
                    q = (f((nj + nk - 4) >> 1) * cj - sdj) - sk
                    if kk < j:
                        if cj >= 0:
                            red[0].append((q, kk))
                    else:
                        qk = Q[kk]
                        if cj >= 0 and q <= qk:
                            Q[kk] = qk = q
                            P[kk] = j
                            red[1].append((q, kk))
                if pop:
                    v = f(-1) if kk == last else D[last, kk]
                    D[i, kk] = D[kk, i] = v
                    if v >= 0 and kk < last:
                        q = (f((nl + nk - 4) >> 1) * v - sdl) - sk
                        if kk < i:
                            red[2].append((q, kk))
                        elif q <= qk:
                            Q[kk] = q
                            P[kk] = i
                            red[3].append((q, kk))
        sh["red"][k] = [_best(x, big) for x in red]
        if drop != "B":
            yield "B"
        if design == "stage":  # the next join's copy, patched below
            Qs = sh["Qs"][k] = Q.copy()

        # (C) in every block: the reductions, Q and P of j and i, the seed
        (Qj, xj), (qcj, xcj), (Qi, xi), (qci, xci) = (
            _best([sh["red"][b][x] for b in range(G)], big)
            for x in range(4))
        Q[j], P[j] = Qj, 0 if Qj == big else xj
        mi = xcj if xcj >= 0 and qcj <= Qj else j
        mj = 0
        if pop:
            Q[i], P[i] = Qi, 0 if Qi == big else xi
            mj = xci if xci >= 0 and qci <= Qi else i
        Q[last] = big
        if design == "stage":
            Qs[j] = Q[j]
            if pop:
                Qs[i] = Q[i]
            Qs[last] = big
        qmj, qmi = Q[mj], Q[mi]
        if mj == last:
            seed = mi
        elif mi == last:
            seed = mj
        else:
            seed = mj if qmj < qmi or (mi < mj and qmj == qmi) else mi
        qs = Q[seed]
        nxt = (qs, seed, int(P[seed])) if seed != 0 and qs != big \
            else (big, 0, 0)
    S["stats"][1] += cnt["nreval"]
    if lead:
        S["stats"][0] += cnt["npass"]
        S["seed"][0] = seed
        if track:
            S["exact"][...] = exact
        if stop >= 0:
            S["first_inexact"][0] = stop


def segment_model(S, t0, t1, m, G, rng, neg_limbs=False, drop=None,
                  design="stage", cap=None, pw=PIECE_UNITS, mutant=None):
    """csrc/dnj_segment_float.cu's launch over joins [t0, t1) on the
    numpy state S, in place, in the design `design` with a list of
    `cap` rows (the kernel's LIST_K G if None) and pieces of `pw` units:
    G blocks, each run up to its next grid barrier in a random order of
    the blocks; raises _Diverged where the blocks reach different
    barriers.  Returns the list's refills."""
    cap = LIST_K * G if cap is None else cap
    f = S["D"].dtype.type
    big = np.finfo(f).max
    complete = bool((S["D"][:m, :m] >= 0).all())
    sh = {"scan_v": np.zeros((2, G), f), "scan_x": np.zeros((2, G), int),
          "scan_r": np.zeros((2, G), int),
          "part": [(f(0), f(0), NEG, 0)] * G,
          "red": [[(big, -1)] * 4] * G,
          "oldj": np.zeros(S["D"].shape[0], f),
          "adv_r": np.zeros(G, int), "adv_c": np.zeros(G, int),
          "pieces": [[(big, -1, -1, 0)] * (2 * G) for _ in range(2)],
          "slices": [[] for _ in range(G)], "Qs": [None] * G,
          "refills": 0}
    live = [_block(k, S, sh, t0, t1, m, G, neg_limbs, complete, rng, drop,
                   design, cap, pw, mutant)
            for k in range(G)]
    while live:
        reached, nxt = set(), []
        for x in rng.permutation(len(live)):
            try:
                reached.add(next(live[x]))
                nxt.append(live[x])
            except StopIteration:
                reached.add(None)
        if len(reached) > 1:
            raise _Diverged(reached)
        live = nxt
    return sh["refills"]


def model_state(st):
    return {k: (None if st[k] is None else st[k].numpy().copy())
            for k in sf.STATE_KEYS}


def assert_model_equals_plain(S, st, msg, rtol=0.0):
    """Every state array of the model against the plain loop's: bit for
    bit, or (rtol) picks, N, P, the flags and the stats equal and the
    floats within rtol of max(|x|, 1)."""
    for k in sf.STATE_KEYS:
        if st[k] is None:
            assert S[k] is None, k
            continue
        a, b = np.asarray(S[k]), st[k].numpy()
        if rtol and a.dtype.kind == "f":
            ok = np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1.0)
            assert ok.all(), f"{k} {msg}: {np.abs(a - b).max()}"
        else:
            np.testing.assert_array_equal(bits(a) if a.dtype.kind == "f"
                                          else a, bits(b)
                                          if b.dtype.kind == "f" else b,
                                          err_msg=f"{k} {msg}")


def run_both(flat, n, G, seed, monkeypatch, dtype=torch.float64,
             neg_limbs=False, exact_sums=False, rtol=0.0, design="stage",
             cap=None, pw=PIECE_UNITS):
    """The model (in `design`, with a list of `cap` rows, the kernel's
    if None, and pieces of `pw` units) and the plain loop (batch K = G,
    so their pass counts agree) over random segments of one run,
    compared at every boundary.  Returns both states; the model's
    refills of the list are in run_both.refills."""
    monkeypatch.setattr(te, "KBATCH", G)
    rng = np.random.default_rng(seed)
    st = new_state(flat, n, dtype, exact_sums)
    S = model_state(st)
    t0, refills = 0, 0
    for t1 in _cuts(np.random.RandomState(seed), n):
        refills += segment_model(S, t0, t1, n, G, rng, neg_limbs,
                                 design=design, cap=cap, pw=pw)
        run_plain(st, t0, t1, n, neg_limbs)
        assert_model_equals_plain(S, st, f"after [{t0}, {t1})", rtol)
        if int(st["first_inexact"]) >= 0:
            break
        t0 = t1
    run_both.refills = refills
    return S, st


def _designs(*cases):
    """`cases` (tuples of parameters) in each of DESIGNS, the design
    first; the default design's ids are the cases' own."""
    return [pytest.param(d, *c, id="-".join(
        [*map(str, c), *([d] if d != "stage" else [])]))
        for c in cases for d in DESIGNS]


@pytest.mark.parametrize("design,case,G", _designs(("snp", 5), ("ties", 2),
                                                   ("ties", 24)))
def test_kernel_model_matches_plain(design, case, G, monkeypatch):
    """The kernel's decomposition on complete integer matrices equals the
    plain loop bit for bit at every boundary, whatever order the blocks
    and threads run in, in each design (the list the kernel's, LIST_K G
    rows, so it overflows and is topped up)."""
    flat, n = CASES[case]()
    flat, n = flat[:80 * 79 // 2], 80  # the first 80 taxa
    S, st = run_both(flat, n, G, G, monkeypatch, design=design)
    assert int(st["stats"][0]) > 0 and int(st["stats"][1]) > 0
    assert design == "rows" or G == 24 or run_both.refills > 0


@pytest.mark.parametrize("design", DESIGNS)
def test_kernel_model_float32_and_negative_limbs(design, monkeypatch):
    """float32 state (cells below 20, sums within 24 bits) with negative
    limbs kept."""
    flat = np.minimum(int_matrix(80, 5, 0, 40), 20.0)
    S, _ = run_both(flat, 80, 7, 3, monkeypatch, dtype=torch.float32,
                    neg_limbs=True, design=design)
    assert min(S["LI"][:78].min(), S["LJ"][:78].min()) < 0


@pytest.mark.parametrize("design", DESIGNS)
def test_kernel_model_with_missing_cells(design, monkeypatch):
    """The instance with missing cells (walker slots, garbage reads):
    picks, N and P equal, sums and limbs within 1e-12 of max(|x|, 1);
    the run meets one-sided updates on both sides of j."""
    flat = int_matrix(90, 31, 1, 60, drop=0.12)
    run_both(flat, 90, 5, 11, monkeypatch, rtol=1e-12, design=design)


@pytest.mark.parametrize("design", DESIGNS)
def test_caterpillar_stops_at_the_same_join(design, monkeypatch, n=64):
    """With the exact range tracked, the model and the plain loop stop at
    the same join of a caterpillar (its cells reach 52 fractional bits);
    their records before it equal the JAX engine's."""
    flat = caterpillar(n)
    S, st = run_both(flat, n, 5, 2, monkeypatch, exact_sums=True,
                     design=design)
    stop = int(st["first_inexact"])
    assert 0 < stop < n - 2 and int(S["first_inexact"][0]) == stop
    assert not bool(st["exact"])
    with pytest.raises(te.InexactSums) as e:
        te.dnj_joins(torch.from_numpy(te.square_matrix(flat, n)), n,
                     exact_sums=True)
    assert e.value.join == stop
    ref = je.dnj_joins(jnp.asarray(padded(flat, n, np.float64)),
                       jnp.int32(n), scan="batch")
    for k, want in zip(("I", "J", "LI", "LJ"), ref[:4]):
        np.testing.assert_array_equal(bits(S[k][:stop]) if k[0] == "L"
                                      else S[k][:stop],
                                      bits(np.asarray(want)[:stop])
                                      if k[0] == "L"
                                      else np.asarray(want)[:stop],
                                      err_msg=k)


@pytest.mark.parametrize("design,case,G,cap,pw", [
    ("slices", "snp", 5, 2048, 0), ("slices", "ties", 3, 2048, 16),
    ("stage", "ties", 4, 4, 0), ("slices", "ties", 4, 6, 2048),
    ("stage", "snp", 7, 2048, 5)])
def test_kernel_model_designs_match_plain(design, case, G, cap, pw,
                                          monkeypatch):
    """The candidate-list designs equal the plain loop bit for bit on
    complete integer matrices with other values of the kernel's
    constants (which chip_smoke.py times in turns): lists that hold
    every candidate (no top-up) or very few (refilled from Q after each
    pass, with the copy of Q in shared memory or from slices), and the
    pass's rows split by their cells alone (pw = 0) or with another
    cost a piece."""
    flat, n = CASES[case]()
    flat, n = flat[:80 * 79 // 2], 80
    run_both(flat, n, G, G + 1, monkeypatch, design=design, cap=cap, pw=pw)
    assert (run_both.refills > 0) == (cap < 2048)


def _model_differs(monkeypatch, G, **kw):
    """Whether the model (`segment_model`'s keywords `kw`) differs from
    the plain loop, its blocks reach different barriers or an invariant
    of the design fails, on at least one of a few seeded states of a
    40-taxon run."""
    monkeypatch.setattr(te, "KBATCH", G)
    rng = np.random.default_rng(17)
    for case in range(6):
        flat = int_matrix(40, 60 + case, 0, 25,
                          drop=0.15 if kw.get("drop") == "A0" else 0.0)
        st = new_state(flat, 40)
        t0 = int(rng.integers(0, 20))
        run_plain(st, 0, t0, 40)
        S = model_state(st)
        try:
            segment_model(S, t0, 38, 40, G, rng, **kw)
        except (_Diverged, _Broken):
            return True
        run_plain(st, t0, 38, 40)
        if any(not np.array_equal(np.asarray(S[k]), st[k].numpy())
               for k in sf.STATE_KEYS if st[k] is not None):
            return True
    return False


@pytest.mark.parametrize("design,fault", _designs(
    ("pass",), ("A",), ("B",), ("A0",))
    + [pytest.param("slices", "list", id="list")])
def test_kernel_model_sees_a_missing_barrier(design, fault, monkeypatch):
    """Without one of the kernel's grid barriers the model differs from
    the plain loop (or its blocks reach different barriers, where the
    card would hang) on at least one of a few seeded states, in each
    design; "list", the barrier after the candidate list's slices, in
    that design."""
    assert _model_differs(monkeypatch, 4, drop=fault, design=design), \
        f"the model without barrier {fault} matched the plain loop on " \
        "every state"


@pytest.mark.parametrize("mutant,cap", [("hi", 2048), ("tie", 2048),
                                        ("overflow", 4)])
def test_kernel_model_sees_a_broken_list(mutant, cap, monkeypatch):
    """The default design's rules hold: a list that keeps the row at the
    next pass's bound ("hi"), a merge of a row's pieces that keeps the
    first column at a tie instead of the last ("tie"), and a list too
    small for a join's candidates taken for the whole ("overflow") each
    make the model differ from the plain loop on some seeded state."""
    kw = dict(cap=cap, pw=0)  # pw = 0: rows split over blocks
    assert not _model_differs(monkeypatch, 4, **kw)  # intact: equal
    assert _model_differs(monkeypatch, 4, mutant=mutant, **kw), \
        f"the model with mutant {mutant} matched the plain loop on every " \
        "state"


# ---------------------------------------------------------------------
# the wrapper


def _args(n=64, dtype=torch.float64):
    v = {k: torch.zeros(n, dtype=dtype) for k in ("sD", "Q", "LI", "LJ")}
    v.update({k: torch.zeros(n, dtype=torch.int32)
              for k in ("N", "P", "I", "J")})
    return dict(D=torch.zeros((n, n), dtype=dtype),
                seed=torch.zeros(1, dtype=torch.int64), exact=None,
                first_inexact=torch.zeros(1, dtype=torch.int32),
                stats=torch.zeros(2, dtype=torch.int64), **v)


@pytest.mark.parametrize("bad,match", [
    (dict(D=torch.zeros((64, 64), dtype=torch.float16)), "D: expected"),
    (dict(Q=torch.zeros(64, dtype=torch.float32)), "Q: expected"),
    (dict(N=torch.zeros(64, dtype=torch.int64)), "N: expected"),
    (dict(D=torch.zeros((64, 128))[:, ::2]), "D: expected"),
    (dict(LJ=torch.zeros(63, dtype=torch.float64)), "bad shapes"),
    (dict(D=torch.zeros((64, 65), dtype=torch.float64)), "bad shapes"),
    (dict(stats=torch.zeros(4, dtype=torch.int64)), "bad shapes"),
    (dict(seed=torch.zeros(1, dtype=torch.int32)), "seed: expected"),
    (dict(exact=torch.ones(1, dtype=torch.int32)), "exact: expected"),
    (dict(exact=torch.ones(2, dtype=torch.bool)), "bad shapes"),
    (dict(first_inexact=torch.zeros(2, dtype=torch.int32)), "bad shapes"),
    (dict(K=0), "K = 0"),
    (dict(K=133), "K = 133"),
    (dict(max_blocks=-2), "K = 128"),
])
def test_wrapper_checks_cuda_arguments(bad, match):
    """The checks of the CUDA route (run once a run, by
    `dnj_segment_float_prepare`) refuse what the kernel does not take;
    on the CPU the wrapper runs the plain version and never reaches
    them."""
    a = _args()
    lim = dict(K=128, max_blocks=132)
    for k, v in bad.items():
        (lim if k in lim else a)[k] = v
    with pytest.raises(ValueError, match=match):
        sf.check_segment_float_args(*(a[k] for k in sf.STATE_KEYS), **lim)
    ok = _args(dtype=torch.float32)
    ok["exact"] = torch.ones((), dtype=torch.bool)
    sf.check_segment_float_args(*(ok[k] for k in sf.STATE_KEYS), K=132,
                                max_blocks=132)


@pytest.mark.parametrize("bad,match", [
    (dict(sD=torch.zeros(65, dtype=torch.float64)[1:]), "16-byte aligned"),
    (dict(K=257, max_blocks=300), "K = 257"),
    (dict(D=torch.zeros(64 * 64 + 1, dtype=torch.float64)[1:].view(64, 64)),
     "16-byte aligned"),
    (dict(Q=torch.zeros(65, dtype=torch.float64)[1:]), "16-byte aligned")])
def test_wrapper_checks_list_and_alignment(bad, match):
    """The candidate-list design's checks: K <= 256 (a block scans one
    entry of the list a thread), and the tensors its vector loads and
    its copy of Q read are 16-byte aligned."""
    a = _args()
    lim = dict(K=128, max_blocks=132, rows=False)
    for k, v in bad.items():
        (lim if k in lim else a)[k] = v
    with pytest.raises(ValueError, match=match):
        sf.check_segment_float_args(*(a[k] for k in sf.STATE_KEYS), **lim)


def test_default_design_by_size():
    """The design a run takes by default, from the two timed in turns:
    the first (ROWS) below ROWS_BELOW taxa, else the candidate list,
    from a copy of Q in shared memory up to STAGE_Q_ROWS rows; flags
    given explicitly are kept."""
    assert sf.default_design(2048, 2048) == sf.ROWS
    assert sf.default_design(4096, sf.ROWS_BELOW - 1) == sf.ROWS
    assert sf.default_design(4096, 4096) == sf.STAGE_Q
    assert sf.default_design(sf.STAGE_Q_ROWS, sf.STAGE_Q_ROWS) == sf.STAGE_Q
    assert sf.default_design(32768, 32768) == 0
    D = torch.zeros((10, 10), dtype=torch.float64)
    assert sf.prepare_flags(D, 10) == sf.ROWS | sf.COMPLETE
    assert sf.prepare_flags(D.float(), 10, sf.STAGE_Q) \
        == sf.STAGE_Q | sf.COMPLETE | sf.FLOAT32


def test_instance_flags():
    """The instance: float32 or not, complete over the m active taxa
    (the padding of a carried state does not count) or not."""
    D = torch.from_numpy(padded(int_matrix(10, 1, 0, 9), 10, np.float64))
    assert sf.instance_flags(D, 10) == sf.COMPLETE
    assert sf.instance_flags(D.float(), 10) == sf.COMPLETE | sf.FLOAT32
    D[3, 5] = D[5, 3] = -1.0
    assert sf.instance_flags(D, 10) == 0
    assert sf.instance_flags(D, 4) == sf.COMPLETE


def test_dnj_joins_runs_one_call_per_segment(monkeypatch, n=40):
    """dnj_joins(scan="batch") calls dnj_segment_float once per segment
    of tree/segmenting.py, and its records equal the plain per-join
    loop's (scan="seq" takes the same trajectory)."""
    from ccphylo_tpu_torch.tree import segmenting
    calls = []
    real = sf.dnj_segment_float
    monkeypatch.setattr(sf, "dnj_segment_float",
                        lambda *a, **k: calls.append(a[13:15]) or real(*a,
                                                                       **k))
    monkeypatch.setattr(segmenting, "SEG", 16)
    flat = int_matrix(n, 8, 0, 30)
    D = torch.from_numpy(te.square_matrix(flat, n))
    ours = te.dnj_joins(D.clone(), n)
    assert calls == [(0, 16), (16, 32), (32, 38)]
    seq = te.dnj_joins(D.clone(), n, scan="seq")
    for a, b in zip(ours[:4], seq[:4]):
        np.testing.assert_array_equal(bits(a) if a.dtype.kind == "f" else a,
                                      bits(b) if b.dtype.kind == "f" else b)


@pytest.mark.parametrize("n,tile", [(1, 8), (2, 8), (37, 1024), (37, 8),
                                    (40, 8)])
def test_square_matrix_mirrors_the_flat_triangle(n, tile, monkeypatch):
    """The host square matrix of the float routes, built by row copies
    and mirrored tiles (8 rows here, so that a matrix spans several),
    equals the scatter through tril_indices: row i holds the flat cells
    of row i, the upper triangle mirrors it, the diagonal is 0, missing
    cells stay -1."""
    monkeypatch.setattr(te, "_TILE", tile)
    flat = int_matrix(n, n, -1, 9) if n > 1 else np.zeros(0)
    want = np.full((n, n), 7.0)
    iu = np.tril_indices(n, -1)
    want[iu] = flat
    want[iu[1], iu[0]] = flat
    np.fill_diagonal(want, 0.0)
    got = te.square_matrix(flat, n, 7.0)
    np.testing.assert_array_equal(bits(got), bits(want))
