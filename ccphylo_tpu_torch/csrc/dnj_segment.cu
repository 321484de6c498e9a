// A segment of joins of the packed DNJ engine in one persistent
// launch (Hopper, sm_90a).
//
// Replaces the reference's device loop of joins `_packed_segment`
// (ccphylo_tpu/tree/packed_engine.py:450-458): its join `one_join`
// (:151-345), the batch scan's while_loop with the Pallas kernel it
// calls per pass (ccphylo_tpu/ops/scan_pallas.py:49), then the jnp join
// body.  Its plain form is ops/segment.py::dnj_segment_plain, the loop
// over the joins of ops/scan.py::dnj_scan_plain then
// ops/join.py::dnj_join_plain; the scan's passes and the body's phases
// below run in one launch.
//
// What it computes: joins t in [t0, t1), with m_t = m - t active rows,
// co = 2 (m_t - 2), co_post = 2 (m_t - 3), last = m_t - 1, all on the
// card.  Per join: the scan's passes from the seed row to the pair
// (i, j), every pass's write-back of (Q[r], P[r]); then the body:
// records at row t, updateD, the cache repairs of rows and columns j
// and i, popArrange, Q[last] = IBIG, the seed of the next join.
// stats[0] += passes and stats[1] += rows whose Q changed, once at the
// end.  The state arrays after the launch are bit-equal to the plain
// loop's.
//
// The scan.  Q[r] caches the minimum of row r's join criterion and P[r]
// its column; the caches may be stale (too low).  From the seed row's
// (minv, pi, pj), while some row r in [1, m_t) has Q[r] < minv: take the
// K largest such rows, in descending order; compute each row's true
// (rmin, rarg) as qrow_mins does; write it back to (Q[r], P[r]) where
// Q[r] undercuts the running minimum of minv and the rmin of the rows
// before it in that order (the C's cache rule); lower (minv, pi, pj) to
// the pass's smallest rmin, ties to the larger row.  Two facts shape
// it.  (a) A scanned row ends its pass with Q[r] >= the new minv, and
// minv only falls, so within a join no row is a candidate twice: the
// next pass's candidates lie below this pass's smallest selected row,
// and there is a next pass only if this one found more than K; so a
// walk reads only Q entries that no pass of the join has written, and
// the changed rows are counted where they are written.  (b) Block k
// needs only the candidate of rank k and the total, both functions of
// (Q below the bound, minv), so every block selects for itself: each
// warp counts the candidates of its own stripe of Q in 16-byte loads,
// top stripe first, and the warp whose stripe holds rank k walks it
// again with ballots to find the row.
//
// The body, thread g owning k = g, g + G kThreads, ... in every phase
// (so a cell or cache entry one phase writes and the next reads is read
// by its owner, and the column-j update of Q[k] precedes the column-i
// update of the same Q[k] in program order): (A) the records, updateD
// of row and column j and of sD2[k], a per-block partial of sum d;
// grid barrier (row and column j written before row `last` is read and
// before column i overwrites D[j][i]; every sD2[k] final before the
// repairs read it); (B) sD2[j] from the partials, sD2[i] = sD2[last],
// the repairs of row and column j, the row move with the repairs of row
// and column i, each with per-block partials (minimum, largest index at
// it) of the four reductions; grid barrier; (C) the reductions, Q and P
// of rows j and i, Q[last] = IBIG, the seed.  Sums and (min, largest
// index) reductions are exact in any order, so the result is bit-equal
// to the plain version whatever the blocks' order.
//
// What bounded a join of two cooperative launches on Hopper (the design
// this kernel replaced: a scan kernel wrote the pair (i, j) to the card,
// a join-body kernel read it there; PERF.md §6): not
// bytes (a join moves ~30 m_t bytes and reads Q per pass; microseconds
// of HBM time at m_t = 32768) but latency: two cooperative launches, a
// memset and a Python loop step per join on the host (32-64 us of
// enqueue a join), and on the card the grid barriers and chains of
// dependent loads.  What the design does about each:
//  - launches: one cooperative launch of G = K blocks (the scan's
//    batch) runs the whole segment; the host does nothing between
//    fences.  Thread g of the body owns k = g, g + G kThreads, ...
//  - barriers: one per scan pass and two per join (after the body's
//    phases A and B); none between the scan and the body (every block
//    holds the pass's reduction, so (i, j)), none after phase C: every
//    block reduces the body's partials itself, writes the same Q[j],
//    P[j], Q[i], P[i], Q[last] and takes the same seed.  A join with no
//    joinable pair (never on a real run) takes one barrier before it
//    writes Q[last].  The barrier is cooperative groups' grid.sync(): a
//    hand-written one (an arrival counter and a generation word) was
//    bit-equal and 3-11% slower on an H100 (PERF.md).
//  - dependent loads: with kStageQ, Q for the next join is brought into
//    shared memory by one bulk copy (cp.async.bulk, the 1-D TMA, on an
//    mbarrier) started right after the body's second barrier, while the
//    block reduces phase C; the block then patches the three entries
//    phase C writes.  Every walk of every pass reads shared memory (a
//    pass reads only entries below the rows of the pass before, which
//    no pass of the join has written, so one copy serves the join).
//    Without it the walks read Q through L2.  Q needs 4 n bytes of
//    shared memory: the wrapper drops kStageQ above 57,824 rows.
//    Counting each group's candidates in the first walk, so that the
//    second could skip to the right group, was slower (PERF.md).
//  - the loads of a phase are all in flight before any is used: the pass's
//    reduction reads four blocks' results a lane at once, phase C a
//    block's 8 partials at once and reduces all four in one pass, and
//    thread 0 reads the next join's seed row (Q and P) in phase C.
//  - the row scan: block k scans the pass's row of rank k whole (row_min.cuh's body in row_min_l2, its loads through
//    L2, four vectors deep).  Two other designs were bit-equal and not
//    kept (PERF.md has their times): a ring of bulk copies streaming
//    each block's row through shared memory, and every block scanning a
//    slice of columns of every row of the pass (sd2 read once a slice,
//    not once a row).
// Coherence: every read of state that another block may have written
// earlier in the launch goes through L2 (__ldcg) or through a bulk copy
// started after a barrier and a proxy fence; never through the
// non-coherent read-only path or L1.  The scan's two result buffers
// alternate by the parity of the pass, which runs on across joins.
// Every loop condition and branch around a grid barrier reads only
// values that every block holds alike (total candidates, i, j, m_t), so
// no block leaves early.

#include <cooperative_groups.h>

#include "row_min.cuh"

namespace cg = cooperative_groups;

namespace {

enum : int { kStageQ = 1, kProfile = 2 };

// kProfile: block 0's thread 0 adds the SM clock cycles it spends in
// each part of a join to a buffer after the scratch (its waits at
// barriers included), in this order
enum : int {
  kPQ,           // the copy of Q awaited, the seed's state broadcast
  kPSelect,      // the walks of the selection
  kPRow,         // the pass's row scanned
  kPPass,        // the pass's grid barrier
  kPReduce,      // the pass's reduction and write-back
  kPA,           // body phase A
  kPBarrierA,
  kPB,           // body phase B
  kPBarrierB,
  kPC,           // phase C, the seed
  kPhases
};

constexpr int kSmemHead = 128;  // the mbarrier of the copy of Q

// bytes of dynamic shared memory: the mbarrier, then Q
int smem_bytes(int flags, int n) {
  return kSmemHead + ((flags & kStageQ) ? 4 * n : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t mb) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t mb, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(mb), "r"(parity)
        : "memory");
  } while (!done);
}

// the mbarrier expects `bytes` more; then one bulk copy global -> shared
__device__ __forceinline__ void mbar_expect(uint32_t mb, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   mb),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(mb)
      : "memory");
}

// generic-proxy writes of global memory (this thread's, and those a
// barrier made visible to it) before the async proxy's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Q[0, entries rounded up to 128) into Qs; thread 0 only
__device__ __forceinline__ void copy_q(int* Qs, const int* Q, int entries,
                                       uint32_t mb) {
  const uint32_t bytes = 4u * (uint32_t)((entries + 127) / 128 * 128);
  fence_proxy_async();
  mbar_expect(mb, bytes);
  bulk_copy(smem_addr(Qs), Q, bytes, mb);
}

// candidate test of one Q entry: index in [1, hi) and cached Q below minv
__device__ __forceinline__ bool cand(int q, int idx, int hi, int minv) {
  return idx >= 1 && idx < hi && q < minv;
}

// block_best on R pairs at once: (minimum, largest index at it) of
// each over the block, valid in thread 0
template <int R>
__device__ __forceinline__ void block_best_n(int (&v)[R], int (&x)[R]) {
  __shared__ int sv[R][kWarps], sx[R][kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      take_better(v[r], x[r], __shfl_down_sync(kFullMask, v[r], off),
                  __shfl_down_sync(kFullMask, x[r], off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sv[r][warp] = v[r];
      sx[r][warp] = x[r];
    }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = lane < kWarps ? sv[r][lane] : kIBig;
      x[r] = lane < kWarps ? sx[r][lane] : -1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
        take_better(v[r], x[r], __shfl_down_sync(kFullMask, v[r], off),
                    __shfl_down_sync(kFullMask, x[r], off));
  }
  __syncthreads();
}

// row_min.cuh's row body (the same result, valid in thread 0) reading
// the cells and sd2 through L2, since the join body of this launch
// writes both, with the loads of four vectors a thread in flight before
// any is used
__device__ __forceinline__ void row_min_l2(int r, int co, const uint4* words,
                                           const int* sd2, int n, int& best,
                                           int& bidx) {
  const unsigned sdr = (unsigned)__ldcg(sd2 + r);
  const uint4* row = words + (size_t)r * (n / 16);
  const int4* sd4 = reinterpret_cast<const int4*>(sd2);
  best = kIBig;
  bidx = -1;
  const int nvec = (r + 15) / 16;
  // columns rise within a thread, so `<=` keeps the last index at the min
  constexpr int kUnroll = 4;
  for (int v0 = threadIdx.x; v0 < nvec; v0 += kUnroll * kThreads) {
    uint4 w4[kUnroll];
    int4 s4[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nvec) {
        w4[u] = __ldcg(row + v);
#pragma unroll
        for (int j = 0; j < 4; ++j) s4[u][j] = __ldcg(sd4 + 4 * v + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v >= nvec) break;
      const uint32_t ws[4] = {w4[u].x, w4[u].y, w4[u].z, w4[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ss[4] = {s4[u][j].x, s4[u][j].y, s4[u][j].z, s4[u][j].w};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = 16 * v + 4 * j + b;
          const unsigned cell = (ws[j] >> (8 * b)) & 0xFFu;
          const int q = (int)((unsigned)co * cell - sdr - (unsigned)ss[b]);
          if (c < r && q <= best) {
            best = q;
            bidx = c;
          }
        }
      }
    }
  }
  block_best(best, bidx);
}

// the four reductions of phase B, in scratch after the B partial sums
enum { kRowJ = 0, kColJ = 1, kRowI = 2, kColI = 3, kReductions = 4 };

__global__ void __launch_bounds__(kThreads)
dnj_segment_kernel(unsigned char* D, int n, int* sd2, int* Q, int* P,
                   long long* seed_p, int* I, int* J, int* DIJ2, int* SDI2,
                   int* SDJ2, int* stats, int t0, int t1, int m,
                   int* scratch, long long* prof_buf, int flags) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_wcnt[kWarps];
  __shared__ int s_row;
  __shared__ int s_state[4];  // minv, pi, pj, bound of the next walk
  const int G = gridDim.x, k = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int stride = G * kThreads, k0 = k * kThreads + threadIdx.x;
  const bool lead = k == 0 && threadIdx.x == 0;
  const bool stage = flags & kStageQ;
  const size_t N = (size_t)n;
  cg::grid_group grid = cg::this_grid();
  const bool prof = (flags & kProfile) && k == 0 && threadIdx.x == 0;
  long long tprev = prof ? clock64() : 0, acc[kPhases] = {};
#define MARK(ph)                        \
  if (prof) {                           \
    const long long now_ = clock64();   \
    acc[ph] += now_ - tprev;            \
    tprev = now_;                       \
  }

  int* Qs = reinterpret_cast<int*>(smem + kSmemHead);
  const uint32_t mbq = smem_addr(smem);
  unsigned qphase = 0;
  int* scan_buf = scratch;  // 2 x 3G: (rmin, rarg, row) by pass parity
  int* part = scratch + 6 * G;  // G partial sums of phase A
  int* red = part + G;          // 8G (min, index) partials of phase B

  if (threadIdx.x == 0 && stage) {
    mbar_init(mbq);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (stage && threadIdx.x == 0) copy_q(Qs, Q, m - t0, mbq);
  // thread 0 of every block: the seed and the scan's starting state
  // (minv, pi, pj) for the next join, and the entries of Q it wrote in
  // phase C (patched into the copy of Q)
  int seed = (int)__ldcg(seed_p), nminv = kIBig, npi = 0, npj = 0;
  if (threadIdx.x == 0) {
    const int qs = __ldcg(Q + seed);
    if (seed != 0 && qs != kIBig) {
      nminv = qs;
      npi = seed;
      npj = __ldcg(P + seed);
    }
  }
  int npatch = 0, patch_idx[3], patch_val[3];
  int par = 0, npass_all = 0, nchanged = 0;

  for (int t = t0; t < t1; ++t) {
    const int m_t = m - t, co = 2 * (m_t - 2), last = m_t - 1;
    if (stage) {
      mbar_wait(mbq, qphase);
      qphase ^= 1;
    }
    if (threadIdx.x == 0) {
      if (stage)
        for (int p = 0; p < npatch; ++p) Qs[patch_idx[p]] = patch_val[p];
      s_state[0] = nminv;
      s_state[1] = npi;
      s_state[2] = npj;
    }
    __syncthreads();
    int minv = s_state[0], pi = s_state[1], pj = s_state[2];
    MARK(kPQ);

    // ---- the batch scan's passes
    const int4* Q4 = reinterpret_cast<const int4*>(stage ? Qs : Q);
    int hi = m_t, npass = 0;
    for (;;) {
      // (1) selection.  Q is cut into groups of 128 entries (one int4 per
      // lane); warp w owns a contiguous stripe of groups, warp 0 the top.
      const int ng = (hi + 127) / 128;
      const int gpw = (ng + kWarps - 1) / kWarps;
      const int gtop = ng - 1 - warp * gpw;
      const int gbot = max(gtop - gpw + 1, 0);
      int cnt = 0;
      for (int g = gtop; g >= gbot; --g) {
        const int4 q = stage ? Q4[g * 32 + lane] : __ldcg(Q4 + g * 32 + lane);
        const int base = g * 128 + lane * 4;
        cnt += (int)cand(q.x, base, hi, minv)
               + (int)cand(q.y, base + 1, hi, minv)
               + (int)cand(q.z, base + 2, hi, minv)
               + (int)cand(q.w, base + 3, hi, minv);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        cnt += __shfl_xor_sync(kFullMask, cnt, off);
      if (lane == 0) s_wcnt[warp] = cnt;
      if (threadIdx.x == 0) s_row = 0;
      __syncthreads();
      int total = 0, above = 0;  // above: candidates in the stripes over mine
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_wcnt[w];
        if (w < warp) above += c;
        total += c;
      }
      if (total == 0) break;  // the same in every block
      const bool valid = k < total;
      if (valid && above <= k && k < above + cnt) {
        // rank k lies in this warp's stripe: walk it again, descending
        int seen = above;
        for (int g = gtop; g >= gbot; --g) {
          const int4 q =
              stage ? Q4[g * 32 + lane] : __ldcg(Q4 + g * 32 + lane);
          const int base = g * 128 + lane * 4;
          const bool p0 = cand(q.x, base, hi, minv);
          const bool p1 = cand(q.y, base + 1, hi, minv);
          const bool p2 = cand(q.z, base + 2, hi, minv);
          const bool p3 = cand(q.w, base + 3, hi, minv);
          const unsigned m0 = __ballot_sync(kFullMask, p0);
          const unsigned m1 = __ballot_sync(kFullMask, p1);
          const unsigned m2 = __ballot_sync(kFullMask, p2);
          const unsigned m3 = __ballot_sync(kFullMask, p3);
          const int gt = __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
          if (seen + gt <= k) {
            seen += gt;
            continue;
          }
          // candidates of this group in higher lanes come first, then
          // this lane's own entries from the top
          const unsigned up = lane == 31 ? 0u : (kFullMask << (lane + 1));
          int rank = seen + __popc(m0 & up) + __popc(m1 & up)
                     + __popc(m2 & up) + __popc(m3 & up);
          if (p3 && rank++ == k) s_row = base + 3;
          if (p2 && rank++ == k) s_row = base + 2;
          if (p1 && rank++ == k) s_row = base + 1;
          if (p0 && rank++ == k) s_row = base;
          break;
        }
      }
      __syncthreads();
      const int r = s_row;
      // Q[r] as the pass found it: no pass of this join wrote a row below
      // the bound, and only this block writes row r in this pass
      const int qr = !valid || threadIdx.x ? 0
                     : stage ? Qs[r] : __ldcg(Q + r);
      MARK(kPSelect);

      // (2) row k, published for every block
      int rmin = kIBig, rarg = -1;
      if (valid) {
        row_min_l2(r, co, reinterpret_cast<const uint4*>(D), sd2, n, rmin,
                   rarg);
        if (rmin == kIBig) rarg = n - 1;  // as the masked full-width reduction
      }
      MARK(kPRow);
      int* buf = scan_buf + par * 3 * G;
      if (threadIdx.x == 0) {
        buf[k] = rmin;
        buf[G + k] = rarg;
        buf[2 * G + k] = valid ? r : -1;
      }
      grid.sync();
      par ^= 1;
      MARK(kPPass);

      // (3) gating, write-back of row k, new (minv, pi, pj): warp 0,
      // four blocks' entries a lane, their loads in flight together
      if (warp == 0) {
        int bv = kIBig, br = -1, ba = 0, before = minv;
        const int hnext = lane == 0 ? __ldcg(buf + 3 * G - 1) : 0;
        for (int base = 0; base < G; base += 128) {
          int v[4], a[4], row[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int kk = base + lane + 32 * u;
            v[u] = kk < G ? __ldcg(buf + kk) : kIBig;
            a[u] = kk < G ? __ldcg(buf + G + kk) : 0;
            row[u] = kk < G ? __ldcg(buf + 2 * G + kk) : -1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (base + lane + 32 * u < k) before = min(before, v[u]);
            if (v[u] < bv || (v[u] == bv && row[u] > br)) {
              bv = v[u];
              br = row[u];
              ba = a[u];
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          before = min(before, __shfl_xor_sync(kFullMask, before, off));
          const int ov = __shfl_xor_sync(kFullMask, bv, off);
          const int orow = __shfl_xor_sync(kFullMask, br, off);
          const int oa = __shfl_xor_sync(kFullMask, ba, off);
          if (ov < bv || (ov == bv && orow > br)) {
            bv = ov;
            br = orow;
            ba = oa;
          }
        }
        if (lane == 0) {
          if (valid && qr < before) {
            Q[r] = rmin;
            P[r] = rarg;
            nchanged += (int)(rmin != qr);
          }
          const bool better = bv < minv;
          s_state[0] = better ? bv : minv;
          s_state[1] = better ? br : pi;
          s_state[2] = better ? ba : pj;
          s_state[3] = hnext;
        }
      }
      __syncthreads();
      minv = s_state[0];
      pi = s_state[1];
      pj = s_state[2];
      ++npass;
      MARK(kPReduce);
      if (total <= G) break;  // every candidate was scanned
      hi = s_state[3];        // the rest lie below the last selected row
    }
    MARK(kPSelect);  // a walk that found no candidate
    npass_all += npass;

    // ---- the join body's phases
    const int i = pi, j = pj;
    if (i == 0 && j == 0) {  // no joinable pair: every block takes this
      if (lead) I[t] = J[t] = DIJ2[t] = SDI2[t] = SDJ2[t] = 0;
      grid.sync();  // the passes' write-backs, before Q is written or copied
      if (threadIdx.x == 0) {
        Q[last] = kIBig;
        seed = 0;
        nminv = kIBig;
        npi = npj = 0;
        npatch = 1;
        patch_idx[0] = last;
        patch_val[0] = kIBig;
        if (stage) copy_q(Qs, Q, m_t - 1, mbq);
      }
      continue;
    }
    const unsigned char* rowi = D + (size_t)i * N;
    unsigned char* rowj = D + (size_t)j * N;
    const int cij = __ldcg(rowi + j);

    // (A) records, updateD
    if (lead) {
      I[t] = i;
      J[t] = j;
      DIJ2[t] = 2 * cij;
      SDI2[t] = __ldcg(sd2 + i);
      SDJ2[t] = __ldcg(sd2 + j);
    }
    int dsum = 0;
    for (int kk = k0; kk < m_t; kk += stride) {
      if (kk == i || kk == j) continue;
      const int ci = __ldcg(rowi + kk), cj = __ldcg(rowj + kk);
      const int d = max(ci + cj - cij, 0);
      sd2[kk] = __ldcg(sd2 + kk) - (2 * ci + 2 * cj - d);
      dsum += d;
      const unsigned char q = (unsigned char)min((2 * d + 1) >> 2, 255);
      rowj[kk] = q;
      D[(size_t)kk * N + j] = q;
    }
    dsum = block_sum(dsum);
    if (threadIdx.x == 0) part[k] = dsum;
    MARK(kPA);
    grid.sync();
    MARK(kPBarrierA);

    // (B) sD2[j], the repairs of row and column j, popArrange
    int psum = 0;
    for (int bb = threadIdx.x; bb < G; bb += kThreads)
      psum += __ldcg(part + bb);
    const int sdj = block_sum(psum);
    const bool pop = i != last;
    const int sdl = __ldcg(sd2 + last);  // sD2[i] after the move
    const int co_post = 2 * (m_t - 3);
    if (lead) {
      sd2[j] = sdj;
      if (pop) sd2[i] = sdl;
    }
    int bv[kReductions], bx[kReductions];
#pragma unroll
    for (int r = 0; r < kReductions; ++r) {
      bv[r] = kIBig;
      bx[r] = -1;
    }
    const unsigned char* rowl = D + (size_t)last * N;
    unsigned char* rowi_w = D + (size_t)i * N;
    // kk ascends within a thread, so `<=` keeps the largest index at a min
    for (int kk = k0; kk < n; kk += stride) {
      // every load of this kk first, then the updates
      const bool repj = kk < j || (kk > j && kk < m_t && kk != i);
      const int sk =
          kk == j ? sdj : (kk < m_t && kk != i ? __ldcg(sd2 + kk) : 0);
      const int cj = repj ? __ldcg(rowj + kk) : 0;
      const int q0 = repj && kk > j ? __ldcg(Q + kk) : 0;
      const int cl = pop && kk != i ? __ldcg(rowl + kk) : 0;
      int qk = 0;  // Q[kk] as this thread last wrote or read it
      if (repj) {
        const int q = qval(co_post, cj, sdj, sk);
        if (kk < j) {
          if (q <= bv[kRowJ]) {
            bv[kRowJ] = q;
            bx[kRowJ] = kk;
          }
        } else {
          qk = q0;
          if (q <= qk) {
            Q[kk] = qk = q;
            P[kk] = j;
            if (q <= bv[kColJ]) {
              bv[kColJ] = q;
              bx[kColJ] = kk;
            }
          }
        }
      }
      if (pop) {
        // cell (last, i) is written below by its owner, kk = last; its
        // reader, kk = i, takes 0 instead
        const unsigned char v = (unsigned char)cl;
        rowi_w[kk] = v;
        D[(size_t)kk * N + i] = v;
        if (kk < i) {
          const int q = qval(co_post, v, sdl, sk);
          if (q <= bv[kRowI]) {
            bv[kRowI] = q;
            bx[kRowI] = kk;
          }
        } else if (kk > i && kk < last) {
          const int q = qval(co_post, v, sdl, sk);
          if (q <= qk) {  // kk > i > j: qk holds Q[kk] after column j
            Q[kk] = q;
            P[kk] = i;
            if (q <= bv[kColI]) {
              bv[kColI] = q;
              bx[kColI] = kk;
            }
          }
        }
      }
    }
    block_best_n(bv, bx);
    if (threadIdx.x == 0)
#pragma unroll
      for (int r = 0; r < kReductions; ++r) {
        red[(2 * r) * G + k] = bv[r];
        red[(2 * r + 1) * G + k] = bx[r];
      }
    MARK(kPB);
    grid.sync();
    MARK(kPBarrierB);
    // Q is final but for the three entries phase C writes: copy it now
    if (stage && threadIdx.x == 0) copy_q(Qs, Q, m_t - 1, mbq);

    // (C) every block: the reductions (a block's 8 partials loaded
    // together), Q and P of rows j and i, the seed
#pragma unroll
    for (int r = 0; r < kReductions; ++r) {
      bv[r] = kIBig;
      bx[r] = -1;
    }
    for (int bb = threadIdx.x; bb < G; bb += kThreads) {
      int pv[kReductions], px[kReductions];
#pragma unroll
      for (int r = 0; r < kReductions; ++r) {
        pv[r] = __ldcg(red + (2 * r) * G + bb);
        px[r] = __ldcg(red + (2 * r + 1) * G + bb);
      }
#pragma unroll
      for (int r = 0; r < kReductions; ++r)
        take_better(bv[r], bx[r], pv[r], px[r]);
    }
    block_best_n(bv, bx);
    if (threadIdx.x == 0) {
      const int Qj = bv[kRowJ];
      Q[j] = Qj;
      P[j] = Qj == kIBig ? 0 : bx[kRowJ];
      patch_idx[0] = j;
      patch_val[0] = Qj;
      npatch = 1;
      const int mi = bx[kColJ] >= 0 && bv[kColJ] <= Qj ? bx[kColJ] : j;
      int mj = 0;
      if (pop) {
        const int Qi = bv[kRowI];
        Q[i] = Qi;
        P[i] = Qi == kIBig ? 0 : bx[kRowI];
        patch_idx[npatch] = i;
        patch_val[npatch++] = Qi;
        mj = bx[kColI] >= 0 && bv[kColI] <= Qi ? bx[kColI] : i;
      }
      Q[last] = kIBig;
      patch_idx[npatch] = last;
      patch_val[npatch++] = kIBig;
      const int qmj = __ldcg(Q + mj), qmi = __ldcg(Q + mi);
      const int pmj = __ldcg(P + mj), pmi = __ldcg(P + mi);
      bool to_mj;
      if (mj == last)
        to_mj = false;
      else if (mi == last)
        to_mj = true;
      else
        to_mj = qmj < qmi || (mi < mj && qmj == qmi);
      seed = to_mj ? mj : mi;
      // the next join's scan starts from the seed row's cached minimum
      const int qs = to_mj ? qmj : qmi;
      const bool ok = seed != 0 && qs != kIBig;
      nminv = ok ? qs : kIBig;
      npi = ok ? seed : 0;
      npj = ok ? (to_mj ? pmj : pmi) : 0;
    }
    MARK(kPC);
  }
#undef MARK
  if (stage) mbar_wait(mbq, qphase);  // no copy left in flight at exit
  if (prof)
    for (int p = 0; p < kPhases; ++p) prof_buf[p] += acc[p];
  if (threadIdx.x == 0) {
    if (nchanged) atomicAdd(stats + 1, nchanged);
    if (k == 0) {
      stats[0] += npass_all;
      *seed_p = seed;
    }
  }
}

}  // namespace

extern "C" {

// The largest grid that one cooperative launch of dnj_segment can hold
// on the current device with these flags at n rows (co-resident
// blocks), or minus a cudaError_t.  Sets the kernel's dynamic shared
// memory limit first, as the launch does.
int dnj_segment_max_blocks(int flags, int n) {
  const int smem = smem_bytes(flags, n);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)dnj_segment_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dnj_segment_kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return coop ? sms * per_sm : 0;
}

// words: (n, n/4) u32, the u8 matrix; sd2, Q, P, I, J, DIJ2, SDI2, SDJ2:
// n int32; seed: one int64; stats: 4 int32; n % 128 == 0; words, sd2 and
// Q 16-byte aligned; 0 <= t0 <= t1 <= m - 2, m <= n; scratch: 15 G
// int32, then (8-byte aligned) kPhases int64 that kProfile adds to;
// flags: kStageQ, kProfile; 1 <= G <= dnj_segment_max_blocks(flags, n).
// The state is updated in place.
int dnj_segment(void* words, int n, void* sd2, void* Q, void* P,
                void* seed, void* I, void* J, void* DIJ2, void* SDI2,
                void* SDJ2, void* stats, int t0, int t1, int m, int G,
                void* scratch, int flags, void* stream) {
  const int smem = smem_bytes(flags, n);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)dnj_segment_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* prof_buf = (int*)scratch + (15 * G + 1) / 2 * 2;
  void* args[] = {&words, &n,    &sd2,  &Q,     &P,  &seed,    &I,
                  &J,     &DIJ2, &SDI2, &SDJ2,  &stats, &t0, &t1,
                  &m,     &scratch, &prof_buf, &flags};
  e = cudaLaunchCooperativeKernel((const void*)dnj_segment_kernel, dim3(G),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
