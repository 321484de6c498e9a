// A segment of joins of the float DNJ engine in one persistent launch
// (Hopper, sm_90a).
//
// Replaces the reference's device loop of joins `_dnj_segment`
// (ccphylo_tpu/tree/jax_engine.py:453-461): a jitted fori_loop over its
// join `one_join` (`_mk_one_join`, :224-450) with scan="batch", whose
// scan is a nested while_loop (`batch_scan`, :271-331).  No Pallas
// kernel: the JAX package left the loop to XLA.  Its plain form is
// ops/segment_float.py::dnj_segment_float_plain, the port's loop of
// tree/torch_engine.py::_one_join (one host read a scan pass and one for
// the limbs).
//
// What it computes: joins t in [t0, t1), m_t = m - t active rows, last =
// m_t - 1, on the state D (n, n), sD, N, Q, P, seed of `T` = double or
// float (N, P int32, seed int64), all on the card.  Per join:
//  - the seeded batch scan: from the seed row's cache, passes over the
//    G = K largest candidate rows (Q[r] < minv), each row's Q values
//    ((c D) - sD[r]) - sD[col] over partners col < r with D >= 0, c =
//    (N[r] + N[col] - 4) >> 1, last-wins minimum; the C-exact gating by
//    the shifted prefix-min; the pair updated strictly, the largest row
//    winning a tie;
//  - the limbs (nj.c:42-109) in T; with tracking (`exact` given), a join
//    whose pair would read a sum outside T's exact range stops the
//    launch: first_inexact = t;
//  - updateD (nj.c:836-1044) with the reference's bookkeeping: d2 =
//    ((D_ik + D_kj) - D_ij) / 2 clamped at 0, the one-sided stores, the
//    sD and N walker targets, the out-of-row "garbage" read of
//    nj.c:1022, sD[j] and N[j] rebuilt, row and column j written;
//  - the cache repairs of row and column j, popArrange (i != last) with
//    the repairs of row and column i, Q[last] = big, the seed chained;
//  - the records I, J, LI, LJ at row t (a join with no pair: 0, 0, -1,
//    -1); the exact flag and-ed with the exactness of each rebuilt sD[j].
// stats[0] += scan passes, stats[1] += rows whose cache the scan
// rewrote.  Bit-equal to the plain loop wherever every sum is exact in
// T (sums in another order are then equal); outside that range the sums
// of sD[j] and of the exactness test run in the blocks' order.
//
// Two instances a type: `Complete` (no missing cell among the active
// rows, which a run keeps: d2 >= 0) stores d2 everywhere, every walker
// target is the cell's own row k and no garbage is read; the other
// needs each cell's walker slot, a prefix count of the advancing cells
// over the whole row, so it copies row j to scratch and counts first
// (barrier A0).
//
// One cooperative launch of G blocks runs the segment: a grid barrier
// per scan pass and after each body phase (A0, A, B); none after the
// last phase, since every block reduces the partials of phase B itself
// and takes the same pair, Q[j], Q[i], seed.  Thread 0 of every block
// writes the same values of Q and P in phase C.  Every block keeps the
// exact flag in a register, so a stop needs no barrier: all blocks take
// the same branch at the same join.
//
// Two designs of the scan, with the same results.  kRows, the first:
// in every pass every block walks Q through L2 twice (it counts the
// candidates, then finds the one of rank k) and block k scans the whole
// row of rank k, with scalar loads.  On an H100 at n = 32768 (float64)
// those three parts took 91% of a join: the walks of Q, the rows, and
// the pass barrier, which waits for the longest row (PERF.md §5).  The
// candidate-list design, the default from 2560 taxa (ops/segment_float.py
// picks by size from the two timed in turns):
//  - the candidate list.  Every block holds in shared memory a list of
//    up to cap = kListK G of the join's candidate rows (1 <= r < m_t,
//    Q[r] below minv at the scan's start), in descending order, with
//    their Q.  A pass takes the list's first min(G, total) rows; the
//    next pass's candidates are the list's entries after the first G
//    whose Q lies below the new minv.  Why that is exact: a pass writes
//    back only rows it scanned, which all lie at or above the next
//    pass's bound hi (the last row it took), and a scanned row it does
//    not write back keeps a Q at or above the prefix-min it was gated
//    by, which is at or above the new minv; so no row at or above hi is
//    a candidate of the next pass, and every row below hi keeps the Q
//    it had when the list was made; minv only falls, so the next pass's
//    candidates (rows below hi with Q below minv) are among the join's
//    first candidates below hi, with the Q listed.
//    (tests/test_torch_segment_float.py checks this in its model of the
//    kernel.)  Where the join has more
//    candidates than the list holds, the list is topped up after a pass:
//     - kStageQ: the candidates are read from a copy of Q in shared
//       memory (one bulk copy a join, the 1-D TMA on an mbarrier,
//       started after barrier B of the join before, the three entries
//       phase C writes patched in) as a stream of rows in descending
//       order; the list is a window on it, topped up from where the
//       stream stopped, so each row is read once a join;
//     - without: block k compacts its G-th of Q into the scratch with
//       the least Q of each 32 of its entries, one grid barrier, every
//       block copies the first cap entries; a top-up reads only the
//       groups of 32 whose least Q lies below the new minv (after a
//       pass the candidates collapse: on the outbreak matrix at 32768 a
//       first pass had ten thousand, the next a few).
//    The top-ups are counted in the scratch.
//  - the row scan, balanced: a pass's row x weighs kPieceUnits units
//    (what a piece costs beside its cells), then one unit a cell (c <
//    r); block k takes the units [k U / G, (k + 1) U / G) of their
//    concatenation, so it may take parts of several rows, and writes a
//    piece (minimum, largest column at it) for each, tagged with the
//    pass, to slot x + k (distinct for distinct pieces).  16-byte loads
//    of D, sD and N, eight vectors a thread in flight.  After the pass
//    barrier warp 0 of every block merges the pieces: the pair
//    (smallest value, then largest row, then largest column, which is
//    the plain loop's tie rule), and for block k's row of rank k its
//    minimum (ties to the larger column) and the prefix-min of the rows
//    before it, for the gating and the write-back.
// What bounds it on an H100: at n = 32768 the rows' bytes (8 a cell of
// D from device memory, 12 of sD and N from L2) and the barriers; at n
// = 2048 latency: grid barriers, rounds of dependent loads and block
// reductions, of which the list design's pass has more than the first
// design's (a piece costs a round and a reduction however few its
// cells), so the first design stays the faster below 2560 taxa (PERF.md
// §5).
//
// Arithmetic: each step is one IEEE operation rounded to nearest, as the
// plain version's separate PyTorch operations are; the intrinsics
// (__dmul_rn, __dsub_rn, ...) keep nvcc from contracting a multiply and
// a subtraction into a fused multiply-add.
//
// Coherence: every read of state that another block may have written
// earlier in the launch goes through L2 (__ldcg) or through a bulk copy
// started after a barrier and a proxy fence; never through the
// read-only path.  Ownership: block k owns the cells k of one contiguous
// chunk of [0, m_t) in every body phase; in a pass block k writes back
// the row of rank k.  Hazards between joins: every write of join t + 1
// that a reader of join t may still need follows a barrier that reader
// has passed (see the notes at each phase).  Every loop condition and
// branch around a grid barrier reads values that every block holds
// alike (the list, total candidates, the pair, the exact flag), so no
// block leaves early.

#include <cooperative_groups.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// The candidate list's capacity in rows a block of the grid (a list
// holds kListK G rows), and the units a piece of a row costs beside its
// cells in the split of a pass.  Constants of the kernel; the macros
// exist only so that chip_smoke.py's float_sizes phase can time other
// values in turns (ops/build.py's `variant`).
#ifndef DNJ_FLOAT_LIST_K
#define DNJ_FLOAT_LIST_K 1
#endif
#ifndef DNJ_FLOAT_PIECE_UNITS
#define DNJ_FLOAT_PIECE_UNITS 2048
#endif
constexpr int kListK = DNJ_FLOAT_LIST_K;
constexpr int kPieceUnits = DNJ_FLOAT_PIECE_UNITS;
static_assert(kListK >= 1 && kPieceUnits >= 0, "a list holds the G rows "
              "of a pass; a piece costs 0 units or more");

// flags of the entry point: the instance (kFloat32, kComplete); kProfile;
// the design (kRows: the first; else the default, with kStageQ the copy
// of Q in shared memory)
enum : int {
  kFloat32 = 1,
  kComplete = 2,
  kProfile = 4,
  kRows = 8,
  kStageQ = 16
};

// kProfile: thread 0 of each block adds the SM clock cycles it spends in
// each part of a join (its waits at barriers included) to its row of
// the scratch's block_prof, block 0's also to the int64 counters at the
// start of the scratch, in this order
enum : int {
  kPCopyQ,     // the copy of Q awaited, the scan's start broadcast
  kPSelect,    // the candidate rows of the join and of each pass found
  kPList,      // the barrier after the candidate list's slices
  kPRow,       // the pass's rows scanned
  kPPass,      // the pass's grid barrier
  kPReduce,    // gating, write-back, the new pair
  kPLimbs,     // the limbs and the records
  kPA0,        // row j copied, advancing cells counted (missing cells)
  kPBarrierA0,
  kPA,
  kPBarrierA,
  kPB,
  kPBarrierB,
  kPC,         // phase C, the seed
  kPhases
};
// the int64 counters at the start of the scratch: the kPhases above,
// the serial of the last pass (the pieces' tags), the list's refills
enum : int { kSerial = kPhases, kRefills, kCounters };
constexpr int kCounterBytes = 8 * kCounters;
constexpr int kSmemHead = 128;  // the mbarrier of the copy of Q

#define MARK(ph)                        \
  if (prof) {                           \
    const long long now_ = clock64();   \
    acc[ph] += now_ - tprev;            \
    tprev = now_;                       \
  }
// IEEE operations rounded to nearest, never contracted
template <typename T>
struct Num;

template <>
struct Num<double> {
  static constexpr int kMant = 52;
  __device__ static double big() { return DBL_MAX; }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double of(int x) { return __int2double_rn(x); }
  // e of frexp: x = f 2^e with f in [0.5, 1)
  __device__ static int exponent(double x) {
    int e;
    frexp(x, &e);
    return e;
  }
  // b with x = odd * 2^-b (the binary places x needs); INT_MIN for 0
  __device__ static int places(double x) {
    const long long bits = __double_as_longlong(x);
    const int e = (int)((bits >> 52) & 0x7ff);
    const long long man = bits & ((1LL << 52) - 1);
    if (e == 0)
      return man ? 1074 - (__ffsll(man) - 1) : INT_MIN;
    return 1075 - e - (__ffsll(man | (1LL << 52)) - 1);
  }
};

template <>
struct Num<float> {
  static constexpr int kMant = 23;
  __device__ static float big() { return FLT_MAX; }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float of(int x) { return __int2float_rn(x); }
  __device__ static int exponent(float x) {
    int e;
    frexpf(x, &e);
    return e;
  }
  __device__ static int places(float x) {
    const int bits = __float_as_int(x);
    const int e = (bits >> 23) & 0xff;
    const int man = bits & ((1 << 23) - 1);
    if (e == 0) return man ? 149 - (__ffs(man) - 1) : INT_MIN;
    return 150 - e - (__ffs(man | (1 << 23)) - 1);
  }
};

// the better of two (min, index) pairs: smaller value, then larger index
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& x, T ov, int ox) {
  if (ov < v || (ov == v && ox > x)) {
    v = ov;
    x = ox;
  }
}

// R (minimum, largest index at it) pairs over the block, valid in
// thread 0; (big, -1) where the block has no entry
template <typename T, int R>
__device__ __forceinline__ void block_best(T (&v)[R], int (&x)[R]) {
  __shared__ T sv[R][kWarps];
  __shared__ int sx[R][kWarps];
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
      v[r] = lane < kWarps ? sv[r][lane] : Num<T>::big();
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

// phase A's partials of a block: the sum and the sum of |x| of the
// summands of sD[j], the most binary places one needs, their count
template <typename T>
struct Part {
  T sum, abs;
  int places, count;
};

// the partials over the block (every thread's own summed in a fixed
// order), returned to every thread
template <typename T>
__device__ __forceinline__ Part<T> block_part(Part<T> p) {
  __shared__ Part<T> sp[kWarps];
  __shared__ Part<T> total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p.sum = Num<T>::add(p.sum, __shfl_down_sync(kFullMask, p.sum, off));
    p.abs = Num<T>::add(p.abs, __shfl_down_sync(kFullMask, p.abs, off));
    p.places = max(p.places, __shfl_down_sync(kFullMask, p.places, off));
    p.count += __shfl_down_sync(kFullMask, p.count, off);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) sp[warp] = p;
  __syncthreads();
  if (threadIdx.x == 0) {
    Part<T> s = sp[0];
    for (int w = 1; w < kWarps; ++w) {
      s.sum = Num<T>::add(s.sum, sp[w].sum);
      s.abs = Num<T>::add(s.abs, sp[w].abs);
      s.places = max(s.places, sp[w].places);
      s.count += sp[w].count;
    }
    total = s;
  }
  __syncthreads();
  return total;
}

// sums of two ints over the block, returned to every thread
__device__ __forceinline__ int2 block_sum2(int a, int b) {
  __shared__ int sa[kWarps], sb[kWarps];
  __shared__ int2 total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(kFullMask, a, off);
    b += __shfl_down_sync(kFullMask, b, off);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int2 s = make_int2(0, 0);
    for (int w = 0; w < kWarps; ++w) {
      s.x += sa[w];
      s.y += sb[w];
    }
    total = s;
  }
  __syncthreads();
  return total;
}

// row r of the ltd cell f = off(j) + k (off(r) = r (r - 1) / 2): the
// largest r with off(r) <= f, exact in 64-bit integers
__device__ __forceinline__ long long ltd_row(long long f) {
  long long r = (long long)((1.0 + sqrt(8.0 * (double)f + 1.0)) * 0.5);
  while (r > 1 && r * (r - 1) / 2 > f) --r;
  while ((r + 1) * r / 2 <= f) ++r;
  return r;
}

// exclusive prefix over the block of one int a thread (in thread order),
// and the total, to every thread
__device__ __forceinline__ int block_scan(int v, int& total) {
  __shared__ int s_w[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_w[warp] = x;
  __syncthreads();
  int pre = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_w[w];
    if (w < warp) pre += c;
    total += c;
  }
  __syncthreads();
  return pre + x - v;
}

// 16 bytes through L2 into an array
__device__ __forceinline__ void ldv(const double* p, double (&o)[2]) {
  const double2 x = __ldcg(reinterpret_cast<const double2*>(p));
  o[0] = x.x;
  o[1] = x.y;
}
__device__ __forceinline__ void ldv(const float* p, float (&o)[4]) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
// the N entries beside them: 8 bytes (two) or 16 (four)
__device__ __forceinline__ void ldv(const int* p, int (&o)[2]) {
  const int2 x = __ldcg(reinterpret_cast<const int2*>(p));
  o[0] = x.x;
  o[1] = x.y;
}
__device__ __forceinline__ void ldv(const int* p, int (&o)[4]) {
  const int4 x = __ldcg(reinterpret_cast<const int4*>(p));
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
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

// the mbarrier expects `bytes` more (and takes this thread's arrival)
__device__ __forceinline__ void mbar_expect(uint32_t mb, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   mb),
               "r"(bytes)
               : "memory");
}

// one bulk copy global -> shared (the 1-D TMA), completing on mbarrier mb
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(mb)
      : "memory");
}

// Q[0, entries) into Qs by one bulk copy of whole 16-byte units inside
// Q's n entries; returns the entries copied (the rest, at most three,
// the caller loads after the wait).  Thread 0 only; the generic-proxy
// writes of global memory it has seen come before the copy's reads.
template <typename T>
__device__ __forceinline__ int copy_q(T* Qs, const T* Q, int entries, int n,
                                      uint32_t mb) {
  const uint32_t want = ((uint32_t)entries * sizeof(T) + 15u) / 16u * 16u;
  const uint32_t room = (uint32_t)n * sizeof(T) / 16u * 16u;
  const uint32_t bytes = want < room ? want : room;
  asm volatile("fence.proxy.async.global;" ::: "memory");
  mbar_expect(mb, bytes);
  if (bytes) bulk_copy(smem_addr(Qs), Q, bytes, mb);
  return min(entries, (int)(bytes / sizeof(T)));
}

// The candidates (row >= 1, Q below minv) among the positions [0, len)
// of a source in descending row order, in order, the first `cap` into
// (dr, dq); returns, to every thread, how many there are and len, or,
// where there are more than cap, a count above cap and the position
// after the cap-th (the walk stops in the chunk that holds it).
// src(p, r, q) sets position p's row and cached Q.  The block takes
// chunks of kThreads U positions, warp w the w-th 32 U of a chunk, lane
// l the positions l, l + 32, ... of it, every load in flight before any
// is used; a warp's ballots keep the order within it, the warps'
// counts (one barrier) the order between them.
template <typename T, typename Src>
__device__ __forceinline__ int2 fill_list(int len, const Src& src, T minv,
                                          int* dr, T* dq, int cap) {
  constexpr int U = 8;
  __shared__ int s_wc[kWarps], s_next;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) s_next = len;  // read after a barrier below
  int base = 0;
  for (int c0 = 0; c0 < len && base <= cap; c0 += kThreads * U) {
    const int w0 = c0 + warp * 32 * U;
    int r[U];
    T q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = w0 + 32 * u + lane;
      r[u] = 0;
      q[u] = minv;
      if (p < len) src(p, r[u], q[u]);
    }
    unsigned bal[U];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bal[u] = __ballot_sync(kFullMask, r[u] >= 1 && q[u] < minv);
      cnt += __popc(bal[u]);
    }
    if (lane == 0) s_wc[warp] = cnt;
    __syncthreads();
    int off = base, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_wc[w];
      if (w < warp) off += c;
      tot += c;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int at = off + __popc(bal[u] & ((1u << lane) - 1u));
      if ((bal[u] >> lane & 1u) && at < cap) {
        dr[at] = r[u];
        dq[at] = q[u];
        if (at == cap - 1) s_next = w0 + 32 * u + lane + 1;
      }
      off += __popc(bal[u]);
    }
    base += tot;
    __syncthreads();  // s_wc free again; the list complete
  }
  __syncthreads();  // s_next written (also where no chunk ran)
  const int next = s_next;
  __syncthreads();  // s_next free again
  return make_int2(base, base > cap ? next : len);
}

// (minimum, largest column at it) of row r's Q values over its cells
// [c0, c1) (c1 <= r), valid in thread 0; (big, -1) where no cell is
// present.  The cells are cut into the 16-byte vectors of sD that hold
// them; a thread takes vectors tid, tid + kThreads, ..., U at a time,
// and issues every load of them (D as a vector where row r's start
// allows it, sD and N as vectors; the first and last vector of the
// piece, where partial, cell by cell) before it compares any: one
// round trip for up to U kThreads vectors.  A cell outside [c0, c1)
// takes D = -1, as a missing cell.  A thread's cells rise, so `<=`
// keeps the last column at its minimum.  (Not inlined: its registers,
// U vectors of three arrays a thread, stay out of the allocation of the
// join body around it.)
template <typename T>
__device__ __noinline__ void piece_min(const T* D, size_t ld, const T* sD,
                                       const int* N, int r, int c0, int c1,
                                       T& best, int& bidx) {
  using F = Num<T>;
  constexpr int V = 16 / sizeof(T), U = 8;
  const int tid = threadIdx.x;
  const T* row = D + (size_t)r * ld;
  const T sdr = __ldcg(sD + r);
  const int nr = __ldcg(N + r);
  const bool dvec = ((size_t)r * ld) % V == 0;  // row r's vectors aligned
  const int v1 = (c1 + V - 1) / V;
  T bv[1] = {F::big()};
  int bx[1] = {-1};
  for (int vb = c0 / V + tid; vb < v1; vb += U * kThreads) {
    T d[U][V], s[U][V];
    int nn[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (vb + u * kThreads) * V;
      if (c >= c0 && c + V <= c1) {
        if (dvec) {
          ldv(row + c, d[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) d[u][e] = __ldcg(row + c + e);
        }
        ldv(sD + c, s[u]);
        ldv(N + c, nn[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int ce = c + e;
          const bool in = ce >= c0 && ce < c1;
          d[u][e] = in ? __ldcg(row + ce) : (T)-1;
          s[u][e] = in ? __ldcg(sD + ce) : (T)0;
          nn[u][e] = in ? __ldcg(N + ce) : 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (d[u][e] >= (T)0) {
          const T q = F::sub(
              F::sub(F::mul(F::of((nr + nn[u][e] - 4) >> 1), d[u][e]), sdr),
              s[u][e]);
          if (q <= bv[0]) {
            bv[0] = q;
            bx[0] = (vb + u * kThreads) * V + e;
          }
        }
      }
    }
  }
  block_best(bv, bx);
  best = bv[0];
  bidx = bx[0];
}

// the scratch after the counters, by the offsets of `Layout`
template <typename T>
struct Layout {
  T* scan_v;    // 2 x G: each block's row minimum, by pass parity (kRows)
  T* part_sum;  // G: phase A's partials
  T* part_abs;  // G
  T* red_v;     // 4 x G: phase B's minima
  T* oldj;      // n: row j before the join (missing cells only)
  T* piece_v;   // 2 x 2G: the pieces' minima, by pass parity
  T* list_q;    // n: the candidate list's slices (no kStageQ)
  T* list_gmin;  // n / 32 + 2G: the least Q of each 32 entries of a slice
  int* scan_x;  // 2 x 2 x G: column and row of each block's minimum
  int* part_places;  // G
  int* part_count;   // G
  int* red_x;   // 4 x G
  int* adv_r;   // G: advancing cells k < j of each block's chunk
  int* adv_c;   // G: advancing cells k > j
  int* piece_c;  // 2 x 2G: the pieces' columns, rows and pass tags
  int* piece_r;
  int* piece_tag;
  int* list_r;  // n
  int* list_n;  // G: candidates in each block's slice
  long long* block_prof;  // G x kPhases: kProfile's counters of each block
  __host__ __device__ Layout(void* base, int G, int n) {
    block_prof = static_cast<long long*>(base);
    T* f = reinterpret_cast<T*>(block_prof + (size_t)G * kPhases);
    scan_v = f;
    part_sum = scan_v + 2 * G;
    part_abs = part_sum + G;
    red_v = part_abs + G;
    oldj = red_v + 4 * G;
    piece_v = oldj + n;
    list_q = piece_v + 4 * G;
    list_gmin = list_q + n;
    int* i = reinterpret_cast<int*>(list_gmin + n / 32 + 2 * G);
    scan_x = i;
    part_places = scan_x + 4 * G;
    part_count = part_places + G;
    red_x = part_count + G;
    adv_r = red_x + 4 * G;
    adv_c = adv_r + G;
    piece_c = adv_c + G;
    piece_r = piece_c + 4 * G;
    piece_tag = piece_r + 4 * G;
    list_r = piece_tag + 4 * G;
    list_n = list_r + n;
  }
  static size_t bytes(int G, int n) {
    return 8 * (size_t)G * kPhases +
           sizeof(T) * (14 * (size_t)G + 2 * (size_t)n + n / 32) +
           sizeof(int) * (25 * (size_t)G + n);
  }
};

// dynamic shared memory of the candidate-list design: the mbarrier;
// with kStageQ the copy of Q; two candidate lists of kListK G entries
// (their Q, then their rows); the rows' offsets in the pass's units and
// the slices' offsets (G + 1 each); without kStageQ the groups of 32
// entries a refill reads (n / 32 + 2G)
size_t smem_bytes(int flags, int n, int G) {
  if (flags & kRows) return 0;
  const size_t cap = (size_t)kListK * G;
  const size_t ts = (flags & kFloat32) ? 4 : 8;
  const size_t qb = (flags & kStageQ) ? ((size_t)n * ts + 127) / 128 * 128 : 0;
  const size_t qg = (flags & kStageQ) ? 0 : (size_t)n / 32 + 2 * G;
  return kSmemHead + qb + 2 * cap * (ts + 4) + 8 * ((size_t)G + 1) +
         4 * qg;
}

// the four reductions of phase B
enum { kRowJ = 0, kColJ = 1, kRowI = 2, kColI = 3, kReductions = 4 };

template <typename T, bool Complete, bool Rows>
__global__ void __launch_bounds__(kThreads)
dnj_segment_float_kernel(T* D, int n, T* sD, int* N, T* Q, int* P,
                         long long* seed_p, int* I, int* J, T* LI, T* LJ,
                         unsigned char* exact_p, int* first_inexact,
                         unsigned long long* stats, int t0, int t1, int m,
                         int neg_limbs, void* scratch, int flags) {
  using F = Num<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_wcnt[kWarps], s_wcr[kWarps], s_wcc[kWarps];
  __shared__ int s_row;
  __shared__ T s_minv;
  __shared__ int s_pi, s_pj, s_hnext;
  const int G = gridDim.x, k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool lead = k == 0 && tid == 0;
  const size_t ld = (size_t)n;
  const T big = F::big();
  cg::grid_group grid = cg::this_grid();
  long long* counters = static_cast<long long*>(scratch);
  Layout<T> S(static_cast<char*>(scratch) + kCounterBytes, G, n);
  const bool prof = (flags & kProfile) && tid == 0;
  const int cap = kListK * G, pw = kPieceUnits;
  long long tprev = prof ? clock64() : 0, acc[kPhases] = {};

  // the default design's shared memory (see smem_bytes)
  const bool stage = !Rows && (flags & kStageQ);
  const size_t qb = stage ? ((size_t)n * sizeof(T) + 127) / 128 * 128 : 0;
  T* Qs = reinterpret_cast<T*>(smem + kSmemHead);
  T* lq0 = reinterpret_cast<T*>(smem + kSmemHead + qb);
  T* lq1 = lq0 + cap;
  int* lr0 = reinterpret_cast<int*>(lq1 + cap);
  int* lr1 = lr0 + cap;
  int* s_cum = lr1 + cap;      // G + 1: the pass's rows' first units
  int* s_pre = s_cum + G + 1;  // G + 1: the slices' first entries
  int* s_qg = s_pre + G + 1;   // n / 32 + 2G: the groups a refill reads
  const uint32_t mbq = smem_addr(smem);
  uint32_t qphase = 0;
  int qdone = 0, qwant = 0;  // thread 0: entries of Q copied, wanted
  int npatch = 0, patch_idx[3];
  T patch_val[3];
  if (stage) {
    if (tid == 0) {
      mbar_init(mbq);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0 && t0 < t1) {
      qwant = m - t0;
      qdone = copy_q(Qs, Q, qwant, n, mbq);
    }
  }
  // the pieces' tags: the passes' serial numbers, on across launches
  const int tag0 = (int)__ldcg(counters + kSerial) + 1;

  const bool track = exact_p != nullptr;
  bool exact = track ? *exact_p != 0 : true;  // the same in every block
  int stop = -1;
  // thread 0 of every block: the seed and the next scan's start
  long long seed = __ldcg(seed_p);
  T nminv = big;
  int npi = 0, npj = 0;
  if (tid == 0) {
    const T qs = __ldcg(Q + seed);
    if (seed != 0 && qs != big) {
      nminv = qs;
      npi = (int)seed;
      npj = __ldcg(P + seed);
    }
  }
  int par = 0, npass = 0, nreval = 0, nrefill = 0;

  for (int t = t0; t < t1; ++t) {
    const int m_t = m - t, last = m_t - 1;
    if (stage) {
      mbar_wait(mbq, qphase);
      qphase ^= 1;
    }
    if (tid == 0) {
      if (stage) {
        for (int r = qdone; r < qwant; ++r) Qs[r] = __ldcg(Q + r);
        for (int p = 0; p < npatch; ++p) Qs[patch_idx[p]] = patch_val[p];
      }
      s_minv = nminv;
      s_pi = npi;
      s_pj = npj;
    }
    __syncthreads();
    T minv = s_minv;
    int pi = s_pi, pj = s_pj;
    MARK(kPCopyQ);

    if constexpr (Rows) {
      // ---- the batch scan.  A pass selects the candidates (1 <= r < hi,
      // Q[r] < minv) of rank 0..G-1 in descending order, block k the one
      // of rank k; the rows a pass writes back all lie at or above the
      // next pass's bound hi, so no block reads a Q entry another block
      // writes in the same pass.
      int hi = m_t;
      for (;;) {
        // warp w owns a contiguous stripe of groups of 32 entries, warp 0
        // the top one
        const int ng = (hi + 31) / 32;
        const int gpw = (ng + kWarps - 1) / kWarps;
        const int gtop = ng - 1 - warp * gpw;
        const int gbot = max(gtop - gpw + 1, 0);
        int cnt = 0;
        for (int g = gtop; g >= gbot; --g) {
          const int r = g * 32 + lane;
          cnt += r >= 1 && r < hi && __ldcg(Q + r) < minv;
        }
  #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          cnt += __shfl_xor_sync(kFullMask, cnt, off);
        if (lane == 0) s_wcnt[warp] = cnt;
        if (tid == 0) s_row = 0;
        __syncthreads();
        int total = 0, above = 0;
  #pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (w < warp) above += s_wcnt[w];
          total += s_wcnt[w];
        }
        if (total == 0) break;  // the same in every block
        const bool valid = k < total;
        if (valid && above <= k && k < above + cnt) {
          int seen = above;  // rank k lies in this warp's stripe
          for (int g = gtop; g >= gbot; --g) {
            const int r = g * 32 + lane;
            const bool p = r >= 1 && r < hi && __ldcg(Q + r) < minv;
            const unsigned bal = __ballot_sync(kFullMask, p);
            const int gt = __popc(bal);
            if (seen + gt <= k) {
              seen += gt;
              continue;
            }
            const unsigned up = lane == 31 ? 0u : (kFullMask << (lane + 1));
            if (p && seen + __popc(bal & up) == k) s_row = r;
            break;
          }
        }
        __syncthreads();
        const int r = s_row;
        const T qr = valid && tid == 0 ? __ldcg(Q + r) : big;
        MARK(kPSelect);

        // row r's minimum over partners c < r
        T rmin[1] = {big};
        int rarg[1] = {-1};
        if (valid) {
          const T sdr = __ldcg(sD + r);
          const int nr = __ldcg(N + r);
          const T* row = D + (size_t)r * ld;
          for (int c = tid; c < r; c += kThreads) {  // c rises: `<=` keeps
            const T d = __ldcg(row + c);             // the last at the min
            if (d >= (T)0) {
              const T q = F::sub(
                  F::sub(F::mul(F::of((nr + __ldcg(N + c) - 4) >> 1), d), sdr),
                  __ldcg(sD + c));
              if (q <= rmin[0]) {
                rmin[0] = q;
                rarg[0] = c;
              }
            }
          }
        }
        block_best(rmin, rarg);  // every thread calls it
        if (valid && rmin[0] == big) rarg[0] = m_t - 1;  // as the masked
                                                         // full-width min
        MARK(kPRow);
        T* bv = S.scan_v + par * G;
        int* bx = S.scan_x + par * 2 * G;
        if (tid == 0) {
          bv[k] = rmin[0];
          bx[k] = rarg[0];
          bx[G + k] = valid ? r : -1;
        }
        grid.sync();
        par ^= 1;
        MARK(kPPass);

        // gating, write-back of row r, the new (minv, pi, pj): warp 0
        if (warp == 0) {
          T before = minv, best = big;
          int brow = -1, barg = 0;
          for (int b = lane; b < G; b += 32) {
            const T v = __ldcg(bv + b);
            const int a = __ldcg(bx + b), row = __ldcg(bx + G + b);
            if (b < k) before = v < before ? v : before;
            if (v < best || (v == best && row > brow)) {
              best = v;
              brow = row;
              barg = a;
            }
          }
  #pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const T ob = __shfl_xor_sync(kFullMask, before, off);
            before = ob < before ? ob : before;
            const T ov = __shfl_xor_sync(kFullMask, best, off);
            const int orow = __shfl_xor_sync(kFullMask, brow, off);
            const int oa = __shfl_xor_sync(kFullMask, barg, off);
            if (ov < best || (ov == best && orow > brow)) {
              best = ov;
              brow = orow;
              barg = oa;
            }
          }
          if (lane == 0) {
            if (valid && qr < before) {
              Q[r] = rmin[0];
              P[r] = rarg[0];
              ++nreval;
            }
            const bool better = best < minv;
            s_minv = better ? best : minv;
            s_pi = better ? brow : pi;
            s_pj = better ? barg : pj;
            s_hnext = __ldcg(bx + 2 * G - 1);
          }
        }
        __syncthreads();
        minv = s_minv;
        pi = s_pi;
        pj = s_pj;
        ++npass;
        MARK(kPReduce);
        if (total <= G) break;  // every candidate was scanned
        hi = s_hnext;           // the rest lie below the last selected row
      }
      MARK(kPSelect);  // a walk that found no candidate
    } else {
      // ---- the batch scan: the join's candidate list.  With kStageQ
      // the candidates are a stream, the rows of the copy of Q in
      // descending order, read once a join: the list is a window on it of
      // up to cap candidates, filtered after each pass and topped up from
      // the stream where it did not end.  Without, block k compacts its
      // slice of rows into the scratch with the least Q of each 32 of its
      // entries (a group); after a barrier every block copies the first
      // cap entries; where they were more, every later pass's candidates
      // come from the groups whose least Q lies below its minv
      int sl = 0, gps = 0;  // the slices' length, groups a slice
      int slen = 0, spos = 0;  // the stream's positions, its next
      int2 f;
      int total;
      if (stage) {
        slen = m_t - 1;
        f = fill_list(
            slen,
            [&](int p, int& r, T& q) {
              r = m_t - 1 - p;
              q = Qs[r];
            },
            minv, lr0, lq0, cap);
        total = f.x;
        spos = f.y;
      } else {
        const int top = m_t - 1;
        sl = (top + G - 1) / G;
        gps = (sl + 31) / 32;
        const int base = k * sl, ktop = top - base;
        const int2 c = fill_list(
            min(sl, ktop),
            [&](int p, int& r, T& q) {
              r = ktop - p;
              q = __ldcg(Q + r);
            },
            minv, S.list_r + base, S.list_q + base, sl);
        for (int g = warp; g * 32 < c.x; g += kWarps) {
          const int e = g * 32 + lane;
          T v = e < c.x ? __ldcg(S.list_q + base + e) : big;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const T o = __shfl_xor_sync(kFullMask, v, off);
            v = o < v ? o : v;
          }
          if (lane == 0) S.list_gmin[k * gps + g] = v;
        }
        if (tid == 0) S.list_n[k] = c.x;
        MARK(kPSelect);
        grid.sync();
        MARK(kPList);
        const int pre = block_scan(tid < G ? __ldcg(S.list_n + tid) : 0,
                                   total);
        if (tid < G) s_pre[tid] = pre;
        if (tid == 0) s_pre[G] = total;
        __syncthreads();
        for (int p = tid; p < min(total, cap); p += kThreads) {
          int b = 0, e = G;  // the slice holding entry p: the last b with
          while (e - b > 1) {  // s_pre[b] <= p
            const int mid = (b + e) / 2;
            if (s_pre[mid] <= p)
              b = mid;
            else
              e = mid;
          }
          const int at = b * sl + p - s_pre[b];
          lr0[p] = __ldcg(S.list_r + at);
          lq0[p] = __ldcg(S.list_q + at);
        }
        __syncthreads();
      }
      bool over = total > cap;  // the list holds the first cap only
      MARK(kPSelect);
      int cur = 0;
      for (;;) {
        if (total == 0) break;  // the same in every block
        const int R = min(G, total);
        const int* rows = cur ? lr1 : lr0;
        const T* qs = cur ? lq1 : lq0;
        // row x of the pass takes pw units (what a piece costs beyond its
        // cells), then one a cell; block k takes the units [lo, hk)
        int units;
        const int first = block_scan(tid < R ? rows[tid] + pw : 0, units);
        if (tid < R) s_cum[tid] = first;
        if (tid == 0) s_cum[R] = units;
        __syncthreads();
        const int lo = (int)((long long)k * units / G);
        const int hk = (int)((long long)(k + 1) * units / G);
        const int tag = tag0 + npass;
        if (lo < hk) {
          int x = 0, e = R;  // the row holding unit lo
          while (e - x > 1) {
            const int mid = (x + e) / 2;
            if (s_cum[mid] <= lo)
              x = mid;
            else
              e = mid;
          }
          for (; x < R && s_cum[x] < hk; ++x) {
            const int at = s_cum[x] + pw, r = rows[x];  // at: cell 0
            const int c0 = max(lo, at) - at, c1 = min(hk, s_cum[x + 1]) - at;
            if (c0 >= c1) continue;  // the same in every thread
            T v;
            int c;
            piece_min(D, ld, sD, N, r, c0, c1, v, c);
            if (tid == 0) {
              const int slot = par * 2 * G + x + k;
              S.piece_v[slot] = v;
              S.piece_c[slot] = c;
              S.piece_r[slot] = r;
              S.piece_tag[slot] = tag;
            }
          }
        }
        MARK(kPRow);
        grid.sync();
        MARK(kPPass);

        // merge the pieces (warp 0): the pair; block k's row of rank k,
        // its minimum and the prefix-min of the rows before it, for the
        // gating and the write-back
        if (warp == 0) {
          const int nslot = R + G - 1, at = par * 2 * G;
          const int myr = k < R ? rows[k] : INT_MAX;
          T bv = big, mv = big, before = minv;
          int brow = -1, bcol = 0, mcol = -1;
          for (int s0 = 0; s0 < nslot; s0 += 256) {
            T v[8];
            int c[8], rr[8], tg[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int sl = s0 + lane + 32 * u;
              const bool in = sl < nslot;
              v[u] = in ? __ldcg(S.piece_v + at + sl) : big;
              c[u] = in ? __ldcg(S.piece_c + at + sl) : -1;
              rr[u] = in ? __ldcg(S.piece_r + at + sl) : -1;
              tg[u] = in ? __ldcg(S.piece_tag + at + sl) : -1;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (tg[u] != tag) continue;  // no piece in this slot
              if (v[u] < bv || (v[u] == bv && (rr[u] > brow ||
                                               (rr[u] == brow && c[u] > bcol)))) {
                bv = v[u];
                brow = rr[u];
                bcol = c[u];
              }
              if (rr[u] == myr)
                take_better(mv, mcol, v[u], c[u]);
              else if (rr[u] > myr && v[u] < before)
                before = v[u];
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const T ob = __shfl_xor_sync(kFullMask, before, off);
            before = ob < before ? ob : before;
            const T ov = __shfl_xor_sync(kFullMask, bv, off);
            const int orow = __shfl_xor_sync(kFullMask, brow, off);
            const int ocol = __shfl_xor_sync(kFullMask, bcol, off);
            if (ov < bv ||
                (ov == bv && (orow > brow || (orow == brow && ocol > bcol)))) {
              bv = ov;
              brow = orow;
              bcol = ocol;
            }
            take_better(mv, mcol, __shfl_xor_sync(kFullMask, mv, off),
                        __shfl_xor_sync(kFullMask, mcol, off));
          }
          if (lane == 0) {
            // qs[k]: Q[myr] as the pass found it (no pass of this join
            // wrote a row below its bound; only this block writes myr)
            if (k < R && qs[k] < before) {
              Q[myr] = mv;
              P[myr] = mv == big ? m_t - 1 : mcol;  // as the masked
              ++nreval;                             // full-width min
            }
            const bool better = bv < minv;
            s_minv = better ? bv : minv;
            s_pi = better ? brow : pi;
            s_pj = better ? bcol : pj;
          }
        }
        __syncthreads();
        minv = s_minv;
        pi = s_pi;
        pj = s_pj;
        ++npass;
        par ^= 1;
        MARK(kPReduce);
        if (total <= G) break;  // every candidate was scanned
        // the next pass's candidates (rows below hi = rows[G - 1] with Q
        // below the new minv): the list's after the first G; then, where
        // the copy of Q's stream did not end, its next ones; or, where the
        // slices' entries were more than the list held, those of the
        // groups whose least Q lies below minv
        const int hi = rows[G - 1];
        int* dr = cur ? lr0 : lr1;
        T* dq = cur ? lq0 : lq1;
        if (!stage && over) {
          // the groups that may hold one, in order: thread t takes the
          // t-th contiguous run of them
          const int ng = G * gps, per = (ng + kThreads - 1) / kThreads;
          const int g0 = min(tid * per, ng), g1 = min(g0 + per, ng);
          auto may = [&](int g) {
            const int b = g / gps;
            return (g % gps) * 32 < s_pre[b + 1] - s_pre[b]
                   && __ldcg(S.list_gmin + g) < minv;
          };
          int nq = 0;
          for (int g = g0; g < g1; ++g) nq += may(g);
          int ngr;
          int q0 = block_scan(nq, ngr);
          for (int g = g0; g < g1; ++g)
            if (may(g)) s_qg[q0++] = g;
          __syncthreads();
          f = fill_list(
              32 * ngr,
              [&](int p, int& r, T& q) {
                const int g = s_qg[p / 32], b = g / gps;
                const int e = (g % gps) * 32 + p % 32;
                r = 0;
                if (e < s_pre[b + 1] - s_pre[b]) {
                  r = __ldcg(S.list_r + b * sl + e);
                  q = __ldcg(S.list_q + b * sl + e);
                  if (r >= hi) r = 0;  // scanned: no candidate
                }
              },
              minv, dr, dq, cap);
          total = f.x;
          over = total > cap;
          ++nrefill;
        } else {
          f = fill_list(
              min(total, cap) - G,
              [&](int p, int& r, T& q) {
                r = rows[G + p];
                q = qs[G + p];
              },
              minv, dr, dq, cap);
          total = f.x;
          if (spos < slen && total < cap) {
            f = fill_list(
                slen - spos,
                [&](int p, int& r, T& q) {
                  r = m_t - 1 - (spos + p);
                  q = Qs[r];
                },
                minv, dr + total, dq + total, cap - total);
            total += f.x;
            spos += f.y;
            ++nrefill;
          }
        }
        cur ^= 1;
        MARK(kPSelect);
      }
      MARK(kPSelect);  // a list with no candidate
    }

    const int i = pi, j = pj;
    if (i == 0 && j == 0) {  // no joinable pair: every block takes this
      if (lead) {
        I[t] = J[t] = 0;
        LI[t] = LJ[t] = (T)-1;
      }
      grid.sync();  // the passes' write-backs, before Q[last] is written
      if (tid == 0) {
        Q[last] = big;
        seed = 0;
        nminv = big;
        npi = npj = 0;
        if (stage && t + 1 < t1) {  // Q for the next join, patched
          npatch = 1;
          patch_idx[0] = last;
          patch_val[0] = big;
          qwant = m_t - 1;
          qdone = copy_q(Qs, Q, qwant, n, mbq);
        }
      }
      continue;
    }

    // ---- limbs (nj.c:42-109), the same in every block
    const T Dij = __ldcg(D + (size_t)i * ld + j);
    const T sDi = __ldcg(sD + i), sDj = __ldcg(sD + j);
    const int Ni = __ldcg(N + i) - 2, Nj = __ldcg(N + j) - 2;
    if (track && !exact) {  // a sum the pair reads may not be exact
      stop = t;
      break;
    }
    T Li, Lj;
    if (Ni > 0 && Nj > 0) {
      const T delta = F::sub(F::div(F::sub(sDi, Dij), F::of(Ni)),
                             F::div(F::sub(sDj, Dij), F::of(Nj)));
      Li = F::div(F::add(Dij, delta), (T)2);
      Lj = F::div(F::sub(Dij, delta), (T)2);
    } else if (Ni > 0) {
      Li = (T)0;
      Lj = Dij;
    } else if (Nj > 0) {
      Li = Dij;
      Lj = (T)0;
    } else {
      Li = Lj = F::div(Dij, (T)2);
    }
    if (!neg_limbs) {
      if (Li < (T)0) {
        Li = (T)0;
        Lj = Dij;
      } else if (Lj < (T)0) {
        Li = Dij;
        Lj = (T)0;
      }
    }
    if (lead) {
      I[t] = i;
      J[t] = j;
      LI[t] = Li;
      LJ[t] = Lj;
    }
    MARK(kPLimbs);

    // block k's cells: one contiguous chunk of [0, m_t), in tiles of
    // kThreads (the same number of tiles for every thread of the block)
    const int chunk = (m_t + G - 1) / G;
    const int lo = min(k * chunk, m_t), hi_k = min(lo + chunk, m_t);
    const T* rowi = D + (size_t)i * ld;
    T* rowj = D + (size_t)j * ld;
    Part<T> part = {(T)0, (T)0, INT_MIN, 0};

    if (Complete) {
      // (A) updateD, both cells present: d2 stored in row and column j,
      // sD[k] and N[k] updated in place (k != i, j).  No reader of this
      // join needs what it overwrites: the limbs read D_ij, sD and N of
      // i and j only, which no thread writes here.
      for (int k0 = lo; k0 < hi_k; k0 += kThreads) {
        const int kk = k0 + tid;
        if (kk >= hi_k || kk == i || kk == j) continue;
        const T dik = __ldcg(rowi + kk), dkj = __ldcg(rowj + kk);
        const T s = F::add(dik, dkj);
        T d2 = F::div(F::sub(s, Dij), (T)2);
        if (d2 < (T)0) d2 = (T)0;
        sD[kk] = F::add(__ldcg(sD + kk), -F::sub(s, d2));
        N[kk] = __ldcg(N + kk) - 1;
        rowj[kk] = d2;
        D[(size_t)kk * ld + j] = d2;
        part.sum = F::add(part.sum, d2);
        part.abs = F::add(part.abs, d2 < (T)0 ? -d2 : d2);
        part.places = max(part.places, F::places(d2));
        ++part.count;
      }
    } else {
      // (A0) row j as it was, for the garbage reads of other cells; the
      // advancing cells of this chunk on each side of j
      int cr = 0, cc = 0;
      for (int k0 = lo; k0 < hi_k; k0 += kThreads) {
        const int kk = k0 + tid;
        if (kk >= hi_k) continue;
        const T dkj = __ldcg(rowj + kk);
        S.oldj[kk] = dkj;
        const bool adv = kk != i && kk != j &&
                         (__ldcg(rowi + kk) >= (T)0 || dkj >= (T)0);
        cr += adv && kk < j;
        cc += adv && kk > j;
      }
      const int2 c2 = block_sum2(cr, cc);
      if (tid == 0) {
        S.adv_r[k] = c2.x;
        S.adv_c[k] = c2.y;
      }
      MARK(kPA0);
      grid.sync();
      MARK(kPBarrierA0);

      // (A) updateD with its walker slots: cell k's sD and N updates
      // land in slot wpos (k < j) or nr + 1 + (k > i) + prevc (k > j),
      // all distinct but for slot j, which is rebuilt in phase B (its
      // updates are dropped here); row and column j written
      int pre_r = 0, pre_c = 0, nr = 0;
      for (int b = tid; b < G; b += kThreads) {
        const int a = __ldcg(S.adv_r + b), c = __ldcg(S.adv_c + b);
        nr += a;
        if (b < k) {
          pre_r += a;
          pre_c += c;
        }
      }
      const int2 pre = block_sum2(pre_r, pre_c);
      nr = block_sum2(nr, 0).x;
      int run_r = pre.x, run_c = pre.y;
      const long long offj = (long long)j * (j - 1) / 2;
      for (int k0 = lo; k0 < hi_k; k0 += kThreads) {
        const int kk = k0 + tid;
        const bool in = kk < hi_k && kk != i && kk != j;
        const T dik = in ? __ldcg(rowi + kk) : (T)-1;
        const T dkj = in ? __ldcg(S.oldj + kk) : (T)-1;
        const bool vi = dik >= (T)0, vj = dkj >= (T)0;
        const bool adv = in && (vi || vj);
        // the exclusive prefix counts of advancing cells on each side
        const unsigned br = __ballot_sync(kFullMask, adv && kk < j);
        const unsigned bc = __ballot_sync(kFullMask, adv && kk > j);
        const unsigned below = (1u << lane) - 1;
        if (lane == 0) {
          s_wcr[warp] = __popc(br);
          s_wcc[warp] = __popc(bc);
        }
        __syncthreads();
        int wr = run_r + __popc(br & below), wc = run_c + __popc(bc & below);
        for (int w = 0; w < kWarps; ++w) {
          if (w < warp) {
            wr += s_wcr[w];
            wc += s_wcc[w];
          }
          run_r += s_wcr[w];
          run_c += s_wcc[w];
        }
        __syncthreads();  // s_wcr, s_wcc free for the next tile
        if (!in) continue;
        const bool both = vi && vj, only_i = vi && !vj, only_j = !vi && vj;
        const T s = F::add(dik, dkj);
        T d2 = F::div(F::sub(s, Dij), (T)2);
        if (d2 < (T)0) d2 = (T)0;
        const T stored = both     ? d2
                         : only_i ? F::sub(dik, Li)
                         : only_j ? F::sub(dkj, Lj)
                                  : dkj;
        T contrib = stored;
        if (only_j && kk > j) {
          // the out-of-row read of nj.c:1022: ltd cell off(j) + k, row
          // r, column c; in column j it reads what the sweep stored
          // there already (rows j < r < k but i) or the old cell
          const long long f = offj + kk;
          const long long r = ltd_row(f);
          const int c = (int)(f - r * (r - 1) / 2), rr = (int)r;
          T garb;
          if (c != j) {
            garb = __ldcg(D + (size_t)rr * ld + c);  // outside row/col j
          } else if (rr == kk) {
            garb = stored;
          } else {
            const T oj = __ldcg(S.oldj + rr);
            garb = oj;
            if (rr < kk && rr != i) {
              const T ri = __ldcg(rowi + rr);
              const bool rvi = ri >= (T)0, rvj = oj >= (T)0;
              if (rvi || rvj) {  // row rr advanced: its stored value
                if (rvi && rvj) {
                  T e = F::div(F::sub(F::add(ri, oj), Dij), (T)2);
                  garb = e < (T)0 ? (T)0 : e;
                } else {
                  garb = rvi ? F::sub(ri, Li) : F::sub(oj, Lj);
                }
              }
            }
          }
          contrib = F::sub(stored, garb);
        }
        if (adv) {
          const int tgt = kk < j ? wr : nr + 1 + (kk > i) + wc;
          if (tgt != j) {
            const T delta = both           ? -F::sub(s, d2)
                            : only_i       ? -Li
                            : kk < j       ? -Lj
                                           : contrib;
            sD[tgt] = F::add(__ldcg(sD + tgt), delta);
            if (!only_i) N[tgt] = __ldcg(N + tgt) - 1;
          }
          part.sum = F::add(part.sum, contrib);
          part.abs = F::add(part.abs, contrib < (T)0 ? -contrib : contrib);
          part.places = max(part.places, F::places(contrib));
          ++part.count;
        }
        rowj[kk] = stored;
        D[(size_t)kk * ld + j] = stored;
      }
    }
    part = block_part(part);
    if (tid == 0) {
      S.part_sum[k] = part.sum;
      S.part_abs[k] = part.abs;
      S.part_places[k] = part.places;
      S.part_count[k] = part.count;
    }
    MARK(kPA);
    grid.sync();
    MARK(kPBarrierA);

    // (B) sD[j], N[j] and the exact flag from the partials (every block,
    // in block order); the repairs of row and column j; popArrange with
    // the repairs of row and column i.  Thread k reads and writes Q[k]
    // only; it reads row last, which no thread writes here but for cell
    // (last, i), which its reader, k = i, takes as 0 instead.
    Part<T> tot = {(T)0, (T)0, INT_MIN, 0};
    for (int b = tid; b < G; b += kThreads) {
      tot.sum = F::add(tot.sum, __ldcg(S.part_sum + b));
      tot.abs = F::add(tot.abs, __ldcg(S.part_abs + b));
      tot.places = max(tot.places, __ldcg(S.part_places + b));
      tot.count += __ldcg(S.part_count + b);
    }
    tot = block_part(tot);
    const T sdj = tot.sum;
    const int nj = 1 + tot.count;
    if (track)  // sums_exact: every summand on the grid 2^-(mant - e)
      exact = exact &&
              tot.places <= F::kMant - F::exponent(F::add(tot.abs, (T)1));
    const bool pop = i != last;
    const T sdl = __ldcg(sD + last);
    const int nl = __ldcg(N + last);
    if (lead) {
      sD[j] = sdj;
      N[j] = nj;
      if (pop) {
        sD[i] = sdl;
        N[i] = nl;
      }
    }
    T bv[kReductions];
    int bx[kReductions];
#pragma unroll
    for (int r = 0; r < kReductions; ++r) {
      bv[r] = big;
      bx[r] = -1;
    }
    const T* rowl = D + (size_t)last * ld;
    T* rowi_w = D + (size_t)i * ld;
    // kk rises within a thread, so `<=` keeps the largest index at a min
    for (int k0 = lo; k0 < hi_k; k0 += kThreads) {
      const int kk = k0 + tid;
      if (kk >= hi_k || kk == i) {
        if (pop && kk == i) {
          rowi_w[i] = (T)0;
        }
        continue;
      }
      const T sk = kk == j ? sdj : __ldcg(sD + kk);
      const int nk = kk == j ? nj : __ldcg(N + kk);
      T qk = big;  // Q[kk] as this thread last wrote or read it
      if (kk != j) {
        const T cj = __ldcg(rowj + kk);
        const T q = F::sub(F::sub(F::mul(F::of((nj + nk - 4) >> 1), cj), sdj),
                           sk);
        if (kk < j) {
          if (cj >= (T)0 && q <= bv[kRowJ]) {
            bv[kRowJ] = q;
            bx[kRowJ] = kk;
          }
        } else {
          qk = __ldcg(Q + kk);
          if (cj >= (T)0 && q <= qk) {
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
        const T v = kk == last ? (T)-1 : __ldcg(rowl + kk);
        rowi_w[kk] = v;
        D[(size_t)kk * ld + i] = v;
        if (v >= (T)0 && kk < last) {
          const T q = F::sub(
              F::sub(F::mul(F::of((nl + nk - 4) >> 1), v), sdl), sk);
          if (kk < i) {
            if (q <= bv[kRowI]) {
              bv[kRowI] = q;
              bx[kRowI] = kk;
            }
          } else if (q <= qk) {  // kk > i > j: qk holds Q[kk] after column j
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
    block_best(bv, bx);
    if (tid == 0)
#pragma unroll
      for (int r = 0; r < kReductions; ++r) {
        S.red_v[r * G + k] = bv[r];
        S.red_x[r * G + k] = bx[r];
      }
    MARK(kPB);
    grid.sync();
    MARK(kPBarrierB);
    // Q is final but for the three entries phase C writes (patched in):
    // copy it for the next join now
    if (stage && tid == 0 && t + 1 < t1) {
      qwant = m_t - 1;
      qdone = copy_q(Qs, Q, qwant, n, mbq);
    }

    // (C) every block: the reductions, Q and P of rows j and i, Q[last],
    // the seed, the next scan's start
#pragma unroll
    for (int r = 0; r < kReductions; ++r) {
      bv[r] = big;
      bx[r] = -1;
    }
    for (int b = tid; b < G; b += kThreads)
#pragma unroll
      for (int r = 0; r < kReductions; ++r)
        take_better(bv[r], bx[r], __ldcg(S.red_v + r * G + b),
                    __ldcg(S.red_x + r * G + b));
    block_best(bv, bx);
    if (tid == 0) {
      const T Qj = bv[kRowJ];
      Q[j] = Qj;
      P[j] = Qj == big ? 0 : bx[kRowJ];
      const int mi = bx[kColJ] >= 0 && bv[kColJ] <= Qj ? bx[kColJ] : j;
      int mj = 0;
      if (pop) {
        const T Qi = bv[kRowI];
        Q[i] = Qi;
        P[i] = Qi == big ? 0 : bx[kRowI];
        mj = bx[kColI] >= 0 && bv[kColI] <= Qi ? bx[kColI] : i;
      }
      Q[last] = big;
      if (stage) {
        npatch = 0;
        patch_idx[npatch] = j;
        patch_val[npatch++] = Qj;
        if (pop) {
          patch_idx[npatch] = i;
          patch_val[npatch++] = bv[kRowI];
        }
        patch_idx[npatch] = last;
        patch_val[npatch++] = big;
      }
      const T qmj = __ldcg(Q + mj), qmi = __ldcg(Q + mi);
      // the default design loads P of both candidates with their Q
      const int pmj = Rows ? 0 : __ldcg(P + mj), pmi = Rows ? 0 : __ldcg(P + mi);
      bool to_mj;
      if (mj == last)
        to_mj = false;
      else if (mi == last)
        to_mj = true;
      else
        to_mj = qmj < qmi || (mi < mj && qmj == qmi);
      seed = to_mj ? mj : mi;
      const T qs = to_mj ? qmj : qmi;
      const bool ok = seed != 0 && qs != big;
      nminv = ok ? qs : big;
      npi = ok ? (int)seed : 0;
      npj = !ok ? 0 : Rows ? __ldcg(P + seed) : to_mj ? pmj : pmi;
    }
    MARK(kPC);
  }
  if (prof)
    for (int p = 0; p < kPhases; ++p) {
      if (k == 0) counters[p] += acc[p];
      S.block_prof[k * kPhases + p] += acc[p];
    }
  if (tid == 0) {
    if (nreval) atomicAdd(stats + 1, (unsigned long long)nreval);
    if (k == 0) {
      stats[0] += (unsigned long long)npass;
      *seed_p = seed;
      if (track) *exact_p = exact;
      if (stop >= 0) *first_inexact = stop;
      if (!Rows) {
        counters[kSerial] = tag0 - 1 + npass;
        counters[kRefills] += nrefill;
      }
    }
  }
}


template <typename T, bool Complete, bool Rows>
const void* kernel_of() {
  return (const void*)dnj_segment_float_kernel<T, Complete, Rows>;
}

template <typename T>
const void* kernel_for_type(bool complete, bool rows) {
  if (rows)
    return complete ? kernel_of<T, true, true>() : kernel_of<T, false, true>();
  return complete ? kernel_of<T, true, false>() : kernel_of<T, false, false>();
}

const void* kernel_for(int flags) {
  const bool complete = flags & kComplete, rows = flags & kRows;
  return (flags & kFloat32) ? kernel_for_type<float>(complete, rows)
                            : kernel_for_type<double>(complete, rows);
}

// the kernel's dynamic shared memory limit set for a launch of `flags`
cudaError_t set_smem(int flags, int n, int G, size_t& smem) {
  smem = smem_bytes(flags, n, G);
  return cudaFuncSetAttribute(kernel_for(flags),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// 1 where the dynamic shared memory of a launch of `flags` (the
// instance, the design, kStageQ) at n rows and G blocks fits beside the
// kernel's static shared memory in a block of the current device, 0
// where it does not, or minus a cudaError_t less 1.
int dnj_segment_float_fits(int flags, int n, int G) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel_for(flags));
  if (e != cudaSuccess) return -(int)e - 1;
  return (long long)attr.sharedSizeBytes +
                 (long long)smem_bytes(flags, n, G) <=
             (long long)optin
             ? 1
             : 0;
}

// The largest grid one cooperative launch of `flags` at n rows and G
// blocks can hold on the current device, or minus a cudaError_t.  Sets
// the kernel's dynamic shared memory limit first, as the launch does.
int dnj_segment_float_max_blocks(int flags, int n, int G) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  size_t smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = set_smem(flags, n, G, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for(flags), kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return coop ? sms * per_sm : 0;
}

// Bytes of scratch a launch of G blocks at n rows needs (flags as
// above): the int64 counters (kProfile's, the pass serial, the list's
// refills), then `Layout`.
int dnj_segment_float_scratch_bytes(int G, int n, int flags) {
  return kCounterBytes + (int)((flags & kFloat32) ? Layout<float>::bytes(G, n)
                                                  : Layout<double>::bytes(G, n));
}

// D: (n, n) of T (double, or float with kFloat32); sD, Q, LI, LJ: n of
// T; N, P, I, J: n int32; seed: one int64; exact: one bool or null (no
// tracking); first_inexact: one int32, written only where the launch
// stops; stats: two uint64 (added to); 0 <= t0 <= t1 <= m - 2, m <= n;
// D, sD, N and Q 16-byte aligned; scratch:
// dnj_segment_float_scratch_bytes(G, n, flags), zeroed before a run's
// first launch, 8-byte aligned; 1 <= G <= dnj_segment_float_max_blocks;
// without kRows G <= 256 (a block scans one list entry a thread).
// kComplete only
// where no active cell is missing.  The state is updated in place.
int dnj_segment_float(void* D, int n, void* sD, void* N, void* Q, void* P,
                      void* seed, void* I, void* J, void* LI, void* LJ,
                      void* exact, void* first_inexact, void* stats, int t0,
                      int t1, int m, int neg_limbs, int G, void* scratch,
                      int flags, void* stream) {
  if (!(flags & kRows) && G > kThreads) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t e = set_smem(flags, n, G, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&D,  &n,     &sD,    &N,  &Q,  &P,
                  &seed, &I,   &J,     &LI, &LJ, &exact,
                  &first_inexact, &stats, &t0, &t1, &m, &neg_limbs,
                  &scratch, &flags};
  e = cudaLaunchCooperativeKernel(kernel_for(flags), dim3(G), dim3(kThreads),
                                  args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
