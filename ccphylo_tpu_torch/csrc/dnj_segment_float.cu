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
// What bounds it on an H100: not bytes (the body moves ~10 cells of 8
// bytes a row k, about 2.6 MB at m_t = 32768, and a scan pass a few
// rows: microseconds of HBM time) but latency: the plain loop spends
// 100-370 launches and 3-4 host reads a join, and in one launch the
// grid barriers and chains of dependent loads remain.  So, as
// csrc/dnj_segment.cu (the packed engine's segment kernel) does: one
// cooperative launch of G blocks for the segment; a grid barrier per
// scan pass and after each body phase (A0, A, B); none after the last
// phase, since every block reduces the partials of phase B itself and
// takes the same pair, Q[j], Q[i], seed.
// Thread 0 of every block writes the same values of Q and P in phase C.
// Every block keeps the exact flag in a register, so a stop needs no
// barrier: all blocks take the same branch at the same join.  Q is read
// through L2 (no copy in shared memory in this version).
//
// Arithmetic: each step is one IEEE operation rounded to nearest, as the
// plain version's separate PyTorch operations are; the intrinsics
// (__dmul_rn, __dsub_rn, ...) keep nvcc from contracting a multiply and
// a subtraction into a fused multiply-add.
//
// Coherence: every read of state that another block may have written
// earlier in the launch goes through L2 (__ldcg), never through the
// read-only path.  Ownership: block k owns the cells k of one contiguous
// chunk of [0, m_t) in every body phase; the scan's row r is block k's
// for the pass whose candidate of rank k it is.  Hazards between joins:
// every write of join t + 1 that a reader of join t may still need
// follows a barrier that reader has passed (see the notes at each
// phase).  Every loop condition and branch around a grid barrier reads
// values that every block holds alike (total candidates, the pair, the
// exact flag), so no block leaves early.

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

enum : int { kFloat32 = 1, kComplete = 2 };  // flags of the entry point

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

// the scratch, by the offsets of `Layout`
template <typename T>
struct Layout {
  T* scan_v;   // 2 x G: each block's row minimum, by pass parity
  T* part_sum;  // G: phase A's partials
  T* part_abs;  // G
  T* red_v;    // 4 x G: phase B's minima
  T* oldj;     // n: row j before the join (missing cells only)
  int* scan_x;  // 2 x 2 x G: column and row of each block's minimum
  int* part_places;  // G
  int* part_count;   // G
  int* red_x;  // 4 x G
  int* adv_r;  // G: advancing cells k < j of each block's chunk
  int* adv_c;  // G: advancing cells k > j
  __host__ __device__ Layout(void* base, int G, int n) {
    T* f = static_cast<T*>(base);
    scan_v = f;
    part_sum = scan_v + 2 * G;
    part_abs = part_sum + G;
    red_v = part_abs + G;
    oldj = red_v + 4 * G;
    int* i = reinterpret_cast<int*>(oldj + n);
    scan_x = i;
    part_places = scan_x + 4 * G;
    part_count = part_places + G;
    red_x = part_count + G;
    adv_r = red_x + 4 * G;
    adv_c = adv_r + G;
  }
  static size_t bytes(int G, int n) {
    return sizeof(T) * (8 * (size_t)G + n) + sizeof(int) * 12 * (size_t)G;
  }
};

// the four reductions of phase B
enum { kRowJ = 0, kColJ = 1, kRowI = 2, kColI = 3, kReductions = 4 };

template <typename T, bool Complete>
__global__ void __launch_bounds__(kThreads)
dnj_segment_float_kernel(T* D, int n, T* sD, int* N, T* Q, int* P,
                         long long* seed_p, int* I, int* J, T* LI, T* LJ,
                         unsigned char* exact_p, int* first_inexact,
                         unsigned long long* stats, int t0, int t1, int m,
                         int neg_limbs, void* scratch) {
  using F = Num<T>;
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
  Layout<T> S(scratch, G, n);

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
  int par = 0, npass = 0, nreval = 0;

  for (int t = t0; t < t1; ++t) {
    const int m_t = m - t, last = m_t - 1;
    if (tid == 0) {
      s_minv = nminv;
      s_pi = npi;
      s_pj = npj;
    }
    __syncthreads();
    T minv = s_minv;
    int pi = s_pi, pj = s_pj;

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
      T* bv = S.scan_v + par * G;
      int* bx = S.scan_x + par * 2 * G;
      if (tid == 0) {
        bv[k] = rmin[0];
        bx[k] = rarg[0];
        bx[G + k] = valid ? r : -1;
      }
      grid.sync();
      par ^= 1;

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
      if (total <= G) break;  // every candidate was scanned
      hi = s_hnext;           // the rest lie below the last selected row
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
      grid.sync();

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
    grid.sync();

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
    grid.sync();

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
      const T qmj = __ldcg(Q + mj), qmi = __ldcg(Q + mi);
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
      npj = ok ? __ldcg(P + seed) : 0;
    }
  }
  if (tid == 0) {
    if (nreval) atomicAdd(stats + 1, (unsigned long long)nreval);
    if (k == 0) {
      stats[0] += (unsigned long long)npass;
      *seed_p = seed;
      if (track) *exact_p = exact;
      if (stop >= 0) *first_inexact = stop;
    }
  }
}

template <typename T, bool Complete>
const void* kernel_of() {
  return (const void*)dnj_segment_float_kernel<T, Complete>;
}

const void* kernel_for(int flags) {
  const bool f32 = flags & kFloat32, complete = flags & kComplete;
  if (f32)
    return complete ? kernel_of<float, true>() : kernel_of<float, false>();
  return complete ? kernel_of<double, true>() : kernel_of<double, false>();
}

}  // namespace

extern "C" {

// The largest grid one cooperative launch of the instance `flags`
// (kFloat32, kComplete) can hold on the current device, or minus a
// cudaError_t.
int dnj_segment_float_max_blocks(int flags) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for(flags), kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  return coop ? sms * per_sm : 0;
}

// Bytes of scratch a launch of G blocks at n rows needs (flags as
// above).
int dnj_segment_float_scratch_bytes(int G, int n, int flags) {
  return (int)((flags & kFloat32) ? Layout<float>::bytes(G, n)
                                  : Layout<double>::bytes(G, n));
}

// D: (n, n) of T (double, or float with kFloat32); sD, Q, LI, LJ: n of
// T; N, P, I, J: n int32; seed: one int64; exact: one bool or null (no
// tracking); first_inexact: one int32, written only where the launch
// stops; stats: two uint64 (added to); 0 <= t0 <= t1 <= m - 2, m <= n;
// scratch: dnj_segment_float_scratch_bytes(G, n, flags), 8-byte
// aligned; 1 <= G <= dnj_segment_float_max_blocks(flags).  kComplete
// only where no active cell is missing.  The state is updated in place.
int dnj_segment_float(void* D, int n, void* sD, void* N, void* Q, void* P,
                      void* seed, void* I, void* J, void* LI, void* LJ,
                      void* exact, void* first_inexact, void* stats, int t0,
                      int t1, int m, int neg_limbs, int G, void* scratch,
                      int flags, void* stream) {
  void* args[] = {&D,  &n,     &sD,    &N,  &Q,  &P,
                  &seed, &I,   &J,     &LI, &LJ, &exact,
                  &first_inexact, &stats, &t0, &t1, &m, &neg_limbs,
                  &scratch};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_for(flags), dim3(G), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
