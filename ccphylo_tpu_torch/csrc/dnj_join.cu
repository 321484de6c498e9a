// The join body of one DNJ join of the packed engine in one launch
// (Hopper, sm_90a).
//
// Replaces the jnp join body of the reference's one_join
// (ccphylo_tpu/tree/packed_engine.py:215-345), which XLA compiles into
// the device loop of joins `_packed_segment` (:450-458).  Its plain form
// is ops/join.py::dnj_join_plain, about 100 small tensor operations
// whose slices and branches need the picked pair on the host.  Here the
// pair (i, j) is read on the card from the scan's result (`out`, written
// by dnj_scan just before on the same stream), so a join is two launches
// and no host read.
//
// What it computes, on the u8 matrix D (the u32 words viewed as bytes),
// with m_t active rows, last = m_t - 1 and co_post = 2 (m_t - 3):
//  - records I, J, DIJ2 = 2 D[i][j], SDI2 = sD2[i], SDJ2 = sD2[j] (sums
//    before the update); stats[0:2] += out[2:4];
//  - updateD: for k < m_t, k != i, j: d = max(D[i][k] + D[j][k] - D[i][j],
//    0); sD2[k] -= 2 D[i][k] + 2 D[j][k] - d; sD2[j] = sum of d; row and
//    column j get min((2d + 1) >> 2, 255);
//  - cache repair of row j (Q[j], P[j]: the last minimum of
//    co_post D[j][k] - sD2[j] - sD2[k] over k < j) and of column j (for
//    j < k < m_t, k != i, Q[k] and P[k] take that value and j where it is
//    <= Q[k]);
//  - popArrange when i != last: row `last` moves into row and column i
//    over the full padded width, cell (i, i) 0; sD2[i] = sD2[last]; the
//    repair of row i and of column i (i < k < last);
//  - Q[last] = IBIG and the seed chaining of dnj.c:1026-1032.
// With no joinable pair (i == j == 0) only the records (zeros), the
// stats, Q[last] and the seed (0) are written.
//
// Design.  One cooperative launch of B blocks of kThreads threads.
// Thread g owns the indices k = g, g + B kThreads, ... in every phase,
// so a cell or cache entry that one phase writes and the next reads is
// read by its owner, and the column-j update of Q[k] precedes the
// column-i update of the same Q[k] in program order.  Three phases:
//  (A) records (block 0, thread 0; sD2[i] and sD2[j] are written only in
//      phase B), updateD of row and column j and of sD2[k], and a
//      per-block partial of sum d;
//  grid barrier: row and column j are written before row `last` (whose
//      cell j is fresh) is read and before column i overwrites D[j][i];
//      every sD2[k] is final before either repair reads it;
//  (B) every block sums the partials to sD2[j]; block 0 thread 0 writes
//      sD2[j] and sD2[i] = sD2[last] (no other thread reads either: the
//      repairs take sD2[j] from the sum, and skip k = i); the repairs of
//      row j and column j, the row move with the repairs of row i and
//      column i, each with a per-block partial (minimum, largest index
//      at it) of the four reductions;
//  grid barrier;
//  (C) block 0 reduces the partials, writes Q and P of rows j and i,
//      then Q[last] = IBIG, then reads Q for the seed.
// Every block reads the same i, j and m_t and takes the same branches,
// so no block leaves before a barrier the others wait at.  Sums and
// (min, largest index) reductions are exact in any order, so the result
// is bit-equal to the plain version whatever the blocks' order.  Reads
// of what another block may have written in this launch go through L2
// (__ldcg).
//
// What bounds it on Hopper: latency.  The bytes it must move are rows i,
// j and last read, rows and columns j and i written, sD2, Q and P read
// and written: about 30 m_t bytes, under 0.3 us at 3.35 TB/s for
// m_t = 32768.  Its cost is the two grid barriers, the strided byte
// writes of two columns and the dependent loads of each phase.  Later
// work: one persistent kernel per segment of joins, or the scan and the
// body in one launch.

#include <cooperative_groups.h>

#include "row_min.cuh"

namespace cg = cooperative_groups;

namespace {

// the four reductions of phase B, in scratch after the B partial sums
enum { kRowJ = 0, kColJ = 1, kRowI = 2, kColI = 3, kReductions = 4 };

__global__ void __launch_bounds__(kThreads)
dnj_join_kernel(unsigned char* D, int n, int* sd2, int* Q, int* P,
                long long* seed, const int* __restrict__ out, int* I, int* J,
                int* DIJ2, int* SDI2, int* SDJ2, int* stats, int t, int m_t,
                int* scratch) {
  cg::grid_group grid = cg::this_grid();
  const int B = gridDim.x, b = blockIdx.x;
  const int stride = B * kThreads;
  const int k0 = b * kThreads + threadIdx.x;
  const bool lead = b == 0 && threadIdx.x == 0;
  const int i = out[0], j = out[1];
  const int last = m_t - 1;
  const size_t N = (size_t)n;

  if (i == 0 && j == 0) {  // no joinable pair: every block leaves here
    if (lead) {
      I[t] = J[t] = DIJ2[t] = SDI2[t] = SDJ2[t] = 0;
      stats[0] += out[2];
      stats[1] += out[3];
      Q[last] = kIBig;
      *seed = 0;
    }
    return;
  }
  const unsigned char* rowi = D + (size_t)i * N;
  unsigned char* rowj = D + (size_t)j * N;
  const int cij = rowi[j];  // no phase writes D[i][j] or D[j][i] before B

  // (A) records, updateD
  if (lead) {
    I[t] = i;
    J[t] = j;
    DIJ2[t] = 2 * cij;
    SDI2[t] = sd2[i];
    SDJ2[t] = sd2[j];
    stats[0] += out[2];
    stats[1] += out[3];
  }
  int dsum = 0;
  for (int k = k0; k < m_t; k += stride) {
    if (k == i || k == j) continue;
    const int ci = rowi[k], cj = rowj[k];
    const int d = max(ci + cj - cij, 0);
    sd2[k] -= 2 * ci + 2 * cj - d;
    dsum += d;
    const unsigned char q = (unsigned char)min((2 * d + 1) >> 2, 255);
    rowj[k] = q;
    D[(size_t)k * N + j] = q;
  }
  dsum = block_sum(dsum);
  if (threadIdx.x == 0) scratch[b] = dsum;
  grid.sync();

  // (B) sD2[j], the repairs of row and column j, popArrange
  int part = 0;
  for (int bb = threadIdx.x; bb < B; bb += kThreads)
    part += __ldcg(scratch + bb);
  const int sdj = block_sum(part);
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
  // k ascends within a thread, so `<=` keeps the largest index at a min
  for (int k = k0; k < n; k += stride) {
    // sD2[k] (no repair reads k = i, whose entry block 0 writes now)
    const int sk = k == j ? sdj : (k < m_t && k != i ? __ldcg(sd2 + k) : 0);
    int qk = 0;  // Q[k] as this thread last wrote or read it
    if (k < j || (k > j && k < m_t && k != i)) {
      const int q = qval(co_post, __ldcg(rowj + k), sdj, sk);
      if (k < j) {
        if (q <= bv[kRowJ]) {
          bv[kRowJ] = q;
          bx[kRowJ] = k;
        }
      } else {
        qk = __ldcg(Q + k);
        if (q <= qk) {
          Q[k] = qk = q;
          P[k] = j;
          if (q <= bv[kColJ]) {
            bv[kColJ] = q;
            bx[kColJ] = k;
          }
        }
      }
    }
    if (pop) {
      // cell (last, i) is written below by its owner, k = last; its
      // reader, k = i, takes 0 instead
      const unsigned char v = k == i ? 0 : __ldcg(rowl + k);
      rowi_w[k] = v;
      D[(size_t)k * N + i] = v;
      if (k < i) {
        const int q = qval(co_post, v, sdl, sk);
        if (q <= bv[kRowI]) {
          bv[kRowI] = q;
          bx[kRowI] = k;
        }
      } else if (k > i && k < last) {
        const int q = qval(co_post, v, sdl, sk);
        if (q <= qk) {  // k > i > j: qk holds Q[k] after column j
          Q[k] = q;
          P[k] = i;
          if (q <= bv[kColI]) {
            bv[kColI] = q;
            bx[kColI] = k;
          }
        }
      }
    }
  }
  int* red = scratch + B;
#pragma unroll
  for (int r = 0; r < kReductions; ++r) {
    block_best(bv[r], bx[r]);
    if (threadIdx.x == 0) {
      red[(2 * r) * B + b] = bv[r];
      red[(2 * r + 1) * B + b] = bx[r];
    }
  }
  grid.sync();
  if (b != 0) return;

  // (C) block 0: the reductions, Q and P of rows j and i, the seed
#pragma unroll
  for (int r = 0; r < kReductions; ++r) {
    int v = kIBig, x = -1;
    for (int bb = threadIdx.x; bb < B; bb += kThreads)
      take_better(v, x, __ldcg(red + (2 * r) * B + bb),
                  __ldcg(red + (2 * r + 1) * B + bb));
    block_best(v, x);
    bv[r] = v;
    bx[r] = x;
  }
  if (threadIdx.x != 0) return;
  const int Qj = bv[kRowJ];
  Q[j] = Qj;
  P[j] = Qj == kIBig ? 0 : bx[kRowJ];
  const int mi = bx[kColJ] >= 0 && bv[kColJ] <= Qj ? bx[kColJ] : j;
  int mj = 0;
  if (pop) {
    const int Qi = bv[kRowI];
    Q[i] = Qi;
    P[i] = Qi == kIBig ? 0 : bx[kRowI];
    mj = bx[kColI] >= 0 && bv[kColI] <= Qi ? bx[kColI] : i;
  }
  Q[last] = kIBig;
  const int qmj = __ldcg(Q + mj), qmi = __ldcg(Q + mi);
  int s;
  if (mj == last)
    s = mi;
  else if (mi == last)
    s = mj;
  else
    s = qmj < qmi || (mi < mj && qmj == qmi) ? mj : mi;
  *seed = s;
}

}  // namespace

extern "C" {

// The largest B that one cooperative launch of dnj_join can hold on the
// current device (co-resident blocks), or minus a cudaError_t.
int dnj_join_max_blocks() {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dnj_join_kernel, kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  return coop ? sms * per_sm : 0;
}

// words: (n, n/4) u32, the u8 matrix; sd2, Q, P, I, J, DIJ2, SDI2, SDJ2:
// n int32; seed: one int64; out: the scan's 4 int32 (pi, pj, passes,
// changed rows); stats: 4 int32; 0 <= t < n; 3 <= m_t <= n; scratch:
// 9 * B int32; 1 <= B <= dnj_join_max_blocks().  Everything but out is
// updated in place.
int dnj_join(void* words, int n, void* sd2, void* Q, void* P, void* seed,
             const void* out, void* I, void* J, void* DIJ2, void* SDI2,
             void* SDJ2, void* stats, int t, int m_t, int B, void* scratch,
             void* stream) {
  void* args[] = {&words, &n,    &sd2,  &Q,     &P, &seed, &out,
                  &I,     &J,    &DIJ2, &SDI2,  &SDJ2, &stats, &t,
                  &m_t,   &scratch};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)dnj_join_kernel, dim3(B), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
