// The whole batch scan of one DNJ join in one launch (Hopper, sm_90a).
//
// Replaces the `bcond`/`bbody` while_loop of the reference's one_join
// (ccphylo_tpu/tree/packed_engine.py:157-214) together with the Pallas
// kernel it calls per pass, ccphylo_tpu/ops/scan_pallas.py::_kernel
// (:49-84).  Its plain form is ops/scan.py::dnj_scan_plain, a loop of
// about 30 small tensor operations and one host read per pass around
// qrow_mins.
//
// What it computes.  Q[r] caches the minimum of row r's join criterion
// and P[r] its column; the caches may be stale (too low).  Start from
// the seed row's (minv, pi, pj).  While some row r in [1, m_t) has
// Q[r] < minv: take the K largest such rows, in descending order;
// compute each row's true (rmin, rarg) as qrow_mins does; write
// (rmin, rarg) back to (Q[r], P[r]) where Q[r] undercuts the running
// minimum of minv and the rmin of the rows before it in that order (the
// C's cache rule); lower (minv, pi, pj) to the pass's smallest rmin,
// ties to the larger row.  Returns out = (pi, pj, passes, rows whose Q
// changed).
//
// Two facts shape the kernel.  (a) A scanned row ends its pass with
// Q[r] >= the new minv, and minv only falls, so within a join no row is
// a candidate twice: the candidates of the next pass are the candidates
// below this pass's smallest selected row, and there is a next pass
// only if this one found more than K.  So the walk of pass p+1 reads
// only Q entries that no pass has written, no barrier is needed between
// the write-back and the next walk, and the changed rows can be counted
// where they are written.  (b) Block k needs only the candidate of rank
// k and the total, both pure functions of (Q below the bound, minv), so
// every block makes the selection for itself and no barrier separates
// selection from the row scan.
//
// What bounds it on Hopper: latency, then bytes.  A join reads Q once
// per pass (4*m_t bytes, L2-resident) and the c < r prefix of each
// scanned row with the matching sd2 entries, a few integer operations
// per byte; at the engine's sizes that is microseconds of HBM time, so
// the cost is the chain of dependent steps.  Design: one cooperative
// launch of K blocks of 256 threads (co-resident: the host side checks
// the occupancy), one grid barrier per pass.  Per pass, each block
// (1) counts the candidates below the bound, each warp over its own
// contiguous stripe of Q in 16-byte loads, top stripe first; the warp
// whose stripe holds rank k walks it again with ballots to find row k;
// (2) scans row k with the row body shared with qrow_mins
// (row_min.cuh) and publishes (rmin, rarg, row) to a scratch buffer
// picked by the parity of the pass; grid barrier; (3) warp 0 of every
// block reduces the K published triples to the new (minv, pi, pj) and
// to the prefix minimum before k, and writes back its own row.  The
// host reads out once per join.

#include <cooperative_groups.h>

#include "row_min.cuh"

namespace cg = cooperative_groups;

namespace {

// candidate test of one Q entry: index in [1, hi) and cached Q below minv
__device__ __forceinline__ bool cand(int q, int idx, int hi, int minv) {
  return idx >= 1 && idx < hi && q < minv;
}

__global__ void __launch_bounds__(kThreads)
dnj_scan_kernel(const uint4* __restrict__ words,
                const int* __restrict__ sd2, int n, int* Q, int* P,
                const long long* __restrict__ seed_p, int m_t, int co,
                int* scratch, int* out) {
  cg::grid_group grid = cg::this_grid();
  const int K = gridDim.x, k = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __shared__ int s_wcnt[kWarps];
  __shared__ int s_row;
  __shared__ int s_state[4];  // minv, pi, pj, bound of the next walk

  const int seed = (int)*seed_p;
  int minv = kIBig, pi = 0, pj = 0;
  {
    const int qs = Q[seed];
    if (seed != 0 && qs != kIBig) {
      minv = qs;
      pi = seed;
      pj = P[seed];
    }
  }

  const int4* Q4 = reinterpret_cast<const int4*>(Q);
  int hi = m_t, npass = 0, nchanged = 0;
  for (;;) {
    // (1) selection.  Q is cut into groups of 128 entries (one int4 per
    // lane); warp w owns a contiguous stripe of groups, warp 0 the top.
    const int G = (hi + 127) / 128;
    const int gpw = (G + kWarps - 1) / kWarps;
    const int gtop = G - 1 - warp * gpw;
    const int gbot = max(gtop - gpw + 1, 0);
    int cnt = 0;
    for (int g = gtop; g >= gbot; --g) {
      const int4 q = Q4[g * 32 + lane];
      const int base = g * 128 + lane * 4;
      cnt += (int)cand(q.x, base, hi, minv) + (int)cand(q.y, base + 1, hi, minv)
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
    // total is the same in every block: all blocks leave together
    if (total == 0) break;
    const bool valid = k < total;
    if (valid && above <= k && k < above + cnt) {
      // rank k lies in this warp's stripe: walk it again, descending
      int seen = above;
      for (int g = gtop; g >= gbot; --g) {
        const int4 q = Q4[g * 32 + lane];
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
        // candidates of this group in higher lanes come first, then this
        // lane's own entries from the top
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

    // (2) row k, published for every block
    int rmin = kIBig, rarg = -1;
    if (valid) {
      row_min_block(r, r, co, words, sd2, n, rmin, rarg);
      if (rmin == kIBig) rarg = n - 1;  // as the masked full-width reduction
    }
    int* buf = scratch + (npass & 1) * 3 * K;
    if (threadIdx.x == 0) {
      buf[k] = rmin;
      buf[K + k] = rarg;
      buf[2 * K + k] = valid ? r : -1;
    }
    grid.sync();

    // (3) gating, write-back of row k, new (minv, pi, pj)
    if (warp == 0) {
      int bv = kIBig, br = -1, ba = 0, before = minv;
      for (int kk = lane; kk < K; kk += 32) {
        const int v = __ldcg(buf + kk);
        const int row = __ldcg(buf + 2 * K + kk);
        if (kk < k) before = min(before, v);
        if (v < bv || (v == bv && row > br)) {
          bv = v;
          br = row;
          ba = __ldcg(buf + K + kk);
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
        if (valid) {
          const int qr = Q[r];
          if (qr < before) {
            Q[r] = rmin;
            P[r] = rarg;
            nchanged += (int)(rmin != qr);
          }
        }
        const bool better = bv < minv;
        s_state[0] = better ? bv : minv;
        s_state[1] = better ? br : pi;
        s_state[2] = better ? ba : pj;
        s_state[3] = __ldcg(buf + 2 * K + K - 1);
      }
    }
    __syncthreads();
    minv = s_state[0];
    pi = s_state[1];
    pj = s_state[2];
    ++npass;
    if (total <= K) break;  // every candidate was scanned
    hi = s_state[3];        // the rest lie below the last selected row
  }
  if (threadIdx.x == 0) {
    if (k == 0) {
      out[0] = pi;
      out[1] = pj;
      out[2] = npass;
    }
    if (nchanged) atomicAdd(out + 3, nchanged);
  }
}

}  // namespace

extern "C" {

// The largest K that one cooperative launch of dnj_scan can hold on the
// current device (co-resident blocks), or minus a cudaError_t.
int dnj_scan_max_blocks() {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dnj_scan_kernel, kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  return coop ? sms * per_sm : 0;
}

// words: (n, n/4) u32; sd2, Q, P: n int32; words, sd2 and Q 16-byte
// aligned; n % 128 == 0; seed: one int64 in [0, n); 1 <= m_t <= n;
// scratch: 6 * K int32; out: 4 int32 (pi, pj, passes, changed rows).
// 1 <= K <= dnj_scan_max_blocks().  Q and P are updated in place.
int dnj_scan(const void* words, const void* sd2, int n, void* Q, void* P,
             const void* seed, int m_t, int co, int K, void* scratch,
             void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, 4 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&words, &sd2, &n, &Q, &P, &seed, &m_t, &co, &scratch, &out};
  e = cudaLaunchCooperativeKernel((const void*)dnj_scan_kernel, dim3(K),
                                  dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
