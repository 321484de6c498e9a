// Row body of the packed DNJ engine's batch scan, used by the qrow_mins
// kernel (qrow_mins.cu), and the block reductions that the segment
// kernel (dnj_segment.cu) uses too.
//
// The u8 distance matrix is stored as u32 words, four cells per word in
// little-endian byte lanes (cell c of a row is byte c % 4 of word
// c / 4).  For one row r:
//     q[c] = co * cell[r, c] - sd2[r] - sd2[c]   for c < r
// and the block returns the minimum and the largest c at the minimum.
// Arithmetic is int32 with two's-complement wrap (done in unsigned).
// The row body reads through the read-only path: qrow_mins writes
// neither the cells nor sd2.  dnj_segment.cu, whose join body writes
// both in the same launch, keeps a row body of its own that reads
// through L2.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIBig = INT_MAX;
constexpr unsigned kFullMask = 0xffffffffu;

// the better of two (min, index) pairs: smaller value, then larger index
__device__ __forceinline__ void take_better(int& best, int& bidx, int ob,
                                            int oi) {
  if (ob < best || (ob == best && oi > bidx)) {
    best = ob;
    bidx = oi;
  }
}

// q = co * cell - a - b in int32 with two's-complement wrap
__device__ __forceinline__ int qval(int co, int cell, int a, int b) {
  return (int)((unsigned)co * (unsigned)cell - (unsigned)a - (unsigned)b);
}

// sum over the block, returned to every thread
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int s[kWarps];
  __shared__ int total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFullMask, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s[w];
    total = t;
  }
  __syncthreads();
  return total;
}

// (minimum, largest index at it) over the block, valid in thread 0;
// (kIBig, -1) for a block with no entry
__device__ __forceinline__ void block_best(int& v, int& x) {
  __shared__ int sv[kWarps], sx[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    take_better(v, x, __shfl_down_sync(kFullMask, v, off),
                __shfl_down_sync(kFullMask, x, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sv[warp] = v;
    sx[warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : kIBig;
    x = lane < kWarps ? sx[lane] : -1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take_better(v, x, __shfl_down_sync(kFullMask, v, off),
                  __shfl_down_sync(kFullMask, x, off));
  }
  __syncthreads();  // sv, sx free for the next call
}

// One block of kThreads threads scans the c < r prefix of row r in
// 16-byte vectors (16 cells and 16 sd2 entries per step, neighbouring
// threads on neighbouring vectors) and reduces by warp shuffles.  The
// result is valid in thread 0: (min, largest c at the min), or
// (kIBig, -1) for a row with no column.  Every thread of the block must
// call it; two calls in one kernel must be separated by a block barrier
// (the partials live in shared memory).  words and sd2 are 16-byte
// aligned and n % 16 == 0.  The cells of row r are read from storage row
// `srow` of `words`: r itself where the whole matrix is on the card, the
// row's slot where `words` is a cache of rows; r still sets the c < r
// mask and sd2[r].
__device__ __forceinline__ void row_min_block(int r, int srow, int co,
                                              const uint4* __restrict__ words,
                                              const int* __restrict__ sd2,
                                              int n, int& best, int& bidx) {
  const unsigned sdr = (unsigned)sd2[r];
  const uint4* row = words + (size_t)srow * (n / 16);
  const int4* sd4 = reinterpret_cast<const int4*>(sd2);
  best = kIBig;
  bidx = -1;
  const int nvec = (r + 15) / 16;
  // columns rise within a thread, so `<=` keeps the last index at the min
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 w4 = row[v];
    const uint32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 s4 = sd4[4 * v + j];
      const int ss[4] = {s4.x, s4.y, s4.z, s4.w};
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    take_better(best, bidx, __shfl_down_sync(kFullMask, best, off),
                __shfl_down_sync(kFullMask, bidx, off));
  __shared__ int sb[kWarps], si[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sb[warp] = best;
    si[warp] = bidx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? sb[lane] : kIBig;
    bidx = lane < kWarps ? si[lane] : -1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take_better(best, bidx, __shfl_down_sync(kFullMask, best, off),
                  __shfl_down_sync(kFullMask, bidx, off));
  }
}

}  // namespace
