// Batch-scan row minima of the packed DNJ engine (Hopper, sm_90a).
//
// Replaces ccphylo_tpu/ops/scan_pallas.py::_kernel (:49-84), launched by
// qrow_mins (:88-121); its plain form is the jnp expression at
// ccphylo_tpu/tree/packed_engine.py:183-189.
//
// What it computes.  The u8 distance matrix is stored as u32 words, four
// cells per word in little-endian byte lanes (cell c of a row is byte
// c % 4 of word c / 4).  For each of K candidate rows r:
//     q[c] = co * cell[r, c] - sd2[r] - sd2[c]   for c < r, IBIG elsewhere
// and the kernel returns the row minimum and the last-wins argmin, the
// largest c at the minimum.  Where the minimum is IBIG the argmin is
// n - 1, the largest masked column, exactly as the reference's masked
// reduction over all n columns gives.  Rows may repeat; row 0 (padding)
// has no columns.  Arithmetic is int32 with two's-complement wrap, as in
// the JAX engine.
//
// What bounds it on Hopper: bytes read.  Each row streams r/4 words of
// the matrix and r sd2 entries, a few integer operations per byte.  The
// design is one block per candidate row; its threads stride the row in
// 16-byte vectors (16 cells and 16 sd2 entries per step, neighbouring
// threads on neighbouring vectors), read only the c < r prefix, keep a
// (min, largest index at min) pair each, and reduce within the block by
// warp shuffles.  The TPU version's 8x sublane over-read, its one-hot
// lane writes and its int32-only reductions are dropped.
//
// With `slotof` (the row-cache engine, tree/streamed_engine.py) `words`
// is a cache of X rows and the cells of row r lie in storage row
// slotof[r]; r itself still sets the c < r mask and sd2[r].  A row that
// is not resident (slotof[r] < 0) is scanned as a row without columns,
// as padding is, and never read.
//
// The row body lives in row_min.cuh, shared with dnj_scan.cu, which runs
// every pass of a join's scan in one launch; this kernel serves the
// engine's host-driven loop of passes (ops/scan.py::dnj_scan_passes).

#include "row_min.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
qrow_mins_kernel(const int* __restrict__ rows, int co,
                 const uint4* __restrict__ words,
                 const int* __restrict__ sd2, int n,
                 const int* __restrict__ slotof, int* __restrict__ rmin,
                 int* __restrict__ rarg) {
  const int k = blockIdx.x;
  int r = rows[k], srow = r;
  if (slotof != nullptr) {
    srow = slotof[r];
    if (srow < 0) r = srow = 0;
  }
  int best, bidx;
  row_min_block(r, srow, co, words, sd2, n, best, bidx);
  if (threadIdx.x == 0) {
    rmin[k] = best;
    rarg[k] = best == kIBig ? n - 1 : bidx;
  }
}

}  // namespace

extern "C" {

// rows: K int32 row indices in [0, n); words: (n, n/4) u32, 16-byte
// aligned; sd2: n int32, 16-byte aligned; n % 16 == 0; rmin, rarg: K int32.
// slotof: null, or n int32 with slotof[r] the storage row of r in `words`,
// then (X, n/4) u32, or < 0 where r is not resident.
int qrow_mins(const void* rows, int K, int co, const void* words, int n,
              const void* sd2, const void* slotof, void* rmin, void* rarg,
              void* stream) {
  if (K > 0)
    qrow_mins_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)rows, co, (const uint4*)words, (const int*)sd2, n,
        (const int*)slotof, (int*)rmin, (int*)rarg);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
