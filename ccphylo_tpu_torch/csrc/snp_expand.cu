// ±1 3-Gram expansion of 2-bit packed sequences for the all-pairs SNP
// Gram (Hopper, sm_90a).
//
// Replaces ccphylo_tpu/ops/snp_pallas.py::_expand_kernel_shared (:69-77)
// and ::_expand_kernel_pairwise (:80-88), both launched by _expand
// (:96-137).
//
// What it computes.  Word w of sample row i holds 16 bases, base k at
// bits (30-2k, 31-2k); pair-mask bit 30-2k includes it.  Each base gives
// three int8 planes s1, s0, s1*s0 with s = 1 - 2*bit, all zero where the
// base is excluded, so that code(x).code(y) = 4*[x == y] - 1 and the
// int8 Gram G = X.X^T gives dist = (3*npos - G) / 4.  The pairwise
// kernel also writes the include plane M (one 0/1 int8 per base), whose
// Gram is the per-pair shared count.
//
// Column order is the port's own: X[i, 48*w + 3*k + c] and
// M[i, 16*w + k].  The Gram is invariant under one column permutation
// applied to both operands, so any order gives the same counts; this one
// lets a thread write its 48 (+16) bytes as three (+one) 16-byte stores.
//
// What bounds it on Hopper: write bytes.  It reads 4 (8) bytes and
// writes 48 (64) per word, so it is a pure HBM-write stream.  The design
// is one thread per (row, word), 16-byte vector stores, neighbouring
// threads on neighbouring 48-byte segments; the TPU version's
// (TI=128, WB=512) VMEM tiling and its shift-major plane segments are
// dropped.  The Gram itself is a separate int8 product (torch._int_mm),
// as the JAX package leaves it to XLA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 48 output bytes of one word packed into 12 u32 registers
__device__ __forceinline__ void signed_planes(uint32_t s, uint32_t m,
                                              uint32_t out[12]) {
#pragma unroll
  for (int q = 0; q < 12; ++q) out[q] = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int sh = 30 - 2 * k;
    const int g = (m >> sh) & 1;
    const int p1 = g * (1 - 2 * (int)((s >> (sh + 1)) & 1u));
    const int p0 = g * (1 - 2 * (int)((s >> sh) & 1u));
    const int v[3] = {p1, p0, p1 * p0};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int byte = 3 * k + c;
      out[byte >> 2] |= (uint32_t)(uint8_t)(int8_t)v[c] << (8 * (byte & 3));
    }
  }
}

// 16 include bytes (0/1) of one word
__device__ __forceinline__ uint4 include_plane(uint32_t m) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    o[k >> 2] |= ((m >> (30 - 2 * k)) & 1u) << (8 * (k & 3));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store48(int8_t* dst, const uint32_t o[12]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  d[2] = make_uint4(o[8], o[9], o[10], o[11]);
}

__global__ void expand_shared_kernel(const uint32_t* __restrict__ seqs,
                                     int ld_seq,
                                     const uint32_t* __restrict__ pm,
                                     int8_t* __restrict__ X, int n, int W) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * W) return;
  const int i = (int)(t / W), w = (int)(t % W);
  uint32_t o[12];
  signed_planes(seqs[(size_t)i * ld_seq + w], pm[w], o);
  store48(X + ((size_t)i * W + w) * 48, o);
}

__global__ void expand_pairwise_kernel(const uint32_t* __restrict__ seqs,
                                       int ld_seq,
                                       const uint32_t* __restrict__ masks,
                                       int ld_mask, int8_t* __restrict__ X,
                                       int8_t* __restrict__ M, int n,
                                       int W) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * W) return;
  const int i = (int)(t / W), w = (int)(t % W);
  const uint32_t m = masks[(size_t)i * ld_mask + w];
  uint32_t o[12];
  signed_planes(seqs[(size_t)i * ld_seq + w], m, o);
  store48(X + ((size_t)i * W + w) * 48, o);
  *reinterpret_cast<uint4*>(M + ((size_t)i * W + w) * 16) = include_plane(m);
}

constexpr int kThreads = 256;

unsigned int blocks_for(int n, int W) {
  return (unsigned int)(((long long)n * W + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// seqs: n rows of W u32 words, row stride ld_seq; pm: W u32 pair-mask
// words; X: (n, 48W) int8, contiguous and 16-byte aligned.
int snp_expand_shared(const void* seqs, int ld_seq, const void* pm, void* X,
                      int n, int W, void* stream) {
  if (n > 0 && W > 0)
    expand_shared_kernel<<<blocks_for(n, W), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)seqs, ld_seq, (const uint32_t*)pm, (int8_t*)X, n,
        W);
  return (int)cudaGetLastError();
}

// masks: n rows of W u32 pair masks, row stride ld_mask; M: (n, 16W)
// int8, contiguous and 16-byte aligned.
int snp_expand_pairwise(const void* seqs, int ld_seq, const void* masks,
                        int ld_mask, void* X, void* M, int n, int W,
                        void* stream) {
  if (n > 0 && W > 0)
    expand_pairwise_kernel<<<blocks_for(n, W), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)seqs, ld_seq, (const uint32_t*)masks, ld_mask,
        (int8_t*)X, (int8_t*)M, n, W);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
