// Top-k gather and scatter over client rows, for Hopper (sm_90a).
//
// gather:  x (N, P) f32, idx (N, K) i32 -> out (N, K) f32
//            out[r, k] = x[r, idx[r, k]]
// scatter: idx (N, K) i32, vals (N, K) f32 -> out (N, n) f32
//            out[r] = 0, then out[r, idx[r, k]] = vals[r, k] for k = 0..K-1,
//            so a duplicate index within a row resolves last-wins.
//
// Replaces the Pallas TPU kernels src/repro/kernels/topk/topk.py
// (topk_gather_pallas / _gather_kernel and topk_scatter_pallas /
// _scatter_kernel), which run one grid step per row and a sequential
// fori_loop of dynamic loads / stores inside VMEM.
//
// Bound: bytes.  Both are pure data movement.  gather must read idx and
// the K addressed values of x and write K values: 12*N*K bytes.  scatter
// must read idx and vals and write the whole dense output: 8*N*K + 4*N*n.
//
// gather design: one thread per output element on a (K-chunk, row) grid;
// neighbouring threads read neighbouring idx and write neighbouring out,
// and, since the wire plane sends sorted indices, read nearby addresses of
// x, so a warp's loads of x touch few 32-byte sectors.
//
// scatter design: one launch over (column-chunk, row).  Each CTA zeroes
// its chunk of the row, then reads the row's K indices to find, with
// __syncthreads_or, whether any lies outside [0, n) and whether they
// strictly increase.  An increasing row (every honest payload:
// argpartition + sort) has no duplicate, so the CTA's threads write the
// entries that land in its chunk in parallel; any other row is walked in
// k order by one thread of each CTA, which writes the entries of its
// chunk: exactly the sequential last-wins loop.  Chunks are disjoint, so
// no two CTAs write one address, and the barrier orders the zeros before
// the scatter writes.  Chunks are sized for about two waves of CTAs over
// the card and at least kMinCols columns, so each CTA's second read of
// the row's indices (after the one that classifies them) stays cheap at
// the wire plane's widths: 1 to 48 rows, K <= 10,180, n = 25,450.
//
// Bad indices: both kernels check 0 <= idx < bound and set *err to 1
// instead of reading or writing out of bounds; the wrapper raises when it
// is set (a row with a bad index is left all zero, never passed off as a
// result).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 512;
constexpr long long kMinCols = 4096;    // least dense columns per CTA
constexpr long long kTargetCtas = 264;  // two CTAs per SM of 132
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
              float* __restrict__ out, int64_t rows, int64_t P, int64_t K,
              int* __restrict__ err) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kGatherThreads +
                    threadIdx.x;
  if (k >= K) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int j = __ldg(idx + r * K + k);
    float v = 0.f;
    if (j >= 0 && j < P) {
      v = __ldg(x + r * P + j);
    } else {
      atomicExch(err, 1);
    }
    out[r * K + k] = v;
  }
}

__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ vals,
               float* __restrict__ out, int64_t rows, int64_t K, int64_t n,
               int64_t cols, int* __restrict__ err) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int64_t c1 = c0 + cols < n ? c0 + cols : n;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    float* dst = out + r * n;
    const int* ri = idx + r * K;
    const float* rv = vals + r * K;
    for (int64_t c = c0 + threadIdx.x; c < c1; c += kScatterThreads) {
      dst[c] = 0.f;
    }
    int unordered = 0, bad = 0;
    for (int64_t k = threadIdx.x; k < K; k += kScatterThreads) {
      const int j = __ldg(ri + k);
      bad |= (j < 0 || j >= n);
      if (k + 1 < K) unordered |= (j >= __ldg(ri + k + 1));
    }
    // Both barriers also order this CTA's zeros before its scatter writes.
    bad = __syncthreads_or(bad);
    unordered = __syncthreads_or(unordered);
    if (bad) {
      if (threadIdx.x == 0) atomicExch(err, 1);  // the row stays all zero
    } else if (!unordered) {
      for (int64_t k = threadIdx.x; k < K; k += kScatterThreads) {
        const int64_t j = __ldg(ri + k);
        if (j >= c0 && j < c1) dst[j] = __ldg(rv + k);
      }
    } else if (threadIdx.x == 0) {
      for (int64_t k = 0; k < K; ++k) {
        const int64_t j = __ldg(ri + k);
        if (j >= c0 && j < c1) dst[j] = __ldg(rv + k);
      }
    }
  }
}

}  // namespace

extern "C" int topk_gather_f32(const void* x, const void* idx, void* out,
                               long long rows, long long P, long long K,
                               void* err, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(err, 0, sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (rows <= 0 || K <= 0) return 0;
  const long long blocks = (K + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid_y =
      static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY);
  gather_kernel<<<dim3(static_cast<unsigned>(blocks), grid_y),
                  kGatherThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, P, K, static_cast<int*>(err));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int topk_scatter_f32(const void* idx, const void* vals, void* out,
                                long long rows, long long K, long long n,
                                void* err, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(err, 0, sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (rows <= 0 || n <= 0) return 0;
  long long cols = (rows * n + kTargetCtas - 1) / kTargetCtas;
  if (cols < kMinCols) cols = kMinCols;
  if (cols > n) cols = n;
  const long long chunks = (n + cols - 1) / cols;
  const unsigned grid_y =
      static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY);
  scatter_kernel<<<dim3(static_cast<unsigned>(chunks), grid_y),
                   kScatterThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(vals),
      static_cast<float*>(out), rows, K, n, cols, static_cast<int*>(err));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
