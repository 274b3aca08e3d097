// Weighted FedAvg over a flat client stack, for Hopper (sm_90a).
//
//   out[n] = sum_k w[k] * x[k, n]      x: (K, N) f32, w: (K,) f32, out: (N,) f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg/fedavg.py
// (fedavg_pallas / _fedavg_kernel), which reduces a (K, 16384) VMEM tile
// over K in one fused pass.
//
// Bound: bytes.  Each element is read once and used for one multiply-add,
// so the kernel moves 4*K*N + 4*N bytes for 2*K*N flops -- a quarter of a
// flop per byte, far below the card's ridge point.  Design: one thread per
// column n, looping over the K clients in order.  Neighbouring threads read
// neighbouring addresses of each row, so every warp load is one coalesced
// 128-byte transaction, and the (N,) output is written once.
//
// Exactness: the fold starts at 0.f and applies
//   acc = __fadd_rn(acc, __fmul_rn(w[k], x[k, n]))   for k = 0 .. K-1,
// the host numpy fold `acc += w_k * row_k` operation for operation.  The
// _rn intrinsics forbid nvcc from contracting the pair into an FMA, so the
// result is bit-identical to the numpy aggregation (and hence to the
// pinned orchestrator digests), not merely close to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fedavg_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int K, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k), __ldg(x + k * N + n)));
  }
  out[n] = acc;
}

}  // namespace

extern "C" int fedavg_f32(const void* x, const void* w, void* out, int K,
                          long long N, void* stream) {
  if (N <= 0) return 0;
  const long long blocks = (N + kThreads - 1) / kThreads;
  fedavg_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), K, static_cast<int64_t>(N));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
