// Blockwise absmax int8 quantization and its inverse, for Hopper (sm_90a).
//
// quantize:   x (R, n) f32 -> q (R, nb*block) i8, scales (R, nb) f32
//   per block of `block` values (lanes past n count as 0):
//     s = max(absmax, 1e-12) / 127,  q = clip(rint(x / s), -127, 127)
// dequantize: q (R, nb*block) i8, scales (R, nb) f32 -> out (R, n) f32
//     out = q * s
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize/quantize.py
// (quantize_pallas / _quant_kernel and dequantize_pallas / _dequant_kernel),
// which process (8, 1024) VMEM tiles at a fixed 1024 block.  Here the block
// size is a runtime argument, so every `int8(b)` wire stage reaches the
// kernel.
//
// Bound: bytes.  Quantize reads 4 bytes and writes 1 (plus 4 per block) for
// a handful of flops per element; dequantize reads 1 and writes 4.  Design:
// quantize runs one CTA per (row, block) -- the absmax is a per-block
// reduction (warp shuffles, then one value per warp in shared memory; max
// is exact in any order), after which the CTA rereads its block, which is
// still in L1/L2, to write the codes.  Dequantize runs one thread per output
// element on a (columns, rows) grid, so loads and stores are coalesced.
//
// Exactness: __fdiv_rn / __fmul_rn are the correctly rounded IEEE
// operations numpy performs, and rintf rounds half to even like np.rint, so
// both kernels are bit-identical to repro_torch.core.compression's
// quantize_int8_batch / dequantize_int8_batch on finite inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 256;
constexpr int kDequantThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t n, int nb, int block) {
  const int row = blockIdx.x / nb;
  const int b = blockIdx.x - row * nb;
  const float* xr = x + static_cast<int64_t>(row) * n;
  const int64_t base = static_cast<int64_t>(b) * block;

  float m = 0.f;
  for (int j = threadIdx.x; j < block; j += kQuantThreads) {
    const int64_t i = base + j;
    if (i < n) m = fmaxf(m, fabsf(__ldg(xr + i)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[kQuantThreads / 32];
  __shared__ float s_shared;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kQuantThreads / 32 ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) {
      const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
      s_shared = s;
      scales[static_cast<int64_t>(row) * nb + b] = s;
    }
  }
  __syncthreads();
  const float s = s_shared;

  int8_t* qr = q + static_cast<int64_t>(row) * nb * block + base;
  for (int j = threadIdx.x; j < block; j += kQuantThreads) {
    const int64_t i = base + j;
    const float v = i < n ? __ldg(xr + i) : 0.f;
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
    qr[j] = static_cast<int8_t>(r);
  }
}

__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t n, int nb, int block) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kDequantThreads
                    + threadIdx.x;
  if (j >= n) return;
  const int64_t row = blockIdx.y;
  const float s = __ldg(scales + row * nb + j / block);
  const float v = static_cast<float>(q[row * nb * block + j]);
  out[row * n + j] = __fmul_rn(v, s);
}

}  // namespace

extern "C" int quantize_f32_i8(const void* x, void* q, void* scales,
                               long long rows, long long n, int nb,
                               int block, void* stream) {
  if (rows <= 0 || nb <= 0) return 0;
  quantize_kernel<<<static_cast<unsigned>(rows * nb), kQuantThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), static_cast<int64_t>(n), nb, block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_i8_f32(const void* q, const void* scales,
                                 void* out, long long rows, long long n,
                                 int nb, int block, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long cols = (n + kDequantThreads - 1) / kDequantThreads;
  // gridDim.y is capped at 65535: launch the rows in slabs of that many.
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const long long r = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(r));
    dequantize_kernel<<<grid, kDequantThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q) + r0 * nb * block,
        static_cast<const float*>(scales) + r0 * nb,
        static_cast<float*>(out) + r0 * n, static_cast<int64_t>(n), nb,
        block);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
