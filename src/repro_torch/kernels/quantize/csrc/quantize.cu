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
// a handful of flops per element; dequantize reads 1 and writes 4.
//
// quantize design: one CTA per (row, block) -- the absmax is a per-block
// reduction (warp shuffles, then one value per warp in shared memory; max
// is exact in any order), after which the CTA rereads its block, which is
// still in L1/L2, to write the codes.
//
// dequantize design: its bytes are 4/5 stores, so what matters is that
// every store is a whole, coalesced 16-byte vector and that enough of them
// are in flight.  Each thread expands 4 codes into one float4 of out, a
// warp 32 neighbouring float4s (512 contiguous bytes an instruction), over
// a grid-stride loop on a grid of about the CTAs the card holds at once
// (the SM count times this kernel's CTAs an SM).  The hard part is
// alignment: out's rows are n floats apart and the codes' rows nb * block
// bytes apart, so on the wire plane's widths (n = 25,450, and the top-k
// tiers 1018 / 3817 / 10,180: n % 4 = 2 / 2 / 1 / 0) rows after the first
// start off the 16-byte grid, and the codes of an aligned float4 are not
// themselves aligned.  So each row is cut into units on out's 16-byte
// grid: a row whose first float lies `head` (1-3) floats before a 16-byte
// boundary starts with a partial unit, and a ragged end makes another;
// those take the scalar path.  A whole unit's 4 codes lie at any byte
// phase: the thread loads the aligned word holding the first and, off the
// grid, the next one, and funnel-shifts them into place (each word it
// loads holds one of its codes, so no load leaves the 4-byte granule of a
// live byte).  The scale's index is a multiply and a shift (FastDiv, set
// up on the host for the call's block), none of the 64-bit divisions of an
// element-per-thread kernel; with block >= 4 a unit spans at most two
// blocks, so it loads both scales and picks one an element.  One launch
// covers any number of rows.  Tried on an H100 and dropped: 16 codes a
// thread (its 64-byte runs leave every 32-byte sector half-written by each
// store instruction), and 2 to 8 units in flight a thread (no faster at
// the large shapes, slower on short rows).
//
// Exactness: __fdiv_rn / __fmul_rn are the correctly rounded IEEE
// operations numpy performs, and rintf rounds half to even like np.rint, so
// both kernels are bit-identical to repro_torch.core.compression's
// quantize_int8_batch / dequantize_int8_batch on finite inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 256;
constexpr int kDequantThreads = 128;
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

// c / d for 0 <= c < 2^31 as a multiply and a shift (m and s from
// FastDiv::of, on the host; d = 1 passes c through).
struct FastDiv {
  uint32_t d, m, s;
  static FastDiv of(uint32_t d) {
    uint32_t l = 0;
    while ((1ull << l) < d) ++l;                  // ceil(log2 d)
    if (d <= 1) return {1u, 0u, 0u};
    return {d, static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d),
            l - 1};
  }
  __device__ __forceinline__ uint32_t div(uint32_t c) const {
    return d == 1 ? c : __umulhi(c, m) >> s;
  }
};

// The 4 codes starting at byte address b (any alignment), as one
// little-endian word: the aligned word holding b and, if b is off the
// grid, the next one (which holds b + 3), funnel-shifted into place.
__device__ __forceinline__ uint32_t load_codes4(uintptr_t b) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(b & ~uintptr_t(3));
  const uint32_t sh = static_cast<uint32_t>(b & 3) * 8;
  const uint32_t lo = __ldg(a);
  const uint32_t hi = sh ? __ldg(a + 1) : 0u;
  return __funnelshift_r(lo, hi, sh);
}

__device__ __forceinline__ float times(uint32_t word, int e, float s) {
  return __fmul_rn(static_cast<float>(static_cast<int8_t>(word >> (8 * e))),
                   s);
}

// Grid (CTAs along a row, rows), a grid-stride loop over a row's units.
// Unit w covers columns c .. c+3, c = base + 4 w with base = head ? head -
// 4 : 0, so a whole unit is one aligned float4 of out, and a warp's store
// is 32 neighbouring float4s (512 contiguous bytes).  Column arithmetic is
// 32-bit (n <= 2^31 - 2^24, checked by the launcher): the index math
// before the first load is the latency of a short row.
__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t rows, int n, int nb, int block, FastDiv fd) {
  const int64_t L = static_cast<int64_t>(nb) * block;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    float* orow = out + r * n;
    const int8_t* qrow = q + r * L;
    const float* srow = scales + r * nb;
    const int head = static_cast<int>(
        (4u - ((reinterpret_cast<uintptr_t>(orow) >> 2) & 3u)) & 3u);
    const int base = head ? head - 4 : 0;
    const uint32_t units = static_cast<uint32_t>(n - base + 3) / 4;
    for (uint32_t w = blockIdx.x * kDequantThreads + threadIdx.x; w < units;
         w += gridDim.x * kDequantThreads) {
      const int c = base + 4 * static_cast<int>(w);
      if (c >= 0 && c + 4 <= n && block >= 4) {
        const uint32_t code =
            load_codes4(reinterpret_cast<uintptr_t>(qrow + c));
        const int bi = static_cast<int>(fd.div(static_cast<uint32_t>(c)));
        const float s0 = __ldg(srow + bi);
        const float s1 = __ldg(srow + (bi + 1 < nb ? bi + 1 : bi));
        // Column c lies in block bi, and the split - 1 columns after it
        // too; the rest (if any) in the next block.
        const int split = block - (c - bi * block);
        *reinterpret_cast<float4*>(orow + c) = make_float4(
            times(code, 0, s0), times(code, 1, split > 1 ? s0 : s1),
            times(code, 2, split > 2 ? s0 : s1),
            times(code, 3, split > 3 ? s0 : s1));
      } else {                                    // a ragged unit, or block < 4
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c + e;
          if (j >= 0 && j < n) {
            orow[j] = __fmul_rn(
                static_cast<float>(qrow[j]),
                __ldg(srow + fd.div(static_cast<uint32_t>(j))));
          }
        }
      }
    }
  }
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
  if (n > 0x7f000000LL || static_cast<long long>(nb) * block > 0x7fffffffLL
      || block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // About as many CTAs as the card holds at once (cached per device),
  // spread over the rows, or fewer if the rows need fewer.
  static int resident[64];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dequantize_kernel, kDequantThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long grid_y = rows < kMaxGridY ? rows : kMaxGridY;
  const long long per_row =
      resident[dev] / grid_y > 1 ? resident[dev] / grid_y : 1;
  const long long units = (n + 6) / 4;             // the most a row has
  long long grid_x = (units + kDequantThreads - 1) / kDequantThreads;
  if (grid_x > per_row) grid_x = per_row;
  dequantize_kernel<<<dim3(static_cast<unsigned>(grid_x),
                           static_cast<unsigned>(grid_y)),
                      kDequantThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), rows, static_cast<int>(n), nb, block,
      FastDiv::of(static_cast<uint32_t>(block)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
