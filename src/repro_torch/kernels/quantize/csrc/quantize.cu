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
// quantize design (redesigned for Hopper): the FL paths quantize rows of
// every width, from the pod aggregation's 16 and 64 values a block (a
// parameter leaf's last axis; 7.8 M of its 10 M rows) to the wire and LM-FL
// paths' 1024 and the leaves' 1600 and 5504.  One CTA a block would leave
// 3/4 to 15/16 of a CTA idle on the narrow rows and launch millions of
// CTAs, so the grid would set the pace, not the bytes.  Instead a group of
// `lanes` threads (a power of two, 1-256) owns a block: lane l holds units
// l, l + lanes, ... of it in registers, a unit being 4 consecutive values
// (one float4 where the block lies on the 16-byte grid), so the block is
// read from device memory once and coded from registers.  The absmax
// reduces by __shfl_xor_sync inside the group (a group of up to 32 lanes
// lies inside one warp); a group wider than a warp adds one exchange
// through shared memory (double-buffered: one __syncthreads a block).
// Each lane packs its 4 codes into one word and stores it once (bytes
// where the block is no multiple of 4).  A CTA of 256 threads takes
// 256 / lanes blocks at a time, over a grid-stride loop on a grid of about
// the CTAs the card holds at once.  ops.quantize_plan picks the geometry:
//   short (a call whose blocks fit on the card at one unit a lane): that
//     many lanes, up to 256 (blocks over 1024 values: 256 lanes of 2-8
//     units).  Such a call is paced by each thread's chain of loads and
//     divisions, not by the bytes, so the chain is kept short (one warp of
//     8 units a 1024-value block ran the wire path's 25 blocks slower
//     than the first design, one CTA a block);
//   and, for calls paced by the bytes:
//   narrow (block <= 128): the block's units rounded up to 2^k, split
//     2^ceil(k/2) lanes of 2^floor(k/2) units (16 values: 2 lanes of 2
//     units; 64: 4 of 4), so a warp spans 8 or more blocks and each lane
//     has a few loads in flight;
//   row (block <= 8192): one warp a block while 8 units a lane hold it
//     (1024 values), else 64 / 128 / 256 lanes of 6 or 8 units (1600: 64
//     lanes of 8; 5504: 256 of 6), at most 64 registers a thread;
//   wide (longer blocks): one CTA a block, reading it twice (the first
//     design of this kernel; no path sends such blocks).
// Off the grid (x's base, or a row start when n % 4 != 0 and there are
// several rows, or block % 4 != 0) the plan names scalar loads: the same
// units, each value loaded alone.  A row's ragged last unit on the vector
// route loads its values alone too.  A zero codes to 0 without the
// division (code_of): __fdiv_rn's slow path on a zero numerator made the
// padded lanes of short rows (wire_bench's 2 values in a block of 1024)
// cost more than the block's real values.  Tried on an H100 and dropped:
// one lane a whole narrow block (a warp's loads then hit 32 separate runs
// of 64-256 bytes; far slower), one-unit lanes on narrow blocks (slower
// than the even split at 16 and 64 values), one warp of 16 units a lane
// at 1600 values (slower than 64 lanes of 8, and 128 registers), and
// grids of half or twice the resident CTAs (within a few percent).
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

constexpr int kQuantThreads = 256;     // every quantize route's CTA
constexpr int kDequantThreads = 128;
constexpr int kMaxGridY = 65535;

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

// The code of v under scale s, as the low byte of a word.  A zero (the
// padding of a row's last block, most of all) codes to 0 without the
// division: __fdiv_rn takes its slow path for a zero numerator.
__device__ __forceinline__ uint32_t code_of(float v, float s) {
  if (v == 0.f) return 0u;
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// The short, narrow and row routes (see the header): G lanes a block, U
// units a lane in registers, 256 / G blocks a CTA at a time.  Block g of
// the (rows, nb) grid of blocks is row g / nb, block g % nb of it; its
// scale is scales[g] and its codes q[g * block ...].  `vec`: x's blocks
// start on the 16-byte grid (block % 4 == 0 and, over several rows,
// n % 4 == 0).  The loop runs while the CTA's first block exists, so
// every thread takes each turn and reaches each shuffle and
// __syncthreads; a group past the last block loads and stores nothing.
template <int G, int U>
__global__ void __launch_bounds__(kQuantThreads)
quantize_lanes_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scales, int64_t n, int nb,
                      int block, int64_t total, FastDiv fnb, int vec) {
  static_assert(G >= 1 && G <= kQuantThreads && (G & (G - 1)) == 0,
                "lanes a block: a power of two up to the CTA");
  constexpr int kPer = kQuantThreads / G;          // blocks a CTA at a time
  constexpr int kShfl = G < 32 ? G : 32;           // lanes a shuffle spans
  constexpr int kWarps = G / 32;                   // warps a block, G > 32
  __shared__ float part[2][kQuantThreads / 32];
  const int lane = threadIdx.x & (G - 1);
  const int grp = threadIdx.x / G;
  const bool words = (block & 3) == 0;
  int parity = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kPer; base < total;
       base += static_cast<int64_t>(gridDim.x) * kPer) {
    const int64_t g = base + grp;
    const bool live = g < total;
    int64_t row = 0, b = 0;
    if (live) {
      row = fnb.div(static_cast<uint32_t>(g));
      b = g - row * nb;
    }
    const float* xb = x + row * n + b * block;
    const int count = live ? static_cast<int>(
        n - b * block < block ? n - b * block : block) : 0;

    float v[4 * U];
    float m = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = 4 * (u * G + lane);
      if (vec && j + 4 <= count) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(xb + j));
        v[4 * u] = f.x;
        v[4 * u + 1] = f.y;
        v[4 * u + 2] = f.z;
        v[4 * u + 3] = f.w;
      } else {                 // scalar route, a ragged unit, or padding
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[4 * u + e] = j + e < count ? __ldg(xb + j + e) : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) m = fmaxf(m, fabsf(v[4 * u + e]));
    }
#pragma unroll
    for (int off = kShfl / 2; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if constexpr (G > 32) {
      if ((threadIdx.x & 31) == 0) part[parity][threadIdx.x >> 5] = m;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        m = fmaxf(m, part[parity][grp * kWarps + w]);
      }
      parity ^= 1;             // the next turn writes the other half
    }
    const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
    if (live && lane == 0) scales[g] = s;

    int8_t* qb = q + g * block;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = 4 * (u * G + lane);
      if (!live || j >= block) continue;
      if (words) {             // j + 4 <= block, and the word is aligned
        *reinterpret_cast<uint32_t*>(qb + j) =
            code_of(v[4 * u], s) | (code_of(v[4 * u + 1], s) << 8) |
            (code_of(v[4 * u + 2], s) << 16) |
            (code_of(v[4 * u + 3], s) << 24);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < block) {
            qb[j + e] = static_cast<int8_t>(code_of(v[4 * u + e], s));
          }
        }
      }
    }
  }
}

// The wide route: one CTA a (row, block), which rereads its block (still
// in L1/L2) to write the codes after the block-wide absmax.
__global__ void __launch_bounds__(kQuantThreads)
quantize_wide_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, int64_t n, int nb,
                     int block) {
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
    qr[j] = static_cast<int8_t>(code_of(v, s));
  }
}

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

template <int G, int U>
cudaError_t launch_lanes(const float* x, int8_t* q, float* scales,
                         long long total, long long n, int nb, int block,
                         unsigned grid, int vec, cudaStream_t st) {
  quantize_lanes_kernel<G, U><<<grid, kQuantThreads, 0, st>>>(
      x, q, scales, static_cast<int64_t>(n), nb, block,
      static_cast<int64_t>(total), FastDiv::of(static_cast<uint32_t>(nb)),
      vec);
  return cudaGetLastError();
}

using LaunchLanes = cudaError_t (*)(const float*, int8_t*, float*, long long,
                                    long long, int, int, unsigned, int,
                                    cudaStream_t);

// The (lanes, units) instantiations ops.quantize_plan may pick (its
// QUANT_KERNELS): short 1-256 lanes of one unit and 256 of 2-8; narrow
// (2, 2) to (8, 4); row 32 lanes of 2-8 units, 64 / 128 of 6 or 8.
struct LanesKernel {
  int lanes, units;
  LaunchLanes launch;
};
const LanesKernel kLanesKernels[] = {
    {1, 1, launch_lanes<1, 1>},     {2, 1, launch_lanes<2, 1>},
    {4, 1, launch_lanes<4, 1>},     {8, 1, launch_lanes<8, 1>},
    {16, 1, launch_lanes<16, 1>},   {32, 1, launch_lanes<32, 1>},
    {64, 1, launch_lanes<64, 1>},   {128, 1, launch_lanes<128, 1>},
    {256, 1, launch_lanes<256, 1>}, {256, 2, launch_lanes<256, 2>},
    {256, 4, launch_lanes<256, 4>}, {256, 6, launch_lanes<256, 6>},
    {256, 8, launch_lanes<256, 8>}, {2, 2, launch_lanes<2, 2>},
    {4, 2, launch_lanes<4, 2>},     {4, 4, launch_lanes<4, 4>},
    {8, 4, launch_lanes<8, 4>},     {32, 2, launch_lanes<32, 2>},
    {32, 4, launch_lanes<32, 4>},   {32, 6, launch_lanes<32, 6>},
    {32, 8, launch_lanes<32, 8>},   {64, 6, launch_lanes<64, 6>},
    {64, 8, launch_lanes<64, 8>},   {128, 6, launch_lanes<128, 6>},
    {128, 8, launch_lanes<128, 8>}};

}  // namespace

// lanes, units, grid: ops.quantize_plan's (vec its vector loads); units
// 0 takes the wide route (one CTA a block; lanes, grid and vec unread).
// rows * nb < 2^31.
extern "C" int quantize_f32_i8(const void* x, void* q, void* scales,
                               long long rows, long long n, int nb,
                               int block, int lanes, int units,
                               long long grid, int vec, void* stream) {
  if (rows <= 0 || nb <= 0) return 0;
  const long long total = rows * nb;
  if (total > 0x7fffffffLL || block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int8_t* qi = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(scales);
  if (units == 0) {
    quantize_wide_kernel<<<static_cast<unsigned>(total), kQuantThreads, 0,
                           st>>>(xf, qi, sf, static_cast<int64_t>(n), nb,
                                 block);
    return static_cast<int>(cudaGetLastError());
  }
  if (grid <= 0 || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const LanesKernel& k : kLanesKernels) {
    if (k.lanes == lanes && k.units == units) {
      return static_cast<int>(k.launch(xf, qi, sf, total, n, nb, block,
                                       static_cast<unsigned>(grid), vec,
                                       st));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
