// ChunkSum-32 payload checksum, for Hopper (sm_90a).
//
//   x: (L,) u8 -> sums (2,) u32:  A = sum_i x_i,
//                                 B = sum_i ((i mod 8191) + 1) * x_i
//   both mod 2^32; the checksum is (A & 0xFFFF) | ((B & 0xFFFF) << 16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/checksum/checksum.py
// (checksum_pallas / _checksum_kernel), which widens the bytes to int32,
// walks (8, 1024) tiles in grid order and carries the two sums in its
// output block from one grid step to the next.
//
// Bound: bytes.  Each byte is read once for two integer multiply-adds, far
// below the card's operation rate, so the floor is L bytes over the memory
// rate.  Design: the raw bytes are read as 16-byte vectors (a scalar head
// and tail handle a misaligned start and a ragged end), each thread keeps A
// and B in 32-bit unsigned registers over a grid-stride loop, the block
// reduces them with warp shuffles and shared memory, and one atomicAdd per
// block folds them into the two outputs.  Unsigned addition mod 2^32 is the
// int32 two's-complement wrap of the definition, and it is order-free, so
// the result is exact whatever order the blocks finish in.  The weight's
// index is the 64-bit global byte offset, so buffers past 2^31 bytes keep
// the right period.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPeriod = 8191;     // WEIGHT_PERIOD of the definition

__device__ __forceinline__ void add_byte(uint32_t& a, uint32_t& b,
                                         uint32_t byte, uint32_t w) {
  a += byte;
  b += w * byte;
}

// The 16 bytes of one vector, the first at global offset `off`.
__device__ __forceinline__ void add_vec(uint32_t& a, uint32_t& b, uint4 v,
                                        int64_t off) {
  uint32_t m = static_cast<uint32_t>(off % kPeriod);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      add_byte(a, b, (words[q] >> (8 * s)) & 0xffu, m + 1);
      m = (m + 1 == kPeriod) ? 0 : m + 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
checksum_kernel(const uint8_t* __restrict__ x, int64_t L, int64_t head,
                uint32_t* __restrict__ sums) {
  uint32_t a = 0, b = 0;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  // Scalar head (up to 15 bytes before the first 16-byte boundary) and
  // tail (past the last whole vector).
  const int64_t nvec = (L - head) / 16;
  const int64_t tail = head + nvec * 16;
  if (tid < head) {
    add_byte(a, b, x[tid], static_cast<uint32_t>(tid % kPeriod) + 1);
  }
  if (tid < L - tail) {
    const int64_t i = tail + tid;
    add_byte(a, b, x[i], static_cast<uint32_t>(i % kPeriod) + 1);
  }
  const uint4* vec = reinterpret_cast<const uint4*>(x + head);
  for (int64_t v = tid; v < nvec; v += nthreads) {
    add_vec(a, b, __ldg(vec + v), head + v * 16);
  }
  // Block reduction: warp shuffles, one pair per warp in shared memory.
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  __shared__ uint32_t wa[kThreads / 32], wb[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    wa[warp] = a;
    wb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? wa[lane] : 0u;
    b = lane < kThreads / 32 ? wb[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      atomicAdd(sums, a);
      atomicAdd(sums + 1, b);
    }
  }
}

}  // namespace

// sums: (2,) u32 owned by the caller; zeroed here, then accumulated.
extern "C" int chunksum32_u8(const void* x, long long L, void* sums,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(sums, 0, 2 * sizeof(uint32_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (L <= 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  long long head = static_cast<long long>((16 - (p & 15)) & 15);
  if (head > L) head = L;
  const long long nvec = (L - head) / 16;
  const long long scalars = head > L - head - nvec * 16
                                ? head : L - head - nvec * 16;
  long long work = nvec > scalars ? nvec : scalars;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  checksum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(x), L, head, static_cast<uint32_t*>(sums));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* checksum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
