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
// gather design: one thread per output element; neighbouring threads
// read neighbouring idx and write neighbouring out, and, since the wire
// plane sends sorted indices, read nearby addresses of x, so a warp's loads
// of x touch few 32-byte sectors.  A row of K <= 256 takes K rounded up to
// a power of two lanes, and a CTA holds 256 / that many rows (wire_bench's
// rows of two values: 128 rows a CTA, where a CTA a row ran two live
// threads of 256); a longer row takes ceil(K / 256) CTAs.  A call is one
// launch and nothing else: no memset of the error flag (below).
//
// scatter design: one launch over (column tile, row); the wrapper picks
// the tile width (ops.scatter_tile: about one CTA an SM, 1024 to 16,384
// columns).  The dense output dominates the bytes, so it must cross device
// memory once, in whole 32-byte sectors:
//   1. The CTA zeroes its tile in shared memory, laid out at the tile's
//      16-byte phase in the row (rows of n % 4 != 0 start off the grid).
//   2. For an increasing row (every honest payload: argpartition + sort)
//      the tile's entries are one range [k_lo, k_hi) of k.  The CTA finds
//      both ends with a block-wide search: each round its threads test
//      1024 evenly spaced positions of the window at once and count the
//      ones below the target, so K = 157,286 takes two rounds of loads
//      where a binary search would take 18 dependent ones.
//   3. It reads only that range, kBatch entries a thread in flight at
//      once, writes them into the shared tile, and stores the tile once
//      with 16-byte streaming stores (scalar stores only for the up to
//      3 + 3 columns off the 16-byte grid at its ends).
// Any other input must still resolve exactly (last-wins), in the same
// single launch.  The check is local: each CTA verifies that its range is
// strictly increasing and inside its columns (tile 0 starts at k = 0, the
// last tile ends at k = K), and that k_lo <= k_hi.  The search is a
// deterministic function of (row, target), so consecutive tiles' ranges
// meet (k_hi(t) = k_lo(t+1)), and the checks all pass exactly when the
// whole row is strictly increasing and inside [0, n).  A CTA that fails
// them marks its row.  Every CTA then takes a ticket for its row (a
// 64-bit atomicAdd after a __threadfence: the count of tiles done, and in
// the high word the count of marks), and the last CTA of a marked row
// rewrites the whole row with exact last-wins, using the row itself as
// scratch: -1 everywhere, atomicMax of each k into its index's slot (max
// is order-free), then each slot's winner's value or 0.  The other CTAs'
// stores are ordered before that rewrite by their fences and the ticket.
// A short row (K <= kLocalMax, the wire plane's topk(0.04) tier) skips
// search and ticket: one batch of loads gives each CTA every index, so it
// classifies the row alone and resolves its own tile (local_tile).  So
// every input takes one launch, and an honest one never rereads an index
// outside its tile's range.  The tickets and the error flag are one
// scratch buffer, zeroed with the call.  Tile widths, kBatch, the local
// threshold and the streaming stores were chosen by timing variants on an
// H100 at the wire plane's shapes and at (64, 157,286) -> 2^20.
//
// Bad indices: both kernels check 0 <= idx < bound and flag the call
// instead of reading or writing out of bounds; the wrapper raises when it
// is flagged (a scatter row with a bad index is marked, and its rewrite
// leaves it all zero, never passed off as a result).  The scatter sets its
// scratch's first int to 1 (the scratch is zeroed with the call).  The
// gather stores the call's stamp in a flag that nothing zeroes: ops.py
// keeps one 64-bit flag a (device, stream, host thread), zero when made,
// and gives each call a stamp from one counter of the process, so no two
// calls share a stamp.  The wrapper reads the flag on its own stream right
// after the launch and raises only if it holds this call's stamp.  A
// stale stamp from an earlier bad call is another number, so it raises
// nothing; a bad call right after another stores its own stamp, so it
// raises.  A call on another stream (or from another thread) has its own
// flag: it can neither overwrite this one, and so hide this call's error,
// nor store this call's stamp, and so invent one.  Within one stream the
// read follows the launch in stream order, before any later launch of
// this thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kProbes = 4;                        // search probes a thread
constexpr int kSearchWidth = kScatterThreads * kProbes;
constexpr int kLocalPerThread = 4;      // a row this short: every index a CTA
constexpr int kLocalMax = kScatterThreads * kLocalPerThread;
constexpr int kBatch = 8;            // range entries a thread has in flight
constexpr int kMaxGridY = 65535;
constexpr int kDefaultSmem = 48 * 1024;

// Grid (K-chunks, row groups): lane t & (L - 1) of a CTA is column k of
// the chunk, t >> shift its row (L = 2^shift lanes a row, 256 / L rows a
// CTA; shift = 8 for a row longer than 256).
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
              float* __restrict__ out, int64_t rows, int64_t P, int64_t K,
              int shift, unsigned long long stamp,
              unsigned long long* __restrict__ flag) {
  const int per = kGatherThreads >> shift;         // rows a CTA
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kGatherThreads +
                    (threadIdx.x & ((1u << shift) - 1u));
  if (k >= K) return;
  for (int64_t r = static_cast<int64_t>(blockIdx.y) * per +
                   (threadIdx.x >> shift);
       r < rows; r += static_cast<int64_t>(gridDim.y) * per) {
    const int j = __ldg(idx + r * K + k);
    float v = 0.f;
    if (j >= 0 && j < P) {
      v = __ldg(x + r * P + j);
    } else {
      *flag = stamp;                  // every bad thread stores the same
    }
    out[r * K + k] = v;
  }
}

// The block-wide sums of two per-thread counts (`part`: kScatterWarps
// slots of shared memory, free again on return).
__device__ __forceinline__ int2 block_sum2(int a, int b, int2* part) {
  a = __reduce_add_sync(0xffffffffu, a);
  b = __reduce_add_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  int2 s = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kScatterWarps; ++w) {
    s.x += part[w].x;
    s.y += part[w].y;
  }
  __syncthreads();
  return s;
}

// One round of a block-wide lower_bound over ri[lo, hi): test up to
// kSearchWidth evenly spaced positions, count those below `target`
// (`count` is the block's sum of `mine`), and shrink the window to the
// stretch between the last one below and the first one not below.  On
// sorted data the answer stays in [lo, hi]; on any data the window only
// shrinks, stays inside [0, K] and ends at lo == hi.
__device__ __forceinline__ int64_t probe_stride(int64_t lo, int64_t hi) {
  return (hi - lo + kSearchWidth - 1) / kSearchWidth;
}

__device__ __forceinline__ int probe(const int* __restrict__ ri, int64_t lo,
                                     int64_t hi, int target) {
  int mine = 0;
  if (hi > lo) {
    const int64_t step = probe_stride(lo, hi);
#pragma unroll
    for (int i = 0; i < kProbes; ++i) {
      const int64_t p = lo + (threadIdx.x + i * kScatterThreads) * step;
      if (p < hi && __ldg(ri + p) < target) ++mine;
    }
  }
  return mine;
}

__device__ __forceinline__ void narrow(int64_t& lo, int64_t& hi, int count) {
  if (hi <= lo) return;
  const int64_t step = probe_stride(lo, hi);
  if (count == 0) {
    hi = lo;
  } else {
    const int64_t end = lo + count * step;
    lo += (count - 1) * step + 1;
    hi = end < hi ? end : hi;
  }
}

// The last CTA of a marked row: exact last-wins over the whole row, with
// the row as scratch (each column's winning k, -1 for none).  A bad index
// sets *err and leaves the row zero.
__device__ void rewrite_row(const int* __restrict__ ri,
                            const float* __restrict__ rv,
                            float* __restrict__ dst, int64_t K, int64_t n,
                            int* __restrict__ err) {
  int* win = reinterpret_cast<int*>(dst);
  for (int64_t c = threadIdx.x; c < n; c += kScatterThreads) win[c] = -1;
  __threadfence();
  __syncthreads();
  int bad = 0;
  for (int64_t k = threadIdx.x; k < K; k += kScatterThreads) {
    const int j = __ldg(ri + k);
    if (j < 0 || j >= n) {
      bad = 1;
    } else {
      atomicMax(win + j, static_cast<int>(k));
    }
  }
  __threadfence();
  bad = __syncthreads_or(bad);
  if (bad) {
    if (threadIdx.x == 0) atomicExch(err, 1);
    for (int64_t c = threadIdx.x; c < n; c += kScatterThreads) dst[c] = 0.f;
    return;
  }
  for (int64_t c = threadIdx.x; c < n; c += kScatterThreads) {
    const int w = __ldcg(win + c);
    dst[c] = w >= 0 ? __ldg(rv + w) : 0.f;
  }
}

// A row of K <= kLocalMax: the CTA loads every index of it in one batch
// (kLocalPerThread a thread, its neighbour's through a shuffle), so it
// classifies the row alone and resolves its own tile exactly, with no
// ticket: an increasing row's entries go straight into the tile; any
// other row's go through each column's winning k (atomicMax in the tile's
// words, -1 for none); a bad index sets *err and leaves the tile zero.
// `win` is the tile as words, sm[phase .. end) its columns; returns after
// the tile is complete in shared memory.
__device__ void local_tile(const int* __restrict__ ri,
                           const float* __restrict__ rv, float* sm,
                           int64_t K, int64_t n, int64_t c0, int64_t c1,
                           int phase, int64_t end, int* __restrict__ err) {
  int j[kLocalPerThread];
  int bad = 0, unordered = 0;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kLocalPerThread; ++i) {
    const int64_t p = threadIdx.x + i * kScatterThreads;
    j[i] = p < K ? __ldg(ri + p) : 0;
    bad |= p < K && (j[i] < 0 || j[i] >= n);
  }
#pragma unroll
  for (int i = 0; i < kLocalPerThread; ++i) {
    const int64_t p = threadIdx.x + i * kScatterThreads;
    int next = __shfl_down_sync(0xffffffffu, j[i], 1);
    if (lane == 31 && p + 1 < K) next = __ldg(ri + p + 1);
    unordered |= p + 1 < K && j[i] >= next;
  }
  bad = __syncthreads_or(bad);
  unordered = __syncthreads_or(unordered);
  if (bad) {
    if (threadIdx.x == 0) atomicExch(err, 1);
    return;                                        // the tile stays zero
  }
  if (!unordered) {
#pragma unroll
    for (int i = 0; i < kLocalPerThread; ++i) {
      const int64_t p = threadIdx.x + i * kScatterThreads;
      if (p < K && j[i] >= c0 && j[i] < c1) {
        sm[phase + (j[i] - c0)] = __ldg(rv + p);
      }
    }
    __syncthreads();
    return;
  }
  int* win = reinterpret_cast<int*>(sm);
  for (int64_t s = phase + threadIdx.x; s < end; s += kScatterThreads) {
    win[s] = -1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLocalPerThread; ++i) {
    const int64_t p = threadIdx.x + i * kScatterThreads;
    if (p < K && j[i] >= c0 && j[i] < c1) {
      atomicMax(win + phase + (j[i] - c0), static_cast<int>(p));
    }
  }
  __syncthreads();
  for (int64_t s = phase + threadIdx.x; s < end; s += kScatterThreads) {
    const int w = win[s];
    sm[s] = w >= 0 ? __ldg(rv + w) : 0.f;
  }
  __syncthreads();
}

// The tile, from shared memory to its row: whole float4s where the tile
// covers them, single floats at its ends.
__device__ __forceinline__ void store_tile(const float4* tile4,
                                           const float* sm, float4* base4,
                                           int phase, int64_t end,
                                           int64_t nvec) {
  for (int64_t i = threadIdx.x; i < nvec; i += kScatterThreads) {
    if (4 * i >= phase && 4 * i + 4 <= end) {
      __stcs(base4 + i, tile4[i]);     // streaming: never read back here
    } else {
      float* d = reinterpret_cast<float*>(base4 + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * i + e >= phase && 4 * i + e < end) d[e] = sm[4 * i + e];
      }
    }
  }
}

// Grid (tiles, rows); `tile` columns a CTA (a multiple of 4), dynamic
// shared memory (tile + 4) floats.  scratch: err (int), a pad int, then a
// u64 ticket per row, all zero at launch.
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ vals,
               float* __restrict__ out, int64_t rows, int64_t K, int64_t n,
               int64_t tile, int* __restrict__ scratch) {
  extern __shared__ float4 tile4[];
  float* sm = reinterpret_cast<float*>(tile4);
  __shared__ int2 part[kScatterWarps];
  __shared__ int rewrite;
  int* err = scratch;
  unsigned long long* tickets =
      reinterpret_cast<unsigned long long*>(scratch + 2);
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t c1 = c0 + tile < n ? c0 + tile : n;
  const bool first = blockIdx.x == 0;
  const bool last = blockIdx.x == gridDim.x - 1;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int* ri = idx + r * K;
    const float* rv = vals + r * K;
    float* dst = out + r * n;
    // sm[phase + (c - c0)] holds column c; sm[4i..4i+3] is the 16-byte
    // vector at base4 + i.
    const int phase =
        static_cast<int>((reinterpret_cast<uintptr_t>(dst + c0) >> 2) & 3);
    float4* base4 = reinterpret_cast<float4*>(dst + c0 - phase);
    const int64_t end = phase + (c1 - c0);       // past the last column
    const int64_t nvec = (end + 3) / 4;
    for (int64_t i = threadIdx.x; i < nvec; i += kScatterThreads) {
      tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (K <= kLocalMax) {                          // uniform in the grid
      local_tile(ri, rv, sm, K, n, c0, c1, phase, end, err);
      store_tile(tile4, sm, base4, phase, end, nvec);
      __syncthreads();                // sm free for the next row
      continue;
    }

    // The tile's range of k: lower_bound of c0 and of c1 (tile 0 starts
    // at 0 and the last tile ends at K by definition, and the checks
    // below hold them to it).
    int64_t lo0 = 0, hi0 = first ? 0 : K;
    int64_t lo1 = last ? K : 0, hi1 = K;
    while (hi0 > lo0 || hi1 > lo1) {               // uniform in the CTA
      const int2 cnt = block_sum2(probe(ri, lo0, hi0, static_cast<int>(c0)),
                                  probe(ri, lo1, hi1, static_cast<int>(c1)),
                                  part);
      narrow(lo0, hi0, cnt.x);
      narrow(lo1, hi1, cnt.y);
    }
    const int64_t k_lo = lo0, k_hi = lo1;
    __syncthreads();                               // zeros before entries

    // The range's entries, kBatch a thread in flight at once.
    int bad = k_lo > k_hi;
    for (int64_t k0 = k_lo + threadIdx.x; k0 < k_hi;
         k0 += kScatterThreads * kBatch) {
      int j[kBatch], next[kBatch];
      float v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int64_t k = k0 + b * kScatterThreads;
        j[b] = k < k_hi ? __ldg(ri + k) : 0;
        v[b] = k < k_hi ? __ldg(rv + k) : 0.f;
        next[b] = k + 1 < k_hi ? __ldg(ri + k + 1) : 0x7fffffff;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k0 + b * kScatterThreads >= k_hi) break;
        if (j[b] >= c0 && j[b] < c1) {
          sm[phase + (j[b] - c0)] = v[b];
        } else {
          bad = 1;
        }
        if (j[b] >= next[b]) bad = 1;
      }
    }
    bad = __syncthreads_or(bad);

    if (!bad) store_tile(tile4, sm, base4, phase, end, nvec);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long old = atomicAdd(
          tickets + r, 1ull | (bad ? 1ull << 32 : 0ull));
      rewrite = static_cast<unsigned>(old) == gridDim.x - 1 &&
                (bad || (old >> 32) != 0);
    }
    __syncthreads();
    if (rewrite) {
      __threadfence();
      rewrite_row(ri, rv, dst, K, n, err);
    }
    __syncthreads();                  // sm and `rewrite` free for the next row
  }
}

}  // namespace

// flag: the caller's (1,) 64-bit flag, where a bad index stores `stamp`.
extern "C" int topk_gather_f32(const void* x, const void* idx, void* out,
                               long long rows, long long P, long long K,
                               unsigned long long stamp, void* flag,
                               void* stream) {
  if (rows <= 0 || K <= 0) return 0;
  int shift = 0;
  while ((1LL << shift) < K && (1 << shift) < kGatherThreads) ++shift;
  const long long chunks = (K + kGatherThreads - 1) / kGatherThreads;
  if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long per = kGatherThreads >> shift;
  const long long groups = (rows + per - 1) / per;
  const unsigned grid_y =
      static_cast<unsigned>(groups < kMaxGridY ? groups : kMaxGridY);
  gather_kernel<<<dim3(static_cast<unsigned>(chunks), grid_y),
                  kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, P, K, shift, stamp,
      static_cast<unsigned long long*>(flag));
  return static_cast<int>(cudaGetLastError());
}

// scratch: (2 + 2 * rows) ints, see scatter_kernel; zeroed here.
extern "C" int topk_scatter_f32(const void* idx, const void* vals, void* out,
                                long long rows, long long K, long long n,
                                long long tile, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(2 + 2 * (rows > 0 ? rows : 0)) *
                      sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (rows <= 0 || n <= 0) return 0;
  if (tile <= 0 || tile % 4 != 0 || K > 0x7fffffffLL || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (n + tile - 1) / tile;
  const size_t smem = static_cast<size_t>(tile + 4) * sizeof(float);
  if (smem > kDefaultSmem) {
    rc = cudaFuncSetAttribute(scatter_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned grid_y =
      static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY);
  scatter_kernel<<<dim3(static_cast<unsigned>(tiles), grid_y),
                   kScatterThreads, smem, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(vals),
      static_cast<float*>(out), rows, K, n, tile,
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
