// Weighted FedAvg over a flat client stack, for Hopper (sm_90a).
//
//   out[n] = sum_k w[k] * x[k, n]      x: (K, N) f32, w: (K,) f32, out: (N,) f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg/fedavg.py
// (fedavg_pallas / _fedavg_kernel), which reduces a (K, 16384) VMEM tile
// over K in one fused pass.
//
// Exactness: each column folds from 0.f as
//   acc = __fadd_rn(acc, __fmul_rn(w[k], x[k, n]))   for k = 0 .. K-1,
// the host numpy fold `acc += w_k * row_k` operation for operation.  The
// _rn intrinsics forbid nvcc from contracting the pair into an FMA, so the
// result is bit-identical to the numpy aggregation (and hence to the
// pinned orchestrator digests), not merely close to it.  So K is never
// split: one thread folds one column, in client order.
//
// Bound: bytes (a quarter of a flop a byte).  But the only parallelism is
// the N columns, each a serial chain of K dependent adds: about 5 cycles
// a row for a multiply and its add, so a tall, narrow stack (the flow
// fleets' (1875, 2048): 2,048 chains of 1,875) is bound by its chains
// unless every column is on the card at once and its rows arrive ahead of
// its adds.  The wrapper's plan (ops.py: plan(k, n, aligned) -> (route,
// tile, stage)) picks one of three routes; each tile is the widest whose
// grid still covers the 132 SMs:
//
//   * wide (K <= 32, or N >= 2 * 132 * 256): one thread a column, 8 to 256
//     a CTA, its rows loaded straight from global memory, 16 ahead of
//     their adds.  Short stacks need one round trip; wide ones (16, 2^24)
//     and LM-FL's (3, 140.6 M) fill the card with coalesced loads.
//   * tma / cp_async (the rest): a CTA owns a strip of C columns (8 to
//     128; at N = 2048, C = 8 and 256 CTAs, two an SM) and streams its
//     rows through a ring of kStages shared-memory stages of R rows and
//     their R weights (4 KB stages up to 512 clients, so the first lands
//     sooner; 8 KB above, half the stage turns).  Every thread folds from
//     a lead of registers that the ring refills 16 rows ahead, across
//     stage boundaries, so only the adds wait on one another.
//       - tma: thread 0 issues each stage as two TMA boxes (C x R of the
//         stack by a rank-2 f32 map with no swizzle, R of the weights as
//         one row of K), completing on the stage's mbarrier.  TMA needs
//         both bases and the row stride (N * 4 bytes) on the 16-byte grid.
//       - cp_async: for the rest (N = 2050 gives an 8,200-byte stride, 8
//         mod 16), every thread issues 4-byte cp.async copies into the
//         same ring, one commit group a stage.
//   Weights travel with the rows, chunk by chunk, so any K works: a
//   60,000-client fold has 240 KB of weights, more than shared memory.
//
// A fourth route, pods (fedavg_pods below, its own entry point), serves the
// pod aggregation (distributed/fl_mesh.py): every pod's copy of the mean of
// a short stack (K = the pods) of up to 1.1 G columns a leaf, in the leaf's
// own dtype:
//
//   out[k, n] = round(sum_j w[j] * float(x[j, n]))  for each k
//       x: (K, N) f32, bf16 or f16; out: (K, N) f32, bf16 or f16
//
// the same fold as above, rounded once to nearest even (as a cast does),
// in place of a cast to f32, the fold, a cast back and a broadcast copy.
// Bound by bytes: each thread owns a 16-byte vector of columns (8 of a
// 2-byte type, 4 floats), issues that vector's loads from every row of a
// chunk (K <= 32 at once) before its first add, and stores the rounded
// vector K times with streaming stores (nothing reads the copies again in
// the round).  64-bit indices; a grid of one thread a vector.  Columns
// before the first 16-byte vector (a base off the grid) and after the
// last, or all of them where rows do not share an alignment (N not a
// multiple of the vector), fold one a thread.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_map.h"

namespace {

enum Route { kWide = 0, kTma = 1, kCpAsync = 2 };

constexpr int kWideThreads = 256;   // the wide kernel's largest CTA
constexpr int kAhead = 16;          // rows a wide-route thread loads ahead
constexpr int kStages = 4;
constexpr int kMaxStageFloats = 2048;  // 8 KB of the stack a stage at most
constexpr int kMaxRows = 256;          // rows a stage (TMA's largest box side)
constexpr int kLead = 16;              // rows a fold thread loads ahead

// A tall kernel's shape: C columns a CTA, stages of SF floats (R = SF / C
// rows; 4 KB stages for short stacks, 8 KB for tall ones).
template <int C, int SF>
struct Tall {
  static constexpr int R = SF / C;
  static constexpr int kThreads = C < 32 ? 32 : C;
  static_assert(C >= 8 && C <= 128 && (C & (C - 1)) == 0, "C: 8 to 128, a power of two");
  static_assert(SF <= kMaxStageFloats && R >= 16 && R <= kMaxRows, "16 to 256 rows a stage");
};

// The ring: stage s holds R rows of the CTA's C columns and the R weights
// of those rows; full[s] completes when a TMA-fed stage has landed.
struct TallSmem {
  alignas(128) float x[kStages][kMaxStageFloats];
  alignas(128) float w[kStages][kMaxRows];
  alignas(8) uint64_t full[kStages];
};

// The registers a fold thread carries from row to row (and stage to
// stage): its column's next D values and the next 2D weights, D = kLead
// (R / 2 for shorter stages).  Both rings divide R, so row j of the next
// stage lands in slot j, where the next stage's fold looks for it.
template <int C, int R>
struct Lead {
  static constexpr int D = R >= 2 * kLead ? kLead : R / 2, DW = 2 * D;
  static_assert(R % DW == 0 && D % 4 == 0, "the rings divide a stage");
  float x[D], w[DW];

  __device__ __forceinline__ void load_w4(int row, const float* src) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    w[row % DW] = q.x, w[(row + 1) % DW] = q.y, w[(row + 2) % DW] = q.z,
    w[(row + 3) % DW] = q.w;
  }

  // Rows 0 .. D - 1 of a stage.
  __device__ __forceinline__ void prime(const float* xs, const float* ws) {
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = xs[j * C];
#pragma unroll
    for (int j = 0; j < D; j += 4) load_w4(j, ws + j);
  }
};

// Fold a stage into acc, in row order, from the lead registers: at row r
// the loads of row r + D are issued, so they land long before their add,
// and only the adds (the serial part, about 4 cycles each) wait on one
// another.  xs / ws: this thread's column and the weights in the stage.
//
// A whole stage (kWhole: R rows) reads rows R .. R + D - 1 from the next
// stage (xn, wn); `turn()` runs at row R - D, once every read of this
// stage has been issued: it waits for the next stage and hands this one
// back for its refill, and the lead runs on into the next stage without a
// pause.  The last stage of a strip folds its first `rows` rows (K's
// remainder) and stops; entries past them are loaded but never added.
template <int C, int R, bool kWhole, typename Turn>
__device__ __forceinline__ float fold_stage(float acc, Lead<C, R>& g, const float* xs,
                                            const float* ws, const float* xn,
                                            const float* wn, int rows, Turn turn) {
  constexpr int D = Lead<C, R>::D, DW = Lead<C, R>::DW;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!kWhole && r % 4 == 0 && r >= rows) break;
    if (kWhole && r == R - D) turn();
    const float p = __fmul_rn(g.w[r % DW], g.x[r % D]);
    const int q = r + D;
    if (q < R) {
      g.x[r % D] = xs[q * C];
      if (r % 4 == 0) g.load_w4(q, ws + q);
    } else if (kWhole) {
      g.x[r % D] = xn[(q - R) * C];
      if (r % 4 == 0) g.load_w4(q, wn + (q - R));
    }
    if (kWhole || r < rows) acc = __fadd_rn(acc, p);
  }
  return acc;
}

// The fold over every chunk of the CTA's strip, shared by both tall
// kernels; `st` moves the chunks: st.issue(ch) starts chunk ch into stage
// ch % kStages (a no-op past the last chunk; cp.async commits a group
// either way), st.landed<P>(ch) returns once chunk ch is in shared memory
// for every thread (P: cp.async groups that may still be pending then).
// Every thread folds (the lanes of a one-warp CTA past C fold a copy of
// column t % C and store nothing), so the waits and barriers are uniform.
template <int C, int SF, typename Stages>
__device__ __forceinline__ float fold_strip(TallSmem& sm, Stages& st, int K) {
  constexpr int R = Tall<C, SF>::R;
  const int chunks = (K + R - 1) / R, whole = K / R;
  const int col = threadIdx.x % C;
  for (int s = 0; s < kStages; ++s) st.issue(s);
  float acc = 0.f;
  Lead<C, R> g;
  if (chunks > 0) {
    st.template landed<kStages - 1>(0);
    g.prime(sm.x[0] + col, sm.w[0]);
  }
  for (int ch = 0; ch < whole; ++ch) {
    const int s = ch % kStages, s1 = (ch + 1) % kStages;
    acc = fold_stage<C, R, true>(acc, g, sm.x[s] + col, sm.w[s], sm.x[s1] + col, sm.w[s1], R,
                                 [&] {
                                   if (ch + 1 < chunks) st.template landed<kStages - 2>(ch + 1);
                                   __syncthreads();  // every thread is done reading stage s
                                   st.issue(ch + kStages);
                                 });
  }
  if (whole < chunks) {  // landed: waited for in the last whole stage's turn, or above
    const int s = whole % kStages;
    acc = fold_stage<C, R, false>(acc, g, sm.x[s] + col, sm.w[s], nullptr, nullptr,
                                  K - whole * R, [] {});
  }
  return acc;
}

// Stages by TMA: thread 0 issues each chunk as two boxes (C x R of the
// stack, R of the weights) completing on the stage's mbarrier.
template <int C, int SF>
struct TmaStages {
  static constexpr int R = Tall<C, SF>::R;
  TallSmem& sm;
  const CUtensorMap* xmap;
  const CUtensorMap* wmap;
  int c0, chunks;

  __device__ void issue(int ch) {
    if (threadIdx.x != 0 || ch >= chunks) return;
    const int s = ch % kStages;
    const uint32_t bar = hopper::smem_addr(&sm.full[s]);
    hopper::fence_proxy_async();
    hopper::mbar_arrive_expect_tx(bar, (R * C + R) * 4);
    hopper::tma_load_2d(hopper::smem_addr(sm.x[s]), xmap, bar, c0, ch * R);
    hopper::tma_load_2d(hopper::smem_addr(sm.w[s]), wmap, bar, ch * R, 0);
  }
  template <int P>
  __device__ void landed(int ch) {
    hopper::mbar_wait(hopper::smem_addr(&sm.full[ch % kStages]), (ch / kStages) & 1);
  }
};

// Stages by cp.async, 4 bytes a copy: thread t copies column t % C of rows
// t / C, t / C + T / C, ... and weights t, t + T, ...; rows past K and
// columns past N are not copied (their entries are never added or
// stored).  One commit group a chunk, empty ones included, so at most P
// groups pending means every chunk up to the P-th last issued has landed.
template <int C, int SF>
struct CpAsyncStages {
  static constexpr int R = Tall<C, SF>::R, T = Tall<C, SF>::kThreads;
  TallSmem& sm;
  const float* x;
  const float* w;
  int K;
  int64_t N, c0;

  __device__ void issue(int ch) {
    const int r0 = ch * R, rows = min(R, K - r0);
    const int t = threadIdx.x, c = t % C;
    const uint32_t ws = hopper::smem_addr(sm.w[ch % kStages]);
    for (int r = t; r < rows; r += T) hopper::cp_async_4(ws + 4 * r, w + r0 + r);
    if (c0 + c < N) {
      const float* src = x + static_cast<int64_t>(r0 + t / C) * N + c0 + c;
      uint32_t dst = hopper::smem_addr(sm.x[ch % kStages] + t);
#pragma unroll 8
      for (int r = t / C; r < rows; r += T / C) {
        hopper::cp_async_4(dst, src);
        src += static_cast<int64_t>(T / C) * N;
        dst += T * 4;
      }
    }
    hopper::cp_async_commit();
  }
  template <int P>
  __device__ void landed(int) {
    hopper::cp_async_wait<P>();
    __syncthreads();
  }
};

// One thread a column (blockDim.x columns a CTA): the column's rows come
// straight from global memory, kAhead loads issued before their adds.
__global__ void __launch_bounds__(kWideThreads)
fedavg_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int K, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* col = x + n;
  float acc = 0.f;
  int k = 0;
  for (; k + kAhead <= K; k += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) v[j] = __ldg(col + static_cast<int64_t>(k + j) * N);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k + j), v[j]));
  }
  for (; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k), __ldg(col + static_cast<int64_t>(k) * N)));
  out[n] = acc;
}

template <int C, int SF>
__global__ void __launch_bounds__(Tall<C, SF>::kThreads)
fedavg_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, float* __restrict__ out, int K,
                  int N) {
  __shared__ TallSmem sm;
  const int c0 = blockIdx.x * C;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(hopper::smem_addr(&sm.full[s]), 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  constexpr int R = Tall<C, SF>::R;
  TmaStages<C, SF> st{sm, &xmap, &wmap, c0, (K + R - 1) / R};
  const float acc = fold_strip<C, SF>(sm, st, K);
  if (threadIdx.x < C && c0 + static_cast<int>(threadIdx.x) < N) out[c0 + threadIdx.x] = acc;
}

template <int C, int SF>
__global__ void __launch_bounds__(Tall<C, SF>::kThreads)
fedavg_cpasync_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int K, int64_t N) {
  __shared__ TallSmem sm;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * C;
  CpAsyncStages<C, SF> st{sm, x, w, K, N, c0};
  const float acc = fold_strip<C, SF>(sm, st, K);
  if (threadIdx.x < C && c0 + threadIdx.x < N) out[c0 + threadIdx.x] = acc;
}

template <int C, int SF>
int launch_tall(int route, const float* x, const float* w, float* out, int K, long long N,
                cudaStream_t stream) {
  constexpr int R = Tall<C, SF>::R;
  const unsigned blocks = static_cast<unsigned>((N + C - 1) / C);
  if (route == kCpAsync) {
    fedavg_cpasync_kernel<C, SF><<<blocks, Tall<C, SF>::kThreads, 0, stream>>>(
        x, w, out, K, static_cast<int64_t>(N));
    return static_cast<int>(cudaGetLastError());
  }
  if (K <= 0 || N % 4 != 0 || N > INT32_MAX || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // The weights as one row of K (its row stride is never used, but must
  // be on the 16-byte grid).
  CUtensorMap xmap, wmap;
  if (!hopper::encode_map_f32_2d(enc, &xmap, x, N, K, N * 4, C, R) ||
      !hopper::encode_map_f32_2d(enc, &wmap, w, K, 1, (K * 4LL + 15) / 16 * 16, R, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  fedavg_tma_kernel<C, SF><<<blocks, Tall<C, SF>::kThreads, 0, stream>>>(
      xmap, wmap, out, K, static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}

template <int SF>
int launch_tall_tile(int route, int tile, const float* x, const float* w, float* out, int K,
                     long long N, cudaStream_t st) {
  switch (tile) {
    case 8: return launch_tall<8, SF>(route, x, w, out, K, N, st);
    case 16: return launch_tall<16, SF>(route, x, w, out, K, N, st);
    case 32: return launch_tall<32, SF>(route, x, w, out, K, N, st);
    case 64: return launch_tall<64, SF>(route, x, w, out, K, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pod route's element types: the bits each value is stored in, widened
// to float exactly and rounded back to nearest even.
struct F32 {
  using Bits = float;
  __device__ static float widen(float b) { return b; }
  __device__ static float narrow(float v) { return v; }
};
struct Bf16 {
  using Bits = unsigned short;
  __device__ static float widen(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  __device__ static unsigned short narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F16 {
  using Bits = unsigned short;
  __device__ static float widen(unsigned short b) { return __half2float(__ushort_as_half(b)); }
  __device__ static unsigned short narrow(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};
enum PodType { kF32 = 0, kBf16 = 1, kF16 = 2 };

constexpr int kPodThreads = 256;

// The access that moves B bytes: n words of type T.
template <int B>
struct Word {
  using T = uint4;
  static constexpr int n = B / 16;
};
template <>
struct Word<8> {
  using T = uint2;
  static constexpr int n = 1;
};
template <>
struct Word<4> {
  using T = unsigned int;
  static constexpr int n = 1;
};
template <>
struct Word<2> {
  using T = unsigned short;
  static constexpr int n = 1;
};

// W neighbouring values, moved as Word's accesses.
template <typename B, int W>
union Pack {
  using Wd = Word<static_cast<int>(sizeof(B)) * W>;
  B v[W];
  typename Wd::T w[Wd::n];
};

template <typename B, int W>
__device__ __forceinline__ Pack<B, W> load_pack(const B* p) {
  using Wd = typename Pack<B, W>::Wd;
  Pack<B, W> r;
#pragma unroll
  for (int i = 0; i < Wd::n; ++i) r.w[i] = __ldg(reinterpret_cast<const typename Wd::T*>(p) + i);
  return r;
}

template <typename B, int W>
__device__ __forceinline__ void store_pack(B* p, const Pack<B, W>& v) {
  using Wd = typename Pack<B, W>::Wd;
#pragma unroll
  for (int i = 0; i < Wd::n; ++i) __stcs(reinterpret_cast<typename Wd::T*>(p) + i, v.w[i]);
}

// Columns n .. n + W - 1: every row's values loaded, R rows at a time,
// before the chunk's first add; folded in row order; rounded; stored in
// every row.
template <typename In, typename Out, int R, int W>
__device__ __forceinline__ void fold_pods(const typename In::Bits* __restrict__ x,
                                          const float* __restrict__ w,
                                          typename Out::Bits* __restrict__ out, int K, int64_t N,
                                          int64_t n) {
  float acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += R) {
    Pack<typename In::Bits, W> v[R];
    float wk[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (k0 + j < K) {
        v[j] = load_pack<typename In::Bits, W>(x + static_cast<int64_t>(k0 + j) * N + n);
        wk[j] = __ldg(w + k0 + j);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (k0 + j < K)
#pragma unroll
        for (int c = 0; c < W; ++c)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(wk[j], In::widen(v[j].v[c])));
  }
  Pack<typename Out::Bits, W> o;
#pragma unroll
  for (int c = 0; c < W; ++c) o.v[c] = Out::narrow(acc[c]);
  for (int k = 0; k < K; ++k)
    store_pack<typename Out::Bits, W>(out + static_cast<int64_t>(k) * N + n, o);
}

// vecs vectors of V columns from column head on, then the other N - V * vecs
// columns one a thread: the head's, then the tail's.
template <typename In, typename Out, int R>
__global__ void __launch_bounds__(kPodThreads)
fedavg_pods_kernel(const typename In::Bits* __restrict__ x, const float* __restrict__ w,
                   typename Out::Bits* __restrict__ out, int K, int64_t N, int64_t head,
                   int64_t vecs) {
  constexpr int V = 16 / static_cast<int>(sizeof(typename In::Bits));
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = t; i < vecs; i += step) fold_pods<In, Out, R, V>(x, w, out, K, N, head + i * V);
  const int64_t body = head + vecs * V;
  for (int64_t i = t; i < N - vecs * V; i += step)
    fold_pods<In, Out, R, 1>(x, w, out, K, N, i < head ? i : body + (i - head));
}

// One thread a vector (a column where it folds alone): at the benchmark's
// largest leaves a grid that covers the work ran at 0.87-0.89 of the
// bytes' bound, a grid of the CTAs the card holds at once, each striding
// over many vectors, at 0.81-0.84.
template <typename In, typename Out, int R>
int launch_pods_rows(const typename In::Bits* x, const float* w, typename Out::Bits* out, int K,
                     int64_t N, int64_t head, int64_t vecs, cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(typename In::Bits));
  const int64_t scalars = N - vecs * V;
  const int64_t need = ((vecs > scalars ? vecs : scalars) + kPodThreads - 1) / kPodThreads;
  const unsigned blocks = static_cast<unsigned>(need < INT32_MAX ? need : INT32_MAX);
  fedavg_pods_kernel<In, Out, R><<<blocks, kPodThreads, 0, st>>>(x, w, out, K, N, head, vecs);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out>
int launch_pods(const void* x, const float* w, void* out, int K, long long N, long long head,
                long long vecs, int rows, cudaStream_t st) {
  using BI = typename In::Bits;
  using BO = typename Out::Bits;
  constexpr int V = 16 / static_cast<int>(sizeof(BI));
  const auto* xi = static_cast<const BI*>(x);
  auto* oo = static_cast<BO*>(out);
  // a vector's loads and stores need every row's column `head` on their grid
  if (head < 0 || vecs < 0 || head + vecs * V > N ||
      (vecs > 0 && (N % V != 0 || reinterpret_cast<uintptr_t>(xi + head) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(oo + head) % (V * sizeof(BO)) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 2: return launch_pods_rows<In, Out, 2>(xi, w, oo, K, N, head, vecs, st);
    case 4: return launch_pods_rows<In, Out, 4>(xi, w, oo, K, N, head, vecs, st);
    case 8: return launch_pods_rows<In, Out, 8>(xi, w, oo, K, N, head, vecs, st);
    case 32: return launch_pods_rows<In, Out, 32>(xi, w, oo, K, N, head, vecs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename In>
int launch_pods_to(int out_type, const void* x, const float* w, void* out, int K, long long N,
                   long long head, long long vecs, int rows, cudaStream_t st) {
  switch (out_type) {
    case kF32: return launch_pods<In, F32>(x, w, out, K, N, head, vecs, rows, st);
    case kBf16: return launch_pods<In, Bf16>(x, w, out, K, N, head, vecs, rows, st);
    case kF16: return launch_pods<In, F16>(x, w, out, K, N, head, vecs, rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The pod route: x (K, N) of in_type, out (K, N) of out_type (PodType
// codes); head, vecs and rows from ops.pod_plan.
extern "C" int fedavg_pods(const void* x, const void* w, void* out, int in_type, int out_type,
                           int K, long long N, long long head, long long vecs, int rows,
                           void* stream) {
  if (K <= 0 || N <= 0) return 0;
  const auto* wf = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case kF32: return launch_pods_to<F32>(out_type, x, wf, out, K, N, head, vecs, rows, st);
    case kBf16: return launch_pods_to<Bf16>(out_type, x, wf, out, K, N, head, vecs, rows, st);
    case kF16: return launch_pods_to<F16>(out_type, x, wf, out, K, N, head, vecs, rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// route: 0 wide (tile: 8 to 256 threads, one a column, a CTA; stage
// unused), 1 tma, 2 cp_async (tile C = 8, 16, 32, 64 columns a CTA with
// stages of 1024 or 2048 floats, or 128 with 2048); see ops.plan.
extern "C" int fedavg_f32(const void* x, const void* w, void* out, int K, long long N,
                          int route, int tile, int stage, void* stream) {
  if (N <= 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (route == kWide) {
    if (tile < 8 || tile > kWideThreads || tile % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (N + tile - 1) / tile;
    fedavg_wide_kernel<<<static_cast<unsigned>(blocks), tile, 0, st>>>(
        xf, wf, of, K, static_cast<int64_t>(N));
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kTma && route != kCpAsync) return static_cast<int>(cudaErrorInvalidValue);
  if (stage == 1024) return launch_tall_tile<1024>(route, tile, xf, wf, of, K, N, st);
  if (stage != 2048) return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 128) return launch_tall<128, 2048>(route, xf, wf, of, K, N, st);
  return launch_tall_tile<2048>(route, tile, xf, wf, of, K, N, st);
}

extern "C" const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
