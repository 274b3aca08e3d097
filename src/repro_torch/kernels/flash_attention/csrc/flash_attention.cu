// Online-softmax (flash) attention with causal and sliding-window masks,
// for Hopper (sm_90a).
//
//   q: (B, S, H, hd)   k, v: (B, T, KV, hd)   out: (B, S, H, hd)
//   f32 or bf16 in and out; scores, softmax statistics and the accumulator
//   in f32.  Query head h reads KV head h / (H / KV) (GQA, indexed, never
//   repeated in memory).  Key t is kept for query s when t < T, and
//   t <= s if causal, and s - t < window if window > 0 (positions from 0).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas / _flash_kernel), which walks a sequential
// (B*H, S/128, T/128) grid with the running max m, sum l and accumulator
// in VMEM scratch.  As there: s = (q . k) * hd^-0.5; m' = max(m, rowmax s);
// c = exp(m - m'); p = exp(s - m'); l = c*l + rowsum(p);
// acc = c*acc + p.astype(v.dtype) @ v; out = acc / max(l, 1e-30).
//
// Bound: operations.  Prefill attention does 4*hd flops per kept
// (query, key) pair on (S + 2T) * H * hd elements; at hd = 256 and a
// 2048-token prompt that is hundreds of flops per byte, far above the
// card's ridge point.
//
// Two kernels, chosen by (dtype, hd) in flash_attention_fwd -- a routing
// by shape, never a fallback (a failure of either raises):
//   * bf16 at hd 64, 128, 256: flash_wgmma_kernel (below), bf16 products
//     with f32 accumulation on the tensor cores (wgmma), K/V streamed by
//     TMA through a ring of shared-memory stages completed on mbarriers,
//     two consumer warpgroups, the producer's loads issued by the last
//     warp to free a stage.  That is the TPU's arithmetic: bf16 MXU
//     products with f32 accumulation (preferred_element_type=f32).
//   * f32 at every hd, and bf16 at hd 512: flash_kernel, f32 FMAs on the
//     CUDA cores.  f32 is held to 2e-5, which the tensor cores' TF32 cannot
//     meet; bf16 at hd 512 would need a 64 x 512 f32 accumulator (256
//     registers a thread in one warpgroup), so it waits for a column split
//     across warpgroups.
//
// flash_kernel: one CTA of 256 threads per (batch*head, query tile of BQ
// rows); the KV tiles are walked in a loop inside the CTA (Hopper's CTAs
// run in no order, so nothing carries between them).  The query tile and
// one K-or-V tile live in shared memory as f32 (row stride hd + 4, so
// 16-byte reads of neighbouring rows fall in different banks).  Per KV
// tile:
//   1. scores: each thread computes an SR x SK block of S = Q K^T from
//      float4 reads (SR + SK loads feed 4*SR*SK FMAs), scaled, into shared
//      memory;
//   2. softmax: one warp per row masks, takes the row max with shuffles,
//      turns scores into p = exp(s - m'), sums them, and rescales the
//      row's statistics; p is rounded to v's type in place (bf16 as on the
//      TPU) -- meanwhile the V tile replaces the K tile;
//   3. PV: each thread rescales and accumulates an OR x TC block of the
//      output (4 rows of p and TC/4 float4 reads of V feed 4*TC FMAs).
// Tiles the mask empties (above the diagonal, before the window) are never
// visited.  A tail tile (S or T not a multiple of the tile) loads zeros and
// masks them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_map.h"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// x rounded to the element type (what p.astype(v.dtype) does).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + ROWS) of a (rows, HD) slab whose rows are `stride`
// elements apart -> dst (ROWS, HD + 4) f32; rows at or past nrows are 0.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int nrows, int64_t stride) {
  constexpr int kVec = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 4;
    const int gr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < nrows) x = load4(src + gr * stride + c);
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) = x;
  }
}

// BQ x BK tiles; scores in SR x SK blocks per thread, the output in
// OR x TC blocks per thread.
template <typename T, int HD, int BQ, int BK, int SR, int SK, int OR>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
             int H, int KV, int causal, int window, float scale) {
  constexpr int LD = HD + 4;
  constexpr int LS = BK + 4;
  constexpr int KG = BK / SK;               // key groups (score blocks)
  static_assert((BQ / SR) * KG == kThreads, "score blocks must cover the tile");
  constexpr int CG = kThreads / (BQ / OR);  // column groups (output blocks)
  constexpr int TC = HD / CG;
  static_assert(TC % 4 == 0 && CG * TC == HD, "output blocks must cover hd");
  constexpr int C4 = TC / 4;
  constexpr int EPL = BK / 32;              // scores per lane in a row

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* KVs = Qs + BQ * LD;                    // BK x LD: K, then V
  float* Ss = KVs + BK * LD;                    // BQ x LS: scores, then p
  float* m_s = Ss + BQ * LS;                    // running max
  float* l_s = m_s + BQ;                        // running sum
  float* c_s = l_s + BQ;                        // this tile's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * Tk * KV + kvh) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * Tk * KV + kvh) * HD;

  load_tile<T, HD, BQ>(Qs, qb, q0, S, q_stride);
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // Key tiles that hold a kept key for some row of this query tile.
  int k_end = Tk;
  if (causal) k_end = min(k_end, q0 + BQ);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int kt1 = (k_end + BK - 1) / BK;

  const int tr = tid / KG, tk = tid % KG;   // score block
  const int og = tid / CG, cg = tid % CG;   // output block
  const int warp = tid / 32, lane = tid % 32;

  float acc[OR][TC];
#pragma unroll
  for (int r = 0; r < OR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's PV is done with KVs and Ss
    load_tile<T, HD, BK>(KVs, kb, k0, Tk, kv_stride);
    __syncthreads();

    // 1. scores
    float s[SR][SK];
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int c = 0; c < SK; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[SR], kv[SK];
#pragma unroll
      for (int r = 0; r < SR; ++r) qv[r] = *reinterpret_cast<const float4*>(Qs + (tr * SR + r) * LD + d);
#pragma unroll
      for (int c = 0; c < SK; ++c) kv[c] = *reinterpret_cast<const float4*>(KVs + (tk + KG * c) * LD + d);
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int c = 0; c < SK; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int c = 0; c < SK; ++c) Ss[(tr * SR + r) * LS + tk + KG * c] = s[r][c] * scale;
    __syncthreads();

    // 2. V replaces K; online softmax, one warp per row
    load_tile<T, HD, BK>(KVs, vb, k0, Tk, kv_stride);
    for (int i = warp; i < BQ; i += kThreads / 32) {
      const int qi = q0 + i;
      const float m_prev = m_s[i];
      float sv[EPL];
      bool ok[EPL];
      float mx = m_prev;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int kj = k0 + lane + 32 * e;
        ok[e] = kj < Tk && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
        sv[e] = Ss[i * LS + lane + 32 * e];
        if (ok[e]) mx = fmaxf(mx, sv[e]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float p = ok[e] ? expf(sv[e] - mx) : 0.f;
        sum += p;
        Ss[i * LS + lane + 32 * e] = round_to(p, v);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - mx);
        c_s[i] = corr;
        l_s[i] = corr * l_s[i] + sum;
        m_s[i] = mx;
      }
    }
    __syncthreads();

    // 3. acc = c * acc + p @ v
#pragma unroll
    for (int r = 0; r < OR; ++r) {
      const float corr = c_s[og * OR + r];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c] *= corr;
    }
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float p[OR];
#pragma unroll
      for (int r = 0; r < OR; ++r) p[r] = Ss[(og * OR + r) * LS + j];
#pragma unroll
      for (int c4 = 0; c4 < C4; ++c4) {
        const float4 vv = *reinterpret_cast<const float4*>(KVs + j * LD + (c4 * CG + cg) * 4);
#pragma unroll
        for (int r = 0; r < OR; ++r) {
          acc[r][c4 * 4 + 0] = fmaf(p[r], vv.x, acc[r][c4 * 4 + 0]);
          acc[r][c4 * 4 + 1] = fmaf(p[r], vv.y, acc[r][c4 * 4 + 1]);
          acc[r][c4 * 4 + 2] = fmaf(p[r], vv.z, acc[r][c4 * 4 + 2]);
          acc[r][c4 * 4 + 3] = fmaf(p[r], vv.w, acc[r][c4 * 4 + 3]);
        }
      }
    }
  }
  __syncthreads();

  // out = acc / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < OR; ++r) {
    const int i = og * OR + r;
    if (q0 + i >= S) continue;
    const float l = fmaxf(l_s[i], 1e-30f);
    T* orow = out + (static_cast<int64_t>(b) * S + q0 + i) * q_stride + static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4) {
      const float4 x = make_float4(acc[r][c4 * 4 + 0] / l, acc[r][c4 * 4 + 1] / l,
                                   acc[r][c4 * 4 + 2] / l, acc[r][c4 * 4 + 3] / l);
      store4(orow + (c4 * CG + cg) * 4, x);
    }
  }
}

template <int HD, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 4) + BK * (HD + 4) + BQ * (BK + 4) + 3 * BQ);
}

template <typename T, int HD, int BQ, int BK, int SR, int SK, int OR>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ, BK>();
  auto kernel = flash_kernel<T, HD, BQ, BK, SR, SK, OR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, KV, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 128, 256: tensor cores (wgmma) fed by TMA.
//
// One CTA of two warpgroups per (batch*head, 128-query tile), each the
// consumer of 64 query rows.  Shared memory holds Q (128 rows, loaded
// once) and rings of ST stages for K and V (BK keys a stage: 2 stages of
// 80 at hd 256, which fills the 227 KB; 4 of 64 below), all bf16 in the
// 128-byte swizzle; each stage completes on a "full" mbarrier (the TMA's
// byte count).  Each warpgroup runs a two-deep software pipeline over the
// KV tiles; in step i it
//   1. waits for K of tile i and issues S = Q K^T as hd/16 wgmma
//      m64n{BK}k16 (both operands in shared memory), then waits for V of
//      tile i-1 and issues O += P V as BK/16 wgmma m64n{hd}k16 (P, tile
//      i-1's probabilities in bf16, from registers; V MN-major in shared
//      memory), both in flight at once;
//   2. once S is done (wgmma groups retire in order), frees the K stage and
//      takes tile i's online softmax in registers while the PV product
//      runs: each row lives in the four lanes of a quad, so its max and sum
//      are two shuffles; masks only on tiles that cross the diagonal, the
//      window's edge or T; scores stay in raw q.k units, the scale folded
//      into the exponent (2^(q.k * c - m * c), c = hd^-0.5 * log2 e);
//   3. once PV is done, frees the V stage, rescales O (64 x hd f32, hd/2
//      registers a thread) by c = exp(m - m') unless c = 1 on all the
//      warp's rows, and rounds tile i's p to bf16 in place as the A
//      fragments of the next PV product.
// The producer's work is done by whichever of the eight warps frees a
// stage last: it counts the warps out on a shared counter, and the eighth
// issues the TMA load of the tile ST ahead into that stage.  So a stage
// is refilled the moment both warpgroups are done with it, and no thread
// waits on an "empty" barrier.  (A dedicated producer warp or warpgroup
// would cap every thread at 168 registers: ptxas sizes a kernel with wgmma
// by whole warpgroups, 384 threads, and allocated the consumers within
// that cap whatever setmaxnreg raised them to, spilling at hd 256; at 256
// threads they take the ~250 registers they need.)
// Tiles the mask empties for the whole CTA are never loaded.  One it
// empties only for one warpgroup's rows (at most one at each end of the
// range) is computed all masked, which leaves O, m and l unchanged, so
// the wgmma products are issued outside any branch (ptxas serialises
// them otherwise).  Query tiles are launched heaviest first: the grid is
// (B*H, query tiles), CTAs start in order of their linear index, so
// blockIdx.y = 0 (started first) takes the last query tile, the one with
// the most causal keys, and the short tiles fill the tail of the last
// wave.
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = 2 * kWgThreads;
constexpr int kWgmmaWarps = kWgmmaThreads / 32;
constexpr int kWgBQ = 128;  // query rows a CTA (two warpgroups x 64)
constexpr int kChunk = 64;  // bf16 columns of one 128-byte swizzled box
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int BK, int ST>
struct WgmmaSmem {
  static constexpr int kChunks = HD / kChunk;
  static constexpr int kQBytes = kWgBQ * HD * 2;
  static constexpr int kTileBytes = BK * HD * 2;  // one K or V stage
  static constexpr int kBarOffset = kQBytes + 2 * ST * kTileBytes;
  // barriers q_full, k_full[ST], v_full[ST]; then counters k_out[ST],
  // v_out[ST] (warps done with the stage)
  static constexpr int kCountOffset = kBarOffset + 8 * (1 + 2 * ST);
  static constexpr int kBytes = kCountOffset + 4 * 2 * ST + 1024;  // + alignment
};
// Online softmax over one 64 x BK tile of raw scores q.k held as wgmma
// accumulators; s = q.k * scale is never formed: with c = scale * log2(e),
// exp(s - m') = 2^(q.k * c - m'_raw * c), and the running max is kept in
// raw units (max commutes with the positive scale).  Leaves p in place of
// the scores, updates m and l, and returns each row's rescale factor.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], int row0,
                                             int keyq, int Tk, int causal, int window,
                                             float c_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float mx = m[i];
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[4 * c + 2 * i + j];
        if (MASK) {
          const int key = keyq + 8 * c + j;
          const bool ok = key < Tk && (!causal || key <= row) &&
                          (window <= 0 || row - key < window);
          x = ok ? x : kNegInf;
          s[4 * c + 2 * i + j] = x;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[i] = hopper::exp2_approx((m[i] - mx) * c_log2);
    const float mxc = mx * c_log2;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x = s[4 * c + 2 * i + j];
        float p = hopper::exp2_approx(fmaf(x, c_log2, -mxc));
        if (MASK) p = x == kNegInf ? 0.f : p;
        sum += p;
        s[4 * c + 2 * i + j] = p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[i] = corr[i] * l[i] + sum;
    m[i] = mx;
  }
}

template <int HD, int BK, int ST>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, int S, int Tk, int H, int KV,
                   int causal, int window, float scale) {
  using L = WgmmaSmem<HD, BK, ST>;
  constexpr int NC = L::kChunks;
  constexpr int kQChunk = 64 * kChunk * 2;     // one warpgroup's 64 rows, one chunk
  constexpr int kKChunk = BK * kChunk * 2;  // one stage's BK rows, one chunk
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle needs 1024-byte aligned boxes.
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  const uint32_t base = raw + pad;
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::kQBytes;
  const uint32_t v_s = k_s + ST * L::kTileBytes;
  const uint32_t q_full = base + L::kBarOffset;
  const uint32_t k_full = q_full + 8;           // + 8 * stage
  const uint32_t v_full = k_full + 8 * ST;      // + 8 * stage
  int* k_out = reinterpret_cast<int*>(smem_raw + pad + L::kCountOffset);
  int* v_out = k_out + ST;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;  // heaviest first
  int k_end = Tk;
  if (causal) k_end = min(k_end, q0 + kWgBQ);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int ntiles = max(0, (k_end + BK - 1) / BK - kt0);

  // TMA loads of tile j's K or V into stage j % ST (one thread).
  auto load_k = [&](int j) {
    const int st = j % ST;
    hopper::mbar_arrive_expect_tx(k_full + 8 * st, L::kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hopper::tma_load_4d(k_s + st * L::kTileBytes + c * kKChunk, &kmap, k_full + 8 * st,
                          c * kChunk, kvh, (kt0 + j) * BK, b);
  };
  auto load_v = [&](int j) {
    const int st = j % ST;
    hopper::mbar_arrive_expect_tx(v_full + 8 * st, L::kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hopper::tma_load_4d(v_s + st * L::kTileBytes + c * kKChunk, &vmap, v_full + 8 * st,
                          c * kChunk, kvh, (kt0 + j) * BK, b);
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      hopper::mbar_init(k_full + 8 * st, 1);
      hopper::mbar_init(v_full + 8 * st, 1);
      k_out[st] = 0;
      v_out[st] = 0;
    }
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hopper::tma_load_4d(q_s + (w * NC + c) * kQChunk, &qmap, q_full, c * kChunk, h,
                            q0 + 64 * w, b);
    for (int j = 0; j < min(ST, ntiles); ++j) {
      load_k(j);
      load_v(j);
    }
  }
  __syncthreads();

  // The warpgroup index through a shuffle from lane 0, so the compiler
  // sees it (and every branch on it) as uniform across the warp and keeps
  // the wgmma products out of divergent paths.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWgThreads, 0);
  const int t = threadIdx.x % kWgThreads;
  const int warp = t / 32, lane = t % 32;
  const int qw = q0 + 64 * wg;                 // this warpgroup's first row
  const int row0 = qw + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int qcol = 2 * (lane % 4);

  // This warp is done with tile i's stage of K or V; the last of the eight
  // refills the stage with tile i + ST.
  auto release = [&](int* count, int i, bool is_k) {
    __syncwarp();
    if (lane == 0 && atomicAdd(count + i % ST, 1) == kWgmmaWarps - 1) {
      count[i % ST] = 0;
      if (i + ST < ntiles) is_k ? load_k(i + ST) : load_v(i + ST);
    }
  };

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const float c_log2 = scale * kLog2e;

  hopper::mbar_wait(q_full, 0);
  const uint32_t q_mine = q_s + wg * NC * kQChunk;

  // Tiles of the CTA's range that the mask empties for this warpgroup's 64
  // rows (at most one at each end) run like the others, all masked: p = 0
  // and c = 1 leave O, m and l as they were.  So every warpgroup issues
  // the same products, and no wgmma sits in a branch.
  auto tile_flags = [&](int i, bool& partial) {
    const int k0 = (kt0 + i) * BK;
    const int k_last = k0 + BK - 1;
    partial = (causal && k_last > qw) || (window > 0 && qw + 63 - k0 >= window) ||
              k_last >= Tk;
    return k0;
  };
  auto issue_qk = [&](float (&s)[BK / 2], int st) {
    const uint32_t k_tile = k_s + st * L::kTileBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 32 bytes a k16 step inside a chunk
      const uint64_t da = hopper::sw128_desc(q_mine + (kk / 4) * kQChunk + off, 0, 1024);
      const uint64_t db = hopper::sw128_desc(k_tile + (kk / 4) * kKChunk + off, 0, 1024);
      hopper::wgmma_ss(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  uint32_t pa[BK / 16][4];  // P of the tile whose PV product comes next
  auto issue_pv = [&](int st, uint32_t ph) {
    hopper::mbar_wait(v_full + 8 * st, ph);
    const uint32_t v_tile = v_s + st * L::kTileBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // 16 keys a step: two 8-row atoms of 1024 bytes
      const uint64_t db = hopper::sw128_desc(v_tile + kk * 2048, kKChunk, 1024);
      hopper::wgmma_rs(o, pa[kk], db);
    }
    hopper::wgmma_commit();
  };
  auto softmax = [&](float (&s)[BK / 2], bool partial, int k0, float (&corr)[2]) {
    if (partial)
      softmax_tile<BK, true>(s, m, l, corr, row0, k0 + qcol, Tk, causal, window, c_log2);
    else
      softmax_tile<BK, false>(s, m, l, corr, row0, k0 + qcol, Tk, causal, window, c_log2);
  };
  // p rounded to bf16 as the A fragments of the next PV product
  auto pack_p = [&](const float (&s)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };

  if (ntiles > 0) {
    // Tile 0: S, softmax (O is still zero, so nothing to rescale).
    {
      float s[BK / 2], corr[2];
      bool partial;
      const int k0 = tile_flags(0, partial);
      hopper::mbar_wait(k_full, 0);
      issue_qk(s, 0);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(s);
      release(k_out, 0, true);
      softmax(s, partial, k0, corr);
      pack_p(s);
    }
    // Software pipeline inside the warpgroup: tile i's S = Q K^T and tile
    // i-1's O += P V are in flight together, and tile i's softmax runs
    // while the PV product still does; O is rescaled once it is done.
    for (int i = 1; i < ntiles; ++i) {
      const int st = i % ST;
      float s[BK / 2], corr[2];
      bool partial;
      const int k0 = tile_flags(i, partial);
      hopper::mbar_wait(k_full + 8 * st, (i / ST) & 1);
      issue_qk(s, st);
      issue_pv((i - 1) % ST, ((i - 1) / ST) & 1);
      hopper::wgmma_wait<1>();  // groups complete in order: S is done
      hopper::fence_operands(s);
      release(k_out, i, true);
      softmax(s, partial, k0, corr);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
      release(v_out, i - 1, false);
      // c = 1 on every row of the warp (no row's max moved) leaves O as
      // it is: skip the hd/2 multiplies a thread
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          o[4 * c] *= corr[0];
          o[4 * c + 1] *= corr[0];
          o[4 * c + 2] *= corr[1];
          o[4 * c + 3] *= corr[1];
        }
      }
      pack_p(s);  // only now: the PV product just done read the old fragments
    }
    issue_pv((ntiles - 1) % ST, ((ntiles - 1) / ST) & 1);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    release(v_out, ntiles - 1, false);
  }

  // out = O / max(l, 1e-30), rows past S dropped
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow =
        out + (static_cast<int64_t>(b) * S + row) * q_stride + static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c + qcol) =
          hopper::pack_bf16(o[4 * c + 2 * i] / li, o[4 * c + 2 * i + 1] / li);
  }
}

template <int HD, int BK, int ST>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S,
                 int Tk, int H, int KV, int causal, int window, float scale,
                 cudaStream_t stream) {
  const hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap qmap, kmap, vmap;
  if (!hopper::encode_map(enc, &qmap, q, HD, H, S, B, 64) ||
      !hopper::encode_map(enc, &kmap, k, HD, KV, Tk, B, BK) ||
      !hopper::encode_map(enc, &vmap, v, HD, KV, Tk, B, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = WgmmaSmem<HD, BK, ST>::kBytes;
  auto kernel = flash_wgmma_kernel<HD, BK, ST>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgmmaThreads, smem, stream>>>(qmap, kmap, vmap,
                                                static_cast<__nv_bfloat16*>(out), S, Tk, H,
                                                KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// f32 at hd 64, 128, 256, 512 (CUDA cores).
int dispatch_f32(const void* q, const void* k, const void* v, void* out, int B, int S,
                 int Tk, int H, int KV, int hd, int causal, int window, float scale,
                 cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<float, 64, 64, 64, 4, 4, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 128:
      return launch<float, 128, 64, 64, 4, 4, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 256:
      return launch<float, 256, 64, 64, 4, 4, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 512:
      return launch<float, 512, 32, 32, 2, 2, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16: tensor cores at hd 64, 128, 256 (ST stages of K and V in the
// ring), CUDA cores at hd 512.
int dispatch_bf16(const void* q, const void* k, const void* v, void* out, int B, int S,
                  int Tk, int H, int KV, int hd, int causal, int window, float scale,
                  cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch_wgmma<64, 64, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 128:
      return launch_wgmma<128, 64, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 256:
      return launch_wgmma<256, 80, 2>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 512:
      return launch<__nv_bfloat16, 512, 32, 32, 2, 2, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {64, 128, 256, 512}.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int S, int T, int H,
                                   int KV, int hd, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, out, B, S, T, H, KV, hd, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, out, B, S, T, H, KV, hd, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a CTA of the kernel flash_attention_fwd picks for
// (dtype, hd) asks for, in bytes; -1 for a pair it does not take.
extern "C" int flash_attention_smem_bytes(int dtype, int hd) {
  if (dtype == 1) {
    switch (hd) {
      case 64: return WgmmaSmem<64, 64, 4>::kBytes;
      case 128: return WgmmaSmem<128, 64, 4>::kBytes;
      case 256: return WgmmaSmem<256, 80, 2>::kBytes;
      case 512: return static_cast<int>(smem_bytes<512, 32, 32>());
      default: return -1;
    }
  }
  if (dtype != 0) return -1;
  switch (hd) {
    case 64: return static_cast<int>(smem_bytes<64, 64, 64>());
    case 128: return static_cast<int>(smem_bytes<128, 64, 64>());
    case 256: return static_cast<int>(smem_bytes<256, 64, 64>());
    case 512: return static_cast<int>(smem_bytes<512, 32, 32>());
    default: return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
