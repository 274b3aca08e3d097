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
// card's ridge point.  This first design runs the products on the CUDA
// cores in f32 (no tensor cores yet), so its ceiling is the f32 rate, not
// the bf16 tensor-core rate the bound is stated against.
//
// Design: one CTA of 256 threads per (batch*head, query tile of BQ rows);
// the KV tiles are walked in a loop inside the CTA (Hopper's CTAs run in no
// order, so nothing carries between them).  The query tile and one K-or-V
// tile live in shared memory as f32 (row stride hd + 4, so 16-byte reads
// of neighbouring rows fall in different banks).  Per KV tile:
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

template <typename T, int HD, int BQ, int BK, int SR, int SK, int OR>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) *
      (BQ * (HD + 4) + BK * (HD + 4) + BQ * (BK + 4) + 3 * BQ);
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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int Tk, int H, int KV, int hd, int causal, int window,
             float scale, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 64, 64, 64, 4, 4, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 128:
      return launch<T, 128, 64, 64, 4, 4, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 256:
      return launch<T, 256, 64, 64, 4, 4, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
    case 512:
      return launch<T, 512, 32, 32, 2, 2, 4>(q, k, v, out, B, S, Tk, H, KV, causal, window, scale, st);
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
    return dispatch<float>(q, k, v, out, B, S, T, H, KV, hd, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, hd, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
