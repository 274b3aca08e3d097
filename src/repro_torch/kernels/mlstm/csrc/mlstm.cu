// Chunkwise-parallel mLSTM (the xLSTM matrix-memory cell over a whole
// sequence), for Hopper (sm_90a).
//
//   q, k, v: (B, S, nh, dh)   F, ig: (B, S, nh) f32   out: (B, S, nh, dh)
//   q/k/v and out f32 or bf16; gates, stabiliser, normaliser and the
//   accumulator in f32.  F = cumsum(log sigmoid(f)) over the sequence is
//   computed outside the kernel (O(S), in the wrapper), as the TPU version
//   does; ig are the raw input-gate logits.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm/mlstm.py
// (mlstm_pallas / _mlstm_kernel), which walks a sequential
// (B*nh, S/128, S/128) grid with the running row max m, the signed
// normaliser n and the accumulator in VMEM scratch.  As there, per key tile:
//   D  = F_q - F_k + i_k  (keys k <= q only);  m' = max(m, rowmax D);
//   c  = exp(m - m');  s = (q . k) * dh^-0.5 * exp(D - m');
//   n  = c*n + rowsum(s);  acc = c*acc + s.astype(v.dtype) @ v;
//   out = acc / max(|n|, exp(-m)).
// m starts at -1e30, as on the TPU; every causal row holds its diagonal
// key, so no row ends without one.
//
// Bound: operations (4*dh flops per causal (query, key) pair, dh = 512 at
// xlstm-350m's width, against (4*dh + 8) bytes per position); this first
// design runs the products on the CUDA cores in f32.
//
// Design: the flash-attention kernel's (kernels/flash_attention/csrc),
// with the gate matrix in place of the softmax: one CTA of 256 threads per
// (batch*head, query tile); the query tile and one K-or-V tile in shared
// memory as f32 (row stride dh + 4); scores in SR x SK blocks per thread
// from float4 reads; one warp per row forms D, the new stabiliser, the
// gated scores and their sum, and rounds s to v's type in place while the
// V tile replaces the K tile; then each thread rescales and accumulates
// an OR x TC block of the output.  Key tiles above the diagonal are never
// visited; a tail tile loads zeros and masks them.

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

// x rounded to the element type (what s.astype(v.dtype) does).
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
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ F,
             const float* __restrict__ ig, T* __restrict__ out, int S,
             int NH, float scale) {
  constexpr int LD = HD + 4;
  constexpr int LS = BK + 4;
  constexpr int KG = BK / SK;
  static_assert((BQ / SR) * KG == kThreads, "score blocks must cover the tile");
  constexpr int CG = kThreads / (BQ / OR);
  constexpr int TC = HD / CG;
  static_assert(TC % 4 == 0 && CG * TC == HD, "output blocks must cover dh");
  constexpr int C4 = TC / 4;
  constexpr int EPL = BK / 32;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* KVs = Qs + BQ * LD;                    // BK x LD: K, then V
  float* Ss = KVs + BK * LD;                    // BQ x LS: scores, then s
  float* m_s = Ss + BQ * LS;                    // running stabiliser
  float* n_s = m_s + BQ;                        // signed normaliser
  float* c_s = n_s + BQ;                        // this tile's rescale
  float* fq_s = c_s + BQ;                       // F of the query rows
  float* fk_s = fq_s + BQ;                      // F of the key tile
  float* ik_s = fk_s + BK;                      // i of the key tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / NH;
  const int h = blockIdx.y % NH;
  const int64_t stride = static_cast<int64_t>(NH) * HD;
  const int64_t base = (static_cast<int64_t>(b) * S * NH + h) * HD;
  const float* Fb = F + static_cast<int64_t>(b) * S * NH + h;    // row t: Fb[t * NH]
  const float* ib = ig + static_cast<int64_t>(b) * S * NH + h;

  load_tile<T, HD, BQ>(Qs, q + base, q0, S, stride);
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    n_s[tid] = 0.f;
    fq_s[tid] = q0 + tid < S ? Fb[static_cast<int64_t>(q0 + tid) * NH] : 0.f;
  }

  const int kt1 = (min(S, q0 + BQ) + BK - 1) / BK;   // causal: keys < q0 + BQ
  const int tr = tid / KG, tk = tid % KG;
  const int og = tid / CG, cg = tid % CG;
  const int warp = tid / 32, lane = tid % 32;

  float acc[OR][TC];
#pragma unroll
  for (int r = 0; r < OR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;

  for (int kt = 0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's PV is done with KVs, Ss and gates
    load_tile<T, HD, BK>(KVs, k + base, k0, S, stride);
    if (tid < BK) {
      const bool in = k0 + tid < S;
      fk_s[tid] = in ? Fb[static_cast<int64_t>(k0 + tid) * NH] : 0.f;
      ik_s[tid] = in ? ib[static_cast<int64_t>(k0 + tid) * NH] : 0.f;
    }
    __syncthreads();

    // 1. scores q . k * scale
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

    // 2. V replaces K; gates and stabiliser, one warp per row
    load_tile<T, HD, BK>(KVs, v + base, k0, S, stride);
    for (int i = warp; i < BQ; i += kThreads / 32) {
      const int qi = q0 + i;
      const float m_prev = m_s[i];
      const float fq = fq_s[i];
      float dv[EPL];
      bool ok[EPL];
      float mx = m_prev;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int j = lane + 32 * e;
        const int kj = k0 + j;
        ok[e] = kj < S && kj <= qi;
        dv[e] = fq - fk_s[j] + ik_s[j];
        if (ok[e]) mx = fmaxf(mx, dv[e]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int j = lane + 32 * e;
        const float sv = ok[e] ? Ss[i * LS + j] * expf(dv[e] - mx) : 0.f;
        sum += sv;
        Ss[i * LS + j] = round_to(sv, v);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - mx);
        c_s[i] = corr;
        n_s[i] = corr * n_s[i] + sum;
        m_s[i] = mx;
      }
    }
    __syncthreads();

    // 3. acc = c * acc + s @ v
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

  // out = acc / max(|n|, exp(-m))
#pragma unroll
  for (int r = 0; r < OR; ++r) {
    const int i = og * OR + r;
    if (q0 + i >= S) continue;
    const float den = fmaxf(fabsf(n_s[i]), expf(-m_s[i]));
    T* orow = out + base + static_cast<int64_t>(q0 + i) * stride;
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4) {
      const float4 x = make_float4(acc[r][c4 * 4 + 0] / den, acc[r][c4 * 4 + 1] / den,
                                   acc[r][c4 * 4 + 2] / den, acc[r][c4 * 4 + 3] / den);
      store4(orow + (c4 * CG + cg) * 4, x);
    }
  }
}

template <typename T, int HD, int BQ, int BK, int SR, int SK, int OR>
int launch(const void* q, const void* k, const void* v, const float* F,
           const float* ig, void* out, int B, int S, int NH, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) *
      (BQ * (HD + 4) + BK * (HD + 4) + BQ * (BK + 4) + 4 * BQ + 2 * BK);
  auto kernel = mlstm_kernel<T, HD, BQ, BK, SR, SK, OR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * NH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), F, ig, static_cast<T*>(out), S, NH, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* F,
             const float* ig, void* out, int B, int S, int NH, int dh,
             float scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<T, 64, 64, 64, 4, 4, 4>(q, k, v, F, ig, out, B, S, NH, scale, st);
    case 128:
      return launch<T, 128, 64, 64, 4, 4, 4>(q, k, v, F, ig, out, B, S, NH, scale, st);
    case 256:
      return launch<T, 256, 64, 64, 4, 4, 4>(q, k, v, F, ig, out, B, S, NH, scale, st);
    case 512:
      return launch<T, 512, 32, 32, 2, 2, 4>(q, k, v, F, ig, out, B, S, NH, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  dh in {64, 128, 256, 512}.
extern "C" int mlstm_fwd(const void* q, const void* k, const void* v,
                         const void* F, const void* ig, void* out, int B,
                         int S, int NH, int dh, float scale, int dtype,
                         void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(F);
  const float* i = static_cast<const float*>(ig);
  if (dtype == 0) return dispatch<float>(q, k, v, f, i, out, B, S, NH, dh, scale, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, f, i, out, B, S, NH, dh, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mlstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
