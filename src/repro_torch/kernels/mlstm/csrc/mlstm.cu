// Chunkwise-parallel mLSTM (the xLSTM matrix-memory cell over a whole
// sequence), for Hopper (sm_90a).
//
//   q, k, v: (B, S, nh, dh)   out: (B, S, nh, dh), f32 or bf16
//   gates, stabiliser, normaliser and the accumulator in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm/mlstm.py:79
// (mlstm_pallas / _mlstm_kernel at :35), which walks a sequential
// (B*nh, S/128, S/128) grid with the running row max m, the signed
// normaliser n and the accumulator in VMEM scratch.  The function, with
// F = cumsum(log sigmoid(f)) over the sequence:
//   D_qk = F_q - F_k + i_k  (keys k <= q only);  m_q = max_k D_qk;
//   s = (q . k) * dh^-0.5 * exp(D - m);  n = sum_k s (signed, unrounded);
//   acc = sum_k s.astype(v.dtype) * v;  out = acc / max(|n|, exp(-m)).
// The stabiliser m cancels in exact arithmetic, so any m gives the same
// function; the TPU kernel keeps a running one.
//
// Bound: operations.  4*dh flops per causal (query, key) pair against
// (4*dh + 8) bytes per position: at xlstm-350m's prefill layer (B = 4,
// S = 2048, nh = 4, dh = 512) 68.75 GFLOP, 0.0695 ms at the bf16 tensor
// cores' 989 TFLOP/s, against 134 MB, 0.040 ms at 3.35 TB/s.
//
// Two kernels, routed by (dtype, dh) in the wrapper (ops.py) -- a routing
// by shape, never a fallback (a failure of either raises):
//   * bf16 at dh 512 (xlstm-350m's width): mlstm_wgmma_kernel (below),
//     bf16 products with f32 accumulation on the tensor cores, K/V fed by
//     TMA -- the TPU's arithmetic (bf16 MXU products, f32 accumulation);
//   * f32 at every dh, and bf16 at dh 64, 128, 256: mlstm_kernel, f32 FMAs
//     on the CUDA cores (f32 is held to 5e-4 and phase 7's f32 twin runs
//     it; no served config has an mLSTM head width under 512).
//
// mlstm_kernel takes F and the raw input-gate logits i, both (B, S, nh)
// f32, F formed in the wrapper (an O(S) pass, as the TPU version does).
// The flash-attention CUDA-core kernel's structure with the gate matrix in
// place of the softmax: one CTA of 256 threads per (batch*head, query
// tile); the query tile and one K-or-V tile in shared memory as f32 (row
// stride dh + 4); scores in SR x SK blocks per thread from float4 reads;
// one warp per row forms D, a running stabiliser m' = max(m, rowmax D)
// (from -1e30, as on the TPU), c = exp(m - m'), the gated scores and their
// sum, and rounds s to v's type in place while the V tile replaces the K
// tile; then each thread rescales (acc = c*acc) and accumulates an OR x TC
// block of the output.  Key tiles above the diagonal are never visited; a
// tail tile loads zeros and masks them.
//
// mlstm_wgmma_kernel: see its own note below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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


// ---------------------------------------------------------------------------
// bf16 at dh 512: tensor cores (wgmma) fed by TMA.
//
// The stabiliser is known before the loop.  With G = i - F and its prefix
// max M_q = max_{k<=q} G_k (both formed by the wrapper in f32, an
// O(B*S*nh) pass beside the cumsum, laid out (B*nh, S)), the full row max
// of D is m_q = F_q + M_q, and exp(D_qk - m_q) = exp(G_k - M_q) <= 1: F_q
// drops out, and the floor exp(-m_q) is the wrapper's third array.  So
// there is no running max, no cross-lane max reduction and no rescale of
// the accumulator, and s is rounded to bf16 under the plain version's own
// stabiliser.  Only the tiles that cross the diagonal mask.
//
// One CTA of two warpgroups (256 threads) per (batch*head, 64-query tile);
// warpgroup g owns the output columns [256g, 256g + 256) -- a 64 x 512 f32
// accumulator would be 256 registers a thread in one warpgroup -- and the
// keys of half g of each key tile for the gates.  Per key tile of BK keys,
// warpgroup g
//   1. issues its partial S_g = Q[:, half g] K[:, half g]^T as 16 wgmma
//      m64n{BK}k16 (both operands K-major in shared memory) and, while it
//      runs, the previous tile's O_g += P V[:, half g] as BK/16 wgmma
//      m64n256k16 (P, bf16, from registers; V MN-major in shared memory);
//   2. once S_g is done, frees its half of the K stage, sends the other
//      warpgroup's keys of S_g through shared memory (f32), meets it at a
//      256-thread named barrier and adds the other's partial of its own
//      keys: each key's S is summed once, by one warpgroup;
//   3. gates its keys in registers, s = S * exp(G_k - M_q) * dh^-0.5 (as
//      powers of 2; below the diagonal factored into one exp2 a key and
//      one a row, see gate_half), masked on the diagonal tile; adds s to
//      its share of n; rounds s to bf16 (its half of P) and sends it;
//   4. once the PV product is done, frees its half of the V stage, meets
//      the other at a second barrier and takes the other half of P: the
//      A fragments of the next PV product.
// n is summed per warpgroup over its keys and the two shares added at the
// end.  No tensor work is repeated, and the gates are computed once.
// Registers: O 128 + S BK/2 + P BK/4 a thread; the shared-memory
// descriptors are rebuilt at each use (hopper::opaque), or ptxas keeps
// the loop-invariant ones of a one-stage ring in registers and spills.
//
// Shared memory: Q (64 x 512 bf16, 64 KB, loaded once), ST stages of K and
// of V (BK keys x 1 KB each), every tile in the 128-byte swizzle as 64-
// column chunks; two buffers each for the S exchange (64 x BK/2 f32) and
// the P exchange (64 x BK/2 bf16), and the n shares.  Each warpgroup's
// half of a stage completes on its own mbarrier and is refilled by the
// last of its four warps to free it (a shared counter), with no producer
// warp: one would push the CTA past 256 threads, where ptxas caps a wgmma
// kernel at 168 registers.  BK = 64, ST = 1: one K and one V stage,
// 224,312 bytes a CTA of the 227 KB it may have; K of tile i+1 loads under
// tile i's exchanges, gates and PV, V of tile i under tile i+1's QK^T.
// Key tiles of 32 in two stages each (212,072 bytes) measured slower: the
// m64n32 QK^T reads as many shared-memory bytes a flop again as m64n64,
// and every key meets twice the barriers.
//
// The K/V stream, the limit: each 64-query tile reads every key before it
// once, so per batch*head sum_{t=1..S/64} 64t keys x 2 KB of K and V --
// 69.2 MB at S = 2048, 1.11 GB a launch over xlstm-350m's 16 (batch, head)
// pairs, against the 134 MB the function must move (a count from the
// code); with one stage each of K and V the refills sit on the critical
// path.  128-query tiles cannot hold O at dh 512 under the register caps
// above.  A 2-CTA cluster multicasting each K/V stage to both query tiles
// of a pair halves the L2 reads, but a refill must then wait for both
// CTAs to free the stage, and it measured slower or barely faster; it
// needs deeper stages than shared memory holds at dh 512.
//
// Query tiles are launched heaviest first, as in the flash attention
// kernel: the grid is (B*nh, query tiles), so blockIdx.y = 0 (started
// first) takes every head's last query tile, and the short ones fill the
// tail of the last wave.  TMA zero-fills rows past S (a last query or key
// tile past S, S < 64); keys past S lie above every kept row's diagonal.
constexpr int kWgThreads = 128;
constexpr int kTcThreads = 2 * kWgThreads;
constexpr int kTcBQ = 64;      // query rows a CTA
constexpr int kTcHD = 512;     // head width of the route
constexpr int kChunk = 64;     // bf16 columns of one 128-byte swizzled box
constexpr int kHalfChunks = kTcHD / 2 / kChunk;  // chunks a warpgroup owns
constexpr float kLog2e = 1.4426950408889634f;

template <int BK, int ST>
struct TcSmem {
  static constexpr int kQChunk = kTcBQ * kChunk * 2;
  static constexpr int kQBytes = kTcBQ * kTcHD * 2;
  static constexpr int kKChunk = BK * kChunk * 2;               // one stage, one chunk
  static constexpr int kHalfBytes = kHalfChunks * kKChunk;     // a warpgroup's half
  static constexpr int kStageBytes = 2 * kHalfBytes;           // BK keys x dh
  static constexpr int kSBytes = kTcBQ * BK / 2 * 4;           // half of S, f32
  static constexpr int kPBytes = kTcBQ * BK / 2 * 2;           // half of P, bf16
  static constexpr int kKOffset = kQBytes;
  static constexpr int kVOffset = kKOffset + ST * kStageBytes;
  static constexpr int kSOffset = kVOffset + ST * kStageBytes;  // two S buffers
  static constexpr int kPOffset = kSOffset + 2 * kSBytes;       // two P buffers
  static constexpr int kNOffset = kPOffset + 2 * kPBytes;       // n of both warpgroups
  // barriers q_full, k_full[ST][2], v_full[ST][2]; then counters
  // k_out[ST][2], v_out[ST][2] (warps done with a warpgroup's half)
  static constexpr int kBarOffset = kNOffset + kTcThreads * 2 * 4;
  static constexpr int kCountOffset = kBarOffset + 8 * (1 + 4 * ST);
  static constexpr int kBytes = kCountOffset + 4 * 4 * ST + 1024;  // + alignment
};

// One thread's share of a 64 x BK tile in the wgmma accumulator layout:
// row r + 8h, keys k0 + 8c + kcol + {0, 1} in s[4c + 2h + {0, 1}] for
// h < 2, c < BK / 8.  Warpgroup WG owns the keys of c in
// [WG * BK / 16, (WG + 1) * BK / 16): it gates them and rounds them to P.

// s = S * 2^((G_k - M_q) log2 e + log2 scale) on warpgroup WG's keys of
// the tile, added to n.  A tile below the diagonal factors the gate as
// a_k b_q = 2^((G_k - c) log2 e) 2^((c - M_q) log2 e + log2 scale) with c =
// M at the tile's last key, so G_k <= c <= M_q and both factors are <= 1:
// one exp2 a key instead of one an element.  The diagonal tile (DIAG)
// takes each element's exponent and zeroes the keys past the row (and
// past S).
template <int BK, int WG, bool DIAG>
__device__ __forceinline__ void gate_half(float (&s)[BK / 2], float (&n)[2],
                                          const float (&mq)[2], const float* __restrict__ Gb,
                                          const float* __restrict__ Mb, int k0, int kcol,
                                          int row, int S, float log2_scale) {
  float b[2], c_ref = 0.f;
  if (!DIAG) {
    c_ref = __ldg(Mb + k0 + BK - 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      b[i] = hopper::exp2_approx(fmaf(c_ref - mq[i], kLog2e, log2_scale));
  }
#pragma unroll
  for (int c = WG * BK / 16; c < (WG + 1) * BK / 16; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = k0 + 8 * c + kcol + j;
      if (DIAG) {
        const float gk = key < S ? __ldg(Gb + key) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = s[4 * c + 2 * i + j] *
                    hopper::exp2_approx(fmaf(gk - mq[i], kLog2e, log2_scale));
          x = key <= row + 8 * i ? x : 0.f;
          n[i] += x;
          s[4 * c + 2 * i + j] = x;
        }
      } else {
        const float a = hopper::exp2_approx((__ldg(Gb + key) - c_ref) * kLog2e);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x = s[4 * c + 2 * i + j] * (a * b[i]);
          n[i] += x;
          s[4 * c + 2 * i + j] = x;
        }
      }
    }
}

template <int BK, int ST>
__global__ void __launch_bounds__(kTcThreads, 1)
mlstm_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const float* __restrict__ G, const float* __restrict__ M,
                   const float* __restrict__ floor_q, __nv_bfloat16* __restrict__ out,
                   int S, int NH, float log2_scale) {
  using L = TcSmem<BK, ST>;
  constexpr int SV = BK / 16;  // float4 of S (and uint2 of P) a thread's half holds
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle needs 1024-byte aligned boxes.
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  const uint32_t base = raw + pad;
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::kKOffset;
  const uint32_t v_s = base + L::kVOffset;
  uint8_t* smem = smem_raw + pad;
  const uint32_t q_full = base + L::kBarOffset;
  const uint32_t k_full = q_full + 8;        // + 8 * (2 * stage + warpgroup)
  const uint32_t v_full = k_full + 16 * ST;  // + 8 * (2 * stage + warpgroup)
  int* k_out = reinterpret_cast<int*>(smem + L::kCountOffset);  // [2 * stage + wg]
  int* v_out = k_out + 2 * ST;

  const int bh = blockIdx.x;
  const int b = bh / NH, h = bh % NH;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest first
  const int ntiles = (min(S, q0 + kTcBQ) + BK - 1) / BK;
  const int64_t row_base = static_cast<int64_t>(bh) * S;

  // TMA loads of warpgroup g's half (columns 256g..) of tile j's K or V
  // into stage j % ST (one thread).
  auto load_k = [&](int j, int g) {
    const int st = j % ST;
    const uint32_t bar = k_full + 8 * (2 * st + g);
    hopper::mbar_arrive_expect_tx(bar, L::kHalfBytes);
#pragma unroll
    for (int c = 0; c < kHalfChunks; ++c)
      hopper::tma_load_4d(k_s + st * L::kStageBytes + g * L::kHalfBytes + c * L::kKChunk,
                          &kmap, bar, (g * kHalfChunks + c) * kChunk, h, j * BK, b);
  };
  auto load_v = [&](int j, int g) {
    const int st = j % ST;
    const uint32_t bar = v_full + 8 * (2 * st + g);
    hopper::mbar_arrive_expect_tx(bar, L::kHalfBytes);
#pragma unroll
    for (int c = 0; c < kHalfChunks; ++c)
      hopper::tma_load_4d(v_s + st * L::kStageBytes + g * L::kHalfBytes + c * L::kKChunk,
                          &vmap, bar, (g * kHalfChunks + c) * kChunk, h, j * BK, b);
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < 2 * ST; ++i) {
      hopper::mbar_init(k_full + 8 * i, 1);
      hopper::mbar_init(v_full + 8 * i, 1);
      k_out[i] = 0;
      v_out[i] = 0;
    }
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int c = 0; c < kTcHD / kChunk; ++c)
      hopper::tma_load_4d(q_s + c * L::kQChunk, &qmap, q_full, c * kChunk, h, q0, b);
    for (int j = 0; j < min(ST, ntiles); ++j)
      for (int g = 0; g < 2; ++g) {
        load_k(j, g);
        load_v(j, g);
      }
  }
  __syncthreads();

  // The warpgroup index through a shuffle from lane 0, so the compiler
  // sees it (and every branch on it) as uniform across the warp.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWgThreads, 0);
  const int t = threadIdx.x % kWgThreads;
  const int warp = t / 32, lane = t % 32;
  const int row = q0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  const int kcol = 2 * (lane % 4);
  float mq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) mq[i] = row + 8 * i < S ? __ldg(M + row_base + row + 8 * i) : 0.f;
  const float* Gb = G + row_base;
  const float* Mb = M + row_base;

  // This warp is done with its warpgroup's half of tile i's K or V stage;
  // the last of the four refills it with tile i + ST.  The counters only
  // grow: four arrivals a use.
  auto release = [&](int* count, int i, bool is_k) {
    __syncwarp();
    if (lane == 0 && (atomicAdd(count + 2 * (i % ST) + wg, 1) & 3) == 3 && i + ST < ntiles)
      is_k ? load_k(i + ST, wg) : load_v(i + ST, wg);
  };

  const uint32_t q_mine = q_s + wg * kHalfChunks * L::kQChunk;
  auto issue_qk = [&](float (&s)[BK / 2], int st) {
    const uint32_t q_tile = hopper::opaque(q_mine);
    const uint32_t k_tile = hopper::opaque(k_s + st * L::kStageBytes + wg * L::kHalfBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcHD / 2 / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 32 bytes a k16 step inside a chunk
      const uint64_t da = hopper::sw128_desc(q_tile + (kk / 4) * L::kQChunk + off, 0, 1024);
      const uint64_t db = hopper::sw128_desc(k_tile + (kk / 4) * L::kKChunk + off, 0, 1024);
      hopper::wgmma_ss(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  float o[kTcHD / 4];        // 64 x 256 f32 over the warpgroup
  uint32_t pa[BK / 16][4];   // P of the tile whose PV product comes next
  auto issue_pv = [&](int i) {
    const int st = i % ST;
    hopper::mbar_wait(v_full + 8 * (2 * st + wg), (i / ST) & 1);
    const uint32_t v_tile = hopper::opaque(v_s + st * L::kStageBytes + wg * L::kHalfBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // 16 keys a step: two 8-row atoms of 1024 bytes
      const uint64_t db = hopper::sw128_desc(v_tile + kk * 2048, L::kKChunk, 1024);
      hopper::wgmma_rs(o, pa[kk], db);
    }
    hopper::wgmma_commit();
  };

  // Tile i's S after its QK^T: warpgroup WG sends the other's keys of its
  // partial and takes its own keys' full S (its partial + the other's),
  // gates them and rounds them to bf16, its half of P (`mine`), which it
  // sends too; then (p_from_both, once the PV product reading pa is done)
  // it takes the other half of P.  Each exchange has two buffers that
  // swap owners every tile (warpgroup g writes buffer (g + i) % 2 and
  // reads the other): each thread writes the slots it read itself one
  // tile before, so one named barrier an exchange suffices.  Templated on
  // the warpgroup so that every register index is a constant.
  float n[2] = {0.f, 0.f};  // this thread's share of the rows' normalisers
  uint2 mine[SV];           // P of my keys: key group c's two registers
  auto s_to_mine = [&](auto wg_const, float (&s)[BK / 2], int i) {
    constexpr int WG = decltype(wg_const)::value;
    float4* s_out = reinterpret_cast<float4*>(smem + L::kSOffset + ((WG + i) & 1) * L::kSBytes);
    const float4* s_in =
        reinterpret_cast<const float4*>(smem + L::kSOffset + ((WG + i + 1) & 1) * L::kSBytes);
#pragma unroll
    for (int v = 0; v < SV; ++v) {
      const int c = (1 - WG) * SV + v;
      s_out[v * kWgThreads + t] = make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
    }
    hopper::named_barrier_sync(1, kTcThreads);
#pragma unroll
    for (int v = 0; v < SV; ++v) {
      const int c = WG * SV + v;
      const float4 x = s_in[v * kWgThreads + t];
      s[4 * c] += x.x;
      s[4 * c + 1] += x.y;
      s[4 * c + 2] += x.z;
      s[4 * c + 3] += x.w;
    }
    const int k0 = i * BK;
    if (k0 + BK - 1 > q0)  // the tile crosses the diagonal
      gate_half<BK, WG, true>(s, n, mq, Gb, Mb, k0, kcol, row, S, log2_scale);
    else
      gate_half<BK, WG, false>(s, n, mq, Gb, Mb, k0, kcol, row, S, log2_scale);
    uint2* p_out = reinterpret_cast<uint2*>(smem + L::kPOffset + ((WG + i) & 1) * L::kPBytes);
#pragma unroll
    for (int v = 0; v < SV; ++v) {
      const int c = WG * SV + v;
      mine[v] = make_uint2(hopper::pack_bf16(s[4 * c], s[4 * c + 1]),
                           hopper::pack_bf16(s[4 * c + 2], s[4 * c + 3]));
      p_out[v * kWgThreads + t] = mine[v];
    }
  };
  // key group c (8 keys) is half of k16 step c / 2: its registers 2(c % 2), +1
  auto p_from_both = [&](auto wg_const, int i) {
    constexpr int WG = decltype(wg_const)::value;
    const uint2* p_in =
        reinterpret_cast<const uint2*>(smem + L::kPOffset + ((WG + i + 1) & 1) * L::kPBytes);
    hopper::named_barrier_sync(1, kTcThreads);
#pragma unroll
    for (int v = 0; v < SV; ++v) {
      const int c = WG * SV + v, co = (1 - WG) * SV + v;
      const uint2 x = p_in[v * kWgThreads + t];
      pa[c / 2][2 * (c % 2)] = mine[v].x;
      pa[c / 2][2 * (c % 2) + 1] = mine[v].y;
      pa[co / 2][2 * (co % 2)] = x.x;
      pa[co / 2][2 * (co % 2) + 1] = x.y;
    }
  };
  auto s_to_mine_wg = [&](float (&s)[BK / 2], int i) {
    if (wg == 0)
      s_to_mine(std::integral_constant<int, 0>(), s, i);
    else
      s_to_mine(std::integral_constant<int, 1>(), s, i);
  };
  auto p_from_both_wg = [&](int i) {
    if (wg == 0)
      p_from_both(std::integral_constant<int, 0>(), i);
    else
      p_from_both(std::integral_constant<int, 1>(), i);
  };

#pragma unroll
  for (int i = 0; i < kTcHD / 4; ++i) o[i] = 0.f;
  hopper::mbar_wait(q_full, 0);
  {  // tile 0: S, exchange, gates (no PV product in flight yet)
    float s[BK / 2];
    hopper::mbar_wait(k_full + 8 * wg, 0);
    issue_qk(s, 0);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    release(k_out, 0, true);
    s_to_mine_wg(s, 0);
    p_from_both_wg(0);
  }
  // Tile i's QK^T and tile i-1's PV in flight together; tile i's exchange
  // and gates run under the PV product.
  for (int i = 1; i < ntiles; ++i) {
    const int st = i % ST;
    float s[BK / 2];
    hopper::mbar_wait(k_full + 8 * (2 * st + wg), (i / ST) & 1);
    issue_qk(s, st);
    issue_pv(i - 1);
    hopper::wgmma_wait<1>();  // groups complete in order: S is done
    hopper::fence_operands(s);
    release(k_out, i, true);
    s_to_mine_wg(s, i);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    release(v_out, i - 1, false);
    p_from_both_wg(i);  // only now: the PV product just done read the old pa
  }
  issue_pv(ntiles - 1);
  hopper::wgmma_wait<0>();
  hopper::fence_operands(o);
  release(v_out, ntiles - 1, false);

  // n = the two warpgroups' shares (f32 addition commutes: both get the
  // same sum), then summed over the row's quad; out = O / max(|n|, exp(-m))
  float2* n_s = reinterpret_cast<float2*>(smem + L::kNOffset);
  n_s[wg * kWgThreads + t] = make_float2(n[0], n[1]);
  hopper::named_barrier_sync(1, kTcThreads);
  const float2 other = n_s[(1 - wg) * kWgThreads + t];
  n[0] += other.x;
  n[1] += other.y;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    n[i] += __shfl_xor_sync(0xffffffffu, n[i], 1);
    n[i] += __shfl_xor_sync(0xffffffffu, n[i], 2);
  }
  const int64_t q_stride = static_cast<int64_t>(NH) * kTcHD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= S) continue;
    const float den = fmaxf(fabsf(n[i]), __ldg(floor_q + row_base + r));
    __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * S + r) * q_stride +
                          static_cast<int64_t>(h) * kTcHD + wg * (kTcHD / 2);
#pragma unroll
    for (int c = 0; c < kTcHD / 2 / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c + kcol) =
          hopper::pack_bf16(o[4 * c + 2 * i] / den, o[4 * c + 2 * i + 1] / den);
  }
}

template <int BK, int ST>
int launch_wgmma(const void* q, const void* k, const void* v, const float* G,
                 const float* M, const float* floor_q, void* out, int B, int S, int NH,
                 float scale, cudaStream_t stream) {
  const hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap qmap, kmap, vmap;
  if (!hopper::encode_map(enc, &qmap, q, kTcHD, NH, S, B, kTcBQ) ||
      !hopper::encode_map(enc, &kmap, k, kTcHD, NH, S, B, BK) ||
      !hopper::encode_map(enc, &vmap, v, kTcHD, NH, S, B, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = TcSmem<BK, ST>::kBytes;
  auto kernel = mlstm_wgmma_kernel<BK, ST>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * NH, (S + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, smem, stream>>>(qmap, kmap, vmap, G, M, floor_q,
                                             static_cast<__nv_bfloat16*>(out), S, NH,
                                             log2f(scale));
  return static_cast<int>(cudaGetLastError());
}

// f32 at dh 64, 128, 256, 512 and bf16 at dh 64, 128, 256 (CUDA cores).
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
    case 512:  // bf16 at 512 runs on the tensor cores
      if constexpr (std::is_same<T, float>::value)
        return launch<T, 512, 32, 32, 2, 2, 4>(q, k, v, F, ig, out, B, S, NH, scale, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The CUDA-core kernel.  dtype: 0 = float32 (dh in {64, 128, 256, 512}),
// 1 = bfloat16 (dh in {64, 128, 256}); F = cumsum(log sigmoid(f)) and ig,
// (B, S, nh) f32.
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

// The tensor-core kernel: bf16 q, k, v, out at dh 512; G, M and the floor
// exp(-(F + M)), (B*nh, S) f32.
extern "C" int mlstm_wgmma_fwd(const void* q, const void* k, const void* v,
                               const void* G, const void* M, const void* floor_q,
                               void* out, int B, int S, int NH, int dh, float scale,
                               void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dh != kTcHD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(G);
  const float* m = static_cast<const float*>(M);
  const float* fl = static_cast<const float*>(floor_q);
  return launch_wgmma<64, 1>(q, k, v, g, m, fl, out, B, S, NH, scale, st);
}

// Dynamic shared memory a CTA of the tensor-core kernel asks for, in bytes.
extern "C" int mlstm_wgmma_smem_bytes() { return TcSmem<64, 1>::kBytes; }

extern "C" const char* mlstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
