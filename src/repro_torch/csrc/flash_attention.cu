// flash_attention: causal (optionally sliding-window) GQA attention with
// the online-softmax recurrence, in the model layout q (B, S, H, D),
// k / v (B, S, KV, D), out (B, S, H, D); float32 or bfloat16 (raw 16-bit
// words, converted with cuda_bf16.h), f32 accumulation.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel). The TPU kernel holds a whole (S, D) K/V stripe in VMEM
// and runs 128 x 128 blocks on the MXU; here a CTA holds one 32-row query
// tile and streams 32-key K/V tiles through shared memory.
//
// Bound: at yi-6b's prefill (S 512, D 128, bf16) the work is ~2 GFLOP per
// layer against ~13 MB of q/k/v/o, so operations bound it on the tensor
// cores. This first kernel runs on the CUDA cores (f32 FMAs), so it is
// far from that bound; tensor cores (wgmma) and TMA come later.
//
// Design: grid (query tiles, q heads, batch); 4 warps, 8 query rows per
// warp. Scores: lane = key of the tile, each lane dots its key row with
// the warp's 8 query rows (float4 shared-memory reads; the K rows are
// padded to D + 4 floats so the lanes' reads hit distinct banks). The
// row max and sum are warp shuffles. P.V: lane owns output dims
// lane + 32 j. Q head h reads KV head h / (H / KV).
//
// Skipped tiles. Key tiles wholly above the causal diagonal, or wholly
// before the sliding window of the tile's first row, are never loaded.
// That is exact, not an approximation: in the TPU kernel such a block
// either comes after every valid key of the row (its scores are -1e30,
// so p = exp(-1e30 - m) = 0), or comes before the row's first valid key,
// where m is still -1e30 and p = exp(0) = 1 -- but then the first valid
// block sets alpha = exp(-1e30 - m_real) = 0, which wipes l and acc. Every
// causal row has at least its own position valid, so that block exists.
// Rows whose keys in a loaded tile are all masked go through the same
// arithmetic as the TPU kernel (masked scores are -1e30, not -inf).
#include <cuda_bf16.h>

#include <cstdint>

namespace {
constexpr int kWarps = 4;
constexpr int kRows = 8;                // query rows per warp
constexpr int kBQ = kWarps * kRows;     // query rows per CTA
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D + kBQ * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int S, int H, int KV, int window, float scale) {
  constexpr int KS = D + 4;   // padded K row (floats)
  constexpr int DL = D / 32;  // output dims per lane
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // kBQ x D, scaled queries
  float* sk = sq + kBQ * D;                     // kBK x KS
  float* sv = sk + kBK * KS;                    // kBK x D
  float* sp = sv + kBK * D;                     // kBQ x kBK probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const size_t q_stride = static_cast<size_t>(H) * D;   // between positions
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* qb = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride + static_cast<size_t>(h / (H / KV)) * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int pos = q0 + i / D;
    sq[i] = pos < S ? to_f(qb[pos * q_stride + i % D]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[r][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = q_last / kBK + 1;
  const int first = window > 0 ? q0 - window + 1 : 0;  // first valid key of row q0
  const int kt_begin = first > 0 ? first / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and sq is written)
    for (int i = tid; i < kBK * D; i += kWarps * 32) {
      const int r = i / D, d = i % D, pos = k0 + r;
      const bool in = pos < S;
      sk[r * KS + d] = in ? to_f(kb[pos * kv_stride + d]) : 0.f;
      sv[r * D + d] = in ? to_f(vb[pos * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(sk + lane * KS);
    const float4* q4 = reinterpret_cast<const float4*>(sq + warp * kRows * D);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = q4[r * (D / 4) + d4];
        s[r] = __fmaf_rn(qq.x, kk.x, s[r]);
        s[r] = __fmaf_rn(qq.y, kk.y, s[r]);
        s[r] = __fmaf_rn(qq.z, kk.z, s[r]);
        s[r] = __fmaf_rn(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      bool ok = kpos <= qpos && kpos < S;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float sr = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[r][j] *= alpha;
      sp[(warp * kRows + r) * kBK + lane] = p;
    }
    __syncwarp();

    const float* pw = sp + warp * kRows * kBK;
    for (int c = 0; c < kBK; ++c) {
      float vv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j) vv[j] = sv[c * D + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBK + c];
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[r][j] = __fmaf_rn(p, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + static_cast<size_t>(b) * S * q_stride + qpos * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < DL; ++j) put(orow + lane + 32 * j, acc[r][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
             int D, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

// q (B, S, H, D), k / v (B, S, KV, D), o (B, S, H, D), contiguous, all
// float32 (bf16 == 0) or all bfloat16 (bf16 == 1). D in {32, 64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int window, int bf16,
                                      float scale, void* stream) {
  if (H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, window, scale, st)
              : launch_d<float>(q, k, v, o, B, S, H, KV, D, window, scale, st);
}
