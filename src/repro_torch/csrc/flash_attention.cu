// flash_attention, float32: causal (optionally sliding-window) GQA
// attention with the online-softmax recurrence, in the model layout
// q (B, S, H, D), k / v (B, S, KV, D), out (B, S, H, D), in exact float32
// on the CUDA cores (no TF32: the served models' float32 gate holds the
// kernel path to 1e-4 of the logit scale). bfloat16 inputs go to the
// tensor-core kernel of flash_attention_sm90.cu; the wrapper picks the
// library by dtype.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel) for float32 inputs. The TPU kernel holds a whole (S, D)
// K/V stripe in VMEM and runs 128 x 128 blocks on the MXU; here a CTA
// holds one 32-row query tile and streams 32-key K/V tiles through shared
// memory.
//
// Bound: at paper-rwsgd's prefill (B 4, S 128, H 8, KV 4, D 32) the work
// is 34 MFLOP against 1.6 MB, so bytes bound it; the kernel runs f32 FMAs
// on the CUDA cores, well above that bound.
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
#include <cuda_runtime.h>

#include <cstdint>

namespace {
constexpr int kWarps = 4;
constexpr int kRows = 8;                // query rows per warp
constexpr int kBQ = kWarps * kRows;     // query rows per CTA
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr float kNegInf = -1e30f;       // the TPU kernel's NEG_INF

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

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ o, int S, int H, int KV, int window, float scale) {
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
  const float* qb = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride + static_cast<size_t>(h / (H / KV)) * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int pos = q0 + i / D;
    sq[i] = pos < S ? qb[pos * q_stride + i % D] * scale : 0.f;
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
      sk[r * KS + d] = in ? kb[pos * kv_stride + d] : 0.f;
      sv[r * D + d] = in ? vb[pos * kv_stride + d] : 0.f;
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
    float* orow = o + static_cast<size_t>(b) * S * q_stride + qpos * q_stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < DL; ++j) orow[lane + 32 * j] = acc[r][j] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// The float32 entry (bf16 must be 0): q (B, S, H, D), k / v (B, S, KV, D),
// o (B, S, H, D), contiguous. D in {32, 64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int window, int bf16,
                                      float scale, void* stream) {
  if (bf16 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, KV, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
