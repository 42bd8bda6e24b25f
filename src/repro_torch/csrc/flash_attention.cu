// flash_attention, float32: causal (optionally sliding-window) GQA
// attention with the online-softmax recurrence, in the model layout
// q (B, S, H, D), k / v (B, S, KV, D), out (B, S, H, D), in exact float32
// on the CUDA cores (no TF32: the served models' float32 gate holds the
// kernel path to 1e-4 of the logit scale). bfloat16 inputs go to the
// tensor-core kernel of flash_attention_sm90.cu; the wrapper picks the
// library by dtype.
//
// Replaces src/repro/kernels/flash_attention.py:75 flash_attention
// (_flash_kernel) for float32 inputs. The TPU kernel holds a whole (S, D)
// K/V stripe in VMEM and runs 128 x 128 blocks on the MXU; here a CTA
// holds one query tile of a whole KV group and streams K/V tiles through
// shared memory.
//
// Bound: operations on the CUDA cores. 4 D FLOPs per valid (query, key)
// pair: at paper-rwsgd's prefill (B 4, S 128, H 8, KV 4, D 32) 34 MFLOP,
// 0.0005 ms at 67 TFLOP/s (its 1.6 MB take about as long at 3.35 TB/s);
// at yi-6b's float32 gate (B 4, S 512, H 32, KV 4, D 128) 8.6 GFLOP
// against 76 MB, 0.128 ms.
//
// Design, for the FMA rate:
// - A CTA serves the G = H / KV query heads of one KV group (M rows:
//   M / G query positions x G heads, position-major, or M heads of one
//   position when G > M), so each K/V tile it loads serves every head of
//   the group. M is 64, or 32 where 64 would leave fewer than two CTAs an
//   SM (paper-rwsgd: 16 positions x 2 heads, 128 CTAs). The grid's slow
//   dimension is the query tile, last (longest) first.
// - Register blocking: a thread owns R rows (4; 2 at D 256, and in the
//   small tile at D 128; 1 in the small tile at D 256) and, of each key
//   tile, BK / 8 keys (keys cg + 8 j, so eight neighbouring threads read
//   eight neighbouring K rows: no bank conflict) and D / 8 output dims
//   (4 d at 4 cg + 32 j, float4). Scores: R + BK / 8 float4 reads feed
//   4 R BK / 8 FMAs; P.V: R + D / 8 float4 reads feed R D / 2 FMAs. A
//   row's max and sum are reduced over its eight threads (three
//   shuffles); the probabilities go through shared memory to the same
//   eight threads (a warp barrier, no CTA barrier).
// - K/V tiles (64 keys in the large tile at D <= 64, else 32) arrive by
//   cp.async (16 bytes a copy where aligned) in a two-stage ring: the
//   next tile's copies are in flight while the current tile is
//   multiplied. Q arrives with the first tile; the 1 / sqrt(D) scale goes
//   on the scores. Keys before the first row's window or after the last
//   row are masked for every row of the CTA and are zero-filled instead
//   of read.
// - The small tile splits its key tiles between NS groups of threads
//   (4 at D <= 64, 2 at D 128), each with its own ring, so that a short
//   sequence's longest CTA takes one tile's time, not four. At the end
//   group g finishes the rows r with r % NS == g: the others hand it
//   their (m, l, acc) of those rows through shared memory, and it merges
//   them as the online softmax merges two blocks.
// At paper-rwsgd's shape the longest CTA spends about a third of its time
// on its first copies (Q and every group's first K/V tile), a third on
// one tile's products, whose shared-memory reads bound them, and the rest
// on the merge and the launch; see PERF.md.
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
constexpr int kGroup = 8;          // threads that share a row
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

// M query rows a CTA, head dim D. The small tile (M 32) splits its key
// tiles between NS groups of threads (4 of 64 threads at D <= 64, 2 of 128
// at D 128, one at D 256, as shared memory allows), each with its own
// ring, merged at the end.
template <int D, int M>
struct Cfg {
  static constexpr int R = M == 32 && D <= 64 ? 4 : M / (D == 256 ? 32 : 16);  // rows per thread
  static constexpr int BK = M == 64 && D <= 64 ? 64 : 32;  // keys per tile
  static constexpr int KC = BK / kGroup;                // keys per thread
  static constexpr int DJ = D / 32;                     // float4 output columns per thread
  static constexpr int QP = D + 4;                      // Q / K row pitch: an odd number of 16-byte units
  static constexpr int PP = BK + 4;                     // probability row pitch
  static constexpr int NS = M == 64 ? 1 : D <= 64 ? 4 : D == 128 ? 2 : 1;  // key groups
  static constexpr int GT = M / R * kGroup;             // threads a group
  static constexpr int kThreads = NS * GT;
  static constexpr int kRing = 2 * BK * QP + 2 * BK * D + M * PP;  // a group's K, V and P (floats)
  static constexpr size_t kSmem = sizeof(float) * (M * QP + NS * kRing);
  // the merge's hand-over fits in the rings
  static_assert(NS == 1 || (R % NS == 0 && NS * R * (2 + 4 * DJ) * GT <= NS * kRing), "merge");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four floats global -> shared (one 16-byte copy, or four 4-byte ones),
// zeros when !valid
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid, bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst + e)),
                   "l"(reinterpret_cast<uint64_t>(src + e)), "r"(valid ? 4 : 0)
                   : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// commits this thread's pending copies and waits for all of them
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// grid (batch x KV group x head chunk, query tiles); gq heads per CTA,
// M / gq positions
template <int D, int M>
__global__ void __launch_bounds__(Cfg<D, M>::kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ o, int S, int H, int KV, int window, float scale, int gq, int nhc,
             int vec) {
  using C = Cfg<D, M>;
  constexpr int NT = C::kThreads, R = C::R, BK = C::BK, KC = C::KC, QP = C::QP, PP = C::PP;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, grp = tid / C::GT, gtid = tid % C::GT;
  const int rg = gtid / kGroup, cg = gtid % kGroup;
  float* sq = reinterpret_cast<float*>(smem4);         // M x QP
  float* sk = sq + M * QP + grp * C::kRing;            // this group's 2 x BK x QP
  float* sv = sk + 2 * BK * QP;                        // 2 x BK x D
  float* sp = sv + 2 * BK * D;                         // M x PP probabilities

  const int G = H / KV, bq = M / gq, rows = bq * gq;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the last (longest) query tiles first
  const int hc = blockIdx.x % nhc, kvh = blockIdx.x / nhc % KV, b = blockIdx.x / nhc / KV;
  const int q0 = qt * bq, h0 = kvh * G + hc * gq, nh = min(gq, G - hc * gq);
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(KV) * D;
  const float* qb = q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h0) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride + static_cast<size_t>(kvh) * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  // row m: position q0 + m / gq, head h0 + m % gq
  for (int i = tid; i < M * D / 4; i += NT) {
    const int m = i / (D / 4), c = i % (D / 4) * 4, pos = q0 + m / gq;
    const bool ok = m < rows && m % gq < nh && pos < S;
    copy4(sq + m * QP + c, qb + (ok ? pos * q_stride + static_cast<size_t>(m % gq) * D + c : 0), ok, vec);
  }
  const int q_last = min(q0 + bq, S) - 1;
  const int kt_end = q_last / BK + 1;
  const int first = window > 0 ? q0 - window + 1 : 0;  // first valid key of row q0
  const int kt_begin = first > 0 ? first / BK : 0;
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int i = gtid; i < BK * D / 4; i += C::GT) {
      const int j = i / (D / 4), c = i % (D / 4) * 4, pos = k0 + j;
      const bool ok = pos >= first && pos <= q_last;  // keys outside are masked for every row
      const size_t off = ok ? pos * kv_stride + c : 0;
      copy4(sk + (buf * BK + j) * QP + c, kb + off, ok, vec);
      copy4(sv + (buf * BK + j) * D + c, vb + off, ok, vec);
    }
    cp_async_commit();
  };

  float m_[R], l_[R], acc[R][4 * C::DJ];
  int qpos[R];  // the thread's rows' positions
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qpos[r] = q0 + (rg * R + r) / gq;
    m_[r] = kNegInf;
    l_[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * C::DJ; ++e) acc[r][e] = 0.f;
  }

  // group g takes key tiles kt_begin + g, + g + NS, ...
  if (kt_begin + grp < kt_end) load_kv(kt_begin + grp, 0);  // with Q in the same copies
  cp_async_wait_all();
  __syncthreads();  // Q and each group's first tile are in

  for (int kt = kt_begin + grp, it = 0; kt < kt_end; kt += C::NS, ++it) {
    const int buf = it & 1;
    if (it > 0) {
      cp_async_wait_all();
      // tile kt is in; the group is done with its previous tile
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(C::GT) : "memory");
    }
    if (kt + C::NS < kt_end) load_kv(kt + C::NS, buf ^ 1);
    const float* K = sk + buf * BK * QP;
    const float* V = sv + buf * BK * D;

    // scores of rows rg * R + r against keys cg + 8 c
    float s[R][KC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) qv[r] = *reinterpret_cast<const float4*>(sq + (rg * R + r) * QP + d);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(K + (cg + kGroup * c) * QP + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][c] = __fmaf_rn(qv[r].x, kk.x, s[r][c]);
          s[r][c] = __fmaf_rn(qv[r].y, kk.y, s[r][c]);
          s[r][c] = __fmaf_rn(qv[r].z, kk.z, s[r][c]);
          s[r][c] = __fmaf_rn(qv[r].w, kk.w, s[r][c]);
        }
      }
    }

    // online softmax, each row over its eight threads
    const int k0 = kt * BK;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = rg * R + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int kpos = k0 + cg + kGroup * c;  // keys past S are past every row's position
        bool ok = kpos <= qpos[r];
        if (window > 0) ok = ok && kpos > qpos[r] - window;
        s[r][c] = ok ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int x = 1; x < kGroup; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m_[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float p = expf(s[r][c] - m_new);
        sp[m * PP + cg + kGroup * c] = p;
        sum += p;
      }
#pragma unroll
      for (int x = 1; x < kGroup; x <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
      const float alpha = expf(m_[r] - m_new);
      l_[r] = l_[r] * alpha + sum;
      m_[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * C::DJ; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();  // a row's probabilities are read by its own eight threads

    // P.V: dims 4 cg + 32 j of rows rg * R + r
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pv[r] = *reinterpret_cast<const float4*>(sp + (rg * R + r) * PP + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int dj = 0; dj < C::DJ; ++dj) {
          const float4 vv = *reinterpret_cast<const float4*>(V + (j + e) * D + 4 * cg + 32 * dj);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float p = lane(pv[r], e);
            acc[r][4 * dj + 0] = __fmaf_rn(p, vv.x, acc[r][4 * dj + 0]);
            acc[r][4 * dj + 1] = __fmaf_rn(p, vv.y, acc[r][4 * dj + 1]);
            acc[r][4 * dj + 2] = __fmaf_rn(p, vv.z, acc[r][4 * dj + 2]);
            acc[r][4 * dj + 3] = __fmaf_rn(p, vv.w, acc[r][4 * dj + 3]);
          }
        }
      }
    }
  }

  if (C::NS > 1) {  // group g finishes rows r with r % NS == g; the others hand theirs over
    constexpr int Z = 2 + 4 * C::DJ;  // (m, l, acc) of a row
    float* slots = sq + M * QP;       // the rings, free now: [group][row][value][thread]
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r % C::NS == grp) continue;
      float* slot = slots + (grp * R + r) * Z * C::GT + gtid;
      slot[0] = m_[r];
      slot[C::GT] = l_[r];
#pragma unroll
      for (int e = 0; e < 4 * C::DJ; ++e) slot[(2 + e) * C::GT] = acc[r][e];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r % C::NS != grp) continue;
#pragma unroll
      for (int g = 0; g < C::NS; ++g) {  // exp(-1e30 - m) = 0 wipes a side whose keys were all masked
        if (g == grp) continue;
        const float* slot = slots + (g * R + r) * Z * C::GT + gtid;
        const float m1 = slot[0], m_new = fmaxf(m_[r], m1);
        const float a0 = expf(m_[r] - m_new), a1 = expf(m1 - m_new);
        l_[r] = l_[r] * a0 + slot[C::GT] * a1;
        m_[r] = m_new;
#pragma unroll
        for (int e = 0; e < 4 * C::DJ; ++e) acc[r][e] = acc[r][e] * a0 + slot[(2 + e) * C::GT] * a1;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = rg * R + r, pos = q0 + m / gq;
    if (r % C::NS != grp || !(m < rows && m % gq < nh && pos < S)) continue;
    const float inv = 1.f / fmaxf(l_[r], 1e-30f);
    float* orow = o + (static_cast<size_t>(b) * S + pos) * q_stride + static_cast<size_t>(h0 + m % gq) * D;
#pragma unroll
    for (int dj = 0; dj < C::DJ; ++dj) {
      float* dst = orow + 4 * cg + 32 * dj;
      const float4 val = make_float4(acc[r][4 * dj] * inv, acc[r][4 * dj + 1] * inv,
                                     acc[r][4 * dj + 2] * inv, acc[r][4 * dj + 3] * inv);
      if (vec) {
        *reinterpret_cast<float4*>(dst) = val;
      } else {
        dst[0] = val.x, dst[1] = val.y, dst[2] = val.z, dst[3] = val.w;
      }
    }
  }
}

struct Shape {
  int B, S, H, KV, window, vec;
  float scale;
};

// (heads per CTA, head chunks, query tiles) for M rows a CTA
void tiles(const Shape& s, int M, int* gq, int* nhc, int* nqt) {
  const int G = s.H / s.KV;
  *gq = G < M ? G : M;
  *nhc = (G + *gq - 1) / *gq;
  const int bq = M / *gq;
  *nqt = (s.S + bq - 1) / bq;
}

template <int D, int M>
int launch_m(const float* q, const float* k, const float* v, float* o, const Shape& s, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D, M>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_kernel<D, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int gq, nhc, nqt;
  tiles(s, M, &gq, &nhc, &nqt);
  const dim3 grid(s.B * s.KV * nhc, nqt);
  flash_kernel<D, M><<<grid, Cfg<D, M>::kThreads, smem, stream>>>(q, k, v, o, s.S, s.H, s.KV, s.window, s.scale,
                                                              gq, nhc, s.vec);
  return static_cast<int>(cudaGetLastError());
}

// 64 rows a CTA where that still gives two CTAs an SM, else 32
template <int D>
int launch(const float* q, const float* k, const float* v, float* o, const Shape& s, cudaStream_t stream) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int gq, nhc, nqt;
  tiles(s, 64, &gq, &nhc, &nqt);
  if (s.B * s.KV * nhc * nqt >= 2 * sms) return launch_m<D, 64>(q, k, v, o, s, stream);
  return launch_m<D, 32>(q, k, v, o, s, stream);
}
}  // namespace

// The float32 entry (bf16 must be 0): q (B, S, H, D), k / v (B, S, KV, D),
// o (B, S, H, D), contiguous. D in {32, 64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int window, int bf16,
                                      float scale, void* stream) {
  if (bf16 || KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const Shape s{B, S, H, KV, window, aligned(q) && aligned(k) && aligned(v) && aligned(o), scale};
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qf, kf, vf, of, s, st);
    case 64: return launch<64>(qf, kf, vf, of, s, st);
    case 128: return launch<128>(qf, kf, vf, of, s, st);
    case 256: return launch<256>(qf, kf, vf, of, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
