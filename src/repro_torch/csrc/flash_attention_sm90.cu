// flash_attention, bfloat16, on the tensor cores: causal (optionally
// sliding-window) GQA attention with the online-softmax recurrence, in
// the model layout q (B, S, H, D), k / v (B, S, KV, D), out (B, S, H, D),
// f32 accumulation. The float32 path stays in flash_attention.cu (CUDA
// cores, exact float32); the wrapper picks the library by dtype.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel) for bfloat16 inputs.
//
// Bound: at yi-6b's prefill (B 4, S 512, H 32, KV 4, D 128) the causal
// work is 8.6 GFLOP against 37.7 MB of q / k / v / o, so on this card
// bytes bound it (11 us at 3.35 TB/s; the FLOPs take 8.7 us at the bf16
// tensor-core peak). Both terms are close: the kernel has to keep the
// tensor cores busy and read k / v once per query tile, not per row.
//
// Design. A CTA owns a 128-row query tile of one (head, batch): two
// consumer warpgroups of 64 rows each and one producer warpgroup (384
// threads). The producer issues TMA loads (cp.async.bulk.tensor, 4-D
// tensor maps over the model layout, 128-byte swizzle; 64-byte for
// D 32) of the Q tile once and of 64-key K and V tiles into a ring of
// kStages stages, with an mbarrier per stage for "full" (transaction
// bytes) and one for "empty" (the eight consumer warps arrive), so the
// next tiles load while the current one is multiplied. Each consumer
// warpgroup runs S = Q.K^T as wgmma m64n64k16 with both operands
// K-major in shared memory, the online softmax on the S registers in
// f32, then O += P.V as wgmma m64nDk16 with P converted to bf16 pairs in
// registers (the S accumulator layout is the A-fragment layout) and V
// read as an MN-major B operand, D contiguous, straight from its TMA
// tile. GQA is an index: q head h reads kv head h / (H / KV).
//
// Registers. The O accumulator takes D / 2 floats per thread (128 at
// D 256), S 32 and P 16. A CTA of 384 threads starts at 168 registers a
// thread (each SM sub-partition holds three of its warps); the producer
// warpgroup gives registers back (setmaxnreg.dec 24) and the consumers
// take them (setmaxnreg.inc 240), which D 256 needs: with the producer as
// one lone warp the kernel had 168 registers and spilled 384 bytes at
// D 256 (-Xptxas -v; the build keeps that report beside the library).
//
// Rounding. P is rounded to bf16 before P.V, as PyTorch's
// scaled_dot_product_attention does; the TPU kernel multiplies P.V in
// f32. The row sums l use the unrounded p. The bf16 tolerance of 3e-2
// covers the difference.
//
// Skipped tiles, as in flash_attention.cu: key tiles wholly above the
// diagonal or wholly before the window of the CTA's first row are never
// loaded; a warpgroup also skips (without reading) the loaded tiles that
// lie wholly above its own diagonal or before its own window. That is
// exact: in the TPU kernel such a tile comes either after every valid
// key of the row (scores -1e30, so p = exp(-1e30 - m) = 0) or before
// the row's first valid key, where m is still -1e30 and p = 1 -- but
// then the first valid tile gives alpha = exp(-1e30 - m_real) = 0, which
// wipes l and O. Only tiles that cross the diagonal or a window edge are
// masked, with the reference's NEG_INF = -1e30 (not -inf), so rows of a
// loaded tile whose keys are all masked follow the same arithmetic. The
// softmax runs in the log2 domain (x = s * scale * log2 e, exp2), which
// keeps that argument: x - m is exactly 0 when both are -1e30.
//
// Heavy query tiles are scheduled first (blockIdx.x walks the tiles in
// reverse), so the causal triangle's long rows do not trail the grid.
#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {
constexpr int kBM = 128;                 // query rows per CTA
constexpr int kBN = 64;                  // keys per tile
constexpr int kStages = 2;               // K / V ring depth
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr float kNegInf = -1e30f;        // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;  // bf16 per TMA box row (128 or 64 bytes)
  static constexpr int kSwizzle = kCols * 2;     // bytes: the swizzle span and the row pitch
  static constexpr int kChunks = D / kCols;      // column chunks of a row
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;   // one K or one V tile
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBarOff + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

// --- TMA --------------------------------------------------------------------
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// d += A.B for one m64n32k16 step: A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B for one m64n64k16 step: A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B for one m64n128k16 step: A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B for one m64n256k16 step: A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  if constexpr (D == 256) wgmma_rs_n256(d, a, db);
}

// A consumer warpgroup: rows [row0, row0 + 64) of the CTA's query tile.
template <int D>
__device__ __forceinline__ void consume(const uint8_t* sq, const uint8_t* sk, const uint8_t* sv,
                                        uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
                                        uint64_t* empty, __nv_bfloat16* __restrict__ out, int q0,
                                        int h, int b, int kt_begin, int n_tiles, int S, int H,
                                        int window, float scale_log2) {
  using T = Tile<D>;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + wg * 64;
  const bool live = row0 < S;
  const int wg_end = live ? (min(row0 + 64, S) - 1) / kBN : -1;
  const int wg_begin = window > 0 ? max(0, row0 - window + 1) / kBN : 0;
  const int r_a = row0 + warp * 16 + lane / 4;  // this thread's rows: r_a and r_a + 8
  constexpr uint32_t kSbo = 8 * T::kSwizzle;     // between 8-row groups of a swizzle atom
  const uint32_t q_addr = smem_u32(sq) + wg * 64 * T::kSwizzle;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if (live) mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int kt = kt_begin + it;
    mbar_wait(k_full + s, ph);
    if (kt < wg_begin || kt > wg_end) {  // wholly above this warpgroup's diagonal or before its window
      mbar_wait(v_full + s, ph);
      if (lane == 0) mbar_arrive(empty + s);
      continue;
    }

    // S = Q.K^T (64 x 64 per warpgroup), K-major operands, k-steps of 16
    float sc[32];
    const uint32_t k_addr = smem_u32(sk + s * T::kKVBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk * 16 % T::kCols) * 2, chunk = kk * 16 / T::kCols;
      wgmma_ss_n64(sc, desc<T::kSwizzle>(q_addr + chunk * kBM * T::kSwizzle + col, 16, kSbo),
                   desc<T::kSwizzle>(k_addr + chunk * kBN * T::kSwizzle + col, 16, kSbo), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in the log2 domain; element i of sc is row r_a + 8 * (i >> 1 & 1),
    // key k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1)
    const int k0 = kt * kBN;
    const bool edge = k0 + kBN - 1 > row0 || (window > 0 && k0 <= row0 + 63 - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        const int qpos = r_a + 8 * (i >> 1 & 1);
        const bool ok = kpos <= qpos && (window <= 0 || kpos > qpos - window);
        x = ok ? x : kNegInf;
      }
      sc[i] = x;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha[r];
    }
    // P as the A operand of P.V: slice kk holds keys 16 kk .. 16 kk + 15,
    // {row r_a, row r_a + 8} x {n-block 2 kk, n-block 2 kk + 1}
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(sc[4 * j] - m[0]), p1 = exp2f(sc[4 * j + 1] - m[0]);
      const float p2 = exp2f(sc[4 * j + 2] - m[1]), p3 = exp2f(sc[4 * j + 3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      p[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      p[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P.V, V MN-major (D contiguous): LBO steps between 64-column chunks
    mbar_wait(v_full + s, ph);
    const uint32_t v_addr = smem_u32(sv + s * T::kKVBytes);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs<D>(o, p[kk], desc<T::kSwizzle>(v_addr + kk * 16 * T::kSwizzle, kBN * T::kSwizzle, kSbo));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty + s);
  }

  // O / l in bf16, straight from the accumulator layout
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t pitch = static_cast<size_t>(H) * D;  // between positions
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r_a + 8 * r;
    if (qpos >= S) continue;
    const float inv = __frcp_rn(fmaxf(l[r], 1e-30f));
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * S + qpos) * pitch +
                          static_cast<size_t>(h) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out, int S,
                  int H, int KV, int window, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms
  uint8_t* sq = smem + T::kQOff;
  uint8_t* sk = smem + T::kKOff;
  uint8_t* sv = smem + T::kVOff;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBN : 0;
  const int n_tiles = (min(q0 + kBM, S) - 1) / kBN - kt_begin + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(sq + c * kBM * T::kSwizzle, &tm_q, q_full, c * T::kCols, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = (kt_begin + it) * kBN;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);  // the first pass finds the ring empty
        mbar_expect_tx(k_full + s, T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(sk + s * T::kKVBytes + c * kBN * T::kSwizzle, &tm_k, k_full + s, c * T::kCols,
                   kvh, k0, b);
        }
        mbar_expect_tx(v_full + s, T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(sv + s * T::kKVBytes + c * kBN * T::kSwizzle, &tm_v, v_full + s, c * T::kCols,
                   kvh, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D>(sq, sk, sv, q_full, k_full, v_full, empty, out, q0, h, b, kt_begin, n_tiles, S, H,
               window, scale_log2);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// does not link libcuda itself
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a (B, S, heads, D) bf16 tensor, innermost first; boxes of
// `rows` positions by `cols` columns of one head, swizzled by cols * 2 bytes.
int tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D, int rows,
               int cols) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int window, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap mq, mk, mv;
  int e = tensor_map(&mq, q, B, S, H, D, kBM, T::kCols);
  if (e == 0) e = tensor_map(&mk, k, B, S, KV, D, kBN, T::kCols);
  if (e == 0) e = tensor_map(&mv, v, B, S, KV, D, kBN, T::kCols);
  if (e != 0) return e;
  static bool sized[64] = {};  // per device: the shared-memory attribute is set once
  int dev = 0;
  cudaError_t a = cudaGetDevice(&dev);
  if (a == cudaSuccess && dev < 64 && !sized[dev]) {
    a = cudaFuncSetAttribute(flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kBytes);
    sized[dev] = a == cudaSuccess;
  }
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  flash_sm90_kernel<D><<<grid, kThreads, T::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H, KV, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// The bfloat16 entry (bf16 must be 1): q (B, S, H, D), k / v (B, S, KV, D),
// o (B, S, H, D), contiguous and 16-byte aligned; D in {32, 64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int window, int bf16,
                                      float scale, void* stream) {
  if (!bf16 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, window, scale, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, KV, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
