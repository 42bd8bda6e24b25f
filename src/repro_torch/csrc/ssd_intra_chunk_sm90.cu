// ssd_intra_chunk, bfloat16 B / C, on the tensor cores: the Mamba-2 SSD
// intra-chunk block and each chunk's outgoing state, for every (batch,
// chunk) and head:
//
//   S[q, t]     = C_q . B_t                                   (shared by every head)
//   y[q, h, p]  = sum_{t <= q} S[q, t] exp(a[q, h] - a[t, h]) x[t, h, p]
//   st[h, p, n] = sum_t x[t, h, p] exp(a[Q-1, h] - a[t, h]) B[t, n]
//
// with x (B, nc, Q, H, P) f32 (dt-weighted inputs), a = da_cs
// (B, nc, Q, H) f32 (in-chunk cumulative log-decay), B / C (B, nc, Q, N)
// bfloat16; y and st are f32. Float32 B / C stay in exact float32 on the
// CUDA cores (ssd_intra_chunk.cu); the wrapper picks the library by dtype.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_intra_chunk (_ssd_kernel)
// for bfloat16 B / C. The TPU kernel builds a chunk's (Q, Q, H) decay
// tensor in VMEM (16 MB at mamba2-1.3b); here the causal mask is a select
// on each element and the decay exp(a_q - a_t) is computed per element
// where it is used, as the reference does (exp(a_q) exp(-a_t) would
// overflow within a chunk).
//
// Bound: at mamba2-1.3b's prefill (batch 4, nc 2, Q 256, H 64, P 64,
// N 128) the block is 4.4 GFLOP against 85 MB of x / y / states, so on
// the tensor cores bytes bound it (0.0255 ms at 3.35 TB/s; the FLOPs take
// 0.009 ms at the TF32 peak), and on the CUDA cores operations (0.066 ms
// at 67 TFLOP/s): only the tensor cores can get near the bound.
//
// Precision: x is f32 and the kernel is held to its plain version within
// 3e-4. x, W and the decayed x go through the tensor cores as TF32 hi /
// lo pairs (hi = v rounded to TF32, lo = v - hi rounded to TF32) and each
// product as hi.hi + hi.lo + lo.hi (3xTF32): a CPU emulation of the y
// product at mamba2-1.3b's shape put its error at 1.6e-5 against a
// float64 sum, with no element over 3e-4, where a bf16 hi / lo split
// reached 1.1e-3 and a single bf16 product 0.42. B and C are exact in
// bf16 and in TF32, so their products need no low part.
//
// Design: two kernels behind one launch.
//   1. scores_kernel, per chunk: one warpgroup per 64 x 64 tile of S on or
//      below the diagonal -- wgmma m64n64k16 in bf16 (exact products, as
//      the plain version's upcast), C and B the K-major A and B operands
//      (n contiguous) -- and one CTA per t-tile that transposes B. S is computed once per
//      chunk and shared by every head through a scratch buffer: per head it
//      would cost a third of the y product again. The scratch holds operand
//      images, laid out byte for byte as the chunk kernel's shared memory
//      wants them (K-major, 128-byte swizzled), so that they arrive there
//      whole by cp.async.bulk: each S tile [q][t], and B^T [n][t] in
//      128-column slices of n as TF32 (exact for bf16) -- the state
//      product's B operand, transposed once per chunk instead of once per
//      head.
//   2. chunk_kernel, one warpgroup per (job, head, batch * chunk), two
//      CTAs an SM. A job takes one 64-row half of p (P > 64: two CTAs) and
//      either a pair of query tiles (k, T - 1 - k), which evens out the
//      causal triangle and shares the x tiles of the pair, or a
//      128-column slice of the state's n. TF32 wgmma takes only K-major
//      operands from shared memory, and K = t while x is p-contiguous, so
//      both products take x as the A operand from registers (M = p),
//      read from a raw x tile and split there: TMA and cp.async copy bytes
//      as they lie and can neither transpose nor split.
//      - The x tiles [t][p] and their a_t go through a two-stage ring by
//        cp.async, 16 bytes a copy where P % 4 == 0 (4 bytes otherwise, so
//        any P), with an mbarrier per stage counting the threads' copies
//        (and, for the state job, the B^T image's bytes). The next tile's
//        copies are in flight while the current one is multiplied.
//      - y job: y^T[p, q] = sum_t x^T[p, t] W^T[t, q], W = S o decay, in
//        steps (t-tile j, query tile of the pair). The S images come by
//        cp.async.bulk through a ring of their own; W is computed from
//        them in f32, split, and stored as the K-major B operand (hi over
//        its S, lo beside it); three m64n64k8 products per 8-step. The next
//        step's W is computed while the current step's products run.
//      - state job: st[p, n] = sum_t (x exp(a_last - a_t))^T[p, t] B[t, n],
//        B = the B^T image; m64n128k8, two products (xw_hi.B + xw_lo.B);
//        the next tile's fragments are built while the current tile's
//        products run.
//      The chunk kernel is launched as a programmatic dependent of the
//      scores kernel: its CTAs start their x copies while the scores
//      kernel finishes and wait (griddepcontrol.wait) before the images.
// Ragged Q, P and N are zero-padded (t past Q by cp.async's zero fill, n
// past N in the images); rows p past P are never stored. P <= 128, any Q,
// any N.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {
constexpr int kTile = 64;                    // query rows and t steps per tile
constexpr int kTileFloats = kTile * kTile;
constexpr int kTileBytes = kTileFloats * 4;  // one f32 64 x 64 image, 16 KB
constexpr int kSlice = 128;                  // state columns (n) per state job
constexpr int kSliceFloats = kSlice * kTile;  // one B^T image, 32 KB
constexpr int kRowBytes = 128;               // one swizzled row: 32 TF32 or 64 bf16 values
constexpr int kStages = 2;
constexpr int kThreads = 128;                // one warpgroup
constexpr uint32_t kSbo = 8 * kRowBytes;     // between 8-row groups of a swizzle atom

// e^z for z <= 0 (the decays): ex2.approx(z log2 e), flushed to 0 below
// 2^-126. Its relative error is about 2^-22 from ex2.approx and |z| 2^-24
// from rounding z log2 e, which is at most 2^-24 / e of e^z's scale
// (z e^z <= 1 / e): both below the TF32 split's. The library's expf
// branches on its argument, which serializes a thread's independent exps.
__device__ __forceinline__ float exp_neg(float z) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(z * 1.44269504f));
  return e;
}


// x rounded to the nearest TF32 (ties away from zero), as f32 bits: the
// tensor cores read the top 19 bits of each f32 operand. Integer ops here
// keep the rounding off the conversion unit (cvt.rna.tf32.f32).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// byte offset of (row, col) in a K-major operand of `rows` rows whose K
// (col) runs in 128-byte swizzled chunks of `per_row` elements of `size`
// bytes; the operand starts on a 1,024-byte boundary
__device__ __forceinline__ uint32_t swz(int row, int col, int rows, int per_row, int size) {
  const int b = (col % per_row) * size;
  return (col / per_row) * rows * kRowBytes + row * kRowBytes + ((((b >> 4) ^ row) & 7) << 4) +
         (b & 15);
}

__device__ __forceinline__ uint64_t sdesc(const uint8_t* p) {
  return desc<128>(smem_u32(p), 16, kSbo);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one contiguous copy global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// four bytes global -> shared, zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 4 : 0)
               : "memory");
}

// sixteen bytes global -> shared, zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 16 : 0)
               : "memory");
}

// arrives on `bar` once this thread's cp.async copies so far are done
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// d += A.B^T for one m64n64k8 TF32 step: A in registers, B K-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B^T for one m64n128k8 TF32 step: A in registers, B K-major in shared memory
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Scratch: the S images of every chunk (BC x T(T+1)/2 tiles of 64 x 64,
// T = ceil(Q / 64)), then the B^T images (BC x T x ceil(N / 128) slices of
// 128 x 64, TF32 hi, and lo for f32 B).
// ---------------------------------------------------------------------------

constexpr int kScoresSmem = 2 * kTile * kRowBytes + 1024;  // a C and a B chunk, alignment slack

// 1. scores: grid (tile pairs (qi, j <= qi) flattened, then one CTA per
// t-tile for the B^T images; batch * chunk)
__global__ void __launch_bounds__(kThreads)
scores_kernel(const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
              float* __restrict__ scratch, int Q, int N) {
  constexpr int kPer = 64;  // n per 128-byte row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t *sc = smem, *sb = smem + kTile * kRowBytes;

  asm volatile("griddepcontrol.launch_dependents;\n");  // the chunk kernel may start its x copies
  const int nqt = (Q + kTile - 1) / kTile, ntp = nqt * (nqt + 1) / 2;
  const int bc = blockIdx.y, tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= ntp) {  // B^T of t-tile j: [n][t], lanes along t (contiguous in the image)
    const int j = blockIdx.x - ntp, tn = min(kTile, Q - j * kTile);
    const int nns = (N + kSlice - 1) / kSlice;
    const __nv_bfloat16* bb = bm + (static_cast<size_t>(bc) * Q + j * kTile) * N;
    float* bt = scratch + static_cast<size_t>(gridDim.y) * ntp * kTileFloats +
                (static_cast<size_t>(bc) * nqt + j) * nns * kSliceFloats;
    for (int e0 = 0; e0 < nns * kSliceFloats; e0 += 16 * kThreads) {
      float v[16];  // sixteen loads in flight
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int e = e0 + tid + kThreads * m, t = e % kTile, n = e / kTile;
        v[m] = t < tn && n < N ? __bfloat162float(bb[t * N + n]) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int e = e0 + tid + kThreads * m, t = e % kTile, n = e / kTile;
        bt[static_cast<size_t>(n / kSlice) * kSliceFloats + swz(n % kSlice, t, kSlice, 32, 4) / 4] = v[m];
      }
    }
    return;
  }
  const int tp = blockIdx.x;
  int qi = 0;
  while ((qi + 1) * (qi + 2) / 2 <= tp) ++qi;
  const int j = tp - qi * (qi + 1) / 2;
  const int qn = min(kTile, Q - qi * kTile), tn = min(kTile, Q - j * kTile);
  // bf16 as its raw bits
  const uint16_t* c_in = reinterpret_cast<const uint16_t*>(cm) + (static_cast<size_t>(bc) * Q + qi * kTile) * N;
  const uint16_t* b_in = reinterpret_cast<const uint16_t*>(bm) + (static_cast<size_t>(bc) * Q + j * kTile) * N;

  // each thread stages kEach elements of C and of B per chunk of n, two to
  // a register; the next chunk's loads are in flight while the current
  // chunk is multiplied
  constexpr int kEach = kTile * kPer / kThreads, kRegs = kEach / 2;
  uint32_t cv[kRegs], bv[kRegs];
  const auto load = [&](int n0) {
#pragma unroll
    for (int m = 0; m < kEach; ++m) {
      const int e = tid + kThreads * m, r = e / kPer, n = n0 + e % kPer, at = r * N + n;
      const uint32_t cval = r < qn && n < N ? c_in[at] : 0u;
      const uint32_t bval = r < tn && n < N ? b_in[at] : 0u;
      if (m < kRegs) {
        cv[m] = cval;
        bv[m] = bval;
      } else {
        cv[m - kRegs] |= cval << 16;
        bv[m - kRegs] |= bval << 16;
      }
    }
  };
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  load(0);
  for (int n0 = 0; n0 < N; n0 += kPer) {
#pragma unroll
    for (int m = 0; m < kEach; ++m) {
      const int e = tid + kThreads * m, sh = m / kRegs * 16;
      const uint32_t off = swz(e / kPer, e % kPer, kTile, kPer, 2);
      *reinterpret_cast<uint16_t*>(sc + off) = static_cast<uint16_t>(cv[m % kRegs] >> sh);
      *reinterpret_cast<uint16_t*>(sb + off) = static_cast<uint16_t>(bv[m % kRegs] >> sh);
    }
    fence_proxy_async();  // the stores above are read by wgmma (the async proxy)
    __syncthreads();
    // Each k16 step's products go to a fresh accumulator and the steps are
    // summed here in f32: the tensor cores' own accumulation loses about
    // an ulp of the running sum at each step, several times an f32 sum's
    // error at |S| ~ 50.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int col = kk * 32;
      float t[32];
      wgmma_fence();
      wgmma_ss_n64(t, sdesc(sc + col), sdesc(sb + col), 0);
      wgmma_commit();
      if (kk == 0 && n0 + kPer < N) load(n0 + kPer);
      wgmma_wait_all();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] += t[i];
    }
    __syncthreads();  // the tiles are consumed before the next chunk overwrites them
  }

  // the S image: element i of the accumulator is row 16 w + l / 4 + 8 (i >> 1 & 1),
  // column 8 (i >> 2) + 2 (l % 4) + (i & 1); column pairs are adjacent in it
  uint8_t* img = reinterpret_cast<uint8_t*>(scratch + (static_cast<size_t>(bc) * ntp + tp) * kTileFloats);
  const int r0 = tid / 32 * 16 + tid % 32 / 4, c2 = 2 * (tid % 4);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int q = r0 + 8 * (i >> 1 & 1), t = 8 * (i >> 2) + c2;
    *reinterpret_cast<float2*>(img + swz(q, t, kTile, 32, 4)) = make_float2(d[i], d[i + 1]);
  }
}

// 2. y and states: grid (jobs, head, batch * chunk). Each job takes one
// 64-row half of p (the rows of M). Shared memory: the x ring (kStages
// raw tiles [64 t][kPitch] of the half's columns, each with its 64 a_t),
// then the operand region -- y job: the S ring (kStages S images; W hi
// is written over its S) and kStages W lo images; state job: kStages B^T
// images -- then a of the y job's two query tiles, the barriers.
struct Layout {
  static constexpr int kPitch = kTile + 8;  // floats a raw row: fragment reads hit 32 banks
  static constexpr int kRawX = kTile * kPitch * 4;
  static constexpr int kRaw = (kRawX + 256 + 1023) / 1024 * 1024;
  static constexpr int kWLo = kStages * kTileBytes;         // offset of the W lo images
  static constexpr int kBt = kSliceFloats * 4;              // one stage's B^T image
  static constexpr int kYOps = 2 * kStages * kTileBytes;
  static constexpr int kOps = kYOps > kStages * kBt ? kYOps : kStages * kBt;
  static constexpr int kAq = kStages * kRaw + kOps;
  static constexpr int kBar = kAq + 2 * kTile * 4;
  static constexpr int kSmem = kBar + 64 + 1024;  // + barriers, alignment slack
};

__global__ void __launch_bounds__(kThreads, 2)
chunk_kernel(const float* __restrict__ x, const float* __restrict__ da,
             const float* __restrict__ scratch, float* __restrict__ y, float* __restrict__ st, int Q,
             int H, int P, int N, int nqt, bool vec) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ops = smem + kStages * L::kRaw;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + L::kBar);  // x ring (state job: and B^T)
  uint64_t* sfull = xfull + kStages;                               // S ring
  float* aqs = reinterpret_cast<float*>(smem + L::kAq);            // a of qa, then of qb

  const int h = blockIdx.y, bc = blockIdx.z, tid = threadIdx.x;
  const int halves = (P + kTile - 1) / kTile, pairs = (nqt + 1) / 2;
  const bool is_y = static_cast<int>(blockIdx.x) < pairs * halves;
  const int job = is_y ? blockIdx.x : blockIdx.x - pairs * halves;
  const int pc = job % halves, p0 = pc * kTile, ph = min(kTile, P - p0);
  // y job: query tiles qa <= qb (a light and a heavy one; one tile when they meet)
  const int qa = job / halves, qb = nqt - 1 - qa;
  const int slice = job / halves;  // state job: its 128 columns of n
  const int ntp = nqt * (nqt + 1) / 2, nns = (N + kSlice - 1) / kSlice;
  const size_t xrow = static_cast<size_t>(H) * P;  // between time steps
  const float* xb = x + static_cast<size_t>(bc) * Q * xrow + static_cast<size_t>(h) * P + p0;
  const float* dab = da + static_cast<size_t>(bc) * Q * H + h;
  const float* s_img = scratch + static_cast<size_t>(bc) * ntp * kTileFloats;
  const float* bt_img = scratch + static_cast<size_t>(gridDim.z) * ntp * kTileFloats +
                        (static_cast<size_t>(bc) * nqt * nns + slice) * kSliceFloats;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(xfull + s, kThreads + !is_y);  // the threads' copies (and the B^T copy)
      mbar_init(sfull + s, 1);                 // the S copy
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // x ring stage j % kStages <- t-tile j: the half's columns of x and a_t, in
  // 16-byte copies where the rows allow them (vec: P % 4 == 0, x 16-byte aligned),
  // else 4-byte; rows past Q are zero-filled
  const int step_t = kThreads / ph, step_p = kThreads % ph;  // the 4-byte copies' walk
  const auto issue_x = [&](int j) {
    const int s = j % kStages, t0 = j * kTile;
    uint8_t* raw = smem + s * L::kRaw;
    float* rx = reinterpret_cast<float*>(raw);
    if (vec) {
      const int row = ph / 4, st_t = kThreads / row, st_p = kThreads % row;
      int t = tid / row, p = tid % row;
      for (int e = tid; e < kTile * row; e += kThreads) {
        const int tg = t0 + t;
        cp_async16(rx + t * L::kPitch + 4 * p, xb + static_cast<size_t>(tg < Q ? tg : 0) * xrow + 4 * p, tg < Q);
        t += st_t;
        p += st_p;
        if (p >= row) {
          p -= row;
          ++t;
        }
      }
    } else {
      int t = tid / ph, p = tid % ph;
      for (int e = tid; e < kTile * ph; e += kThreads) {
        const int tg = t0 + t;
        cp_async4(rx + t * L::kPitch + p, xb + static_cast<size_t>(tg < Q ? tg : 0) * xrow + p, tg < Q);
        t += step_t;
        p += step_p;
        if (p >= ph) {
          p -= ph;
          ++t;
        }
      }
    }
    if (tid < kTile) {
      const int tg = t0 + tid;
      cp_async4(raw + L::kRawX + 4 * tid, dab + static_cast<size_t>(tg < Q ? tg : 0) * H, tg < Q);
    }
    cp_async_arrive(xfull + s);
  };
  // state job: the B^T image of t-tile j into the operand region, on the same barrier
  const auto issue_bt = [&](int j) {
    const int s = j % kStages;
    if (tid == 0) {
      mbar_expect_tx(xfull + s, L::kBt);
      bulk_load(ops + s * L::kBt, bt_img + static_cast<size_t>(j) * nns * kSliceFloats, L::kBt,
                xfull + s);
    }
  };
  // x does not depend on the scores kernel: its first tiles are copied while
  // that kernel finishes (programmatic dependent launch); the images do
  const auto prologue = [&](int tiles) {
    issue_x(0);
    if (tiles > 1) issue_x(1);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  };

  const int warp = tid / 32, lane = tid % 32, c = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows (p) of the half: r0, r0 + 8
  // x^T fragments of tile j for the eight 8-steps k, TF32 hi and lo: (p r0 / r0 + 8,
  // t c / c + 4), each column t scaled by exp(a_last - a_t) for the state job
  const float a_last = dab[static_cast<size_t>(Q - 1) * H];
  const auto frags = [&](int j, uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
    const uint8_t* raw = smem + j % kStages * L::kRaw;
    const float* rx = reinterpret_cast<const float*>(raw);
    const float* at = reinterpret_cast<const float*>(raw + L::kRawX);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = 8 * k + c + 4 * (v >> 1);
        float xv = rx[t * L::kPitch + r0 + 8 * (v & 1)];
        if (!is_y) xv = j * kTile + t < Q ? xv * exp_neg(a_last - at[t]) : 0.f;
        hi[k][v] = tf32(xv);
        lo[k][v] = tf32(xv - __uint_as_float(hi[k][v]));
      }
    }
  };
  const auto fence_frags = [](uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      fence_regs(hi[k]);
      fence_regs(lo[k]);
    }
  };

  if (is_y) {
    // steps n = (t-tile j, query tile): (j, qa), (j, qb) while j <= qa, then (j, qb)
    const bool pair = qa < qb;
    const int n_pair = pair ? 2 * (qa + 1) : 0, n_steps = n_pair + qb + 1 - (pair ? qa + 1 : 0);
    const auto tile_of = [&](int n) { return n < n_pair ? n / 2 : (pair ? qa + 1 : 0) + n - n_pair; };
    const auto heavy = [&](int n) { return n >= n_pair || n % 2 == 1; };  // the step's tile is qb
    // S ring stage n % kStages <- step n's S image
    const auto issue_s = [&](int n) {
      const int s = n % kStages, qt = heavy(n) ? qb : qa;
      if (tid == 0) {
        mbar_expect_tx(sfull + s, kTileBytes);
        bulk_load(ops + s * kTileBytes, s_img + static_cast<size_t>(qt * (qt + 1) / 2 + tile_of(n)) * kTileFloats,
                  kTileBytes, sfull + s);
      }
    };
    // W = S o decay for step n, in place of its S (hi) and in W lo: one
    // 16-byte unit u of the image at a time, row q, columns tl .. tl + 3.
    // Every unit is loaded before any is stored: the stores overwrite S,
    // so the compiler would otherwise keep each unit's loads, exps and
    // stores in one serial chain.
    constexpr int kUnits = kTileFloats / 4 / kThreads;
    const auto make_w = [&](int n) {
      const int s = n % kStages, j = tile_of(n);
      const int dq = ((heavy(n) ? qb : qa) - j) * kTile;  // query row minus t-tile start
      uint8_t* stg = ops + s * kTileBytes;
      const float* aq = aqs + (heavy(n) ? kTile : 0);
      const float* at = reinterpret_cast<const float*>(smem + j % kStages * L::kRaw + L::kRawX);
      uint4* w_lo = reinterpret_cast<uint4*>(ops + L::kWLo + s * kTileBytes);
      float4 sv[kUnits], tv[kUnits];
      float qv[kUnits];
#pragma unroll
      for (int m = 0; m < kUnits; ++m) {
        const int u = tid + kThreads * m, q = u >> 3 & (kTile - 1);
        const int tl = (u >> 9) * 32 + ((u & 7) ^ (q & 7)) * 4;
        sv[m] = reinterpret_cast<const float4*>(stg)[u];
        tv[m] = *reinterpret_cast<const float4*>(at + tl);
        qv[m] = aq[q];
      }
#pragma unroll
      for (int m = 0; m < kUnits; ++m) {
        const int u = tid + kThreads * m, q = u >> 3 & (kTile - 1);
        const int tl = (u >> 9) * 32 + ((u & 7) ^ (q & 7)) * 4;
        const float sa[4] = {sv[m].x, sv[m].y, sv[m].z, sv[m].w};
        const float ta[4] = {tv[m].x, tv[m].y, tv[m].z, tv[m].w};
        uint32_t hv[4], lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = tl + e <= dq + q ? sa[e] * exp_neg(qv[m] - ta[e]) : 0.f;
          hv[e] = tf32(w);
          lv[e] = tf32(w - __uint_as_float(hv[e]));
        }
        reinterpret_cast<uint4*>(stg)[u] = make_uint4(hv[0], hv[1], hv[2], hv[3]);
        w_lo[u] = make_uint4(lv[0], lv[1], lv[2], lv[3]);
      }
      fence_proxy_async();  // W is read by wgmma (the async proxy)
    };
    float acc[2][32];  // y^T of qa, qb
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
    const auto mma = [&](float (&d)[32], int n, uint32_t (&xh)[8][4], uint32_t (&xl)[8][4]) {
      const uint8_t* w_hi = ops + n % kStages * kTileBytes;
      const uint8_t* w_lo = ops + L::kWLo + n % kStages * kTileBytes;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int off = (k / 4) * kTile * kRowBytes + (k % 4) * 32;
        const uint64_t wh = sdesc(w_hi + off), wl = sdesc(w_lo + off);
        mma_rs(d, xh[k], wh);
        mma_rs(d, xh[k], wl);
        mma_rs(d, xl[k], wh);
      }
      wgmma_commit();
    };

    uint32_t xh[8][4], xl[8][4];
    if (tid < kTile) {  // a of the two query tiles
      const int q = qa * kTile + tid, r = qb * kTile + tid;
      aqs[tid] = q < Q ? dab[static_cast<size_t>(q) * H] : 0.f;
      aqs[kTile + tid] = r < Q ? dab[static_cast<size_t>(r) * H] : 0.f;
    }
    __syncthreads();
    prologue(qb + 1);
    issue_s(0);
    if (n_steps > 1) issue_s(1);
    mbar_wait(xfull, 0);
    mbar_wait(sfull, 0);
    make_w(0);
    frags(0, xh, xl);
    __syncthreads();
    for (int n = 0; n < n_steps; ++n) {
      const int j = tile_of(n), j1 = n + 1 < n_steps ? tile_of(n + 1) : j;
      if (heavy(n)) {
        mma(acc[1], n, xh, xl);
      } else {
        mma(acc[0], n, xh, xl);
      }
      if (n + 1 < n_steps) {  // the next step's W, while these products run
        if (j1 != j) mbar_wait(xfull + j1 % kStages, (j1 / kStages) & 1);
        mbar_wait(sfull + (n + 1) % kStages, ((n + 1) / kStages) & 1);
        make_w(n + 1);
      }
      wgmma_wait_all();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      fence_frags(xh, xl);
      if (j1 != j) frags(j1, xh, xl);
      __syncthreads();  // W of n + 1 is visible; step n's S stage and W lo are free
      if (n + kStages < n_steps) issue_s(n + kStages);
      if (j1 != j && j + kStages <= qb) issue_x(j + kStages);  // tile j's stage has been idle since frags(j)
    }
    // acc[w][i] = y^T[p, q]: p = p0 + r0 + 8 (i >> 1 & 1), q = 64 qt + 8 (i >> 2) + 2c + (i & 1)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      if (w == 0 && !pair) continue;
      const int q0 = (w == 0 ? qa : qb) * kTile;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int p = r0 + 8 * (i >> 1 & 1), q = q0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (p < ph && q < Q) {
          y[(static_cast<size_t>(bc) * Q + q) * xrow + static_cast<size_t>(h) * P + p0 + p] = acc[w][i];
        }
      }
    }
  } else {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // the next tile's fragments are built while the current tile's products run
    const auto body = [&](int it, uint32_t (&xh)[8][4], uint32_t (&xl)[8][4], uint32_t (&nh)[8][4],
                          uint32_t (&nl)[8][4]) {
      const uint8_t* bhi = ops + it % kStages * L::kBt;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int off = (k / 4) * kSlice * kRowBytes + (k % 4) * 32;
        const uint64_t bh = sdesc(bhi + off);
        mma_rs_n128(acc, xh[k], bh);
        mma_rs_n128(acc, xl[k], bh);
      }
      wgmma_commit();
      if (it + 1 < nqt) {
        mbar_wait(xfull + (it + 1) % kStages, ((it + 1) / kStages) & 1);
        frags(it + 1, nh, nl);
      }
      wgmma_wait_all();
      fence_regs(acc);
      fence_frags(xh, xl);
      __syncthreads();  // stage it is free
      if (it + kStages < nqt) {
        issue_x(it + kStages);
        issue_bt(it + kStages);
      }
    };
    uint32_t ah[8][4], al[8][4], bh[8][4], bl[8][4];
    prologue(nqt);
    issue_bt(0);
    if (nqt > 1) issue_bt(1);
    mbar_wait(xfull, 0);
    frags(0, ah, al);
    for (int it = 0; it < nqt; it += 2) {
      body(it, ah, al, bh, bl);
      if (it + 1 < nqt) body(it + 1, bh, bl, ah, al);
    }
    // acc[i] = st[p, n]: p = p0 + r0 + 8 (i >> 1 & 1), n = 128 slice + 8 (i >> 2) + 2c + (i & 1)
    float* sb = st + (static_cast<size_t>(bc) * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int p = r0 + 8 * (i >> 1 & 1), n = slice * kSlice + 8 * (i >> 2) + 2 * c + (i & 1);
      if (p < ph && n < N) sb[static_cast<size_t>(p0 + p) * N + n] = acc[i];
    }
  }
}

int launch_chunk(const float* x, const float* da, const float* scratch, float* y, float* st, int BC,
                 int Q, int H, int P, int N, cudaStream_t stream) {
  using L = Layout;
  static bool sized[64] = {};  // per device: the shared-memory attribute is set once
  int dev = 0;
  cudaError_t a = cudaGetDevice(&dev);
  if (a == cudaSuccess && dev < 64 && !sized[dev]) {
    a = cudaFuncSetAttribute(chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    sized[dev] = a == cudaSuccess;
  }
  if (a != cudaSuccess) return static_cast<int>(a);
  const int nqt = (Q + kTile - 1) / kTile, halves = (P + kTile - 1) / kTile;
  const int jobs = ((nqt + 1) / 2 + (N + kSlice - 1) / kSlice) * halves;
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // programmatic dependent launch: the CTAs may start while the scores
  // kernel finishes, and wait for it (griddepcontrol.wait) before its output
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(jobs, H, BC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, chunk_kernel, x, da, scratch, y, st, Q, H, P, N, nqt, vec));
}
}  // namespace

// The bfloat16 entry (bf16 must be 1): x (BC, Q, H, P) f32, da_cs (BC, Q, H)
// f32, b / c (BC, Q, N) bfloat16, y (BC, Q, H, P) f32, st (BC, H, P, N) f32;
// BC = batch * chunks; P <= 128. scores: f32 scratch, 16-byte aligned, of
// BC * (T (T + 1) / 2 * 4096 + T * ceil(N / 128) * 8192) floats,
// T = ceil(Q / 64).
extern "C" int ssd_intra_chunk_launch(const void* x, const void* da, const void* b, const void* c,
                                      void* y, void* st, void* scores, int BC, int Q, int H,
                                      int P, int N, int bf16, void* stream) {
  if (!bf16 || P > 2 * kTile) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  const int nqt = (Q + kTile - 1) / kTile;
  scores_kernel<<<dim3(nqt * (nqt + 1) / 2 + nqt, BC), kThreads, kScoresSmem, s>>>(
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c), sc, Q, N);
  const int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  return launch_chunk(static_cast<const float*>(x), static_cast<const float*>(da), sc,
                      static_cast<float*>(y), static_cast<float*>(st), BC, Q, H, P, N, s);
}
