// ssd_intra_chunk, float32 B / C, on the CUDA cores in exact float32:
// the Mamba-2 SSD intra-chunk block and each chunk's outgoing state, for
// every (batch, chunk) and head:
//
//   S[q, t]     = C_q . B_t                                  (shared by every head)
//   y[q, h, p]  = sum_{t <= q} S[q, t] exp(a[q, h] - a[t, h]) x[t, h, p]
//   st[h, p, n] = sum_t x[t, h, p] exp(a[Q-1, h] - a[t, h]) B[t, n]
//
// with x (B, nc, Q, H, P) f32 (dt-weighted inputs), a = da_cs
// (B, nc, Q, H) f32 (in-chunk cumulative log-decay), B / C (B, nc, Q, N)
// f32; y and st are f32. bfloat16 B / C (the served dtype) run on the
// tensor cores (ssd_intra_chunk_sm90.cu); the wrapper picks the library by
// dtype, as it does for flash_attention.
//
// Replaces src/repro/kernels/ssd_scan.py:53 ssd_intra_chunk (_ssd_kernel)
// for float32 B / C. The TPU kernel builds a chunk's (Q, Q, H) decay
// tensor in VMEM (16 MB at mamba2-1.3b, far beyond a CTA); here the causal
// mask is a select on each weight and the decay exp(a_q - a_t) is computed
// where the weight is staged.
//
// Why float32 stays exact: the float32 serving gate holds mamba2-1.3b's
// kernel path to its plain torch path within 1e-4 of the logit scale, and
// through 48 layers of random weights that model amplifies any rounding
// that differs from torch's float32 einsums past it (a block in float64,
// or 3xTF32 on the tensor cores, misses it). So every output here is one
// ascending chain of float32 FMAs, from 0, over t (over n for S), with
// the weights S * exp(a_q - a_t) and the scaled x * exp(a_last - a_t)
// rounded to float32 before they enter it: the plain version's order.
// There is no TF32, no split of the sum and no reassociation, and expf is
// the accurate one. The schedule is free; the arithmetic is not.
//
// Bound: at mamba2-1.3b's prefill (batch 4, nc 2, Q 256, H 64, P 64,
// N 128) the block is 4.37 GFLOP against 85 MB, so on the CUDA cores'
// 67 TFLOP/s operations bound it: 0.065 ms (bytes 0.025 ms).
//
// Design: each product is a CUDA-core SGEMM tile. A CTA of 128 threads
// owns a 64 x 64 output tile; each thread an 8 x 4 micro-tile of it (32
// independent chains), fed by three 16-byte shared-memory reads per step
// of the sum (32 FMAs). Operand tiles of 32 steps come by cp.async (16
// bytes a copy where the widths allow, 4 otherwise) into a two-stage ring:
// the next tile's copies are in flight while the current one is
// multiplied. Two kernels behind one launch:
//   1. scores_kernel: S^T[t, q] per 64 x 64 tile on or below the diagonal,
//      once per chunk (every head shares it), into the scratch buffer; C
//      and B are staged n-contiguous (rows padded to an odd number of
//      16-byte units) and read four n at a time.
//   2. chunk_kernel, launched as a programmatic dependent of the scores
//      kernel, one CTA per job, longest first: the state jobs (64 p x 64 n
//      of one (chunk, head), all Q steps), then the y jobs (64 query rows x
//      64 p, steps up to the diagonal), the bottom query tiles first. Only
//      the y jobs wait for S (griddepcontrol.wait). Both stage their A
//      operand k-major ([t][row]) and finish it in place, each thread on
//      the elements it copied, before the stage's barrier:
//        - y: A = W^T, w = S^T[t, q] * expf(a_q - a_t), 0 for t > q, with
//          a[., h] of the chunk kept in shared memory; B = x[t, h, p].
//        - state: A = x[t, h, p] * d_t, with d_t = expf(a_last - a_t)
//          computed once per time step into shared memory; B = B[t, n].
// Ragged Q, P and N are zero-filled by cp.async and never stored. P <= 128
// (two p tiles at most, the wrapper's limit), any Q and N.
#include <cuda_runtime.h>

#include <cstdint>

namespace {
constexpr int kTile = 64;      // output tile edge
constexpr int kStep = 32;      // steps of the sum (t, or n for S) per stage
constexpr int kThreads = 128;  // 8 x 16 threads
constexpr int kTM = 8;         // rows of a thread's micro-tile
constexpr int kTN = 4;         // columns of a thread's micro-tile
constexpr int kPitch = kStep + 4;  // scores_kernel: n-contiguous rows, 9 16-byte units
constexpr int kStage = kStep * kTile;  // floats of one k-major operand stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// sixteen (or four) bytes global -> shared, zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// this thread's copies are done and visible to it
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 1. S^T[bc, t, q] = sum_n C[bc, q, n] B[bc, t, n], 64 x 64 tiles with
// t-tile <= q-tile; grid (tiles of the triangle, batch * chunk)
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ scores,
              int Q, int N, int vec) {
  asm volatile("griddepcontrol.launch_dependents;\n");  // the state jobs may start
  __shared__ __align__(16) float sc[2][kTile * kPitch];
  __shared__ __align__(16) float sb[2][kTile * kPitch];
  int tq = 0;
  while ((tq + 1) * (tq + 2) / 2 <= static_cast<int>(blockIdx.x)) ++tq;
  const int tt = blockIdx.x - tq * (tq + 1) / 2, bc = blockIdx.y;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const float* cb = cm + static_cast<size_t>(bc) * Q * N;
  const float* bb = bm + static_cast<size_t>(bc) * Q * N;

  auto stage = [&](int s) {
    const int n0 = s * kStep;
    float *dc = sc[s & 1], *db = sb[s & 1];
    if (vec) {
#pragma unroll
      for (int u = 0; u < kTile * kStep / 4 / kThreads; ++u) {
        const int i = tid + kThreads * u, r = i / (kStep / 4), c = i % (kStep / 4) * 4, n = n0 + c;
        const int qr = tq * kTile + r, tr = tt * kTile + r;
        const bool qok = qr < Q && n < N, tok = tr < Q && n < N;
        cp_async16(dc + r * kPitch + c, cb + (qok ? static_cast<size_t>(qr) * N + n : 0), qok);
        cp_async16(db + r * kPitch + c, bb + (tok ? static_cast<size_t>(tr) * N + n : 0), tok);
      }
    } else {
      for (int i = tid; i < kTile * kStep; i += kThreads) {
        const int r = i / kStep, c = i % kStep, n = n0 + c;
        const int qr = tq * kTile + r, tr = tt * kTile + r;
        const bool qok = qr < Q && n < N, tok = tr < Q && n < N;
        cp_async4(dc + r * kPitch + c, cb + (qok ? static_cast<size_t>(qr) * N + n : 0), qok);
        cp_async4(db + r * kPitch + c, bb + (tok ? static_cast<size_t>(tr) * N + n : 0), tok);
      }
    }
    cp_async_commit();
  };

  // thread (tm, tn): q rows tm * 8 + i, t columns tn + 16 j (16 apart, so
  // eight neighbouring threads read eight neighbouring B rows: no conflict)
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int ns = (N + kStep - 1) / kStep;
  stage(0);
  for (int s = 0; s < ns; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s is in; every thread is done with stage s - 1
    if (s + 1 < ns) stage(s + 1);
    const float* A = sc[s & 1];
    const float* B = sb[s & 1];
#pragma unroll
    for (int k4 = 0; k4 < kStep / 4; ++k4) {
      float4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = *reinterpret_cast<const float4*>(A + (tm * kTM + i) * kPitch + 4 * k4);
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tn + 16 * j) * kPitch + 4 * k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(lane(a[i], kk), lane(b[j], kk), acc[i][j]);
    }
  }
  float* out = scores + static_cast<size_t>(bc) * Q * Q;
  const int q0 = tq * kTile + tm * kTM;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int t = tt * kTile + tn + 16 * j;
    if (t >= Q) continue;
    float* row = out + static_cast<size_t>(t) * Q + q0;
    if (vec) {  // Q % 4 == 0: the row's 8 q are two aligned float4 (or none)
#pragma unroll
      for (int i = 0; i < kTM; i += 4)
        if (q0 + i < Q) *reinterpret_cast<float4*>(row + i) = make_float4(acc[i][j], acc[i + 1][j], acc[i + 2][j], acc[i + 3][j]);
    } else {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        if (q0 + i < Q) row[i] = acc[i][j];
    }
  }
}

// 2. the y and state jobs; grid (jobs): the state jobs, then the y jobs by
// query tile, last (longest) first
__global__ void __launch_bounds__(kThreads, 4)
chunk_kernel(const float* __restrict__ x, const float* __restrict__ da, const float* __restrict__ bm,
             const float* __restrict__ scores, float* __restrict__ y, float* __restrict__ st, int BC,
             int Q, int H, int P, int N, int vec) {
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);  // 2 stages of A, k-major [t][row]
  float* sb = sa + 2 * kStage;                  // 2 stages of B, k-major [t][col]
  float* av = sb + 2 * kStage;                  // per t: a (y) or expf(a_last - a) (state)

  const int nqt = (Q + kTile - 1) / kTile, npt = (P + kTile - 1) / kTile, nnt = (N + kTile - 1) / kTile;
  const int BH = BC * H;
  int job = blockIdx.x;
  const bool state = job < BH * npt * nnt;
  int bh, m0, c0, tlim;  // (chunk, head), first row / column of the tile, t bound of the sum
  if (state) {
    bh = job / (npt * nnt);
    const int r = job % (npt * nnt);
    m0 = r / nnt * kTile;  // p
    c0 = r % nnt * kTile;  // n
    tlim = Q;
  } else {
    job -= BH * npt * nnt;
    const int qt = nqt - 1 - job / (BH * npt), r = job % (BH * npt);
    bh = r / npt;
    m0 = qt * kTile;         // q
    c0 = r % npt * kTile;    // p
    tlim = min(Q, m0 + kTile);
  }
  const int bc = bh / H, h = bh % H;
  const size_t xrow = static_cast<size_t>(H) * P;  // x between time steps
  const float* xb = x + static_cast<size_t>(bc) * Q * xrow + static_cast<size_t>(h) * P;
  const float* dab = da + static_cast<size_t>(bc) * Q * H + h;
  // the operands' sources: row t at base + t * stride, columns below lim
  const float *a_base, *b_base;
  size_t a_stride, b_stride;
  int a_lim, b_lim;
  if (state) {
    a_base = xb + m0, a_stride = xrow, a_lim = P - m0;
    b_base = bm + static_cast<size_t>(bc) * Q * N + c0, b_stride = N, b_lim = N - c0;
  } else {
    a_base = scores + static_cast<size_t>(bc) * Q * Q + m0, a_stride = Q, a_lim = Q - m0;
    b_base = xb + c0, b_stride = xrow, b_lim = P - c0;
  }
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

  if (state) {
    const float a_last = dab[static_cast<size_t>(Q - 1) * H];
    for (int t = tid; t < nqt * kTile; t += kThreads)
      av[t] = t < Q ? expf(a_last - dab[static_cast<size_t>(t) * H]) : 0.f;
  } else {
    for (int t = tid; t < nqt * kTile; t += kThreads) av[t] = t < Q ? dab[static_cast<size_t>(t) * H] : 0.f;
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // S is written
  }

  auto stage = [&](int s) {
    const int t0 = s * kStep;
    float *A = sa + (s & 1) * kStage, *B = sb + (s & 1) * kStage;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kStage / 4 / kThreads; ++u) {
        const int i = tid + kThreads * u, r = i / (kTile / 4), c = i % (kTile / 4) * 4, t = t0 + r;
        const bool aok = t < tlim && c < a_lim, bok = t < tlim && c < b_lim;
        cp_async16(A + r * kTile + c, a_base + (aok ? t * a_stride + c : 0), aok);
        cp_async16(B + r * kTile + c, b_base + (bok ? t * b_stride + c : 0), bok);
      }
    } else {
      for (int i = tid; i < kStage; i += kThreads) {
        const int r = i / kTile, c = i % kTile, t = t0 + r;
        const bool aok = t < tlim && c < a_lim, bok = t < tlim && c < b_lim;
        cp_async4(A + r * kTile + c, a_base + (aok ? t * a_stride + c : 0), aok);
        cp_async4(B + r * kTile + c, b_base + (bok ? t * b_stride + c : 0), bok);
      }
    }
    cp_async_commit();
  };
  // the A operand's finish, on one element this thread copied: (r, c) of stage s
  auto finish = [&](float v, int t, int c) {
    if (state) return v * av[t];  // x * exp(a_last - a_t), as the plain version rounds it
    const int q = m0 + c;
    return q < Q && t <= q ? v * expf(av[q] - av[t]) : 0.f;  // S * exp(a_q - a_t)
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int ns = (tlim + kStep - 1) / kStep;
  stage(0);
  __syncthreads();  // av is written
  for (int s = 0; s < ns; ++s) {
    cp_async_wait_all();
    float* A = sa + (s & 1) * kStage;
    const int t0 = s * kStep;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kStage / 4 / kThreads; ++u) {
        const int i = tid + kThreads * u, r = i / (kTile / 4), c = i % (kTile / 4) * 4;
        float4* p = reinterpret_cast<float4*>(A + r * kTile + c);
        float4 v = *p;
        v.x = finish(v.x, t0 + r, c);
        v.y = finish(v.y, t0 + r, c + 1);
        v.z = finish(v.z, t0 + r, c + 2);
        v.w = finish(v.w, t0 + r, c + 3);
        *p = v;
      }
    } else {
      for (int i = tid; i < kStage; i += kThreads) A[i] = finish(A[i], t0 + i / kTile, i % kTile);
    }
    __syncthreads();  // stage s is whole; every thread is done with stage s - 1
    if (s + 1 < ns) stage(s + 1);
    const float4* A4 = reinterpret_cast<const float4*>(A);
    const float4* B4 = reinterpret_cast<const float4*>(sb + (s & 1) * kStage);
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const float4 a0 = A4[k * (kTile / 4) + 2 * tm], a1 = A4[k * (kTile / 4) + 2 * tm + 1];
      const float4 b = B4[k * (kTile / 4) + tn];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av_i = lane(i < 4 ? a0 : a1, i & 3);
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(av_i, lane(b, j), acc[i][j]);
      }
    }
  }

  // rows m0 + tm * 8 + i, columns c0 + tn * 4 + j
  const int c = c0 + tn * 4, climit = state ? N : P;
  if (c >= climit) return;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + tm * kTM + i;
    float* out;
    if (state) {
      if (m >= P) break;
      out = st + (static_cast<size_t>(bh) * P + m) * N + c;
    } else {
      if (m >= Q) break;
      out = y + (static_cast<size_t>(bc) * Q + m) * xrow + static_cast<size_t>(h) * P + c;
    }
    if (vec) {  // the width is a multiple of 4: the four columns are in or out together
      *reinterpret_cast<float4*>(out) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (c + j < climit) out[j] = acc[i][j];
    }
  }
}

int launch(const float* x, const float* da, const float* bm, const float* cm, float* y, float* st,
           float* scores, int BC, int Q, int H, int P, int N, cudaStream_t stream) {
  const int nqt = (Q + kTile - 1) / kTile, npt = (P + kTile - 1) / kTile, nnt = (N + kTile - 1) / kTile;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = P % 4 == 0 && N % 4 == 0 && Q % 4 == 0 && aligned(x) && aligned(bm) && aligned(cm) &&
                  aligned(y) && aligned(st) && aligned(scores);
  scores_kernel<<<dim3(nqt * (nqt + 1) / 2, BC), kThreads, 0, stream>>>(bm, cm, scores, Q, N, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem = sizeof(float) * (4 * kStage + nqt * kTile);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // programmatic dependent launch: the state jobs may run while the scores
  // kernel finishes; the y jobs wait for it (griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BC * H * npt * (nnt + nqt));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, chunk_kernel, x, da, bm, scores, y, st, BC, Q, H, P, N, vec));
}
}  // namespace

// The float32 entry (bf16 must be 0): x (BC, Q, H, P) f32, da_cs (BC, Q, H)
// f32, b / c (BC, Q, N) f32, y (BC, Q, H, P) f32, st (BC, H, P, N) f32,
// scores (BC, Q, Q) f32 scratch (S^T); BC = batch * chunks; P <= 128.
extern "C" int ssd_intra_chunk_launch(const void* x, const void* da, const void* b, const void* c,
                                      void* y, void* st, void* scores, int BC, int Q, int H,
                                      int P, int N, int bf16, void* stream) {
  if (bf16 || P > 2 * kTile) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(x), static_cast<const float*>(da), static_cast<const float*>(b),
                static_cast<const float*>(c), static_cast<float*>(y), static_cast<float*>(st),
                static_cast<float*>(scores), BC, Q, H, P, N, static_cast<cudaStream_t>(stream));
}
