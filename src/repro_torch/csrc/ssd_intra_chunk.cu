// ssd_intra_chunk, float32 B / C, on the CUDA cores in exact float32:
// the Mamba-2 SSD intra-chunk block and each chunk's outgoing state, for
// every (batch, chunk) and head:
//
//   y[q, h, p]  = sum_{t <= q} (C_q . B_t) exp(a[q, h] - a[t, h]) x[t, h, p]
//   st[h, p, n] = sum_t B[t, n] exp(a[Q-1, h] - a[t, h]) x[t, h, p]
//
// with x (B, nc, Q, H, P) f32 (dt-weighted inputs), a = da_cs
// (B, nc, Q, H) f32 (in-chunk cumulative log-decay), B / C (B, nc, Q, N)
// f32; y and st are f32. bfloat16 B / C (the served dtype) run on the
// tensor cores (ssd_intra_chunk_sm90.cu); the wrapper picks the library by
// dtype, as it does for flash_attention.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_intra_chunk (_ssd_kernel)
// for float32 B / C. Why float32 stays here: the float32 serving gate
// holds mamba2-1.3b's kernel path to its plain torch path within 1e-4 of
// the logit scale, and through 48 layers of random weights that model
// amplifies any rounding that differs from torch's float32 einsums past
// it: an intra-chunk block computed in float64 and rounded misses it, and
// so does the 3xTF32 tensor-core version (chip_smoke.py records the
// float64 one). These kernels sum each output as one ascending chain of
// float32 FMAs, as the einsums do, and meet it. The TPU kernel builds the (Q, Q, H) decay tensor of a
// chunk in VMEM; at mamba2-1.3b (Q 256, H 64) that is 16 MB, far beyond a
// CTA. Here the causal mask becomes loop bounds (t <= q) and the decay is
// computed where it is used, exp(a_q - a_t) in f32.
//
// Bound: at mamba2-1.3b's prefill (batch 4, nc 2, Q 256, H 64, P 64,
// N 128) the block needs ~4.4 GFLOP against ~85 MB of x / y / states, so
// on the CUDA cores' f32 rate it is bound by operations. Design, three
// kernels behind one launch:
//   1. scores: C . B^T (Q x Q, inner N) once per chunk -- it is shared by
//      every head -- into a scratch buffer (B * nc, Q, Q) f32, only the
//      tiles on or below the diagonal; 32 x 32 output tiles, N staged
//      through shared memory 32 at a time;
//   2. y: grid (query tiles, heads, chunks); for each key tile t <= q the
//      weights w[q, t] = scores * exp(a_q - a_t) (0 above the diagonal)
//      and x[t, h, :] are staged in shared memory, and each thread sums
//      8 outputs of one query row;
//   3. states: grid (output tiles, heads, chunks); x[t, h, :] is scaled by
//      exp(a_last - a_t) as it is staged, and each thread sums 32 (p, n)
//      outputs over the chunk, 32 time steps at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {
constexpr int kT = 32;          // tile edge (query rows, key columns, time steps)
constexpr int kThreads = 256;
constexpr int kMaxPPerThread = 16;  // y: P <= 8 * 16
constexpr int kStOut = 32;          // states: outputs per thread

// scores[bc, q, t] = sum_n C[bc, q, n] B[bc, t, n] for tiles with t-tile <= q-tile
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ scores,
              int Q, int N) {
  const int tq = blockIdx.x, tt = blockIdx.y, bc = blockIdx.z;
  if (tt > tq) return;  // wholly above the diagonal: never read
  __shared__ float cs[kT][kT + 1];
  __shared__ float bs[kT][kT + 1];
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;  // ty in [0, 8)
  const size_t base = static_cast<size_t>(bc) * Q * N;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < N; n0 += kT) {
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT, n = n0 + c;
      const int qr = tq * kT + r, tr = tt * kT + r;
      cs[r][c] = (qr < Q && n < N) ? cm[base + static_cast<size_t>(qr) * N + n] : 0.f;
      bs[r][c] = (tr < Q && n < N) ? bm[base + static_cast<size_t>(tr) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kT; ++c) {
      const float bv = bs[tx][c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __fmaf_rn(cs[ty + 8 * i][c], bv, acc[i]);
    }
    __syncthreads();
  }
  const int t = tt * kT + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = tq * kT + ty + 8 * i;
    if (qr < Q && t < Q) scores[(static_cast<size_t>(bc) * Q + qr) * Q + t] = acc[i];
  }
}

__global__ void __launch_bounds__(kThreads)
y_kernel(const float* __restrict__ x, const float* __restrict__ da,
         const float* __restrict__ scores, float* __restrict__ y, int Q, int H, int P) {
  const int tq = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  extern __shared__ float smem[];
  float* w = smem;               // kT x (kT + 1)
  float* xs = w + kT * (kT + 1);  // kT x P
  __shared__ float daq[kT];
  const int r = threadIdx.x / 8, pg = threadIdx.x % 8;  // query row, p group
  const int qr = tq * kT + r;
  const size_t xrow = static_cast<size_t>(H) * P;  // between time steps
  const float* xb = x + static_cast<size_t>(bc) * Q * xrow + static_cast<size_t>(h) * P;
  const float* dab = da + static_cast<size_t>(bc) * Q * H + h;
  const float* sc = scores + static_cast<size_t>(bc) * Q * Q;
  if (threadIdx.x < kT) {
    const int qq = tq * kT + threadIdx.x;
    daq[threadIdx.x] = qq < Q ? dab[static_cast<size_t>(qq) * H] : 0.f;
  }
  float acc[kMaxPPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPPerThread; ++j) acc[j] = 0.f;

  for (int tt = 0; tt <= tq; ++tt) {
    __syncthreads();  // the previous tile is consumed (and daq is written)
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int rr = i / kT, c = i % kT;
      const int q = tq * kT + rr, t = tt * kT + c;
      float wv = 0.f;
      if (q < Q && t <= q) wv = sc[static_cast<size_t>(q) * Q + t] * expf(daq[rr] - dab[static_cast<size_t>(t) * H]);
      w[rr * (kT + 1) + c] = wv;
    }
    for (int i = threadIdx.x; i < kT * P; i += kThreads) {
      const int c = i / P, p = i % P, t = tt * kT + c;
      xs[i] = t < Q ? xb[static_cast<size_t>(t) * xrow + p] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kT; ++c) {
      const float wv = w[r * (kT + 1) + c];
#pragma unroll
      for (int j = 0; j < kMaxPPerThread; ++j) {
        const int p = pg + 8 * j;
        if (p < P) acc[j] = __fmaf_rn(wv, xs[c * P + p], acc[j]);
      }
    }
  }
  if (qr >= Q) return;
  float* yrow = y + (static_cast<size_t>(bc) * Q + qr) * xrow + static_cast<size_t>(h) * P;
#pragma unroll
  for (int j = 0; j < kMaxPPerThread; ++j) {
    const int p = pg + 8 * j;
    if (p < P) yrow[p] = acc[j];
  }
}

__global__ void __launch_bounds__(kThreads)
states_kernel(const float* __restrict__ x, const float* __restrict__ da, const float* __restrict__ bm,
              float* __restrict__ st, int Q, int H, int P, int N) {
  const int h = blockIdx.y, bc = blockIdx.z;
  extern __shared__ float smem[];
  float* xw = smem;        // kT x P: x scaled by exp(a_last - a_t)
  float* bs = xw + kT * P;  // kT x N
  const size_t xrow = static_cast<size_t>(H) * P;
  const float* xb = x + static_cast<size_t>(bc) * Q * xrow + static_cast<size_t>(h) * P;
  const float* dab = da + static_cast<size_t>(bc) * Q * H + h;
  const float* bb = bm + static_cast<size_t>(bc) * Q * N;
  const float a_last = dab[static_cast<size_t>(Q - 1) * H];
  const int out0 = blockIdx.x * kThreads * kStOut;
  float acc[kStOut];
#pragma unroll
  for (int j = 0; j < kStOut; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < Q; t0 += kT) {
    __syncthreads();
    for (int i = threadIdx.x; i < kT * P; i += kThreads) {
      const int c = i / P, p = i % P, t = t0 + c;
      xw[i] = t < Q ? xb[static_cast<size_t>(t) * xrow + p] *
                          expf(a_last - dab[static_cast<size_t>(t) * H])
                    : 0.f;
    }
    for (int i = threadIdx.x; i < kT * N; i += kThreads) {
      const int c = i / N, n = i % N, t = t0 + c;
      bs[i] = t < Q ? bb[static_cast<size_t>(t) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kStOut; ++j) {
      const int o = out0 + j * kThreads + threadIdx.x;
      if (o >= P * N) break;
      const int p = o / N, n = o % N;
      float s = acc[j];
      for (int c = 0; c < kT; ++c) s = __fmaf_rn(xw[c * P + p], bs[c * N + n], s);
      acc[j] = s;
    }
  }
  float* sb = st + (static_cast<size_t>(bc) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < kStOut; ++j) {
    const int o = out0 + j * kThreads + threadIdx.x;
    if (o < P * N) sb[o] = acc[j];
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

int launch(const float* x, const float* da, const float* bm, const float* cm, float* y, float* st,
           float* scores, int BC, int Q, int H, int P, int N, cudaStream_t stream) {
  const int nt = (Q + kT - 1) / kT;
  scores_kernel<<<dim3(nt, nt, BC), kThreads, 0, stream>>>(bm, cm, scores, Q, N);
  int e = static_cast<int>(cudaGetLastError());
  if (e) return e;

  const size_t y_smem = sizeof(float) * (kT * (kT + 1) + kT * P);
  if ((e = set_smem(reinterpret_cast<const void*>(y_kernel), y_smem))) return e;
  y_kernel<<<dim3(nt, H, BC), kThreads, y_smem, stream>>>(x, da, scores, y, Q, H, P);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;

  const size_t st_smem = sizeof(float) * kT * (P + N);
  if ((e = set_smem(reinterpret_cast<const void*>(states_kernel), st_smem))) return e;
  const int ntiles = (P * N + kThreads * kStOut - 1) / (kThreads * kStOut);
  states_kernel<<<dim3(ntiles, H, BC), kThreads, st_smem, stream>>>(x, da, bm, st, Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// The float32 entry (bf16 must be 0): x (BC, Q, H, P) f32, da_cs (BC, Q, H)
// f32, b / c (BC, Q, N) f32, y (BC, Q, H, P) f32, st (BC, H, P, N) f32,
// scores (BC, Q, Q) f32 scratch; BC = batch * chunks; P <= 128.
extern "C" int ssd_intra_chunk_launch(const void* x, const void* da, const void* b, const void* c,
                                      void* y, void* st, void* scores, int BC, int Q, int H,
                                      int P, int N, int bf16, void* stream) {
  if (bf16 || P > 8 * kMaxPPerThread) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(x), static_cast<const float*>(da), static_cast<const float*>(b),
                static_cast<const float*>(c), static_cast<float*>(y), static_cast<float*>(st),
                static_cast<float*>(scores), BC, Q, H, P, N, static_cast<cudaStream_t>(stream));
}
