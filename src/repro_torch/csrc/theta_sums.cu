// theta_sums: the per-node estimator sweep sum_c S_i(t - last_seen[i, c])
// for every node of every trajectory.
//
// Replaces src/repro/kernels/theta_survival.py::theta_sums (_theta_kernel).
// Bound: bytes. Each row reads C int32 of last_seen and B int16 of hist
// and writes one float; the work is O(C + B) per row, far below the
// card's compute rate. Design: one warp per row (the row's B bins read
// in one pass into registers, survival.cuh), eight rows per block, grid
// (row tiles, batch); the ragged last tile masks its rows.
#include "survival.cuh"

namespace {
constexpr int kRows = 8;

__global__ void theta_sums_kernel(const int* __restrict__ ls,
                                  const int16_t* __restrict__ hist,
                                  const int* __restrict__ total,
                                  const int* __restrict__ t,
                                  float* __restrict__ out, int n, int C,
                                  int B, bool vec) {
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRows + warp;
  const int b = blockIdx.y;
  if (row >= n) return;  // whole warps only; no block barrier follows
  const size_t r = static_cast<size_t>(b) * n + row;
  const float s = node_sum_row(hist + r * B, ls + r * C, C, B, t[b], total[r], vec);
  if ((threadIdx.x & 31) == 0) out[r] = s;
}
}  // namespace

extern "C" int theta_sums_launch(const void* ls, const void* hist,
                                 const void* total, const void* t, void* out,
                                 int batch, int n, int C, int B,
                                 void* stream) {
  const dim3 grid((n + kRows - 1) / kRows, batch);
  theta_sums_kernel<<<grid, kRows * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ls), static_cast<const int16_t*>(hist),
      static_cast<const int*>(total), static_cast<const int*>(t),
      static_cast<float*>(out), n, C, B, hist_rows_vec(hist, B));
  return static_cast<int>(cudaGetLastError());
}
