// round_update: one observation round — the return-time histogram
// scatter-add at clip(r, 1, B) - 1, the last_seen scatter-max and the
// node sums — updating last_seen / hist / total in place.
//
// Replaces src/repro/kernels/round_update.py::round_update_pallas
// (_round_kernel). Bound: bytes (the node sums read every row's C + B
// counters once; the W events are a handful of atomics). The TPU kernel
// turns the scatters into one-hot matmuls and compares because a TPU
// avoids scatters; here each block owns a tile of rows, scans the W
// events for the ones landing in its rows and applies them with atomics
// (the int16 add goes through the aligned 32-bit word), then one warp
// per row computes the row's sum from the updated counters. A row
// belongs to one block, so no update crosses blocks.
#include "survival.cuh"

namespace {
constexpr int kRows = 8;

__global__ void round_update_kernel(int* __restrict__ ls,
                                    int16_t* __restrict__ hist,
                                    int* __restrict__ total,
                                    const int* __restrict__ pos,
                                    const int* __restrict__ track,
                                    const int* __restrict__ r,
                                    const uint8_t* __restrict__ valid,
                                    const int* __restrict__ upd,
                                    const int* __restrict__ t,
                                    float* __restrict__ sums, int n, int C,
                                    int B, int W, bool vec) {
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int i = b * W + w;
    const int p = pos[i];
    if (p < row0 || p >= row0 + kRows || p >= n) continue;
    const size_t rr = static_cast<size_t>(b) * n + p;
    if (valid[i]) {
      int bin = r[i];
      bin = (bin < 1 ? 1 : (bin > B ? B : bin)) - 1;
      hist_add_one(hist, rr * B + bin);
      atomicAdd(&total[rr], 1);
    }
    atomicMax(&ls[rr * C + track[i]], upd[i]);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int row = row0 + warp;
  if (row >= n) return;
  const size_t rr = static_cast<size_t>(b) * n + row;
  const float s = node_sum_row(hist + rr * B, ls + rr * C, C, B, t[b], total[rr], vec);
  if ((threadIdx.x & 31) == 0) sums[rr] = s;
}
}  // namespace

extern "C" int round_update_launch(void* ls, void* hist, void* total,
                                   const void* pos, const void* track,
                                   const void* r, const void* valid,
                                   const void* upd, const void* t, void* sums,
                                   int batch, int n, int C, int B, int W,
                                   void* stream) {
  const dim3 grid((n + kRows - 1) / kRows, batch);
  round_update_kernel<<<grid, kRows * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ls), static_cast<int16_t*>(hist),
      static_cast<int*>(total), static_cast<const int*>(pos),
      static_cast<const int*>(track), static_cast<const int*>(r),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(upd),
      static_cast<const int*>(t), static_cast<float*>(sums), n, C, B, W,
      hist_rows_vec(hist, B));
  return static_cast<int>(cudaGetLastError());
}
