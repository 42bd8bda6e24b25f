// Shared device code of the port's round kernels: the one node-sum
// formula (the counterpart of survival_node_sums_rows in the JAX
// package's core/estimator.py) and the int16 histogram increment.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_NEVER (-1)

// sum_c S_i(t - last_seen[i, c]) for one row, computed by one warp.
//
// The reference contracts a (C, B) compare against the histogram,
// because a TPU avoids gathers. Here the warp builds the row's exclusive
// prefix counts in shared memory (B + 1 ints) with a shuffle scan and
// gathers one prefix per column: mass = sum_{c valid} cum(clamp(r_c, 0, B)).
// Every count and the mass are exact integers (C * total < 2**24 at any
// realistic scale), so the result is the reference's bits: only the
// final division and subtraction round, in the reference's order, with
// IEEE round-to-nearest intrinsics (built without fast math or FMA).
__device__ __forceinline__ float node_sum_row(
    const int16_t* hist_row, const int* ls_row, int C, int B, int t,
    int total, int* prefix) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int carry = 0;
  if (lane == 0) prefix[0] = 0;
  for (int base = 0; base < B; base += 32) {
    const int b = base + lane;
    int v = (b < B) ? static_cast<int>(hist_row[b]) : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(full, v, off);
      if (lane >= off) v += y;
    }
    if (b < B) prefix[b + 1] = carry + v;
    carry += __shfl_sync(full, v, 31);
  }
  __syncwarp();
  int nv = 0, mass = 0;
  for (int c = lane; c < C; c += 32) {
    const int l = ls_row[c];
    if (l != REPRO_NEVER) {
      nv += 1;
      int r = t - l;
      r = r < 0 ? 0 : (r > B ? B : r);
      mass += prefix[r];
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    nv += __shfl_xor_sync(full, nv, off);
    mass += __shfl_xor_sync(full, mass, off);
  }
  __syncwarp();  // the scratch row is reused by the warp's next row
  const float nvf = __int2float_rn(nv);
  const float tf = __int2float_rn(total);
  const float s = __fsub_rn(nvf, __fdiv_rn(__int2float_rn(mass), fmaxf(tf, 1.0f)));
  return tf > 0.0f ? s : nvf;
}

// hist[e] += 1 on an int16 table. CUDA has no 16-bit atomicAdd, so the
// aligned 32-bit word holding the element gets 1 (low half, even e) or
// 1 << 16 (high half, odd e). Counts stay far below 2**15, so the low
// half never carries into the high half. The table must be 4-byte
// aligned (the wrappers check).
__device__ __forceinline__ void hist_add_one(int16_t* hist, size_t e) {
  unsigned int* word = reinterpret_cast<unsigned int*>(hist) + (e >> 1);
  atomicAdd(word, (e & 1) ? (1u << 16) : 1u);
}
