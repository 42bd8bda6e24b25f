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
// because a TPU avoids gathers. Here mass = sum_{c valid} cum(clamp(r_c,
// 0, B)), where cum(r) counts the row's bins below r, and the row is read
// in one pass, in segments of 1,024 bins (one for B <= 1024): lane L
// loads the segment's bins [32 L, 32 L + 32) at once -- four 16-byte
// loads when `vec` (B a multiple of 8, the table 16-byte aligned), else
// 32 two-byte loads -- and keeps them in 16 registers, two bins a word.
// One warp scan gives each lane its exclusive prefix E_L. A column with
// clamped return time r takes from the segment the bins below r: E_{src}
// plus the first r % 32 bins of lane src = r / 32, which the column's
// lane reads from lane src's registers with 16 shuffles. No prefix table
// and no shared memory; the first kPreChunks x 32 columns' last_seen load
// with the bins. Every count and the mass are exact integers (C * total
// < 2**24 at any realistic scale), so the result is the reference's
// bits: only the final division and subtraction round, in the
// reference's order, with IEEE round-to-nearest intrinsics (built
// without fast math or FMA).
constexpr int kSegBins = 1024;  // 32 bins per lane
constexpr int kPreChunks = 2;   // chunks of 32 columns loaded before the scan

__device__ __forceinline__ int lo_bin(uint32_t w) { return static_cast<int16_t>(w & 0xffffu); }
__device__ __forceinline__ int hi_bin(uint32_t w) { return static_cast<int16_t>(w >> 16); }

// bins [lo, lo + 32) of the row, zero from B on, two per word
__device__ __forceinline__ void load_bins(const int16_t* h, int lo, int B, bool vec,
                                          uint32_t (&wd)[16]) {
  if (vec) {  // lo and B are multiples of 8: a vector lies wholly below B or not
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int4 x = lo + 8 * v < B ? *reinterpret_cast<const int4*>(h + lo + 8 * v)
                                    : make_int4(0, 0, 0, 0);
      wd[4 * v] = x.x;
      wd[4 * v + 1] = x.y;
      wd[4 * v + 2] = x.z;
      wd[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int b = lo + 2 * j;
      const uint32_t a0 = b < B ? static_cast<uint16_t>(h[b]) : 0u;
      const uint32_t a1 = b + 1 < B ? static_cast<uint16_t>(h[b + 1]) : 0u;
      wd[j] = a0 | (a1 << 16);
    }
  }
}

// The segment's bins below rel (= r - the segment's first bin), for one
// column; every lane of the warp calls it.
__device__ __forceinline__ int segment_part(const uint32_t (&wd)[16], int excl, int seg_total,
                                            int rel) {
  const unsigned full = 0xffffffffu;
  const int src = min(max(rel, 0) >> 5, 31);
  const int off = rel - (src << 5);
  int part = __shfl_sync(full, excl, src);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t x = __shfl_sync(full, wd[j], src);
    part += (2 * j < off ? lo_bin(x) : 0) + (2 * j + 1 < off ? hi_bin(x) : 0);
  }
  return rel <= 0 ? 0 : (rel >= kSegBins ? seg_total : part);
}

// Whether node_sum_row may read a (rows, B) int16 table's rows with
// 16-byte loads: every row then starts 16-byte aligned.
inline bool hist_rows_vec(const void* hist, int B) {
  return B % 8 == 0 && reinterpret_cast<uintptr_t>(hist) % 16 == 0;
}

__device__ __forceinline__ float node_sum_row(
    const int16_t* hist_row, const int* ls_row, int C, int B, int t, int total, bool vec) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int pre[kPreChunks];
#pragma unroll
  for (int j = 0; j < kPreChunks; ++j) {
    const int c = 32 * j + lane;
    pre[j] = c < C ? ls_row[c] : REPRO_NEVER;
  }
  auto ret = [&](int l) {
    const int r = t - l;
    return r < 0 ? 0 : (r > B ? B : r);
  };
  int nv = 0, mass = 0;
  for (int seg0 = 0; seg0 < B; seg0 += kSegBins) {
    uint32_t wd[16];
    load_bins(hist_row, seg0 + 32 * lane, B, vec, wd);
    int own = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) own += lo_bin(wd[j]) + hi_bin(wd[j]);
    int incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += y;
    }
    const int excl = incl - own;
    const int seg_total = __shfl_sync(full, incl, 31);
#pragma unroll
    for (int j = 0; j < kPreChunks; ++j) {
      const int part = segment_part(wd, excl, seg_total, ret(pre[j]) - seg0);
      if (pre[j] != REPRO_NEVER) mass += part;
    }
    for (int c0 = 32 * kPreChunks; c0 < C; c0 += 32) {
      const int l = c0 + lane < C ? ls_row[c0 + lane] : REPRO_NEVER;
      const int part = segment_part(wd, excl, seg_total, ret(l) - seg0);
      if (l != REPRO_NEVER) {
        mass += part;
        nv += seg0 == 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPreChunks; ++j) nv += pre[j] != REPRO_NEVER;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nv += __shfl_xor_sync(full, nv, off);
    mass += __shfl_xor_sync(full, mass, off);
  }
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
