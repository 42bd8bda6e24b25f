// whole_round: one whole simulator round for every trajectory — the
// topology step, resident kills, the masked rank-select hop,
// probabilistic / burst / Byzantine / static Pac-Man failures, the
// return-time scatter and last_seen scatter-max (in place), per-walk
// theta, the pairwise choose and the fork / terminate masks.
//
// Replaces src/repro/kernels/round_update.py::whole_round_pallas
// (_whole_round_kernel). Every uniform is drawn by the caller from the
// reference's streams and enters as data.
//
// Bound: at the paper's scale (n = 100, W = 64, B = 1024, batch = 50) a
// round moves about 6 MB and does a few million simple operations, so
// its bound is about 2 us of bytes; the kernel is limited by the
// latency of its dependent phases, not by bytes or operations. On large
// graphs (n in the hundreds of thousands and up) the topology pass's
// bytes lead: 10 an edge and 11 a node per trajectory.
//
// Design: two launches on one stream. (1) The topology pass, node-tiled:
// a grid of (node tiles of 256, batch), one thread per node and then per
// edge of its tile's rows, writes node_out and edge_out, as the Pallas
// kernel's phase 0 does for each node tile. (2)-(5) run in one CTA of
// 1,024 threads per trajectory (grid = batch), reading node liveness
// from node_out in global memory (L2), so its shared memory is O(W) and
// does not grow with n: any n runs. The TPU kernel carries the walk
// state and the theta accumulator from one grid step to the next; CUDA
// blocks run in parallel in no order, so that carry becomes phases
// inside the CTA, separated by __syncthreads(): (2) walk epilogue over
// W, (3) observation, with each slot's leader (the lowest slot at its
// node) and the choose, (4) theta once per distinct occupied row, (5)
// decisions. Phase (4) dominates when a warp walks its rows' histograms
// in dependent load-scan steps (85 % of an 8-warp kernel on an H100, by
// clock64 stamps at its barriers), so each distinct row gets a warp of
// its own (32 warps; theta is a function of the row, so slots that share
// a node share it), and the warp reads the row in one pass (survival.cuh,
// node_sum_row). The O(W^2) steps -- burst ranks, the leaders and the
// choose -- give each slot a warp whose lanes split
// the other slots. The hop builds its row's availability as a bit mask
// with the chunk's loads in flight together, and every slot input is
// loaded at the kernel's start. The one-hot / compare tricks of the TPU
// kernel are gone: gathers, atomicMax and ballots are cheap here.
#include <math.h>

#include "survival.cuh"

namespace {
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTopoNodes = 256;  // nodes (and threads) of a topology tile

struct Round {
  // observation state, updated in place: (batch, n, C) / (batch, n, B) / (batch, n)
  int* ls;
  int16_t* hist;
  int* total;
  // pre-round topology (batch, n) / (batch, n, D)
  const uint8_t* node_up;
  const uint8_t* edge_up;
  // walks (batch, W)
  const int* pos;
  const int* track;
  const uint8_t* active;
  // static graph (n, D) / (n,)
  const int* nbrs;
  const int* degs;
  // uniforms
  const float* u_move;  // (batch, W)
  const float* u_pfail;
  const float* u_fork;
  const float* u_term;
  const float* u_burst;  // (batch, K, W)
  const int* bsz;  // (batch, K) effective burst sizes
  const float* u_nfail;  // (batch, n)
  const float* u_nrec;
  const uint8_t* sched;  // (batch, n)
  const float* e_fail;  // (batch, n, D) symmetrized
  const float* e_rec;
  const float* pf;  // (batch, 8) p_fail p_nfail p_lfail p_nrec p_lrec eps eps2 p
  const int* pi;  // (batch, 4) t byz_kill_node pacman_node enabled
  // outputs
  uint8_t* node_out;  // (batch, n)
  uint8_t* edge_out;  // (batch, n, D)
  int* pos_out;  // (batch, W)
  uint8_t* act_out;
  float* theta_out;
  uint8_t* chosen_out;
  uint8_t* fork_out;
  uint8_t* term_out;
  int n, C, B, D, W, K, plus;
  bool vec;  // the histogram rows take 16-byte loads (node_sum_row)
};

// The availability of neighbours [k0, k0 + 32) of node p as a bit mask:
// an edge up and both ends up, over the row's first deg slots. The row's
// neighbour ids and edge states load unconditionally (the row holds D of
// each), so a chunk's loads are in flight together.
__device__ __forceinline__ unsigned avail_bits(const uint8_t* node, const int* nb,
                                               const uint8_t* eu, int deg, int D, int k0) {
  unsigned m = 0;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int k = k0 + j;
    if (k >= D) break;
    const int v = nb[k];
    const bool up = eu[k];
    if (k < deg && up && node[v]) m |= 1u << j;
  }
  return m;
}

// A walk slot's inputs. Thread w loads slot w's at the kernel's start, so
// their latency hides under the topology step; a thread whose loop
// reaches a further slot (W > kThreads) loads that one where it is used.
constexpr int kPreBursts = 2;
struct Slot {
  int pos, track;
  bool active;
  float u_move, u_pfail, u_fork, u_term, u_burst[kPreBursts];
};

__device__ __forceinline__ Slot load_slot(const Round& a, size_t bw, int w) {
  Slot s;
  s.pos = a.pos[bw + w];
  s.track = a.track[bw + w];
  s.active = a.active[bw + w];
  s.u_move = a.u_move[bw + w];
  s.u_pfail = a.u_pfail[bw + w];
  s.u_fork = a.u_fork[bw + w];
  s.u_term = a.u_term[bw + w];
#pragma unroll
  for (int kb = 0; kb < kPreBursts; ++kb) {
    s.u_burst[kb] = kb < a.K ? a.u_burst[bw * a.K + static_cast<size_t>(kb) * a.W + w] : 0.f;
  }
  return s;
}

// (1) topology for one tile of kTopoNodes nodes of one trajectory: node
// crash / recovery, then symmetrized link fail / recovery over the
// tile's rows of (n, D), which are contiguous.
__global__ void __launch_bounds__(kTopoNodes) whole_round_topology_kernel(Round a) {
  const int b = blockIdx.y;
  const int n = a.n, D = a.D;
  const int i0 = blockIdx.x * kTopoNodes;
  const float* pf = a.pf + b * 8;
  const float p_nfail = pf[1], p_lfail = pf[2], p_nrec = pf[3], p_lrec = pf[4];
  const size_t bn = static_cast<size_t>(b) * n;
  const int i = i0 + threadIdx.x;
  if (i < n) {
    const bool up = a.node_up[bn + i];
    const bool crash = a.u_nfail[bn + i] < p_nfail;
    const bool recov = a.u_nrec[bn + i] < p_nrec;
    const bool sched = a.sched[bn + i];
    a.node_out[bn + i] = up ? !(crash || sched) : (recov && !sched);
  }
  const size_t e1 = (bn + min(i0 + kTopoNodes, n)) * D;
  for (size_t k = (bn + i0) * D + threadIdx.x; k < e1; k += kTopoNodes) {
    a.edge_out[k] = a.edge_up[k] ? !(a.e_fail[k] < p_lfail) : (a.e_rec[k] < p_lrec);
  }
}

__global__ void __launch_bounds__(kThreads) whole_round_kernel(Round a) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int n = a.n, C = a.C, B = a.B, D = a.D, W = a.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* s_pos = smem;  // W
  int* s_prev = s_pos + W;  // W: last_seen before the update; then the distinct rows
  int* s_rows = s_prev;
  int* s_score = s_prev + W;  // W: burst scores; then each slot's leader
  int* s_leader = s_score;
  float* s_theta = reinterpret_cast<float*>(s_score + W);  // W, at leader slots
  int* s_nrows = reinterpret_cast<int*>(s_theta + W);  // 1
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_nrows + 1);  // W
  uint8_t* s_chosen = s_act + W;  // W

  const float* pf = a.pf + b * 8;
  const int* pi = a.pi + b * 4;
  const float p_fail = pf[0], eps = pf[5], eps2 = pf[6], p_fork = pf[7];
  const int t = pi[0], byz_node = pi[1], pac_node = pi[2];
  const bool enabled = pi[3] > 0;
  const size_t bn = static_cast<size_t>(b) * n;
  const size_t bw = static_cast<size_t>(b) * W;
  const bool has_slot = threadIdx.x < W;
  const Slot mine = has_slot ? load_slot(a, bw, threadIdx.x) : Slot{};
  auto slot = [&](int w) { return w == threadIdx.x ? mine : load_slot(a, bw, w); };
  if (threadIdx.x == 0) *s_nrows = 0;

  const uint8_t* node = a.node_out + bn;  // (1)'s node liveness, written before this launch
  __syncthreads();

  // (2) walk epilogue: resident kills, the masked rank-select hop and
  // the probabilistic failures, one thread per walk
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const Slot sl = slot(w);
    int p = sl.pos;
    const bool here = node[p];
    bool act = sl.active && here;
    const int deg = a.degs[p];
    const int* nb = a.nbrs + static_cast<size_t>(p) * D;
    const uint8_t* eu = a.edge_out + (bn + p) * D;
    const unsigned m0 = here ? avail_bits(node, nb, eu, deg, D, 0) : 0u;
    int adeg = __popc(m0);
    for (int k0 = 32; k0 < D && here; k0 += 32) {
      adeg += __popc(avail_bits(node, nb, eu, deg, D, k0));
    }
    if (act && adeg > 0) {
      // the idx-th available neighbour, in slot order
      int idx = min(static_cast<int>(__fmul_rn(sl.u_move, __int2float_rn(adeg))), adeg - 1);
      for (int k0 = 0;; k0 += 32) {
        unsigned m = k0 == 0 ? m0 : avail_bits(node, nb, eu, deg, D, k0);
        const int c = __popc(m);
        if (idx < c) {
          for (; idx > 0; --idx) m &= m - 1;
          p = nb[k0 + __ffs(m) - 1];
          break;
        }
        idx -= c;
      }
    }
    act = act && !(sl.u_pfail < p_fail);
    s_pos[w] = p;
    s_act[w] = act;
  }
  __syncthreads();
  // bursts in order: kill the bsz lowest-scored active walks; a slot's
  // rank is counted by a warp, its lanes splitting the other slots
  for (int kb = 0; kb < a.K; ++kb) {
    float* score = reinterpret_cast<float*>(s_score);
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      float u = 0.f;
      if (w == threadIdx.x && kb < kPreBursts) {
#pragma unroll
        for (int j = 0; j < kPreBursts; ++j) u = j == kb ? mine.u_burst[j] : u;
      } else {
        u = a.u_burst[bw * a.K + static_cast<size_t>(kb) * W + w];
      }
      score[w] = s_act[w] ? u : INFINITY;
    }
    __syncthreads();
    const int size = a.bsz[b * a.K + kb];
    for (int w = warp; w < W; w += kWarps) {
      const float own = score[w];
      int rank = 0;
      for (int j = lane; j < W; j += 32) rank += own > score[j];
      rank = __reduce_add_sync(0xffffffffu, rank);
      if (lane == 0 && rank < size) s_act[w] = 0;
    }
    __syncthreads();
  }
  // Byzantine and Pac-Man kills (-1 never matches); read last_seen's
  // previous visit before any thread updates it
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int p = s_pos[w];
    const bool act = s_act[w] && p != byz_node && p != pac_node;
    s_act[w] = act;
    a.pos_out[bw + w] = p;
    a.act_out[bw + w] = act;
    s_prev[w] = a.ls[(bn + p) * C + slot(w).track];
  }
  __syncthreads();

  // (3) observation: histogram / total increments, last_seen scatter-max
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int p = s_pos[w];
    const bool act = s_act[w];
    const int prev = s_prev[w];
    const int r = t - prev;
    const size_t row = bn + p;
    if (act && prev != REPRO_NEVER && r >= 1) {
      const int bin = (r > B ? B : r) - 1;
      hist_add_one(a.hist, row * B + bin);
      atomicAdd(&a.total[row], 1);
    }
    if (act) atomicMax(&a.ls[row * C + slot(w).track], t);
  }
  // each slot's leader (the lowest slot at its node: theta is a function
  // of the row, so it is computed once per distinct row) and whether it
  // is chosen (the lowest active slot at its node runs the protocol)
  for (int w = warp; w < W; w += kWarps) {
    const int p = s_pos[w];
    unsigned first = 0xffffffffu;  // lowest slot j < w at p, if any
    bool active_before = false;
    for (int j0 = 0; j0 < w; j0 += 32) {
      const int j = j0 + lane;
      const bool same = j < w && s_pos[j] == p;
      const unsigned hits = __ballot_sync(0xffffffffu, same);
      if (hits && first == 0xffffffffu) first = j0 + __ffs(hits) - 1;
      active_before |= __any_sync(0xffffffffu, same && s_act[j]) != 0;
    }
    if (lane == 0) {
      s_leader[w] = first == 0xffffffffu ? w : static_cast<int>(first);
      s_chosen[w] = s_act[w] && !active_before;
    }
  }
  __syncthreads();  // s_prev is consumed: it holds the distinct rows next
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    if (s_leader[w] == w) s_rows[atomicAdd(s_nrows, 1)] = w;
  }
  __syncthreads();

  // (4) theta at the distinct rows: node sum - 1/2, one warp per row
  for (int i = warp; i < *s_nrows; i += kWarps) {
    const int w = s_rows[i];
    const size_t row = bn + s_pos[w];
    const float s = node_sum_row(a.hist + row * B, a.ls + row * C, C, B, t, a.total[row],
                                 a.vec);
    if (lane == 0) s_theta[w] = __fsub_rn(s, 0.5f);
  }
  __syncthreads();

  // (5) decisions
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const Slot sl = slot(w);
    const bool chosen = s_chosen[w];
    const float th = s_theta[s_leader[w]];
    const bool fork = chosen && th < eps && sl.u_fork < p_fork && enabled;
    const bool term = a.plus && chosen && th > eps2 && sl.u_term < p_fork && enabled && !fork;
    a.theta_out[bw + w] = th;
    a.chosen_out[bw + w] = chosen;
    a.fork_out[bw + w] = fork;
    a.term_out[bw + w] = term;
  }
}
}  // namespace

extern "C" int whole_round_launch(
    void* ls, void* hist, void* total, const void* node_up,
    const void* edge_up, const void* pos, const void* track,
    const void* active, const void* nbrs, const void* degs,
    const void* u_move, const void* u_pfail, const void* u_fork,
    const void* u_term, const void* u_burst, const void* bsz,
    const void* u_nfail, const void* u_nrec, const void* sched,
    const void* e_fail, const void* e_rec, const void* pf, const void* pi,
    void* node_out, void* edge_out, void* pos_out, void* act_out,
    void* theta_out, void* chosen_out, void* fork_out, void* term_out,
    int batch, int n, int C, int B, int D, int W, int K, int plus,
    void* stream) {
  Round a;
  a.ls = static_cast<int*>(ls);
  a.hist = static_cast<int16_t*>(hist);
  a.total = static_cast<int*>(total);
  a.node_up = static_cast<const uint8_t*>(node_up);
  a.edge_up = static_cast<const uint8_t*>(edge_up);
  a.pos = static_cast<const int*>(pos);
  a.track = static_cast<const int*>(track);
  a.active = static_cast<const uint8_t*>(active);
  a.nbrs = static_cast<const int*>(nbrs);
  a.degs = static_cast<const int*>(degs);
  a.u_move = static_cast<const float*>(u_move);
  a.u_pfail = static_cast<const float*>(u_pfail);
  a.u_fork = static_cast<const float*>(u_fork);
  a.u_term = static_cast<const float*>(u_term);
  a.u_burst = static_cast<const float*>(u_burst);
  a.bsz = static_cast<const int*>(bsz);
  a.u_nfail = static_cast<const float*>(u_nfail);
  a.u_nrec = static_cast<const float*>(u_nrec);
  a.sched = static_cast<const uint8_t*>(sched);
  a.e_fail = static_cast<const float*>(e_fail);
  a.e_rec = static_cast<const float*>(e_rec);
  a.pf = static_cast<const float*>(pf);
  a.pi = static_cast<const int*>(pi);
  a.node_out = static_cast<uint8_t*>(node_out);
  a.edge_out = static_cast<uint8_t*>(edge_out);
  a.pos_out = static_cast<int*>(pos_out);
  a.act_out = static_cast<uint8_t*>(act_out);
  a.theta_out = static_cast<float*>(theta_out);
  a.chosen_out = static_cast<uint8_t*>(chosen_out);
  a.fork_out = static_cast<uint8_t*>(fork_out);
  a.term_out = static_cast<uint8_t*>(term_out);
  a.n = n;
  a.C = C;
  a.B = B;
  a.D = D;
  a.W = W;
  a.K = K;
  a.plus = plus;
  a.vec = hist_rows_vec(hist, B);
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);  // grid.y
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 tiles((n + kTopoNodes - 1) / kTopoNodes, batch);
  whole_round_topology_kernel<<<tiles, kTopoNodes, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = (4 * static_cast<size_t>(W) + 1) * 4 + 2 * static_cast<size_t>(W);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(whole_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  whole_round_kernel<<<batch, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
