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
// round moves about a megabyte and does a few million simple operations,
// so its bound is well under a microsecond; the kernel is limited by its
// serial phases and by launch latency, not by bytes or operations.
//
// Design: one CTA per trajectory (grid = batch). The TPU kernel carries
// the walk state and the theta accumulator from one grid step to the
// next; CUDA blocks run in parallel in no order, so that carry becomes
// phases inside the CTA, separated by __syncthreads(): (1) topology over
// (n, D) and (n,), (2) walk epilogue over W, (3) observation, (4) theta
// at the walks' rows only (one warp per walk, the shared node-sum of
// survival.cuh), (5) decisions. The one-hot / compare tricks of the TPU
// kernel are gone: gathers, atomicMax and shared-memory ranks are cheap
// here. Large graphs (n in the tens of thousands) want a node-tiled grid
// for phase (1) instead of one CTA per trajectory; that is left to a
// later change.
#include <math.h>

#include "survival.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
};

__global__ void __launch_bounds__(kThreads) whole_round_kernel(Round a) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int n = a.n, C = a.C, B = a.B, D = a.D, W = a.W;
  int* prefix = smem;  // kWarps * (B + 1)
  int* s_pos = prefix + kWarps * (B + 1);  // W
  int* s_prev = s_pos + W;  // W
  int* s_act = s_prev + W;  // W
  float* s_score = reinterpret_cast<float*>(s_act + W);  // W
  float* s_theta = s_score + W;  // W
  uint8_t* s_node = reinterpret_cast<uint8_t*>(s_theta + W);  // n

  const float* pf = a.pf + b * 8;
  const int* pi = a.pi + b * 4;
  const float p_fail = pf[0], p_nfail = pf[1], p_lfail = pf[2];
  const float p_nrec = pf[3], p_lrec = pf[4], eps = pf[5], eps2 = pf[6],
              p_fork = pf[7];
  const int t = pi[0], byz_node = pi[1], pac_node = pi[2];
  const bool enabled = pi[3] > 0;
  const size_t bn = static_cast<size_t>(b) * n;
  const size_t bw = static_cast<size_t>(b) * W;

  // (1) topology: node crash / recovery, symmetrized link fail / recovery
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool up = a.node_up[bn + i];
    const bool crash = a.u_nfail[bn + i] < p_nfail;
    const bool recov = a.u_nrec[bn + i] < p_nrec;
    const bool sched = a.sched[bn + i];
    const bool nu = up ? !(crash || sched) : (recov && !sched);
    s_node[i] = nu;
    a.node_out[bn + i] = nu;
  }
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const size_t k = bn * D + e;
    a.edge_out[k] = a.edge_up[k] ? !(a.e_fail[k] < p_lfail) : (a.e_rec[k] < p_lrec);
  }
  __syncthreads();

  // (2) walk epilogue: resident kills, the masked rank-select hop and
  // the probabilistic failures, one thread per walk
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int p = a.pos[bw + w];
    bool act = a.active[bw + w] && s_node[p];
    const int deg = a.degs[p];
    const int* nb = a.nbrs + static_cast<size_t>(p) * D;
    const uint8_t* eu = a.edge_out + (bn + p) * D;
    int adeg = 0;
    for (int k = 0; k < D; ++k) {
      adeg += (k < deg) && eu[k] && s_node[p] && s_node[nb[k]];
    }
    const int idx = min(static_cast<int>(__fmul_rn(a.u_move[bw + w],
                                                   __int2float_rn(adeg))),
                        adeg - 1);
    int sel = 0, rank = -1;
    for (int k = 0; k < D; ++k) {
      const bool av = (k < deg) && eu[k] && s_node[p] && s_node[nb[k]];
      rank += av;
      if (av && rank == idx) {
        sel = k;
        break;
      }
    }
    if (act && adeg > 0) p = nb[sel];
    act = act && !(a.u_pfail[bw + w] < p_fail);
    s_pos[w] = p;
    s_act[w] = act;
  }
  __syncthreads();
  // bursts in order: kill the bsz lowest-scored active walks
  for (int kb = 0; kb < a.K; ++kb) {
    const float* u = a.u_burst + (bw * a.K) + static_cast<size_t>(kb) * W;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      s_score[w] = s_act[w] ? u[w] : INFINITY;
    }
    __syncthreads();
    const int size = a.bsz[b * a.K + kb];
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      int rank = 0;
      for (int j = 0; j < W; ++j) rank += s_score[w] > s_score[j];
      if (rank < size) s_act[w] = 0;
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
    s_prev[w] = a.ls[(bn + p) * C + a.track[bw + w]];
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
    if (act) atomicMax(&a.ls[row * C + a.track[bw + w]], t);
  }
  __syncthreads();

  // (4) theta at the walks' rows: node sum - 1/2, one warp per walk
  const int warp = threadIdx.x >> 5;
  for (int w = warp; w < W; w += kWarps) {
    const size_t row = bn + s_pos[w];
    const float s = node_sum_row(a.hist + row * B, a.ls + row * C, C, B, t,
                                 a.total[row], prefix + warp * (B + 1));
    if ((threadIdx.x & 31) == 0) {
      const float th = __fsub_rn(s, 0.5f);
      s_theta[w] = th;
      a.theta_out[bw + w] = th;
    }
  }
  __syncthreads();

  // (5) decisions: the lowest active slot at each node runs the protocol
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const bool act = s_act[w];
    bool chosen = act;
    for (int j = 0; j < w && chosen; ++j) {
      if (s_act[j] && s_pos[j] == s_pos[w]) chosen = false;
    }
    const float th = s_theta[w];
    const bool fork = chosen && th < eps && a.u_fork[bw + w] < p_fork && enabled;
    const bool term = a.plus && chosen && th > eps2 &&
                      a.u_term[bw + w] < p_fork && enabled && !fork;
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
  const size_t smem = (static_cast<size_t>(kWarps) * (B + 1) + 5 * W) * 4 + n;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(whole_round_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  whole_round_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
