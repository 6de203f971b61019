// The node pass that ends a BigCLAM step on Hopper: neighbour candidate
// sums from the full candidate dots, the Armijo tails, the acceptance test
// and the selection, one node at a time.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_csr.py
// `cand_nbr_from_x_csr` (both K-blocked paths) and takes over the torch
// epilogue that followed it there (bigclam_tpu/ops/linesearch.py
// `armijo_update`, XLA in the JAX package). Three entries, one device code:
//
//  (a) bigclam_cand_from_x: the JAX function as it is, per step s and node u
//        out[s, u] = sum_{e in u's CSR slice} log(omp(xc[s, e])) + xc[s, e]
//      with omp = clip(-expm1(-x), 1-max_p, 1-min_p), no tails (the TP use
//      needs a psum over k before them). Output (S, n).
//  (b) bigclam_cand_select_from_x: per node u, from the full xc (S, E), F,
//      sumF, the folded gradient g and llh_nbr:
//        nbr_s    = (a)'s sum over u's slice
//        tail_s   = clip(F_u + eta_s g_u) . (F_u - sumF)
//        node_llh = llh_nbr + (-F_u.sumF + F_u.F_u)
//        ok_s     = nbr_s + tail_s >= node_llh + float32(alpha eta_s) ||g_u||^2
//                   (threshold rounded as kernel A rounds it)
//        F_new_u  = clip(F_u + eta* g_u) for the largest accepted eta*, or
//                   F_u when no step is accepted.
//      Outputs F_new (n, K), node_llh (n,), ok (S, n) 0/1 bytes, as kernel A
//      (fused_superstep.cu) returns them.
//  (c) bigclam_armijo_select: (b)'s epilogue with the neighbour sums given as
//      an (S, n) matrix and node_llh as an input (the ring and pallas_vmem
//      steps, whose neighbour terms come from #9 and #14). Outputs F_new and
//      ok. (b) and (c) are one kernel template, `node_pass_kernel<kNbr>`.
//
// What bounds it on this card: memory. Per node the function reads F_u and
// g_u once and writes F_new_u once, 12 bytes a column; its operations (16
// clipped candidate rows and their dots with F_u - sumF, about 6 per column
// and step) come to about 40% of that time at float32's rate; xc adds 64
// bytes an edge. At the repo's xl_k (n = 59,993, K = 3,000) that is 2.2 GB,
// 0.65 ms at 3.35 TB/s. The torch epilogue it replaces built two (n, K)
// temporaries for each of the 16 steps and read them back.
//
// Design. A group of G warps owns a node: G = 1 (a warp, 8 nodes a block)
// while the row fits 8 float4 a lane (K <= 1,024), else G = 8 (the block).
// Threads lie across the row's columns; with K % 4 == 0 and 16-byte aligned
// rows every load and store is a float4, else a float. A thread holds its
// columns of F_u and g_u in registers (VPT slots of 4 or 1 floats), and
// accumulates the 16 tail partials, ||g||^2, F.F and F.sumF over them. The
// warp reduces the 16 tails by one transposing butterfly (edge_common.cuh
// `reduce16_transpose`: lane 2s ends with step s's warp total) and the three
// dots by butterflies; with G = 8 the warps' partials meet in shared memory
// and every warp sums them in warp order, so all warps of the node hold the
// same bits. The neighbour sums read xc in sectors: a group of 8 lanes takes
// one step's slice, 8 consecutive edges at a time, and after a 3-step
// butterfly lane 2s receives step s's sum (4 passes of 4 steps in a warp;
// with G = 8 each warp takes one pass over half the slice). The decision
// runs once per warp, lane 2s for step s, and each thread then writes its
// columns of F_new from the registers it read them into. Rows longer than
// a block's 8 float4 a thread (K > 8,192) are walked in chunks and written
// from a second read of F_u and g_u, which L2 serves.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kFull;
using bigclam::kMaxS;
using bigclam::kWarp;

constexpr int kThreads = 256;                  // 8 warps a block
constexpr int kBlockWarps = kThreads / kWarp;
constexpr int kMaxVpt = 8;                     // register slots a thread
constexpr int kSectorLanes = 8;                // lanes reading one step's slice
constexpr int kStepsPerPass = kWarp / kSectorLanes;

// Where the node pass takes its neighbour candidate sums from.
enum class Nbr { kFromX, kGiven };

struct NodePass {
  const float* xc;          // kFromX: (S, e_total) full candidate dots
  int64_t e_total;
  const int64_t* indptr;    // kFromX: (n + 1,)
  const float* cand_nbr;    // kGiven: (S, n) neighbour candidate sums
  const float* llh;         // kFromX: llh_nbr (n,); kGiven: node_llh (n,)
  const float* F;           // (n, K)
  const float* grad;        // (n, K), folded
  const float* sumF;        // (K,)
  int n;
  int K;
  float* F_new;             // (n, K)
  float* node_llh;          // kFromX: (n,) output; kGiven: unused
  uint8_t* ok;              // (S, n)
};

// Step (lane >> 1)'s share of the neighbour candidate sums over u's slice
// [e0, e1), for warp `gw` of a group of G: a group of 8 lanes reads 8
// consecutive edges of one step's row at a time (one 32-byte sector), sums
// them by a 3-step butterfly, and lanes 2s and 2s+1 receive step s's sum.
// With G = 1 the warp runs all 4 passes of 4 steps over the whole slice;
// with G = 8 warp gw runs pass gw & 3 over half the slice (8-edge runs
// gw >> 2, stride 16). Steps at or past num_s read nothing and give 0.
template <int G>
__device__ __forceinline__ float nbr_sums(const float* __restrict__ xc,
                                          int64_t e_total, int64_t e0,
                                          int64_t e1, int gw, int lane,
                                          const StepParams& p) {
  // passes a warp runs, and their stride over the 4 passes
  constexpr int kPasses = G < kStepsPerPass ? kMaxS / kStepsPerPass : 1;
  constexpr int kPassStride = G < kStepsPerPass ? 1 : kStepsPerPass;
  constexpr int kEdgeWarps = G < kStepsPerPass ? 1 : G / kStepsPerPass;
  const int q0 = G < kStepsPerPass ? 0 : gw % kStepsPerPass;
  const int64_t first =
      e0 + kSectorLanes * (gw / kStepsPerPass) + (lane & (kSectorLanes - 1));
  const int grp = lane / kSectorLanes;
  const float* xs[kPasses];
  bool live[kPasses];
  float acc[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int s = kStepsPerPass * (q0 + i * kPassStride) + grp;
    live[i] = s < p.num_s;
    xs[i] = xc + static_cast<int64_t>(live[i] ? s : 0) * e_total;
    acc[i] = 0.f;
  }
  // the passes' loads of one edge go out together; each lane still sums
  // its edges in slice order
  for (int64_t e = first; e < e1; e += kSectorLanes * kEdgeWarps) {
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      if (live[i]) {
        const float x = __ldg(xs[i] + e);
        acc[i] += logf(bigclam::survival(x, p)) + x;
      }
    }
  }
  float nb = 0.f;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
#pragma unroll
    for (int o = kSectorLanes / 2; o > 0; o >>= 1)
      acc[i] += __shfl_xor_sync(kFull, acc[i], o);
    // lane L wants step L >> 1, held by group (L >> 1) & 3 in pass L >> 3
    const float v = __shfl_sync(kFull, acc[i], ((lane >> 1) & 3) * kSectorLanes);
    if ((lane >> 3) == q0 + i * kPassStride) nb = v;
  }
  return nb;
}

// Slots of VPT registers of W floats (W = 4: float4, else 1) of one row,
// thread t of a group of G warps taking slots base + v * G * 32 + t; slots
// at or past `slots` load 0.
template <int G, int VPT, int W>
__device__ __forceinline__ void load_slots(const float* __restrict__ row,
                                           int base, int slots, int t,
                                           float (&r)[VPT][W]) {
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = base + v * G * kWarp + t;
    if constexpr (W == 4) {
      const float4 q = j < slots ? __ldg(reinterpret_cast<const float4*>(row) + j)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      r[v][0] = q.x;
      r[v][1] = q.y;
      r[v][2] = q.z;
      r[v][3] = q.w;
    } else {
      r[v][0] = j < slots ? __ldg(row + j) : 0.f;
    }
  }
}

// F_new's slots of one chunk: clip(f + best * g) where a step is accepted,
// else f (the sum and product rounded apart, as torch's F + best * grad).
template <int G, int VPT, int W>
__device__ __forceinline__ void store_slots(float* __restrict__ row, int base,
                                            int slots, int t,
                                            const float (&f)[VPT][W],
                                            const float (&g)[VPT][W],
                                            bool accepted, float best,
                                            const StepParams& p) {
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = base + v * G * kWarp + t;
    if (j >= slots) continue;
    float o[W];
#pragma unroll
    for (int c = 0; c < W; ++c)
      o[c] = accepted ? bigclam::clip_f(__fadd_rn(f[v][c], __fmul_rn(best, g[v][c])), p)
                      : f[v][c];
    if constexpr (W == 4) {
      reinterpret_cast<float4*>(row)[j] = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      row[j] = o[0];
    }
  }
}

template <Nbr kNbr, int G, int VPT, int W>
__global__ void __launch_bounds__(kThreads)
node_pass_kernel(NodePass a, StepParams p) {
  constexpr int kNodesPerBlock = kBlockWarps / G;
  constexpr int kSpan = VPT * G * kWarp;       // slots a chunk
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int gw = warp % G;                      // warp in the node's group
  const int t = gw * kWarp + lane;              // thread in the group
  const int u = blockIdx.x * kNodesPerBlock + warp / G;
  if (G == 1 && u >= a.n) return;               // whole warp (G = 8: one node a block)
  const int slots = a.K / W;
  const int64_t row = static_cast<int64_t>(u) * a.K;
  const float* __restrict__ fu = a.F + row;
  const float* __restrict__ gu = a.grad + row;

  float part[kMaxS];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) part[s] = 0.f;
  float gg = 0.f, ff = 0.f, fs = 0.f;
  float f[VPT][W], g[VPT][W];
  for (int base = 0; base < slots; base += kSpan) {
    float sf[VPT][W];
    load_slots<G, VPT, W>(fu, base, slots, t, f);
    load_slots<G, VPT, W>(gu, base, slots, t, g);
    load_slots<G, VPT, W>(a.sumF, base, slots, t, sf);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const float fv = f[v][c], gv = g[v][c], fms = fv - sf[v][c];
        gg = fmaf(gv, gv, gg);
        ff = fmaf(fv, fv, ff);
        fs = fmaf(fv, sf[v][c], fs);
#pragma unroll
        for (int s = 0; s < kMaxS; ++s)
          part[s] = fmaf(bigclam::clip_f(fmaf(p.etas[s], gv, fv), p), fms, part[s]);
      }
    }
  }
  float tail = bigclam::reduce16_transpose(part, lane);  // step lane >> 1's
  gg = bigclam::warp_sum(gg);
  ff = bigclam::warp_sum(ff);
  fs = bigclam::warp_sum(fs);
  float nb = 0.f;
  if constexpr (kNbr == Nbr::kFromX)
    nb = nbr_sums<G>(a.xc, a.e_total, a.indptr[u], a.indptr[u + 1], gw, lane, p);

  if constexpr (G > 1) {
    // the group's warps' partials, summed in warp order by every warp
    __shared__ float red[G][2 * kMaxS + 4];
    if ((lane & 1) == 0) {
      red[gw][lane >> 1] = tail;
      red[gw][kMaxS + (lane >> 1)] = nb;
    }
    if (lane == 0) {
      red[gw][2 * kMaxS] = gg;
      red[gw][2 * kMaxS + 1] = ff;
      red[gw][2 * kMaxS + 2] = fs;
    }
    __syncthreads();
    tail = nb = gg = ff = fs = 0.f;
#pragma unroll
    for (int w = 0; w < G; ++w) {
      tail += red[w][lane >> 1];
      nb += red[w][kMaxS + (lane >> 1)];
      gg += red[w][2 * kMaxS];
      ff += red[w][2 * kMaxS + 1];
      fs += red[w][2 * kMaxS + 2];
    }
  }

  const int s = lane >> 1;  // this lane's step
  float eta, coef;
  bigclam::candidate_of(p, s, eta, coef);
  const bool live = s < p.num_s;
  float llh;
  if constexpr (kNbr == Nbr::kFromX) {
    llh = __ldg(a.llh + u) + (-fs + ff);  // llh_nbr + the node tail
  } else {
    llh = __ldg(a.llh + u);
    nb = live ? __ldg(a.cand_nbr + static_cast<int64_t>(s) * a.n + u) : 0.f;
  }
  const float cand = nb + tail;
  // threshold rounded as the fused JAX kernel does: llh + float32(alpha*eta) * gg
  const bool ok_s = live && cand >= __fadd_rn(llh, __fmul_rn(coef, gg));
  const bool accepted = __any_sync(kFull, ok_s);
  const float best = bigclam::warp_max(ok_s ? eta : 0.f);

  float* __restrict__ out = a.F_new + row;
  if (slots <= kSpan) {
    store_slots<G, VPT, W>(out, 0, slots, t, f, g, accepted, best, p);
  } else {
    for (int base = 0; base < slots; base += kSpan) {
      load_slots<G, VPT, W>(fu, base, slots, t, f);
      load_slots<G, VPT, W>(gu, base, slots, t, g);
      store_slots<G, VPT, W>(out, base, slots, t, f, g, accepted, best, p);
    }
  }
  if (gw == 0) {
    if constexpr (kNbr == Nbr::kFromX) {
      if (lane == 0) a.node_llh[u] = llh;
    }
    if (live && (lane & 1) == 0) a.ok[static_cast<int64_t>(s) * a.n + u] = ok_s ? 1 : 0;
  }
}

// (a): one warp per node, nbr_sums<1> over its slice.
__global__ void __launch_bounds__(kThreads)
cand_from_x_kernel(const float* __restrict__ xc, const int64_t* __restrict__ indptr,
                   int n, int64_t e_total, StepParams p, float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kBlockWarps + threadIdx.x / kWarp;
  if (u >= n) return;  // whole warp
  const float nb = nbr_sums<1>(xc, e_total, indptr[u], indptr[u + 1], 0, lane, p);
  const int s = lane >> 1;
  if (s < p.num_s && (lane & 1) == 0) out[static_cast<int64_t>(s) * n + u] = nb;
}

template <Nbr kNbr, int G, int VPT, int W>
void launch_one(const NodePass& a, const StepParams& p, cudaStream_t stream) {
  constexpr int kNodesPerBlock = kBlockWarps / G;
  const int blocks = (a.n + kNodesPerBlock - 1) / kNodesPerBlock;
  node_pass_kernel<kNbr, G, VPT, W><<<blocks, kThreads, 0, stream>>>(a, p);
}

// Register slots a thread for `need` slots in a warp a node: the smallest
// of 1, 2, 4, 8 that holds them.
inline int vpt_bucket(int need) {
  int b = 1;
  while (b < need && b < kMaxVpt) b <<= 1;
  return b;
}

template <Nbr kNbr, int W>
void launch_width(const NodePass& a, const StepParams& p, cudaStream_t stream) {
  const int slots = a.K / W;
  if (slots <= kMaxVpt * kWarp) {  // a warp a node
    switch (vpt_bucket((slots + kWarp - 1) / kWarp)) {
      case 1: launch_one<kNbr, 1, 1, W>(a, p, stream); break;
      case 2: launch_one<kNbr, 1, 2, W>(a, p, stream); break;
      case 4: launch_one<kNbr, 1, 4, W>(a, p, stream); break;
      default: launch_one<kNbr, 1, 8, W>(a, p, stream); break;
    }
    return;
  }
  // a block a node: 2, 3, 4 or 8 slots a thread (3: K = 3,072 in float4s
  // fills every slot, where 4 held 80 registers and 3 blocks an SM)
  const int need = (slots + kThreads - 1) / kThreads;
  if (need <= 2)
    launch_one<kNbr, kBlockWarps, 2, W>(a, p, stream);
  else if (need == 3)
    launch_one<kNbr, kBlockWarps, 3, W>(a, p, stream);
  else if (need == 4)
    launch_one<kNbr, kBlockWarps, 4, W>(a, p, stream);
  else
    launch_one<kNbr, kBlockWarps, 8, W>(a, p, stream);
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

template <Nbr kNbr>
int launch_node_pass(const NodePass& a, const StepParams& p, void* stream) {
  if (p.num_s < 1 || p.num_s > kMaxS || a.K < 1) return cudaErrorInvalidValue;
  if (a.n <= 0) return cudaSuccess;
  const bool vec = a.K % 4 == 0 && aligned16(a.F) && aligned16(a.grad) &&
                   aligned16(a.sumF) && aligned16(a.F_new);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    launch_width<kNbr, 4>(a, p, st);
  else
    launch_width<kNbr, 1>(a, p, st);
  return cudaGetLastError();
}

}  // namespace

// (a) Writes the neighbour candidate LLH (num_s, n) from xc (num_s,
// e_total) on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for more than 16 steps).
extern "C" int bigclam_cand_from_x(const float* xc, const int64_t* indptr,
                                   int n, int64_t e_total, int num_s,
                                   float omp_lo, float omp_hi, float* out,
                                   void* stream) {
  if (num_s < 1 || num_s > kMaxS) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the survival clip bounds only
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, num_s, omp_lo, omp_hi, 0.f, 0.f);
  const int blocks = (n + kBlockWarps - 1) / kBlockWarps;
  cand_from_x_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xc, indptr, n, e_total, p, out);
  return cudaGetLastError();
}

// (b) The node pass from the full candidate dots xc (num_s, e_total): writes
// F_new (n, K), node_llh (n,) and ok (num_s, n) on `stream`. F, grad (folded)
// and F_new are (n, K) with contiguous rows of K floats; `etas` and `coefs`
// are host arrays of num_s floats. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for K < 1 or num_s outside 1..16).
extern "C" int bigclam_cand_select_from_x(
    const float* xc, int64_t e_total, const int64_t* indptr, const float* F,
    const float* sumF, const float* grad, const float* llh_nbr, int n, int K,
    const float* etas, const float* coefs, int num_s, float omp_lo,
    float omp_hi, float min_f, float max_f, float* F_new, float* node_llh,
    uint8_t* ok, void* stream) {
  const NodePass a{xc, e_total, indptr, nullptr, llh_nbr, F, grad, sumF,
                   n, K, F_new, node_llh, ok};
  const StepParams p = bigclam::make_params(etas, coefs, num_s, omp_lo, omp_hi,
                                            min_f, max_f);
  return launch_node_pass<Nbr::kFromX>(a, p, stream);
}

// (c) The same epilogue from given neighbour candidate sums cand_nbr
// (num_s, n) and node_llh (n,): writes F_new (n, K) and ok (num_s, n) on
// `stream`. Returns as (b).
extern "C" int bigclam_armijo_select(const float* F, const float* sumF,
                                     const float* grad, const float* node_llh,
                                     const float* cand_nbr, int n, int K,
                                     const float* etas, const float* coefs,
                                     int num_s, float min_f, float max_f,
                                     float* F_new, uint8_t* ok, void* stream) {
  const NodePass a{nullptr, 0, nullptr, cand_nbr, node_llh, F, grad, sumF,
                   n, K, F_new, nullptr, ok};
  // no survival clip: the neighbour terms come in finished
  const StepParams p =
      bigclam::make_params(etas, coefs, num_s, 0.f, 0.f, min_f, max_f);
  return launch_node_pass<Nbr::kGiven>(a, p, stream);
}
