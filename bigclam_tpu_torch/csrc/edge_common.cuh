// Shared device code of the BigCLAM edge kernels for Hopper: the
// single-pass ones (fused_superstep.cu, grad_llh.cu, candidates.cu), the
// ring-phase ones (ring_grad_phase.cu, ring_cand_phase.cu) and the
// K-blocked ones (edge_dots_kb.cu, grad_from_x.cu, cand_dots_kb.cu,
// cand_from_x.cu), which take a window of at most kMaxK columns of wider
// rows.
//
// Layout: the kernels read the graph's CSR directly. One warp owns one
// source node u; its neighbours are the contiguous slice
// indices[indptr[u], indptr[u+1]). Lane j holds the columns
// k = j, j+32, j+64, ... of the rows it touches (KPL = columns per lane,
// a compile-time bucket of ceil(K/32)), so every row load is 32
// consecutive floats per step: coalesced 128-byte transactions. Columns
// k >= K load as 0, so any K <= 1024 works, multiple of 32 or not.
//
// Every node's update reads only OLD rows (the JAX step is a Jacobi
// update), so nodes are independent: no atomics, and each node's sums run
// in neighbour order, which makes a run reproducible bit for bit.
//
// Numerics follow bigclam_tpu/ops/objective.py `edge_terms`:
// omp = clip(-expm1(-x), 1-max_p, 1-min_p), ell = log(omp) + x, with
// expm1f/logf and IEEE division (the build uses no --use_fast_math). The
// clip bounds, the 16 step sizes and alpha*eta come from the host as the
// float32-rounded values the JAX kernels see.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bigclam {

constexpr int kWarp = 32;
constexpr int kMaxS = 16;            // Armijo candidate slots
constexpr int kMaxK = 1024;          // 32 columns per lane
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// The scalars of one launch. Kernel B reads the survival clip bounds
// only; C adds the ladder and the projection; A also the acceptance
// coefficients. One block serves all three on purpose: with the block split
// per kernel, nvcc 12.9 hoisted the 16 x KPL candidate rows of pass 2 out
// of the neighbour loop into local memory, and kernels A and C ran 7x and
// 4.4x slower on an H100 at K=1000.
struct StepParams {
  float etas[kMaxS];    // step candidates (slots >= num_s are 0, unused)
  float coefs[kMaxS];   // float32(alpha * eta), as the fused JAX kernel rounds it
  float omp_lo;         // 1 - max_p
  float omp_hi;         // 1 - min_p
  float min_f;
  float max_f;
  int num_s;
};

// Columns-per-lane bucket for K, or 0 when K is outside [1, kMaxK].
inline int kpl_bucket(int K) {
  if (K < 1 || K > kMaxK) return 0;
  const int need = (K + kWarp - 1) / kWarp;
  int b = 1;
  while (b < need) b <<= 1;
  return b;
}

// The parameter block from host arrays of num_s floats (nullptr: zeros)
// and the scalars.
inline StepParams make_params(const float* etas, const float* coefs, int num_s,
                              float omp_lo, float omp_hi, float min_f,
                              float max_f) {
  StepParams p;
  for (int s = 0; s < kMaxS; ++s) {
    p.etas[s] = etas && s < num_s ? etas[s] : 0.f;
    p.coefs[s] = coefs && s < num_s ? coefs[s] : 0.f;
  }
  p.omp_lo = omp_lo;
  p.omp_hi = omp_hi;
  p.min_f = min_f;
  p.max_f = max_f;
  p.num_s = num_s;
  return p;
}

// Butterfly all-reduce: every lane ends with the same bits (each step adds
// the same two operands in both lanes of a pair).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Transposing reduction of 16 per-lane partials in 16 shuffles (8+4+2+1+1),
// instead of 16 separate 5-shuffle all-reduces: each step halves the values
// a lane keeps and doubles the lanes they are summed over. On return the
// warp total of candidate s = lane >> 1 is in the result (lanes 2s and 2s+1
// hold the same bits), so the per-candidate transcendentals that follow are
// spread over the lanes instead of repeated in every one.
__device__ __forceinline__ float reduce16_transpose(float (&v)[kMaxS], int lane) {
  {
    const bool up = lane & 16;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float send = up ? v[j] : v[j + 8];
      const float keep = up ? v[j + 8] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float send = up ? v[j] : v[j + 4];
      const float keep = up ? v[j + 4] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, 8);
    }
  }
  {
    const bool up = lane & 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float send = up ? v[j] : v[j + 2];
      const float keep = up ? v[j + 2] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, 4);
    }
  }
  {
    const bool up = lane & 2;
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// Step size and alpha*eta of candidate s (unrolled select: no dynamic
// indexing into the parameter block).
__device__ __forceinline__ void candidate_of(const StepParams& p, int s,
                                             float& eta, float& coef) {
  eta = 0.f;
  coef = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxS; ++j) {
    if (j == s) {
      eta = p.etas[j];
      coef = p.coefs[j];
    }
  }
}

__device__ __forceinline__ float survival(float x, const StepParams& p) {
  return fminf(fmaxf(-expm1f(-x), p.omp_lo), p.omp_hi);
}

__device__ __forceinline__ float clip_f(float v, const StepParams& p) {
  return fminf(fmaxf(v, p.min_f), p.max_f);
}

template <int KPL>
__device__ __forceinline__ void load_row(const float* __restrict__ M,
                                         int64_t row, int K, int lane,
                                         float (&r)[KPL]) {
  const float* p = M + row * static_cast<int64_t>(K);
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    r[i] = k < K ? __ldg(p + k) : 0.f;
  }
}

template <int KPL>
__device__ __forceinline__ void store_row(float* __restrict__ M, int64_t row,
                                          int K, int lane,
                                          const float (&r)[KPL]) {
  float* p = M + row * static_cast<int64_t>(K);
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    if (k < K) p[k] = r[i];
  }
}

// Column windows of the K-blocked kernels (edge_dots_kb.cu, grad_from_x.cu,
// cand_dots_kb.cu): lane j holds the columns col0 + j + 32 i of `row` in a
// matrix of row stride `stride`; window columns at or past kc load as 0 and
// are not stored.
template <int KPL>
__device__ __forceinline__ void load_window(const float* __restrict__ M,
                                            int64_t row, int64_t stride,
                                            int col0, int kc, int lane,
                                            float (&r)[KPL]) {
  const float* p = M + row * stride + col0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    r[i] = k < kc ? __ldg(p + k) : 0.f;
  }
}

template <int KPL>
__device__ __forceinline__ void store_window(float* __restrict__ M,
                                             int64_t row, int64_t stride,
                                             int col0, int kc, int lane,
                                             const float (&r)[KPL]) {
  float* p = M + row * stride + col0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    if (k < kc) p[k] = r[i];
  }
}

// The window arguments every K-blocked entry takes: a window of kc in
// [1, kMaxK] columns starting at col0 inside rows of k_pad columns.
inline bool window_ok(int k_pad, int col0, int kc) {
  return kc >= 1 && kc <= kMaxK && col0 >= 0 &&
         static_cast<int64_t>(col0) + kc <= k_pad;
}

// Calls body(v) for every neighbour v of u, in CSR order. The warp reads 32
// neighbour ids at once (one per lane) and broadcasts them by shuffle, so
// the row loads do not wait on a dependent index load per edge.
template <typename Body>
__device__ __forceinline__ void for_each_neighbor(
    const int64_t* __restrict__ indptr, const int* __restrict__ indices,
    int u, int lane, Body&& body) {
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  for (int64_t base = e0; base < e1; base += kWarp) {
    const int64_t rem = e1 - base;
    const int cnt = rem < kWarp ? static_cast<int>(rem) : kWarp;
    const int mine = lane < cnt ? __ldg(indices + base + lane) : 0;
    for (int j = 0; j < cnt; ++j) body(__shfl_sync(kFull, mine, j));
  }
}

// for_each_neighbor that also passes the edge's CSR position: body(e, v).
template <typename Body>
__device__ __forceinline__ void for_each_neighbor_at(
    const int64_t* __restrict__ indptr, const int* __restrict__ indices,
    int u, int lane, Body&& body) {
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  for (int64_t base = e0; base < e1; base += kWarp) {
    const int64_t rem = e1 - base;
    const int cnt = rem < kWarp ? static_cast<int>(rem) : kWarp;
    const int mine = lane < cnt ? __ldg(indices + base + lane) : 0;
    for (int j = 0; j < cnt; ++j) body(base + j, __shfl_sync(kFull, mine, j));
  }
}

// Pass 1: neighbour gradient sum_v F_v / omp(F_u.F_v) into acc, and the
// neighbour LLH sum_v ell (returned, the same in every lane). The
// neighbour rows F_v are rows of Fd, which the CSR's indices index: F
// itself on one device, the gathered F on a mesh's all-gather schedule,
// the rotating shard in a ring phase.
template <int KPL>
__device__ __forceinline__ float grad_pass(
    const float* __restrict__ Fd, const int64_t* __restrict__ indptr,
    const int* __restrict__ indices, int u, int K, int lane,
    const float (&fu)[KPL], float (&acc)[KPL], const StepParams& p) {
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = 0.f;
  float llh = 0.f;
  for_each_neighbor(indptr, indices, u, lane, [&](int v) {
    float fv[KPL];
    load_row<KPL>(Fd, v, K, lane, fv);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) part = fmaf(fu[i], fv[i], part);
    const float x = warp_sum(part);
    const float omp = survival(x, p);
    const float coeff = 1.0f / omp;
#pragma unroll
    for (int i = 0; i < KPL; ++i) acc[i] = fmaf(fv[i], coeff, acc[i]);
    llh += logf(omp) + x;
  });
  return llh;
}

// Fold: g <- nbr - sumF + F_u in place. Returns ||g||^2; `tail` gets the
// node tail -F_u.sumF + F_u.F_u.
template <int KPL>
__device__ __forceinline__ float fold_grad(const float* __restrict__ sumF,
                                           int K, int lane,
                                           const float (&fu)[KPL],
                                           float (&g)[KPL], float& tail) {
  float gg = 0.f, fs = 0.f, ff = 0.f;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    const float sf = k < K ? __ldg(sumF + k) : 0.f;
    g[i] = (g[i] - sf) + fu[i];
    gg = fmaf(g[i], g[i], gg);
    fs = fmaf(fu[i], sf, fs);
    ff = fmaf(fu[i], fu[i], ff);
  }
  tail = -warp_sum(fs) + warp_sum(ff);
  return warp_sum(gg);
}

// Armijo tails nf_s . (F_u - sumF), nf_s = clip(F_u + eta_s g_u): returns
// the tail of candidate lane >> 1.
template <int KPL>
__device__ __forceinline__ float armijo_tails(const float* __restrict__ sumF,
                                              int K, int lane,
                                              const float (&fu)[KPL],
                                              const float (&g)[KPL],
                                              const StepParams& p) {
  float part[kMaxS];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) part[s] = 0.f;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    const float fms = fu[i] - (k < K ? __ldg(sumF + k) : 0.f);
#pragma unroll
    for (int s = 0; s < kMaxS; ++s)
      part[s] = fmaf(clip_f(fmaf(p.etas[s], g[i], fu[i]), p), fms, part[s]);
  }
  return reduce16_transpose(part, lane);
}

// Pass 2: for every candidate s, sum_v ell(clip(F_u + eta_s g_u) . F_v)
// added to `cand` (the lane's candidate lane >> 1), with F_v a row of Fd as
// in grad_pass. The 16 candidate rows are recomputed per neighbour rather
// than held (16 x KPL registers).
template <int KPL>
__device__ __forceinline__ float cand_pass(
    const float* __restrict__ Fd, const int64_t* __restrict__ indptr,
    const int* __restrict__ indices, int u, int K, int lane,
    const float (&fu)[KPL], const float (&g)[KPL], const StepParams& p,
    float cand) {
  for_each_neighbor(indptr, indices, u, lane, [&](int v) {
    float fv[KPL];
    load_row<KPL>(Fd, v, K, lane, fv);
    float part[kMaxS];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) part[s] = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
#pragma unroll
      for (int s = 0; s < kMaxS; ++s)
        part[s] = fmaf(clip_f(fmaf(p.etas[s], g[i], fu[i]), p), fv[i], part[s]);
    }
    const float x = reduce16_transpose(part, lane);
    cand += logf(survival(x, p)) + x;
  });
  return cand;
}

}  // namespace bigclam

// The CUDA error text for the codes the C entries return. Every source of
// the library defines it weak, so the link keeps one copy.
extern "C" __attribute__((weak)) const char* bigclam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Instantiates LAUNCH<KPL>(args) for the bucket of K; sets `rc` to
// cudaErrorInvalidValue when K is out of range.
#define BIGCLAM_DISPATCH_KPL(K, LAUNCH, rc, ...)                     \
  switch (bigclam::kpl_bucket(K)) {                                  \
    case 1: LAUNCH<1>(__VA_ARGS__); break;                           \
    case 2: LAUNCH<2>(__VA_ARGS__); break;                           \
    case 4: LAUNCH<4>(__VA_ARGS__); break;                           \
    case 8: LAUNCH<8>(__VA_ARGS__); break;                           \
    case 16: LAUNCH<16>(__VA_ARGS__); break;                         \
    case 32: LAUNCH<32>(__VA_ARGS__); break;                         \
    default: rc = cudaErrorInvalidValue; break;                      \
  }
