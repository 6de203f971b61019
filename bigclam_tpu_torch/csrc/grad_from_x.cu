// K-blocked gradient of BigCLAM from the full edge dots, for Hopper: one
// column window of every node's gradient, and the neighbour LLH.
//
// Replaces two TPU kernels that compute the same function:
// bigclam_tpu/ops/pallas_fused.py `grad_nbr_from_x_fused` (path
// csr_fused_kb, with the -sumF + F fold in-kernel) and
// bigclam_tpu/ops/pallas_csr.py `grad_nbr_from_x_csr` (path csr_grouped_kb,
// no fold: the caller folds in torch). Per node u (one warp), from the FULL
// dots x (edge_dots_kb over every window):
//   omp_e = clip(-expm1(-x[e])), ell_e = log(omp_e) + x[e]
//   grad_kb[u] = sum_e F_v[win] / omp_e  (- sumF[win] + F_u[win] with fold)
//   llh_nbr[u] = sum_e ell_e
// grad_kb is (n, kc), the window's columns. llh_nbr does not depend on the
// window (the JAX passes keep the copy of block 0): the entry writes it only
// when it is given a pointer for it, which the wrapper does for col0 == 0.
//
// What bounds it on this card: memory. The function reads the window of F
// and writes the gradient window once (2 operations per column per edge).
// The kernel reads one neighbour row window per directed edge, which L2
// serves in part. Lane j loads x of the batch's edge j and evaluates its
// expm1/log/division once; the warp then broadcasts the coefficient by
// shuffle, so the transcendentals are not repeated in every lane.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kFull;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
grad_from_x_kernel(const float* __restrict__ x, const float* __restrict__ F,
                   const float* __restrict__ sumF,
                   const int64_t* __restrict__ indptr,
                   const int* __restrict__ indices, int n, int64_t k_pad,
                   int col0, int kc, StepParams p, int fold,
                   float* __restrict__ grad_kb,
                   float* __restrict__ llh_nbr) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (u >= n) return;  // whole warp
  float acc[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = 0.f;
  float llh = 0.f;
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  for (int64_t base = e0; base < e1; base += kWarp) {
    const int64_t rem = e1 - base;
    const int cnt = rem < kWarp ? static_cast<int>(rem) : kWarp;
    const int mine = lane < cnt ? __ldg(indices + base + lane) : 0;
    const float xe = lane < cnt ? __ldg(x + base + lane) : 0.f;
    const float omp = bigclam::survival(xe, p);
    const float coeff = 1.0f / omp;
    const float ell = logf(omp) + xe;
    for (int j = 0; j < cnt; ++j) {
      const int v = __shfl_sync(kFull, mine, j);
      const float c = __shfl_sync(kFull, coeff, j);
      float fv[KPL];
      bigclam::load_window<KPL>(F, v, k_pad, col0, kc, lane, fv);
#pragma unroll
      for (int i = 0; i < KPL; ++i) acc[i] = fmaf(fv[i], c, acc[i]);
      llh += __shfl_sync(kFull, ell, j);
    }
  }
  if (fold) {
    float fu[KPL];
    bigclam::load_window<KPL>(F, u, k_pad, col0, kc, lane, fu);
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int k = lane + kWarp * i;
      const float sf = k < kc ? __ldg(sumF + col0 + k) : 0.f;
      acc[i] = (acc[i] - sf) + fu[i];
    }
  }
  bigclam::store_window<KPL>(grad_kb, u, kc, 0, kc, lane, acc);
  if (llh_nbr != nullptr && lane == 0) llh_nbr[u] = llh;
}

template <int KPL>
void launch(const float* x, const float* F, const float* sumF,
            const int64_t* indptr, const int* indices, int n, int64_t k_pad,
            int col0, int kc, const StepParams& p, int fold, float* grad_kb,
            float* llh_nbr, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  grad_from_x_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      x, F, sumF, indptr, indices, n, k_pad, col0, kc, p, fold, grad_kb,
      llh_nbr);
}

}  // namespace

// Writes gradient window [col0, col0 + kc) of every node into grad_kb
// (n, kc) on `stream`, folded with -sumF + F when `fold` is non-zero, and
// the neighbour LLH into llh_nbr (n,) unless it is null; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a window
// outside the rows or wider than 1024 columns).
extern "C" int bigclam_grad_from_x(const float* x, const float* F,
                                   const float* sumF, const int64_t* indptr,
                                   const int* indices, int n, int k_pad,
                                   int col0, int kc, float omp_lo,
                                   float omp_hi, int fold, float* grad_kb,
                                   float* llh_nbr, void* stream) {
  if (!bigclam::window_ok(k_pad, col0, kc)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the survival clip bounds only: no ladder
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, 0, omp_lo, omp_hi, 0.f, 0.f);
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(kc, launch, rc, x, F, sumF, indptr, indices, n, k_pad,
                       col0, kc, p, fold, grad_kb, llh_nbr,
                       static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
