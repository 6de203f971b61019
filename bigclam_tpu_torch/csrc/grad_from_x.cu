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
//   grad[u, win] = sum_e F_v[win] / omp_e  (- sumF[win] + F_u[win] with fold)
//   llh_nbr[u] = sum_e ell_e
// The window's columns go to grad_kb, row u at grad_kb + u * ld_grad: a
// window of the step's (n, k_pad) gradient written in place, or an (n, kc)
// matrix. llh_nbr does not depend on the window (the JAX passes keep the
// copy of block 0): the entry writes it only when it is given a pointer for
// it, which the wrapper does for col0 == 0.
//
// What bounds it on this card: memory. The function reads the window of F
// and writes the gradient window once (2 operations per column per edge).
// The gradient is a gather, so warp u must see F_v for every one of its
// edges: one neighbour window per directed edge, 5.30 GB a step at the
// repo's xl_k, which L2 serves in part. The design keeps those rows in
// flight: the windows are staged two edges ahead in the warp's
// shared-memory ring by cp.async (edge_common.cuh `window_walk`, kernel
// B's walk with a row stride), so the axpy of one edge runs while the next
// rows arrive. Lane j loads x of the batch's edge j and evaluates its
// expm1/log/division once per batch of 32 edges; the warp broadcasts the
// coefficient by shuffle. Every column's sum runs over the edges in CSR
// order with the same fmaf as a pass over rows in registers, so the
// outputs are the same bits.
//
// A mesh adds two inputs. The destination ids index `Fd` (F on one card,
// the all-gathered F on the all-gather schedule, the rotating shard in a
// ring phase), and with `accumulate` the kernel adds the window's sums to
// what grad_kb and llh_nbr hold, the ring's sum over its phases. The phase's
// sum is formed from zero first and then added once, so the result is that
// of a pass into a scratch and an add, without the scratch.
//
// On an H100 (chip_smoke.py) a step of the 3 windows at xl_k takes 0.92-0.96
// ms (rows loaded into registers one at a time: 1.26), and 2.10 ms on the
// same graph with shuffled ids (2.63). The gather has no pair to share, so
// a trial read the neighbours inside the block's tile of 16 consecutive
// nodes from the tile staged in shared memory: 1.33 and 2.16 ms, as its 112
// KB a block halved the resident warps.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kFull;
using bigclam::kGradStages;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
grad_from_x_kernel(const float* __restrict__ x, const float* __restrict__ F,
                   const float* __restrict__ Fd,
                   const float* __restrict__ sumF,
                   const int64_t* __restrict__ indptr,
                   const int* __restrict__ indices, int n, int k_pad,
                   int col0, int kc, StepParams p, int fold, int accumulate,
                   bool vec, float* __restrict__ grad_kb, int ld_grad,
                   float* __restrict__ llh_nbr) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + warp;
  if (u >= n) return;  // whole warp
  float acc[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = 0.f;
  float llh = 0.f;
  float coeff = 0.f, ell = 0.f;  // lane j: of the batch's edge j
  const int64_t e1 = indptr[u + 1];
  bigclam::window_walk<KPL>(
      Fd + col0, indices, indptr[u], e1, kc, k_pad, lane, vec,
      reinterpret_cast<float*>(smem4) + warp * kGradStages * kWarp * KPL,
      [&](int64_t e, int j, const float (&fv)[KPL]) {
        if (j == 0) {  // the batch's terms, lane j's from x of its edge j
          const float xe = e + lane < e1 ? __ldg(x + e + lane) : 0.f;
          const float omp = bigclam::survival(xe, p);
          coeff = 1.0f / omp;
          ell = logf(omp) + xe;
        }
        const float c = __shfl_sync(kFull, coeff, j);
#pragma unroll
        for (int i = 0; i < KPL; ++i) acc[i] = fmaf(fv[i], c, acc[i]);
        llh += __shfl_sync(kFull, ell, j);
      });
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
  float* const gu = grad_kb + static_cast<int64_t>(u) * ld_grad;
  if (accumulate) {
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int k = lane + kWarp * i;
      if (k < kc) acc[i] = gu[k] + acc[i];
    }
  }
  bigclam::store_window<KPL>(grad_kb, u, ld_grad, 0, kc, lane, acc);
  if (llh_nbr != nullptr && lane == 0)
    llh_nbr[u] = accumulate ? llh_nbr[u] + llh : llh;
}

template <int KPL>
void launch(const float* x, const float* F, const float* Fd,
            const float* sumF, const int64_t* indptr, const int* indices,
            int n, int k_pad, int col0, int kc, const StepParams& p, int fold,
            int accumulate, bool vec,
            float* grad_kb, int ld_grad, float* llh_nbr, cudaStream_t stream) {
  constexpr int smem = bigclam::grad_smem_bytes(KPL);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  grad_from_x_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      x, F, Fd, sumF, indptr, indices, n, k_pad, col0, kc, p, fold, accumulate,
      vec, grad_kb, ld_grad, llh_nbr);
}

}  // namespace

// Writes gradient window [col0, col0 + kc) of every node into grad_kb (row
// u at grad_kb + u * ld_grad, ld_grad >= kc) on `stream`, the neighbour
// rows from Fd (F when null), folded with -sumF + F when `fold` is
// non-zero, and the neighbour LLH into llh_nbr (n,) unless it is null; with
// `accumulate` non-zero both are added to what they hold (fold must then be
// 0). Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a window outside the rows or wider than 1024 columns, ld_grad < kc,
// or fold with accumulate).
extern "C" int bigclam_grad_from_x(const float* x, const float* F,
                                   const float* Fd, const float* sumF,
                                   const int64_t* indptr, const int* indices,
                                   int n, int k_pad, int col0, int kc,
                                   float omp_lo, float omp_hi, int fold,
                                   int accumulate, float* grad_kb, int ld_grad,
                                   float* llh_nbr, void* stream) {
  if (!bigclam::window_ok(k_pad, col0, kc)) return cudaErrorInvalidValue;
  if (ld_grad < kc) return cudaErrorInvalidValue;
  if (fold && accumulate) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  if (Fd == nullptr) Fd = F;
  // the survival clip bounds only: no ladder
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, 0, omp_lo, omp_hi, 0.f, 0.f);
  const bool vec = kc % 4 == 0 && k_pad % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(Fd + col0) % 16 == 0;
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(kc, launch, rc, x, F, Fd, sumF, indptr, indices, n,
                       k_pad, col0, kc, p, fold, accumulate, vec, grad_kb,
                       ld_grad, llh_nbr, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
