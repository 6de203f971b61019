// Kernel A: the whole BigCLAM edge superstep in one launch, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_fused.py
// `fused_superstep_csr` (body `_superstep_kernel`). Per node u (one warp):
//   pass 1  over N(u): x = F_u.F_v, omp, ell; grad_nbr += F_v/omp, llh += ell
//   fold    g = grad_nbr - sumF + F_u; llh += -F_u.sumF + F_u.F_u
//   tails   cand_s = clip(F_u + eta_s g) . (F_u - sumF)
//   pass 2  over N(u): cand_s += ell(clip(F_u + eta_s g) . F_v) for all 16 s
//   select  ok_s = cand_s >= llh + alpha eta_s ||g||^2 (float32, the fused
//           kernel's rounding); F_new = clip(F_u + max accepted eta * g), or
//           F_u when nothing is accepted.
// Outputs: F_new (n,K), grad (n,K), node_llh (n,), ok (S,n) 0/1 bytes.
// Neighbour rows come from F_dst and the node's own row from F: on one
// device both are the same tensor; on a mesh's all-gather schedule F holds
// the shard's n rows and F_dst the gathered F of every shard, which the
// CSR's global destination ids index (the TPU kernel's F_gather).
//
// What bounds it on this card: arithmetic. The function needs, per directed
// edge, the 2K-operation dot and 2K gradient fma, and per candidate one 2K
// dot of nf_s with F_v (nf_s = clip(F_u + eta_s g) depends on u alone); per
// node, the fold, tails and selection. Its bytes are F read once and the
// outputs written once, far below that. The kernel does more than the
// function needs: it rebuilds nf_s for every neighbour (step fma and clip,
// 3x the needed operations per edge and candidate) rather than hold 16 x K
// of it in registers, and re-reads each neighbour row in pass 2 (L2 catches
// part of that). Everything per node lives in registers (F_u, g_u, the row
// in flight, 16 candidate partials), and the 16 per-edge candidate dots
// are reduced with one transposing butterfly so that each lane then
// evaluates one candidate's expm1/log. The TPU kernel's blocked tiles,
// one-hot MXU matmuls and DMA double buffer have no counterpart here: the
// CSR is read directly and nothing is scattered.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kFull;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
fused_superstep_kernel(const float* __restrict__ F,
                       const float* __restrict__ F_dst,
                       const float* __restrict__ sumF,
                       const int64_t* __restrict__ indptr,
                       const int* __restrict__ indices, int n, int K,
                       StepParams p, float* __restrict__ F_new,
                       float* __restrict__ grad, float* __restrict__ node_llh,
                       uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (u >= n) return;  // whole warp
  float fu[KPL];
  bigclam::load_row<KPL>(F, u, K, lane, fu);
  float g[KPL];
  const float llh_nbr =
      bigclam::grad_pass<KPL>(F_dst, indptr, indices, u, K, lane, fu, g, p);
  float tail;
  const float gg = bigclam::fold_grad<KPL>(sumF, K, lane, fu, g, tail);
  const float llh = llh_nbr + tail;
  float cand = bigclam::armijo_tails<KPL>(sumF, K, lane, fu, g, p);
  cand = bigclam::cand_pass<KPL>(F_dst, indptr, indices, u, K, lane, fu, g, p,
                                cand);

  const int s = lane >> 1;  // this lane's candidate
  float eta, coef;
  bigclam::candidate_of(p, s, eta, coef);
  const bool live = s < p.num_s;
  // threshold rounded as the JAX kernel does: llh + float32(alpha*eta) * gg
  const bool ok_s = live && cand >= __fadd_rn(llh, __fmul_rn(coef, gg));
  const bool accepted = __any_sync(kFull, ok_s);
  const float best = bigclam::warp_max(ok_s ? eta : 0.f);
  float fn[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i)
    fn[i] = accepted ? bigclam::clip_f(__fadd_rn(fu[i], __fmul_rn(best, g[i])), p)
                     : fu[i];
  bigclam::store_row<KPL>(F_new, u, K, lane, fn);
  bigclam::store_row<KPL>(grad, u, K, lane, g);
  if (lane == 0) node_llh[u] = llh;
  if (live && (lane & 1) == 0)
    ok[static_cast<int64_t>(s) * n + u] = ok_s ? 1 : 0;
}

template <int KPL>
void launch(const float* F, const float* F_dst, const float* sumF,
            const int64_t* indptr, const int* indices, int n, int K,
            const StepParams& p, float* F_new, float* grad, float* node_llh,
            uint8_t* ok, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_superstep_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      F, F_dst, sumF, indptr, indices, n, K, p, F_new, grad, node_llh, ok);
}

}  // namespace

// Launches kernel A on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024] or more than 16 steps).
// `etas` and `coefs` are host arrays of num_s floats.
extern "C" int bigclam_fused_superstep(
    const float* F, const float* F_dst, const float* sumF, const int64_t* indptr,
    const int* indices, int n, int K, const float* etas, const float* coefs,
    int num_s, float omp_lo, float omp_hi, float min_f, float max_f,
    float* F_new, float* grad, float* node_llh, uint8_t* ok, void* stream) {
  if (num_s < 1 || num_s > bigclam::kMaxS) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const StepParams p = bigclam::make_params(etas, coefs, num_s, omp_lo, omp_hi,
                                            min_f, max_f);
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F, F_dst, sumF, indptr, indices, n, K, p,
                       F_new, grad, node_llh, ok,
                       static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
