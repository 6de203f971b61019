// Kernel C: the Armijo candidate LLH of BigCLAM for all 16 steps, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_csr.py `candidates_csr`
// (`_cand_blocks` / `_cand_kernel`), the second half of the split schedule
// (path `csr`). Per node u (one warp), for every step eta_s with
// nf_s = clip(F_u + eta_s grad_u, min_f, max_f):
//   cand_s = nf_s . (F_u - sumF) + sum_{v in N(u)} ell(nf_s . F_v)
// i.e. the neighbour terms seeded with the Armijo tails, the FULL candidate
// LLH that armijo_select consumes. Output: cand (S, n). Neighbour rows F_v
// come from F_dst, the node's own row from F (the same tensor on one
// device; the gathered F on a mesh's all-gather schedule).
//
// What bounds it on this card: arithmetic. The function needs one 2K dot
// per candidate and directed edge (nf_s depends on u alone, so building it
// is per-node work); its bytes, F and grad read once, take far less. The
// kernel rebuilds nf_s per neighbour (step fma and clip, 3x the needed
// operations) from F_u and grad_u held in registers rather than hold 16 x K
// of it, and reduces the 16 per-edge dots with one transposing butterfly,
// after which each lane evaluates one candidate's expm1/log.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
candidates_kernel(const float* __restrict__ F, const float* __restrict__ F_dst,
                  const float* __restrict__ grad,
                  const float* __restrict__ sumF,
                  const int64_t* __restrict__ indptr,
                  const int* __restrict__ indices, int n, int K, StepParams p,
                  float* __restrict__ cand_out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (u >= n) return;  // whole warp
  float fu[KPL], g[KPL];
  bigclam::load_row<KPL>(F, u, K, lane, fu);
  bigclam::load_row<KPL>(grad, u, K, lane, g);
  float cand = bigclam::armijo_tails<KPL>(sumF, K, lane, fu, g, p);
  cand = bigclam::cand_pass<KPL>(F_dst, indptr, indices, u, K, lane, fu, g, p,
                                cand);
  const int s = lane >> 1;
  if (s < p.num_s && (lane & 1) == 0)
    cand_out[static_cast<int64_t>(s) * n + u] = cand;
}

template <int KPL>
void launch(const float* F, const float* F_dst, const float* grad,
            const float* sumF, const int64_t* indptr, const int* indices, int n,
            int K, const StepParams& p, float* cand, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  candidates_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      F, F_dst, grad, sumF, indptr, indices, n, K, p, cand);
}

}  // namespace

// Launches kernel C on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024] or more than 16 steps).
// `etas` is a host array of num_s floats.
extern "C" int bigclam_candidates(const float* F, const float* F_dst,
                                  const float* grad,
                                  const float* sumF, const int64_t* indptr,
                                  const int* indices, int n, int K,
                                  const float* etas, int num_s, float omp_lo,
                                  float omp_hi, float min_f, float max_f,
                                  float* cand, void* stream) {
  if (num_s < 1 || num_s > bigclam::kMaxS) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the ladder without acceptance coefficients (selection runs in torch)
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F, F_dst, grad, sumF, indptr, indices, n,
                       K, p, cand, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
