// Kernel #9: one ring phase of the BigCLAM candidate pass, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_fused.py
// `_cand_blocks_fused` (body `_cand_blocks_kernel`), which the ring schedule
// (bigclam_tpu/parallel/ring.py `make_ring_train_step`'s CSR step) runs once
// per (shard, phase) bucket in its second rotation. Per node u (one warp) and
// step eta_s, with nf_s = clip(F_u + eta_s grad_u, min_f, max_f), from zero:
//   part_s = sum_{v in bucket(u)} ell(nf_s . F_rot[v])
// and then once: cb[s, u] = cb[s, u] + part_s. No Armijo tails (the TPU
// kernel's with_tails=False): each phase sees part of u's neighbours, and
// the tails are added once after the rotation.
//
// What bounds it on this card: arithmetic. The function needs one 2K dot
// per candidate and directed edge of the bucket (nf_s depends on u alone);
// its bytes (F_u, grad_u and the rotating rows read, the (S, n) accumulator
// read and written once) take less. The kernel is kernel C's pass
// (edge_common.cuh `cand_pass`: nf_s rebuilt per neighbour from F_u and
// grad_u in registers, the 16 per-edge dots reduced with one transposing
// butterfly, one lane pair per candidate) over the bucket's CSR with the
// destination rows read from the rotating shard. A node with no neighbour
// in the bucket leaves its accumulator column untouched.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ring_cand_phase_kernel(const float* __restrict__ F_loc,
                       const float* __restrict__ grad,
                       const float* __restrict__ F_rot,
                       const int64_t* __restrict__ indptr,
                       const int* __restrict__ indices, int n, int K,
                       StepParams p, float* __restrict__ cb) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (u >= n || indptr[u] == indptr[u + 1]) return;  // whole warp
  float fu[KPL], g[KPL];
  bigclam::load_row<KPL>(F_loc, u, K, lane, fu);
  bigclam::load_row<KPL>(grad, u, K, lane, g);
  const float part = bigclam::cand_pass<KPL>(F_rot, indptr, indices, u, K,
                                             lane, fu, g, p, 0.f);
  const int s = lane >> 1;
  if (s < p.num_s && (lane & 1) == 0) {
    const int64_t at = static_cast<int64_t>(s) * n + u;
    cb[at] = cb[at] + part;
  }
}

template <int KPL>
void launch(const float* F_loc, const float* grad, const float* F_rot,
            const int64_t* indptr, const int* indices, int n, int K,
            const StepParams& p, float* cb, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ring_cand_phase_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      F_loc, grad, F_rot, indptr, indices, n, K, p, cb);
}

}  // namespace

// Launches kernel #9 on `stream` over one bucket of n rows; cb (S, n) is
// accumulated in place. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024] or more than 16 steps).
// `etas` is a host array of num_s floats.
extern "C" int bigclam_ring_cand_phase(const float* F_loc, const float* grad,
                                       const float* F_rot,
                                       const int64_t* indptr,
                                       const int* indices, int n, int K,
                                       const float* etas, int num_s,
                                       float omp_lo, float omp_hi, float min_f,
                                       float max_f, float* cb, void* stream) {
  if (num_s < 1 || num_s > bigclam::kMaxS) return cudaErrorInvalidValue;
  if (bigclam::kpl_bucket(K) == 0) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the ladder without acceptance coefficients (selection runs in torch)
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F_loc, grad, F_rot, indptr, indices, n,
                       K, p, cb, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
