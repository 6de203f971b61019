// Kernel #8: one ring phase of the BigCLAM gradient pass, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_fused.py
// `_grad_blocks_fused` (body `_grad_blocks_kernel`), which the ring schedule
// (bigclam_tpu/parallel/ring.py `make_ring_train_step`'s CSR step) runs once
// per (shard, phase) bucket. In phase r a shard holds the rotating shard
// (i + r) % dp; the bucket lists, for each of the shard's n rows, the
// neighbours that live in the rotating shard, by their row in it. Per node u
// (one warp), from zero:
//   gn_part = sum_v F_rot[v] / omp(F_u . F_rot[v]),   ln_part = sum_v ell
// and then once: gn[u] = gn[u] + gn_part, ln[u] = ln[u] + ln_part, the
// rounding order of the JAX ring's `gn_acc + gn`. No fold and no node tail:
// the ring adds those once after the whole rotation.
//
// What bounds it on this card: memory. The function needs ~4 float32
// operations per column per directed edge of the bucket; its bytes (F_u and
// the rotating rows read, the (n, K) accumulator read and written once per
// phase) take longer at the card's rates. The kernel is kernel B's pass
// (edge_common.cuh `grad_pass`, one warp per node over the bucket's CSR,
// sums in registers, no atomics) with the destination rows read from the
// rotating shard and the result added to the accumulator row. A node with no
// neighbour in the bucket leaves its accumulator row untouched, so a phase
// whose bucket is empty for most nodes costs little more than its indptr.
// The TPU kernel's blocked tiles, one-hot matmuls and DMA double buffer have
// no counterpart: the bucket is a CSR over the shard's rows.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ring_grad_phase_kernel(const float* __restrict__ F_loc,
                       const float* __restrict__ F_rot,
                       const int64_t* __restrict__ indptr,
                       const int* __restrict__ indices, int n, int K,
                       StepParams p, float* __restrict__ gn,
                       float* __restrict__ ln) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (u >= n || indptr[u] == indptr[u + 1]) return;  // whole warp
  float fu[KPL];
  bigclam::load_row<KPL>(F_loc, u, K, lane, fu);
  float part[KPL];
  const float llh =
      bigclam::grad_pass<KPL>(F_rot, indptr, indices, u, K, lane, fu, part, p);
  // the accumulator row is read and written by this warp only
  float* row = gn + static_cast<int64_t>(u) * K;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    if (k < K) row[k] = row[k] + part[i];
  }
  if (lane == 0) ln[u] = ln[u] + llh;
}

template <int KPL>
void launch(const float* F_loc, const float* F_rot, const int64_t* indptr,
            const int* indices, int n, int K, const StepParams& p, float* gn,
            float* ln, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ring_grad_phase_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      F_loc, F_rot, indptr, indices, n, K, p, gn, ln);
}

}  // namespace

// Launches kernel #8 on `stream` over one bucket of n rows; gn (n, K) and
// ln (n,) are accumulated in place. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for K outside [1, 1024]).
extern "C" int bigclam_ring_grad_phase(const float* F_loc, const float* F_rot,
                                       const int64_t* indptr,
                                       const int* indices, int n, int K,
                                       float omp_lo, float omp_hi, float* gn,
                                       float* ln, void* stream) {
  if (bigclam::kpl_bucket(K) == 0) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the survival clip bounds only: no ladder
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, 0, omp_lo, omp_hi, 0.f, 0.f);
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F_loc, F_rot, indptr, indices, n, K, p,
                       gn, ln, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
