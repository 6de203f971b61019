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
// phase) take longer at the card's rates. Every edge gathers one row of
// F_rot (4 KB at K=1,024): a balanced dp = 4 sweep at N=300,000 gathers
// 34.9 GB, ~49.6 GB with F_u and the accumulators, 14.8 ms at 3.35 TB/s if
// no gathered row is found in L2; read once per launch, the rows and the
// rest take 5.7 ms. Two things close that gap here:
//  * the visit order: warp w takes row order[w], a permutation of the
//    bucket's rows with an edge that parallel/ring.py computes from the
//    graph once, so that warps resident together gather the same rows and
//    find them in the 50 MB L2. The degree-balanced relabeling deals a
//    community's nodes over all shard positions, so in row order they do
//    not. The order changes which warps run together, never a node's sum,
//    so any order gives the same bits. Rows without an edge are not in it,
//    so no warp is spent on them. A null order visits all n rows in order;
//  * rows in flight: the warp stages the next kGradStages - 1 rows of its
//    neighbour list in shared memory by cp.async while it runs the
//    dependent warp_sum, transcendentals and axpy of the current one
//    (edge_common.cuh `staged_grad_pass`, which kernel B shares).
// Each dot and sum runs in neighbour order, so the results do not depend on
// the staging. A node with no neighbour in the bucket leaves its accumulator
// row untouched. The TPU kernel's blocked tiles, one-hot matmuls and DMA
// double buffer have no counterpart: the bucket is a CSR over the shard's
// rows.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kGradStages;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ring_grad_phase_kernel(const float* __restrict__ F_loc,
                       const float* __restrict__ F_rot,
                       const int64_t* __restrict__ indptr,
                       const int* __restrict__ indices,
                       const int* __restrict__ order, int m, int K,
                       StepParams p, bool vec, float* __restrict__ gn,
                       float* __restrict__ ln) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = blockIdx.x * kWarpsPerBlock + warp;
  if (w >= m) return;  // whole warp
  const int u = order ? __ldg(order + w) : w;
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  if (e0 == e1) return;
  float fu[KPL];
  bigclam::load_row<KPL>(F_loc, u, K, lane, fu);
  float part[KPL];
  const float llh = bigclam::staged_grad_pass<KPL>(
      F_rot, indices, e0, e1, K, lane, vec,
      reinterpret_cast<float*>(smem4) + warp * kGradStages * kWarp * KPL, fu,
      part, p);
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
            const int* indices, const int* order, int m, int K,
            const StepParams& p, bool vec, float* gn, float* ln,
            cudaStream_t stream, int& rc) {
  const int smem = bigclam::grad_smem_bytes(KPL);
  if (smem > bigclam::kSmemDefault) {
    rc = cudaFuncSetAttribute(ring_grad_phase_kernel<KPL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return;
  }
  // one block at least, so that every call launches (its warps exit at once
  // when m is 0)
  const int blocks = m > 0 ? (m + kWarpsPerBlock - 1) / kWarpsPerBlock : 1;
  ring_grad_phase_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      F_loc, F_rot, indptr, indices, order, m, K, p, vec, gn, ln);
}

}  // namespace

// Launches kernel #8 on `stream` over one bucket of n rows; gn (n, K) and
// ln (n,) are accumulated in place. `order` holds the m rows to visit (the
// bucket's rows with an edge, parallel/ring.py `visit_order`), or is null
// to visit all n rows in order. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024] or m outside [0, n]).
extern "C" int bigclam_ring_grad_phase(const float* F_loc, const float* F_rot,
                                       const int64_t* indptr,
                                       const int* indices, const int* order,
                                       int m, int n, int K, float omp_lo,
                                       float omp_hi, float* gn, float* ln,
                                       void* stream) {
  if (bigclam::kpl_bucket(K) == 0) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  if (order == nullptr) m = n;
  if (m < 0 || m > n) return cudaErrorInvalidValue;
  // the survival clip bounds only: no ladder
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, 0, omp_lo, omp_hi, 0.f, 0.f);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(F_rot) % 16 == 0;
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F_loc, F_rot, indptr, indices, order, m,
                       K, p, vec, gn, ln, static_cast<cudaStream_t>(stream),
                       rc);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
