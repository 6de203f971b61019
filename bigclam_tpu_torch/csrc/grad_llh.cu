// Kernel B: per-node gradient and LLH of BigCLAM, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_csr.py `grad_llh_csr`
// (`_grad_blocks` / `_grad_kernel`), the first half of the split schedule
// (path `csr`). Per node u (one warp): over N(u), x = F_u.F_v, omp, ell;
// grad = sum_v F_v/omp - sumF + F_u and node_llh = sum_v ell - F_u.sumF +
// F_u.F_u. The TPU wrapper adds the -sumF + F fold and the node tail in XLA;
// here both are done in-kernel. Outputs: grad (n,K), node_llh (n,).
// Neighbour rows come from F_dst, the node's own row from F (the same
// tensor on one device; the gathered F on a mesh's all-gather schedule).
//
// What bounds it on this card: memory. The function needs ~4 float32
// operations per column per directed edge, and its bytes (F read once, grad
// written once) take longer than that at the card's rates. The kernel reads
// one 4 K-byte neighbour row per directed edge (34.9 GB at N=300,000,
// K=1,024, 8.5 M edges: 10.4 ms at 3.35 TB/s if L2 served none of them).
// Every node's sum runs in a warp's registers with no atomics and no
// gathered (E, K) buffer (the TPU path's `fd` gather is gone), and the
// neighbour rows are staged kGradStages - 1 edges ahead in shared memory
// by cp.async (edge_common.cuh `staged_grad_pass`, shared with ring kernel
// #8), so a warp keeps rows in flight while the dependent dot, warp_sum,
// transcendentals and axpy of the current edge run. On one card the
// graph's own id order is the locality order, so no visit order is taken:
// warps resident together gather the rows of neighbouring nodes, which L2
// holds. A node without an edge still gets its fold and tail
// (grad = F_u - sumF).
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kGradStages;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
grad_llh_kernel(const float* __restrict__ F, const float* __restrict__ F_dst,
                const float* __restrict__ sumF,
                const int64_t* __restrict__ indptr,
                const int* __restrict__ indices, int n, int K, StepParams p,
                bool vec, float* __restrict__ grad,
                float* __restrict__ node_llh) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + warp;
  if (u >= n) return;  // whole warp
  float fu[KPL];
  bigclam::load_row<KPL>(F, u, K, lane, fu);
  float g[KPL];
  const float llh_nbr = bigclam::staged_grad_pass<KPL>(
      F_dst, indices, indptr[u], indptr[u + 1], K, lane, vec,
      reinterpret_cast<float*>(smem4) + warp * kGradStages * kWarp * KPL, fu,
      g, p);
  float tail;
  bigclam::fold_grad<KPL>(sumF, K, lane, fu, g, tail);
  bigclam::store_row<KPL>(grad, u, K, lane, g);
  if (lane == 0) node_llh[u] = llh_nbr + tail;
}

template <int KPL>
void launch(const float* F, const float* F_dst, const float* sumF,
            const int64_t* indptr, const int* indices, int n, int K,
            const StepParams& p, bool vec, float* grad, float* node_llh,
            cudaStream_t stream) {
  constexpr int smem = bigclam::grad_smem_bytes(KPL);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  grad_llh_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      F, F_dst, sumF, indptr, indices, n, K, p, vec, grad, node_llh);
}

}  // namespace

// Launches kernel B on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024]).
extern "C" int bigclam_grad_llh(const float* F, const float* F_dst,
                                const float* sumF, const int64_t* indptr,
                                const int* indices,
                                int n, int K, float omp_lo, float omp_hi,
                                float* grad, float* node_llh, void* stream) {
  if (n <= 0) return cudaSuccess;
  // the survival clip bounds only: no ladder
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, 0, omp_lo, omp_hi, 0.f, 0.f);
  // 16-byte copies need every row of F_dst to start on 16 bytes
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(F_dst) % 16 == 0;
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F, F_dst, sumF, indptr, indices, n, K, p,
                       vec, grad, node_llh, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
