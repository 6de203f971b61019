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
// What bounds it on this card. A sweep of the 16 buckets at N=300,000,
// K=1,024 needs about 272 GFLOP (S(2K + 2) per directed edge: 4.1 ms at
// 67 TFLOP/s) and gathers one 4 KB row of the rotating shard per edge
// (34.8 GB; kernel #8 gathers the same rows in about 11 ms on the
// unbalanced layout and 21 ms on the balanced one). The kernel is
// edge_common.cuh `ladder_pass` over the bucket's CSR: nf_s built once per
// (tile, column chunk) in shared memory from F_u and grad_u, the rotating
// rows staged by cp.async in a double buffer, the dots as a 4 x 4
// register-blocked product with one fma per multiply-add, each lane
// evaluating its own dots' terms, and only the row groups of a tile that
// hold an edge multiplied: on the balanced layout a node has about 7 edges
// in a bucket. The gather alone does not set its pace (see there). The
// earlier design (kernel C's `cand_pass`) rebuilt nf_s per neighbour from
// 64 registers of F_u and grad_u (168 registers) and walked one row at a
// time. The pass is not templated on K: one
// instantiation serves every K up to 1,024. A node with no neighbour in the
// bucket leaves its accumulator column untouched.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ring_cand_phase_kernel(const float* __restrict__ F_loc,
                       const float* __restrict__ grad,
                       const float* __restrict__ F_rot,
                       const int64_t* __restrict__ indptr,
                       const int* __restrict__ indices, int n, int K,
                       StepParams p, bool vec, float* __restrict__ cb) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + warp;
  if (u >= n || indptr[u] == indptr[u + 1]) return;  // whole warp
  const float* const fu = F_loc + static_cast<int64_t>(u) * K;
  const float* const gu = grad + static_cast<int64_t>(u) * K;
  float out[4];
  bigclam::ladder_pass<true>(
      F_rot, indptr, indices, u, K, lane, vec, p,
      reinterpret_cast<float*>(smem4) + warp * bigclam::kLadderFloats,
      [&](int k, float& f, float& g) {
        f = __ldg(fu + k);
        g = __ldg(gu + k);
      },
      out);
  if ((lane & 7) == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = 4 * (lane >> 3) + c;
      if (s < p.num_s) {
        const int64_t at = static_cast<int64_t>(s) * n + u;
        cb[at] = cb[at] + out[c];
      }
    }
  }
}

}  // namespace

// Launches kernel #9 on `stream` over one bucket of n rows; cb (S, n) is
// accumulated in place. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024], more than 16 steps, or a
// smem_bytes other than the block's shared memory, which ops/csr_kernels.py
// `ladder_launch_plan` computes). `etas` is a host array of num_s floats.
extern "C" int bigclam_ring_cand_phase(const float* F_loc, const float* grad,
                                       const float* F_rot,
                                       const int64_t* indptr,
                                       const int* indices, int n, int K,
                                       const float* etas, int num_s,
                                       float omp_lo, float omp_hi, float min_f,
                                       float max_f, float* cb, int smem_bytes,
                                       void* stream) {
  if (num_s < 1 || num_s > bigclam::kMaxS) return cudaErrorInvalidValue;
  if (bigclam::kpl_bucket(K) == 0) return cudaErrorInvalidValue;
  if (smem_bytes != bigclam::ring_cand_smem_bytes()) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the ladder without acceptance coefficients (selection runs in torch)
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(F_rot) % 16 == 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ring_cand_phase_kernel<<<blocks, kWarpsPerBlock * kWarp, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      F_loc, grad, F_rot, indptr, indices, n, K, p, vec, cb);
  return cudaGetLastError();
}
