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
// is per-node work): about 300 GFLOP at N=300,000, K=1,000 and 8.5 M
// directed edges, the dots 272 of them, 4.5 ms at 67 TFLOP/s; its bytes,
// F, grad and the neighbour rows read once, take far less. The kernel is
// kernel A's second half as it stands (fused_superstep.cu): the tails
// nf_s . (F_u - sumF), reduced by one transposing butterfly so that lane 2s
// holds candidate s's tail, then edge_common.cuh `ladder_pass` over the
// neighbourhood: nf_s built once per (32-row tile, 32-column chunk) in
// shared memory from F_u and grad_u (read by __ldg), the neighbour rows
// staged by cp.async in a double buffer, and the 16 x 32 dots of a tile as
// a 4 x 4 register-blocked product with one fma per multiply-add. The 16 ladder sums (candidate 4 (lane >> 3) + c in
// the 8 lanes of a group) move to the tails' layout through 16 floats of
// shared memory. The earlier design rebuilt nf_s for every neighbour (an
// fma, a max and a min besides the dot's fma) from F_u and grad_u held in
// registers and walked one row at a time. One instantiation serves every K
// up to 1,024. ops/csr_kernels.py `ladder_launch_plan` gives the block's
// shared memory, which the entry checks. On an H100 (chip_smoke.py) C takes
// about 18 ms there, 4x its bound, where A's pass 2 alone takes about 24:
// C's block holds 45.5 KB of shared memory, so 5 blocks fit an SM, A's
// 60.5 KB 3. Trial builds with F_u staged in shared memory as A does (3
// blocks an SM) or with the ladder's row groups each took about 23 ms.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kMaxS;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
candidates_kernel(const float* __restrict__ F, const float* __restrict__ F_dst,
                  const float* __restrict__ grad,
                  const float* __restrict__ sumF,
                  const int64_t* __restrict__ indptr,
                  const int* __restrict__ indices, int n, int K, StepParams p,
                  bool vec, float* __restrict__ cand_out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + warp;
  if (u >= n) return;  // whole warp
  float* const ladder = reinterpret_cast<float*>(smem4) +
                        warp * (bigclam::kLadderFloats + kMaxS);
  float* const sums = ladder + bigclam::kLadderFloats;
  const int64_t row = static_cast<int64_t>(u) * K;
  const float* const fu = F + row;
  const float* const gu = grad + row;

  // Armijo tails: candidate lane >> 1's in the result
  float tail;
  {
    float part[kMaxS];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) part[s] = 0.f;
    for (int k = lane; k < K; k += kWarp) {
      const float f = __ldg(fu + k);
      const float g = __ldg(gu + k);
      const float fms = f - __ldg(sumF + k);
#pragma unroll
      for (int s = 0; s < kMaxS; ++s)
        part[s] = fmaf(bigclam::clip_f(fmaf(p.etas[s], g, f), p), fms, part[s]);
    }
    tail = bigclam::reduce16_transpose(part, lane);
  }

  float out[4];
  bigclam::ladder_pass<false>(
      F_dst, indptr, indices, u, K, lane, vec, p, ladder,
      [&](int k, float& f, float& g) {
        f = __ldg(fu + k);
        g = __ldg(gu + k);
      },
      out);
  if ((lane & 7) == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sums[4 * (lane >> 3) + c] = out[c];
  }
  __syncwarp();
  const int s = lane >> 1;  // this lane's candidate
  if (s < p.num_s && (lane & 1) == 0)
    cand_out[static_cast<int64_t>(s) * n + u] = tail + sums[s];
}

}  // namespace

// Launches kernel C on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024], more than 16 steps, or a
// smem_bytes other than the block's shared memory, which ops/csr_kernels.py
// `ladder_launch_plan` computes). `etas` is a host array of num_s floats.
extern "C" int bigclam_candidates(const float* F, const float* F_dst,
                                  const float* grad,
                                  const float* sumF, const int64_t* indptr,
                                  const int* indices, int n, int K,
                                  const float* etas, int num_s, float omp_lo,
                                  float omp_hi, float min_f, float max_f,
                                  float* cand, int smem_bytes, void* stream) {
  if (num_s < 1 || num_s > kMaxS) return cudaErrorInvalidValue;
  if (bigclam::kpl_bucket(K) == 0) return cudaErrorInvalidValue;
  if (smem_bytes != bigclam::candidates_smem_bytes()) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the ladder without acceptance coefficients (selection runs in torch)
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(F_dst) % 16 == 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  candidates_kernel<<<blocks, kWarpsPerBlock * kWarp, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      F, F_dst, grad, sumF, indptr, indices, n, K, p, vec, cand);
  return cudaGetLastError();
}
