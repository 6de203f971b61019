// The candidate LLH edge terms of BigCLAM's non-CSR step, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_kernels.py
// `candidate_edge_terms` (path `pallas_vmem`). For every edge e = (u, v) of
// a chunk and every step eta_s, with nf_s = clip(F_u + eta_s grad_u, min_f,
// max_f):
//   out[s, e] = ell(nf_s . F_v),   ell(x) = log(omp(x)) + x
// Output: (S, E) float32; the per-node sum stays in torch (index_add_).
//
// The TPU kernel takes F_src, grad_src and F_dst as three (chunk, K_pad)
// arrays that XLA gathered into HBM, and loads them in blocks of 1,024
// edges into VMEM. Here each warp reads its edge's three rows by index
// from F and grad, with the lanes striding over K (lane j takes the
// columns j, j+32, ...), so every row read is coalesced and no gathered
// copy is written. A lane keeps only the 16 partial dots and one column
// of each row at a time, so any K works, and one transposing butterfly
// (reduce16_transpose) leaves candidate s's dot in lanes 2s and 2s+1,
// after which lane 2s applies the edge term and writes out[s, e]. There is
// no mask: the edge chunks are not padded, and any chunk length works.
//
// What bounds it on this card: arithmetic. Per edge and candidate the
// function needs one 2K dot (nf_s depends on u alone); the kernel rebuilds
// nf_s for each edge (an fma and a clip per column), so it executes about
// twice those operations. Its bytes (F and grad read once, src/dst, the
// (S, E) output) take far less time.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kMaxS;
using bigclam::kWarp;

constexpr int kEdgeWarps = 8;  // edges (warps) per block

__global__ void __launch_bounds__(kEdgeWarps * kWarp)
candidate_edge_terms_kernel(const float* __restrict__ F,
                            const float* __restrict__ grad,
                            const int64_t* __restrict__ src,
                            const int64_t* __restrict__ dst, int64_t e_count,
                            int K, StepParams p, float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * kEdgeWarps + threadIdx.x / kWarp;
  if (e >= e_count) return;  // whole warp
  const int64_t k64 = K;
  const float* __restrict__ fu = F + src[e] * k64;
  const float* __restrict__ gu = grad + src[e] * k64;
  const float* __restrict__ fv = F + dst[e] * k64;
  float part[kMaxS];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) part[s] = 0.f;
#pragma unroll 2
  for (int k = lane; k < K; k += kWarp) {
    const float f = __ldg(fu + k);
    const float g = __ldg(gu + k);
    const float d = __ldg(fv + k);
#pragma unroll
    for (int s = 0; s < kMaxS; ++s)
      part[s] = fmaf(bigclam::clip_f(fmaf(p.etas[s], g, f), p), d, part[s]);
  }
  const float x = bigclam::reduce16_transpose(part, lane);
  const int s = lane >> 1;
  if ((lane & 1) == 0 && s < p.num_s)
    out[static_cast<int64_t>(s) * e_count + e] =
        logf(bigclam::survival(x, p)) + x;
}

}  // namespace

// Writes out (num_s, e_count) for the edges src[e] -> dst[e] of F (n, K)
// and grad (n, K) on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K < 1, num_s outside [1, 16] or more edge
// blocks than one grid takes). `etas` is a host array of num_s floats.
extern "C" int bigclam_candidate_edge_terms(
    const float* F, const float* grad, const int64_t* src, const int64_t* dst,
    int64_t e_count, int K, const float* etas, int num_s, float omp_lo,
    float omp_hi, float min_f, float max_f, float* out, void* stream) {
  if (K < 1 || num_s < 1 || num_s > kMaxS || e_count < 0)
    return cudaErrorInvalidValue;
  if (e_count == 0) return cudaSuccess;
  const int64_t blocks = (e_count + kEdgeWarps - 1) / kEdgeWarps;
  if (blocks > static_cast<int64_t>(0x7fffffff)) return cudaErrorInvalidValue;
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  candidate_edge_terms_kernel<<<static_cast<unsigned>(blocks),
                                kEdgeWarps * kWarp, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      F, grad, src, dst, e_count, K, p, out);
  return cudaGetLastError();
}
