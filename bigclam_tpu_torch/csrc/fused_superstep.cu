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
// What bounds it on this card. At N=300,000, K=1,024 and 8.5 M directed
// edges the function needs about 340 GFLOP (the 16 candidate dots 272 of
// them: 5.1 ms at 67 TFLOP/s) and, per pass, one 4 KB neighbour row per
// edge (34.8 GB, which kernel B reads in about 10 ms with help from L2).
// Pass 1 is kernel B's walk, one row at a time in registers, with F_u read
// from shared memory instead of 32 more registers. Pass 2 is edge_common.cuh
// `ladder_pass`: nf_s built once per (tile, column chunk) in shared memory,
// neighbour rows staged by cp.async in a double buffer, and the 16 x 32 dots
// of a tile as a 4 x 4 register-blocked product, one fma per multiply-add;
// the gather alone does not set its pace (see there).
// The gradient goes to its output row after the fold and each lane reads
// back only the columns it wrote, so neither g_u nor F_u is held in
// registers across pass 2 (the earlier design held F_u, g_u, the row in flight
// and 16 partials per lane: 205 registers). Pass 1 still holds the row in
// flight and the gradient accumulator (32 registers each at K = 1,024):
// 143 registers, which a 128 cap turns into spills; at that bucket the
// block's 60.5 KB of shared memory allows 3 blocks an SM either way. The
// TPU kernel's blocked tiles, one-hot MXU matmuls and DMA double buffer have
// no counterpart here: the CSR is read directly and nothing is scattered.
// ops/csr_kernels.py `ladder_launch_plan` gives the block's shared memory,
// which the entry checks.
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
                       StepParams p, bool vec, float* __restrict__ F_new,
                       float* __restrict__ grad, float* __restrict__ node_llh,
                       uint8_t* __restrict__ ok) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + warp;
  if (u >= n) return;  // whole warp
  float* const fu = reinterpret_cast<float*>(smem4) +
                    warp * (kWarp * KPL + bigclam::kLadderFloats + bigclam::kMaxS);
  float* const ladder = fu + kWarp * KPL;
  float* const sums = ladder + bigclam::kLadderFloats;
  const int64_t row = static_cast<int64_t>(u) * K;
  float* const gu = grad + row;

  // F_u into shared memory; lane j only ever touches columns j + 32 i of
  // fu and gu outside ladder_pass's own buffers.
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    fu[k] = k < K ? __ldg(F + row + k) : 0.f;
  }

  // pass 1
  float acc[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = 0.f;
  float llh = 0.f;
  bigclam::for_each_neighbor(indptr, indices, u, lane, [&](int v) {
    float fv[KPL];
    bigclam::load_row<KPL>(F_dst, v, K, lane, fv);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) part = fmaf(fu[lane + kWarp * i], fv[i], part);
    const float x = bigclam::warp_sum(part);
    const float omp = bigclam::survival(x, p);
    const float coeff = 1.0f / omp;
#pragma unroll
    for (int i = 0; i < KPL; ++i) acc[i] = fmaf(fv[i], coeff, acc[i]);
    llh += logf(omp) + x;
    // F_u stays in shared memory: no hoisting of its loads into registers
    asm volatile("" ::: "memory");
  });

  // fold: g into its output row; ||g||^2 and the node tail
  float gg = 0.f, fs = 0.f, ff = 0.f;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    const float sf = k < K ? __ldg(sumF + k) : 0.f;
    const float f = fu[k];
    const float g = (acc[i] - sf) + f;
    if (k < K) gu[k] = g;
    gg = fmaf(g, g, gg);
    fs = fmaf(f, sf, fs);
    ff = fmaf(f, f, ff);
  }
  gg = bigclam::warp_sum(gg);
  llh += -bigclam::warp_sum(fs) + bigclam::warp_sum(ff);  // the node tail

  // Armijo tails: candidate lane >> 1's in the result
  float tail;
  {
    float part[bigclam::kMaxS];
#pragma unroll
    for (int s = 0; s < bigclam::kMaxS; ++s) part[s] = 0.f;
    for (int i = 0; i < KPL; ++i) {
      const int k = lane + kWarp * i;
      if (k >= K) break;
      const float f = fu[k];
      const float g = gu[k];
      const float fms = f - __ldg(sumF + k);
#pragma unroll
      for (int s = 0; s < bigclam::kMaxS; ++s)
        part[s] = fmaf(bigclam::clip_f(fmaf(p.etas[s], g, f), p), fms, part[s]);
    }
    tail = bigclam::reduce16_transpose(part, lane);
  }

  // pass 2
  float out[4];
  bigclam::ladder_pass<false>(
      F_dst, indptr, indices, u, K, lane, vec, p, ladder,
      [&](int k, float& f, float& g) {
        f = fu[k];
        g = gu[k];
      },
      out);
  if ((lane & 7) == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sums[4 * (lane >> 3) + c] = out[c];
  }
  __syncwarp();

  const int s = lane >> 1;  // this lane's candidate
  const float cand = tail + sums[s];
  float eta, coef;
  bigclam::candidate_of(p, s, eta, coef);
  const bool live = s < p.num_s;
  // threshold rounded as the JAX kernel does: llh + float32(alpha*eta) * gg
  const bool ok_s = live && cand >= __fadd_rn(llh, __fmul_rn(coef, gg));
  const bool accepted = __any_sync(kFull, ok_s);
  const float best = bigclam::warp_max(ok_s ? eta : 0.f);
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    if (k < K) {
      const float f = fu[k];
      F_new[row + k] =
          accepted ? bigclam::clip_f(__fadd_rn(f, __fmul_rn(best, gu[k])), p) : f;
    }
  }
  if (lane == 0) node_llh[u] = llh;
  if (live && (lane & 1) == 0)
    ok[static_cast<int64_t>(s) * n + u] = ok_s ? 1 : 0;
}

template <int KPL>
void launch(const float* F, const float* F_dst, const float* sumF,
            const int64_t* indptr, const int* indices, int n, int K,
            const StepParams& p, bool vec, int smem_bytes, float* F_new,
            float* grad, float* node_llh, uint8_t* ok, cudaStream_t stream,
            int& rc) {
  if (smem_bytes != bigclam::fused_smem_bytes(KPL)) {
    rc = cudaErrorInvalidValue;
    return;
  }
  if (smem_bytes > bigclam::kSmemDefault) {
    rc = cudaFuncSetAttribute(fused_superstep_kernel<KPL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
    if (rc != cudaSuccess) return;
  }
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_superstep_kernel<KPL>
      <<<blocks, kWarpsPerBlock * kWarp, smem_bytes, stream>>>(
          F, F_dst, sumF, indptr, indices, n, K, p, vec, F_new, grad, node_llh,
          ok);
}

}  // namespace

// Launches kernel A on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024], more than 16 steps, or a
// smem_bytes other than the block's shared memory at K's bucket, which
// ops/csr_kernels.py `ladder_launch_plan` computes). `etas` and `coefs` are
// host arrays of num_s floats.
extern "C" int bigclam_fused_superstep(
    const float* F, const float* F_dst, const float* sumF, const int64_t* indptr,
    const int* indices, int n, int K, const float* etas, const float* coefs,
    int num_s, float omp_lo, float omp_hi, float min_f, float max_f,
    float* F_new, float* grad, float* node_llh, uint8_t* ok, int smem_bytes,
    void* stream) {
  if (num_s < 1 || num_s > bigclam::kMaxS) return cudaErrorInvalidValue;
  if (bigclam::kpl_bucket(K) == 0) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const StepParams p = bigclam::make_params(etas, coefs, num_s, omp_lo, omp_hi,
                                            min_f, max_f);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(F_dst) % 16 == 0;
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F, F_dst, sumF, indptr, indices, n, K, p,
                       vec, smem_bytes, F_new, grad, node_llh, ok,
                       static_cast<cudaStream_t>(stream), rc);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
