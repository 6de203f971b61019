// K-blocked Armijo candidate dots of BigCLAM, for Hopper: one column
// window's share of every directed edge's 16 candidate dots, added into xc.
//
// Replaces two TPU kernels that compute the same function:
// bigclam_tpu/ops/pallas_fused.py `cand_dots_fused` (path csr_fused_kb) and
// bigclam_tpu/ops/pallas_csr.py `cand_dots_csr` (path csr_grouped_kb). Per
// node u (one warp), edge e = (u, v) and step eta_s, with
// nf_s = clip(F_u[win] + eta_s grad_kb[u], min_f, max_f):
//   xc[s, e] += nf_s . F_v[win]
// grad_kb is the window's gradient columns (n, kc), already folded. xc is
// (S, E), indexed by CSR position; only the warp that owns an edge writes
// it, so there are no atomics.
//
// What bounds it on this card: arithmetic, one 2kc dot per candidate and
// edge (nf_s depends on u alone, so building it is per-node work). The
// kernel is the candidate pass of candidates.cu on a window: F_u and g_u in
// registers, nf_s rebuilt per neighbour (3x the needed operations) rather
// than held as 16 x KPL registers, the 16 per-edge dots reduced with one
// transposing butterfly after which lane 2s holds candidate s's dot. It
// takes the one StepParams block: split per kernel, nvcc hoisted the
// candidate rows out of the neighbour loop into local memory (PERF.md).
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kFull;
using bigclam::kMaxS;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
cand_dots_kernel(const float* __restrict__ F,
                 const float* __restrict__ grad_kb,
                 const int64_t* __restrict__ indptr,
                 const int* __restrict__ indices, int n, int64_t e_total,
                 int64_t k_pad, int col0, int kc, StepParams p,
                 float* __restrict__ xc) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (u >= n) return;  // whole warp
  float fu[KPL], g[KPL];
  bigclam::load_window<KPL>(F, u, k_pad, col0, kc, lane, fu);
  bigclam::load_window<KPL>(grad_kb, u, kc, 0, kc, lane, g);
  const int s = lane >> 1;  // this lane's candidate after the reduction
  const bool writer = s < p.num_s && (lane & 1) == 0;
  float* __restrict__ xs = xc + static_cast<int64_t>(writer ? s : 0) * e_total;
  bigclam::for_each_neighbor_at(indptr, indices, u, lane,
                                [&](int64_t e, int v) {
    float fv[KPL];
    bigclam::load_window<KPL>(F, v, k_pad, col0, kc, lane, fv);
    float part[kMaxS];
#pragma unroll
    for (int t = 0; t < kMaxS; ++t) part[t] = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
#pragma unroll
      for (int t = 0; t < kMaxS; ++t)
        part[t] = fmaf(bigclam::clip_f(fmaf(p.etas[t], g[i], fu[i]), p), fv[i],
                       part[t]);
    }
    const float d = bigclam::reduce16_transpose(part, lane);
    if (writer) xs[e] += d;
  });
}

template <int KPL>
void launch(const float* F, const float* grad_kb, const int64_t* indptr,
            const int* indices, int n, int64_t e_total, int64_t k_pad,
            int col0, int kc, const StepParams& p, float* xc,
            cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cand_dots_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      F, grad_kb, indptr, indices, n, e_total, k_pad, col0, kc, p, xc);
}

}  // namespace

// Adds window [col0, col0 + kc) of every edge's num_s candidate dots into
// xc (num_s, e_total) on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a window outside the rows or wider than
// 1024 columns, or more than 16 steps). `etas` is a host array of num_s
// floats.
extern "C" int bigclam_cand_dots_kb(const float* F, const float* grad_kb,
                                    const int64_t* indptr, const int* indices,
                                    int n, int64_t e_total, int k_pad,
                                    int col0, int kc, const float* etas,
                                    int num_s, float omp_lo, float omp_hi,
                                    float min_f, float max_f, float* xc,
                                    void* stream) {
  if (num_s < 1 || num_s > bigclam::kMaxS) return cudaErrorInvalidValue;
  if (!bigclam::window_ok(k_pad, col0, kc)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the ladder without acceptance coefficients (selection runs in torch)
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(kc, launch, rc, F, grad_kb, indptr, indices, n,
                       e_total, k_pad, col0, kc, p, xc,
                       static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
