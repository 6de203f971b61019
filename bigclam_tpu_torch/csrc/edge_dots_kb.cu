// K-blocked edge dots of BigCLAM, for Hopper: one column window's share of
// every directed edge's dot F_u.F_v, added into x.
//
// Replaces two TPU kernels that compute the same function:
// bigclam_tpu/ops/pallas_fused.py `edge_dots_fused` (path csr_fused_kb; the
// window is DMA'd in-kernel) and bigclam_tpu/ops/pallas_csr.py
// `edge_dots_csr` (path csr_grouped_kb; the window comes as a gathered fd).
// Per node u (one warp) and edge e = (u, v) of its CSR slice:
//   x[e] += F_u[win] . F_v[win],  win = [col0, col0 + kc)
// Calling it for every window in order (col0 = 0, kc, 2kc, ...) leaves the
// full dots in x, summed block by block as the JAX scan sums them. x is
// indexed by CSR position; only the warp that owns an edge writes it, so
// there are no atomics.
//
// What bounds it on this card: memory. The function reads the window of F
// once (2 operations per column per edge against 4 bytes per column per
// node). The kernel reads one neighbour row window per directed edge, which
// L2 serves in part; each lane keeps the dot of the batch's edge j in lane
// j, so the 32 results of a neighbour batch go out as one coalesced
// read-modify-write of x.
#include "edge_common.cuh"

namespace {

using bigclam::kFull;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
edge_dots_kernel(const float* __restrict__ F,
                 const int64_t* __restrict__ indptr,
                 const int* __restrict__ indices, int n, int64_t k_pad,
                 int col0, int kc, float* __restrict__ x) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (u >= n) return;  // whole warp
  float fu[KPL];
  bigclam::load_window<KPL>(F, u, k_pad, col0, kc, lane, fu);
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  for (int64_t base = e0; base < e1; base += kWarp) {
    const int64_t rem = e1 - base;
    const int cnt = rem < kWarp ? static_cast<int>(rem) : kWarp;
    const int mine = lane < cnt ? __ldg(indices + base + lane) : 0;
    float mine_x = 0.f;
    for (int j = 0; j < cnt; ++j) {
      const int v = __shfl_sync(kFull, mine, j);
      float fv[KPL];
      bigclam::load_window<KPL>(F, v, k_pad, col0, kc, lane, fv);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) part = fmaf(fu[i], fv[i], part);
      const float d = bigclam::warp_sum(part);
      if (lane == j) mine_x = d;
    }
    if (lane < cnt) x[base + lane] += mine_x;
  }
}

template <int KPL>
void launch(const float* F, const int64_t* indptr, const int* indices, int n,
            int64_t k_pad, int col0, int kc, float* x, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_dots_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      F, indptr, indices, n, k_pad, col0, kc, x);
}

}  // namespace

// Adds window [col0, col0 + kc) of every edge dot into x (E,) on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// window outside the rows or wider than 1024 columns).
extern "C" int bigclam_edge_dots_kb(const float* F, const int64_t* indptr,
                                    const int* indices, int n, int k_pad,
                                    int col0, int kc, float* x, void* stream) {
  if (!bigclam::window_ok(k_pad, col0, kc)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(kc, launch, rc, F, indptr, indices, n, k_pad, col0, kc,
                       x, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
