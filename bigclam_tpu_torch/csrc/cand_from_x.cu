// Neighbour candidate LLH of BigCLAM from the full candidate dots, for
// Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_csr.py
// `cand_nbr_from_x_csr` (both K-blocked paths). Per step s and node u:
//   out[s, u] = sum_{e in u's CSR slice} log(omp(xc[s, e])) + xc[s, e]
// with omp = clip(-expm1(-x), 1-max_p, 1-min_p). No Armijo tails: the
// caller adds them in torch (armijo_update). Output: (S, n).
//
// What bounds it on this card: memory, xc read once (S floats per edge)
// against about 3 operations per float. One thread per (s, u) sums its
// slice in CSR order; neighbouring threads own neighbouring slices, so
// their reads fall on neighbouring addresses.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cand_from_x_kernel(const float* __restrict__ xc,
                   const int64_t* __restrict__ indptr, int n, int64_t e_total,
                   StepParams p, float* __restrict__ out) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  if (u >= n) return;
  const float* __restrict__ xs = xc + static_cast<int64_t>(s) * e_total;
  const int64_t e1 = indptr[u + 1];
  float acc = 0.f;
  for (int64_t e = indptr[u]; e < e1; ++e) {
    const float xv = __ldg(xs + e);
    acc += logf(bigclam::survival(xv, p)) + xv;
  }
  out[static_cast<int64_t>(s) * n + u] = acc;
}

}  // namespace

// Writes the neighbour candidate LLH (num_s, n) from xc (num_s, e_total) on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for more than 16 steps).
extern "C" int bigclam_cand_from_x(const float* xc, const int64_t* indptr,
                                   int n, int64_t e_total, int num_s,
                                   float omp_lo, float omp_hi, float* out,
                                   void* stream) {
  if (num_s < 1 || num_s > bigclam::kMaxS) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the survival clip bounds only
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, 0, omp_lo, omp_hi, 0.f, 0.f);
  const dim3 grid((n + kThreads - 1) / kThreads, num_s);
  cand_from_x_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xc, indptr, n, e_total, p, out);
  return cudaGetLastError();
}
