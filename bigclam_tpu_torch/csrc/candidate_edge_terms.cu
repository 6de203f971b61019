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
// edges into VMEM. Here the rows are read by index from F and grad, and no
// gathered copy is written.
//
// What bounds it on this card: arithmetic. Per edge and candidate the
// function needs one 2K dot (nf_s depends on u alone): about 272 GFLOP a
// sweep of the 8.5 M directed edges at K=1,000, 4.1 ms at 67 TFLOP/s,
// against F and grad read once and the (S, E) output written once. The
// edges come in CSR order, so a source's edges sit side by side: one warp
// takes one *run*, a maximal range of consecutive edges of the chunk with
// one source (a chunk boundary may split a node into two runs; a shuffled
// chunk is runs of one edge), and walks it on edge_common.cuh's staged
// candidate ladder (`ladder_range`): nf_s built once per (32-edge tile,
// 32-column chunk) in shared memory from F_u and grad_u, the destination
// rows staged by cp.async in a double buffer, the dots as a 4 x 4
// register-blocked product with one fma per multiply-add, and only the row
// groups of a tile that hold an edge multiplied. The epilogue stores each
// dot's term: lane (cg, ng) writes out[4cg + a, e_tile + 8j + ng]. The
// earlier design (one warp per edge) rebuilt nf_s for every edge, an fma,
// a max and a min per column and candidate where the function needs one
// fma, and re-read F_u and grad_u per edge. F_u and grad_u are read per
// column chunk from global memory, so any K works; any chunk length and
// any edge order work, since every run is walked on its own.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

// Stores the tile's terms: candidate 4 cg + a of tile row 8j + ng goes to
// out[s, e0 + 32 t + 8j + ng] for the live rows and candidates.
struct LadderStore {
  float* out;
  int64_t e_count;
  int64_t e0;  // the run's first edge in the chunk
  int cg;      // lane >> 3

  template <int JN>
  __device__ __forceinline__ void tile(const float (&acc)[4][4], int cnt,
                                       int ng, int64_t t, const StepParams& p) {
    const int64_t base = e0 + bigclam::kLadderRows * t;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      if (8 * j + ng < cnt) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int s = 4 * cg + a;
          if (s < p.num_s)
            out[static_cast<int64_t>(s) * e_count + base + 8 * j + ng] =
                logf(bigclam::survival(acc[a][j], p)) + acc[a][j];
        }
      }
    }
  }
};

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
candidate_edge_terms_kernel(const float* __restrict__ F,
                            const float* __restrict__ grad,
                            const int64_t* __restrict__ src,
                            const int64_t* __restrict__ dst,
                            const int64_t* __restrict__ runs, int64_t n_runs,
                            int64_t e_count, int K, StepParams p, bool vec,
                            float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (r >= n_runs) return;  // whole warp
  const int64_t e0 = runs[r];
  const int64_t e1 = runs[r + 1];
  const int64_t k64 = K;
  const float* const fu = F + src[e0] * k64;
  const float* const gu = grad + src[e0] * k64;
  auto col = [&](int k, float& f, float& g) {
    f = __ldg(fu + k);
    g = __ldg(gu + k);
  };
  LadderStore st{out, e_count, e0, lane >> 3};
  bigclam::ladder_range<true>(
      F, dst, e0, e1, K, K, lane, vec, p,
      reinterpret_cast<float*>(smem4) + warp * bigclam::kLadderFloats, col, st);
}

}  // namespace

// Writes out (num_s, e_count) for the edges src[e] -> dst[e] of F (n, K)
// and grad (n, K) on `stream`. runs (n_runs + 1,) are the offsets of the
// chunk's runs: runs[0] = 0, runs[n_runs] = e_count, and src is constant
// on each [runs[r], runs[r + 1]). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for K < 1, num_s outside [1, 16], more run
// blocks than one grid takes, or a smem_bytes other than the block's shared
// memory, which ops/csr_kernels.py `ladder_launch_plan` computes). `etas` is
// a host array of num_s floats.
extern "C" int bigclam_candidate_edge_terms(
    const float* F, const float* grad, const int64_t* src, const int64_t* dst,
    const int64_t* runs, int64_t n_runs, int64_t e_count, int K,
    const float* etas, int num_s, float omp_lo, float omp_hi, float min_f,
    float max_f, float* out, int smem_bytes, void* stream) {
  if (K < 1 || num_s < 1 || num_s > bigclam::kMaxS || e_count < 0 || n_runs < 0)
    return cudaErrorInvalidValue;
  if (smem_bytes != bigclam::edge_terms_smem_bytes()) return cudaErrorInvalidValue;
  if (e_count == 0 || n_runs == 0) return cudaSuccess;
  const int64_t blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > static_cast<int64_t>(0x7fffffff)) return cudaErrorInvalidValue;
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(F) % 16 == 0;
  candidate_edge_terms_kernel<<<static_cast<unsigned>(blocks),
                                kWarpsPerBlock * kWarp, smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      F, grad, src, dst, runs, n_runs, e_count, K, p, vec, out);
  return cudaGetLastError();
}
