// K-blocked Armijo candidate dots of BigCLAM, for Hopper: one column
// window's share of every directed edge's 16 candidate dots, added into xc.
//
// Replaces two TPU kernels that compute the same function:
// bigclam_tpu/ops/pallas_fused.py `cand_dots_fused` (path csr_fused_kb) and
// bigclam_tpu/ops/pallas_csr.py `cand_dots_csr` (path csr_grouped_kb). Per
// node u (one warp), edge e = (u, v) and step eta_s, with
// nf_s = clip(F_u[win] + eta_s grad_kb[u], min_f, max_f):
//   xc[s, e] += nf_s . F_v[win]
// grad_kb is the window's gradient columns, already folded, row u at
// grad_kb + u * ld_grad (a window of the step's gradient). xc is
// (S, E), indexed by CSR position; only the warp that owns an edge writes
// it, so there are no atomics.
//
// What bounds it on this card: arithmetic, one 2kc dot per candidate and
// edge (about 50 GFLOP a step of the 3 windows at the repo's xl_k, K=3,000
// and 431,092 directed edges: 0.75 ms at 67 TFLOP/s; nf_s depends on u
// alone, so building it is per-node work). The kernel walks u's
// neighbourhood on edge_common.cuh's staged candidate ladder
// (`ladder_range`) over the window: nf_s built once per (32-row tile,
// 32-column chunk) in shared memory from F_u[win] and grad_kb[u] (read by
// __ldg), the window of each neighbour row staged by cp.async in a double
// buffer (rows k_pad floats apart; 16-byte copies when the window starts on
// 16 bytes and kc and k_pad are multiples of 4, else 4-byte ones), the dots
// as a 4 x 4 register-blocked product with one fma per multiply-add, and
// only the row groups of a tile that hold an edge multiplied: at xl_k a
// node has about 7 edges, a quarter of a tile. The epilogue adds each dot
// to its edge's sum: lane (cg, ng) adds candidate 4cg + a of tile row
// 8j + ng to xc[4cg + a, e]. The earlier design rebuilt nf_s for every
// neighbour (an fma, a max and a min besides the dot's fma) from F_u and
// grad_u held in registers and walked one row at a time. One instantiation
// serves every kc up to 1,024. On an H100 (chip_smoke.py) a step of the 3
// windows takes about 4.6 ms at xl_k, 6x its bound; 74% of its tiles run
// one row group (7.2 edges a tile), and without row groups it took 7.1 ms.
// Trial builds with the copies, the fmas or the nf build taken out took
// 25%, 38% and 23% less time: a stage's parts run one after another, and
// at 7 rows a tile none of them is long enough to hide the others.
//
// On a mesh the destination ids index `Fd`, a tensor of its own rows with
// F's columns (the all-gathered F, or the rotating shard of a ring phase);
// F_u and grad_kb stay the source rows'. Fd = F on one card.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kMaxS;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

// Adds the tile's dots: candidate 4 cg + a of tile row 8j + ng to
// xc[s, e0 + 32 t + 8j + ng] for the live rows and candidates.
struct LadderStoreAdd {
  float* xc;
  int64_t e_total;
  int64_t e0;  // the node's first edge
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
          if (s < p.num_s) {
            float* const at = xc + static_cast<int64_t>(s) * e_total + base + 8 * j + ng;
            *at += acc[a][j];
          }
        }
      }
    }
  }
};

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
cand_dots_kernel(const float* __restrict__ F, const float* __restrict__ Fd,
                 const float* __restrict__ grad_kb, int ld_grad,
                 const int64_t* __restrict__ indptr,
                 const int* __restrict__ indices, int n, int64_t e_total,
                 int k_pad, int col0, int kc, StepParams p, bool vec,
                 float* __restrict__ xc) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + warp;
  if (u >= n) return;  // whole warp
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  if (e0 == e1) return;
  const float* const fu = F + static_cast<int64_t>(u) * k_pad + col0;
  const float* const gu = grad_kb + static_cast<int64_t>(u) * ld_grad;
  auto col = [&](int k, float& f, float& g) {
    f = __ldg(fu + k);
    g = __ldg(gu + k);
  };
  LadderStoreAdd st{xc, e_total, e0, lane >> 3};
  bigclam::ladder_range<true>(
      Fd + col0, indices, e0, e1, kc, k_pad, lane, vec, p,
      reinterpret_cast<float*>(smem4) + warp * bigclam::kLadderFloats, col, st);
}

}  // namespace

// Adds window [col0, col0 + kc) of every edge's num_s candidate dots into
// xc (num_s, e_total) on `stream`, from the gradient window grad_kb (row u
// at grad_kb + u * ld_grad); returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a window outside the rows or wider than 1024
// columns, ld_grad < kc, more than 16 steps, or a smem_bytes other than the
// block's shared memory, which ops/csr_kernels.py `ladder_launch_plan`
// computes). The neighbour rows come from Fd (F when null). `etas` is a
// host array of num_s floats.
extern "C" int bigclam_cand_dots_kb(const float* F, const float* Fd,
                                    const float* grad_kb,
                                    int ld_grad, const int64_t* indptr,
                                    const int* indices,
                                    int n, int64_t e_total, int k_pad,
                                    int col0, int kc, const float* etas,
                                    int num_s, float omp_lo, float omp_hi,
                                    float min_f, float max_f, float* xc,
                                    int smem_bytes, void* stream) {
  if (num_s < 1 || num_s > kMaxS) return cudaErrorInvalidValue;
  if (!bigclam::window_ok(k_pad, col0, kc)) return cudaErrorInvalidValue;
  if (ld_grad < kc) return cudaErrorInvalidValue;
  if (smem_bytes != bigclam::cand_dots_smem_bytes()) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  if (Fd == nullptr) Fd = F;
  // the ladder without acceptance coefficients (selection runs in torch)
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo,
                                            omp_hi, min_f, max_f);
  const bool vec = kc % 4 == 0 && k_pad % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(Fd + col0) % 16 == 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cand_dots_kernel<<<blocks, kWarpsPerBlock * kWarp, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      F, Fd, grad_kb, ld_grad, indptr, indices, n, e_total, k_pad, col0, kc, p,
      vec, xc);
  return cudaGetLastError();
}
