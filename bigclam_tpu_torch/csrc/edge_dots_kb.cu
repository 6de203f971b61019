// K-blocked edge dots of BigCLAM, for Hopper: one column window's share of
// every directed edge's dot F_u.F_v, added into x.
//
// Replaces two TPU kernels that compute the same function:
// bigclam_tpu/ops/pallas_fused.py `edge_dots_fused` (path csr_fused_kb; the
// window is DMA'd in-kernel) and bigclam_tpu/ops/pallas_csr.py
// `edge_dots_csr` (path csr_grouped_kb; the window comes as a gathered fd).
// Per directed edge e = (u, v) of the CSR:
//   x[e] += F_u[win] . F_v[win],  win = [col0, col0 + kc)
// Calling it for every window in order (col0 = 0, kc, 2kc, ...) leaves the
// full dots in x, summed block by block as the JAX scan sums them. x is
// indexed by CSR position.
//
// What bounds it on this card: memory. The function reads the window of F
// once (2 operations per column per undirected pair against 4 bytes per
// column per node), but a kernel that gathers by index reads a neighbour
// window per edge it walks, and at the repo's xl_k (431,092 directed edges,
// 3,072 columns) one window per directed edge is 5.30 GB a step: more than
// 7 times F, served in part by L2. The design halves that and keeps rows in
// flight:
//
//  * pairs once. The CSR is symmetric without self-loops, so x[(u, v)] and
//    x[(v, u)] are the same number. Warp u walks only its edges with v > u
//    (a suffix of its sorted list, found by ballot) and adds each dot to
//    x[e] and to x[rev[e]], rev the reverse-edge index of the CSR
//    (ops/kblocked.py `reverse_edges`). Each position still has one writer,
//    so there are no atomics; the rows read halve, to 2.65 GB a step.
//  * rows in flight. The neighbour windows are staged two edges ahead in
//    the warp's shared-memory ring by cp.async (edge_common.cuh
//    `window_walk`, kernel B's walk with a row stride; 16-byte copies when
//    kc and k_pad are multiples of 4 and the window starts on 16 bytes,
//    else 4-byte ones), so the dependent dot and warp_sum of one edge run
//    while the next rows arrive.
//  * bits. Lane j holds columns j + 32 i of both rows and each dot is the
//    same fmaf chain and butterfly as before, and fmaf(fu, fv, .) equals
//    fmaf(fv, fu, .): x is bit-equal to a pass over every directed edge.
//    Lane j keeps the dot of the batch's edge j, so a batch of 32 goes out
//    as one coalesced read-modify-write of x and one of x[rev].
//
// Two more inputs serve a mesh, where neither holds:
//
//  * F_dst. The CSR's destination ids index `Fd`, a tensor of its own
//    rows with F's columns: the all-gathered F on the all-gather schedule,
//    the rotating shard in a ring phase. Fd = F on one card.
//  * the directed mode. With a null `rev` warp u walks all its edges and
//    writes x[e] only. A shard's CSR (local rows, global ids) and a ring
//    bucket are not symmetric, so a mesh takes this mode. It runs the same
//    fmaf chain and butterfly per edge, so on a whole symmetric graph it
//    gives the pair mode's bits.
//
// On an H100 (chip_smoke.py) a step of the 3 windows at xl_k takes 0.64 ms
// (one pass over every directed edge: 1.47; sampled_addmm: 1.52), and 1.07
// ms on the same graph with shuffled ids (3.78). A trial that also staged
// each block's 16 consecutive nodes' windows in shared memory and read
// in-tile pairs from there took 0.83 and 1.19 ms: its 112 KB a block
// halved the resident warps.
#include "edge_common.cuh"

namespace {

using bigclam::kFull;
using bigclam::kGradStages;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

// The first edge of [e0, e1) whose neighbour id is above u (a node's
// neighbour list is sorted and holds no self-loop): 32 ids a step.
__device__ __forceinline__ int64_t first_above(const int* __restrict__ indices,
                                               int64_t e0, int64_t e1, int u,
                                               int lane) {
  int64_t e = e0;
  while (e < e1) {
    const int64_t rem = e1 - e;
    const int cnt = rem < kWarp ? static_cast<int>(rem) : kWarp;
    const int v = lane < cnt ? __ldg(indices + e + lane) : u + 1;
    const int below = __popc(__ballot_sync(kFull, v < u));  // a prefix
    e += below;
    if (below < cnt) break;
  }
  return e;
}

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
edge_dots_kernel(const float* __restrict__ F,
                 const float* __restrict__ Fd,
                 const int64_t* __restrict__ indptr,
                 const int* __restrict__ indices, const int* __restrict__ rev,
                 int n, int k_pad, int col0, int kc, bool vec,
                 float* __restrict__ x) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int u = blockIdx.x * kWarpsPerBlock + warp;
  if (u >= n) return;  // whole warp
  float fu[KPL];
  bigclam::load_window<KPL>(F, u, k_pad, col0, kc, lane, fu);
  const int64_t e1 = indptr[u + 1];
  // pair mode: the edges to neighbours above u; directed: all of them
  const int64_t eu = rev != nullptr ? first_above(indices, indptr[u], e1, u, lane)
                                    : indptr[u];
  float mine = 0.f;  // lane j: the dot of the batch's edge j
  bigclam::window_walk<KPL>(
      Fd + col0, indices, eu, e1, kc, k_pad, lane, vec,
      reinterpret_cast<float*>(smem4) + warp * kGradStages * kWarp * KPL,
      [&](int64_t e, int j, const float (&fv)[KPL]) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < KPL; ++i) part = fmaf(fu[i], fv[i], part);
        const float d = bigclam::warp_sum(part);
        if (lane == j) mine = d;
        if (j == kWarp - 1 || e + 1 == e1) {  // the batch's last edge
          const int64_t b = e - j;
          if (lane <= j) {
            x[b + lane] += mine;
            if (rev != nullptr) x[__ldg(rev + b + lane)] += mine;
          }
        }
      });
}

template <int KPL>
void launch(const float* F, const float* Fd, const int64_t* indptr,
            const int* indices,
            const int* rev, int n, int k_pad, int col0, int kc, bool vec,
            float* x, cudaStream_t stream) {
  constexpr int smem = bigclam::grad_smem_bytes(KPL);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_dots_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      F, Fd, indptr, indices, rev, n, k_pad, col0, kc, vec, x);
}

}  // namespace

// Adds window [col0, col0 + kc) of every edge dot into x (E,) on `stream`:
// source rows from F (n rows), destination rows from Fd (F when null; any
// row count, k_pad columns). With `rev` (E,) int32, the reverse-edge index
// of a symmetric CSR without self-loops, each pair is computed once; with a
// null rev every directed edge is. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a window outside the rows or wider than
// 1024 columns).
extern "C" int bigclam_edge_dots_kb(const float* F, const float* Fd,
                                    const int64_t* indptr, const int* indices,
                                    const int* rev, int n, int k_pad, int col0,
                                    int kc, float* x, void* stream) {
  if (!bigclam::window_ok(k_pad, col0, kc)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  if (Fd == nullptr) Fd = F;
  const bool vec = kc % 4 == 0 && k_pad % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(F + col0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Fd + col0) % 16 == 0;
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(kc, launch, rc, F, Fd, indptr, indices, rev, n, k_pad,
                       col0, kc, vec, x, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
