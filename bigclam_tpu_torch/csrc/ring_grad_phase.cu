// Kernel #8: one ring phase of the BigCLAM gradient pass, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/pallas_fused.py
// `_grad_blocks_fused` (body `_grad_blocks_kernel`), which the ring schedule
// (bigclam_tpu/parallel/ring.py `make_ring_train_step`'s CSR step) runs once
// per (shard, phase) bucket. In phase r a shard holds the rotating shard
// (i + r) % dp; the bucket lists, for each of the shard's n rows, the
// neighbours that live in the rotating shard, by their row in it. Per node u
// (one warp), from zero:
//   gn_part = sum_v F_rot[v] / omp(F_u . F_rot[v]),   ln_part = sum_v ell
// and then once: gn[u] = gn[u] + gn_part, ln[u] = ln[u] + ln_part, the
// rounding order of the JAX ring's `gn_acc + gn`. No fold and no node tail:
// the ring adds those once after the whole rotation.
//
// What bounds it on this card: memory. The function needs ~4 float32
// operations per column per directed edge of the bucket; its bytes (F_u and
// the rotating rows read, the (n, K) accumulator read and written once per
// phase) take longer at the card's rates. Every edge gathers one row of
// F_rot (4 KB at K=1,024): a balanced dp = 4 sweep at N=300,000 gathers
// 34.9 GB, ~49.6 GB with F_u and the accumulators, 14.8 ms at 3.35 TB/s if
// no gathered row is found in L2; read once per launch, the rows and the
// rest take 5.7 ms. Two things close that gap here:
//  * the visit order: warp w takes row order[w], a permutation of the
//    bucket's rows with an edge that parallel/ring.py computes from the
//    graph once, so that warps resident together gather the same rows and
//    find them in the 50 MB L2. The degree-balanced relabeling deals a
//    community's nodes over all shard positions, so in row order they do
//    not. The order changes which warps run together, never a node's sum,
//    so any order gives the same bits. Rows without an edge are not in it,
//    so no warp is spent on them. A null order visits all n rows in order;
//  * rows in flight: the warp stages the next kGradStages - 1 rows of its
//    neighbour list in shared memory by cp.async (16-byte copies, 4-byte
//    when K is not a multiple of 4) while it works on the current one.
//    Before (edge_common.cuh `grad_pass`, kernel B's) a warp loaded one row
//    into registers, then ran a dependent warp_sum, the transcendentals and
//    the axpy before the next row's load could start.
// Lane j reads columns j, j + 32, ... of each staged row (conflict-free
// shared reads), so each dot runs in grad_pass's order and the kernel's
// results equal that pass's bit for bit. A node with no neighbour in the
// bucket leaves its accumulator row untouched. The TPU kernel's blocked
// tiles, one-hot matmuls and DMA double buffer have no counterpart: the
// bucket is a CSR over the shard's rows.
#include "edge_common.cuh"

namespace {

using bigclam::StepParams;
using bigclam::kFull;
using bigclam::kWarp;
using bigclam::kWarpsPerBlock;

constexpr int kGradStages = 3;  // staged rows a warp: one in use, two in flight

// Shared-memory bytes of one block at KPL columns a lane.
inline int grad_smem_bytes(int kpl) {
  return 4 * kWarpsPerBlock * kGradStages * kWarp * kpl;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies row v of Fd (K floats) into `dst`, the columns past K not written.
__device__ __forceinline__ void stage_row(float* dst, const float* Fd, int v,
                                          int K, int lane, bool vec) {
  const float* src = Fd + static_cast<int64_t>(v) * K;
  if (vec) {
    for (int q = lane; 4 * q < K; q += kWarp)
      bigclam::cp_async16(dst + 4 * q, src + 4 * q, true);
  } else {
    for (int k = lane; k < K; k += kWarp) bigclam::cp_async4(dst + k, src + k, true);
  }
}

// grad_pass over the edges [e0, e1) with the rows staged in `ring`
// (kGradStages rows of 32 KPL floats): acc = sum_v F_v / omp(F_u.F_v),
// returns sum_v ell (the same in every lane).
template <int KPL>
__device__ __forceinline__ float staged_grad_pass(
    const float* __restrict__ Fd, const int* __restrict__ indices, int64_t e0,
    int64_t e1, int K, int lane, bool vec, float* ring,
    const float (&fu)[KPL], float (&acc)[KPL], const StepParams& p) {
  constexpr int kRow = kWarp * KPL;
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = 0.f;
  float llh = 0.f;
  int64_t ei = e0;  // the next edge whose row is staged
  int ids = 0;      // lane j: the id of edge e0 + 32 floor((ei - e0) / 32) + j
  auto issue = [&](int slot) {
    if (ei < e1) {
      const int at = static_cast<int>((ei - e0) & (kWarp - 1));
      if (at == 0) ids = ei + lane < e1 ? __ldg(indices + ei + lane) : 0;
      stage_row(ring + slot * kRow, Fd, __shfl_sync(kFull, ids, at), K, lane, vec);
    }
    ++ei;
    bigclam::cp_async_commit();  // one group an edge, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kGradStages - 1; ++s) issue(s);
  int slot = 0;
  for (int64_t e = e0; e < e1; ++e) {
    issue(slot == 0 ? kGradStages - 1 : slot - 1);
    cp_async_wait<kGradStages - 1>();  // edge e's row has landed
    __syncwarp();
    float fv[KPL];
    const float* row = ring + slot * kRow;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int k = lane + kWarp * i;
      fv[i] = k < K ? row[k] : 0.f;
    }
    __syncwarp();  // the slot is free for the next issue
    slot = slot == kGradStages - 1 ? 0 : slot + 1;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) part = fmaf(fu[i], fv[i], part);
    const float x = bigclam::warp_sum(part);
    const float omp = bigclam::survival(x, p);
    const float coeff = 1.0f / omp;
#pragma unroll
    for (int i = 0; i < KPL; ++i) acc[i] = fmaf(fv[i], coeff, acc[i]);
    llh += logf(omp) + x;
  }
  return llh;
}

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ring_grad_phase_kernel(const float* __restrict__ F_loc,
                       const float* __restrict__ F_rot,
                       const int64_t* __restrict__ indptr,
                       const int* __restrict__ indices,
                       const int* __restrict__ order, int m, int K,
                       StepParams p, bool vec, float* __restrict__ gn,
                       float* __restrict__ ln) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = blockIdx.x * kWarpsPerBlock + warp;
  if (w >= m) return;  // whole warp
  const int u = order ? __ldg(order + w) : w;
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  if (e0 == e1) return;
  float fu[KPL];
  bigclam::load_row<KPL>(F_loc, u, K, lane, fu);
  float part[KPL];
  const float llh = staged_grad_pass<KPL>(
      F_rot, indices, e0, e1, K, lane, vec,
      reinterpret_cast<float*>(smem4) + warp * kGradStages * kWarp * KPL, fu,
      part, p);
  // the accumulator row is read and written by this warp only
  float* row = gn + static_cast<int64_t>(u) * K;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    if (k < K) row[k] = row[k] + part[i];
  }
  if (lane == 0) ln[u] = ln[u] + llh;
}

template <int KPL>
void launch(const float* F_loc, const float* F_rot, const int64_t* indptr,
            const int* indices, const int* order, int m, int K,
            const StepParams& p, bool vec, float* gn, float* ln,
            cudaStream_t stream, int& rc) {
  const int smem = grad_smem_bytes(KPL);
  if (smem > bigclam::kSmemDefault) {
    rc = cudaFuncSetAttribute(ring_grad_phase_kernel<KPL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return;
  }
  // one block at least, so that every call launches (its warps exit at once
  // when m is 0)
  const int blocks = m > 0 ? (m + kWarpsPerBlock - 1) / kWarpsPerBlock : 1;
  ring_grad_phase_kernel<KPL><<<blocks, kWarpsPerBlock * kWarp, smem, stream>>>(
      F_loc, F_rot, indptr, indices, order, m, K, p, vec, gn, ln);
}

}  // namespace

// Launches kernel #8 on `stream` over one bucket of n rows; gn (n, K) and
// ln (n,) are accumulated in place. `order` holds the m rows to visit (the
// bucket's rows with an edge, parallel/ring.py `visit_order`), or is null
// to visit all n rows in order. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for K outside [1, 1024] or m outside [0, n]).
extern "C" int bigclam_ring_grad_phase(const float* F_loc, const float* F_rot,
                                       const int64_t* indptr,
                                       const int* indices, const int* order,
                                       int m, int n, int K, float omp_lo,
                                       float omp_hi, float* gn, float* ln,
                                       void* stream) {
  if (bigclam::kpl_bucket(K) == 0) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  if (order == nullptr) m = n;
  if (m < 0 || m > n) return cudaErrorInvalidValue;
  // the survival clip bounds only: no ladder
  const StepParams p =
      bigclam::make_params(nullptr, nullptr, 0, omp_lo, omp_hi, 0.f, 0.f);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(F_rot) % 16 == 0;
  int rc = cudaSuccess;
  BIGCLAM_DISPATCH_KPL(K, launch, rc, F_loc, F_rot, indptr, indices, order, m,
                       K, p, vec, gn, ln, static_cast<cudaStream_t>(stream),
                       rc);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
