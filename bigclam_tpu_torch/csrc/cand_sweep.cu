// The candidate sweep of BigCLAM's sparse top-M path, for Hopper.
//
// Replaces no TPU kernel: the JAX package's `sparse_candidates`
// (bigclam_tpu/ops/sparse_members.py) leaves this sweep to XLA's fusion
// after `member_lookup_pallas`. The port ran it as torch ops: a member
// lookup (member_lookup.cu) wrote a (chunk, M) float32 array to device
// memory for every edge chunk, then ten elementwise and reduce ops a step
// candidate read and wrote more such arrays: about 250 GB of traffic and
// 800 launches a sweep of com-Youtube. Here one launch does the sweep. For
// every directed edge e = (u, v) and step candidate s:
//
//   val_j   = w_dst[v, p] if ids_dst[v, p] == ids[u, j] < k_pad, else 0
//   nf_s,j  = clip(w[u, j] + eta_s * grad[u, j], min_f, max_f)
//   x_s     = sum_j nf_s,j * val_j
//   out[s, u] += log(clip(-expm1(-x_s), 1 - max_p, 1 - min_p)) + x_s
//
// The source rows (ids, w, grad) and the destination rows (ids_dst, w_dst)
// come apart: the state twice on one device, a shard's own rows and the
// gathered rows of every shard on the sparse mesh.
//
// What bounds it on this card: memory. A sweep must read the source rows
// (12 bytes a slot), the destination rows (8 bytes a slot) and src and dst
// once, and write the (S, N) sums: 1.62 GB at com-Youtube's N = 1,134,890,
// 2E = 5,975,248, M = 64 and S = 16, 0.48 ms at 3.35 TB/s. Its float32 work
// (the lookup's E M (log2 M + 1) compares and the dots' E S (2M + 2)
// operations) takes 0.23 ms at 67 TFLOP/s. Every edge gathers v's row (512
// bytes at M = 64), which L2 serves only in part.
//
// The design, on member_lookup.cu's span layout (member_rows.cuh):
//  * a warp takes a span of 32 consecutive edges, reads their src and dst
//    once, coalesced, and broadcasts them by shuffle. Lane l owns u's slots
//    l, l + 32, ... It reads u's ids, w and grad only when the source
//    changes and then forms nf_s for all 16 candidates, in registers up to
//    M = 64 (above, from w and grad at each edge), so on edges in CSR order
//    a source's rows are read about once.
//  * v's ids and weights are staged kMemberStages - 1 edges ahead in a
//    per-warp ring of shared memory by cp.async, and each lane finds its
//    ids there by the lower-bound search. The looked-up weights stay in
//    registers: nothing of an edge's slots reaches device memory.
//  * the 16 dots: each lane sums its slots, then one transposing reduction
//    (edge_common.cuh reduce16_transpose: 16 shuffles, where 16 warp sums
//    take 80) leaves x_s in lanes 2s and 2s + 1, which form candidate s's
//    edge term and add it to a register sum of the current source.
//  * the even lanes add a source's 16 sums into out (zeroed by the caller)
//    by atomics once per run of its edges in the span, so a run cut by a
//    span's border, and any edge order, sum right.
// The arithmetic is the plain version's (ops/sparse_members.py
// `sparse_candidates`): float32 with a float32 or float64 sum a node, the
// product and the sum of nf_s rounded apart (no contraction to an fma) and
// clipped before the dot, expm1f and logf, the clip bounds computed on the
// host in float64, and NaN passed through each clip as torch.clamp passes
// it. Only the order of the dots' and the nodes' sums differs.
#include "member_rows.cuh"

namespace {

using bigclam::kFull;
using bigclam::kMaxS;
using bigclam::kMemberStages;
using bigclam::kWarp;
using bigclam::StepParams;

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kMaxM = 1024;
constexpr int kSpan = kWarp;        // edges a warp: one id per lane
constexpr int kNfRegs = 2;          // slots a lane whose nf_s stay in registers

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// nf_s at one slot, its product and sum rounded apart as torch runs them.
__device__ __forceinline__ float step_row(float w, float g, float eta,
                                          const StepParams& p) {
  return clamp_nan(__fadd_rn(w, __fmul_rn(eta, g)), p.min_f, p.max_f);
}

template <int SPL, typename Acc>
__global__ void __launch_bounds__(kThreads)
cand_sweep_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                  const float* __restrict__ grad,
                  const int* __restrict__ ids_dst,
                  const float* __restrict__ w_dst,
                  const int64_t* __restrict__ src,
                  const int64_t* __restrict__ dst, int64_t e_count, int n,
                  int m, int k_pad, bool vec, StepParams p,
                  Acc* __restrict__ out) {
  constexpr bool kNfInRegs = SPL <= kNfRegs;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t e0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp) * kSpan;
  if (e0 >= e_count) return;  // whole warp
  const int rem = static_cast<int>(e_count - e0 < kSpan ? e_count - e0 : kSpan);
  const int words = 2 * bigclam::padded_m(m);
  float* ring = reinterpret_cast<float*>(smem4) + warp * kMemberStages * words;
  const int my_src = lane < rem ? bigclam::load_id(src + e0 + lane) : 0;
  const int my_dst = lane < rem ? bigclam::load_id(dst + e0 + lane) : 0;

  int next = 0;  // the next edge of the span whose v row is staged
  auto issue = [&](int slot) {
    if (next < rem)
      bigclam::stage_member_row(ring + slot * words, ids_dst, w_dst,
                                __shfl_sync(kFull, my_dst, next), m, lane, vec);
    ++next;
    bigclam::cp_async_commit();  // one group an edge, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kMemberStages - 1; ++s) issue(s);

  // lanes 2s and 2s + 1 hold x_s after the reduction; the even one sums
  // candidate s's terms of the current source and writes them
  const int cs = lane >> 1;
  const bool writer = (lane & 1) == 0 && cs < p.num_s;
  Acc* const out_cs = out + static_cast<int64_t>(cs) * n;
  Acc acc = 0;
  int cur = -1;   // the source whose rows the lane holds
  int t[SPL];     // u's ids at the lane's slots lane + 32 i (k_pad past m)
  float wu[SPL], gu[SPL];
  float nf[kNfInRegs ? kMaxS : 1][SPL];
  int slot = 0;
  for (int j = 0; j < rem; ++j) {
    issue(slot == 0 ? kMemberStages - 1 : slot - 1);
    const int u = __shfl_sync(kFull, my_src, j);
    if (u != cur) {  // the same in every lane
      if (cur >= 0 && writer) atomicAdd(out_cs + cur, acc);
      acc = 0;
      cur = u;
      bigclam::slot_row<SPL>(ids, w, u, m, k_pad, lane, t, wu);
      bigclam::slot_vals<SPL>(grad, u, m, lane, gu);
      if constexpr (kNfInRegs) {
#pragma unroll
        for (int s = 0; s < kMaxS; ++s)
#pragma unroll
          for (int i = 0; i < SPL; ++i) nf[s][i] = step_row(wu[i], gu[i], p.etas[s], p);
      }
    }
    bigclam::cp_async_wait<kMemberStages - 1>();  // edge j's row has landed
    __syncwarp();
    float val[SPL];
    bigclam::staged_lookup<SPL>(ring + slot * words, m, k_pad, t, val);
    __syncwarp();  // the slot is free for the next issue
    slot = slot == kMemberStages - 1 ? 0 : slot + 1;
    float part[kMaxS];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      part[s] = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        float f;
        if constexpr (kNfInRegs) {
          f = nf[s][i];
        } else {
          f = step_row(wu[i], gu[i], p.etas[s], p);
        }
        part[s] = fmaf(f, val[i], part[s]);
      }
    }
    const float x = bigclam::reduce16_transpose(part, lane);
    const float omp = clamp_nan(-expm1f(-x), p.omp_lo, p.omp_hi);
    acc += static_cast<Acc>(logf(omp) + x);
  }
  if (writer) atomicAdd(out_cs + cur, acc);
}

constexpr int64_t kPerBlock = static_cast<int64_t>(kWarpsPerBlock) * kSpan;

template <int SPL, typename Acc>
int launch(const int* ids, const float* w, const float* grad,
           const int* ids_dst, const float* w_dst, const int64_t* src,
           const int64_t* dst, int64_t e_count, int n, int m, int k_pad,
           bool vec, const StepParams& p, void* out, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((e_count + kPerBlock - 1) / kPerBlock);
  const int smem = kWarpsPerBlock * bigclam::member_ring_bytes(m);
  if (smem > bigclam::kSmemDefault) {
    const int rc = cudaFuncSetAttribute(cand_sweep_kernel<SPL, Acc>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem);
    if (rc != cudaSuccess) return rc;
  }
  cand_sweep_kernel<SPL, Acc><<<blocks, kThreads, smem, stream>>>(
      ids, w, grad, ids_dst, w_dst, src, dst, e_count, n, m, k_pad, vec, p,
      static_cast<Acc*>(out));
  return cudaSuccess;
}

template <int SPL>
int launch_acc(bool acc64, const int* ids, const float* w, const float* grad,
               const int* ids_dst, const float* w_dst, const int64_t* src,
               const int64_t* dst, int64_t e_count, int n, int m, int k_pad,
               bool vec, const StepParams& p, void* out, cudaStream_t stream) {
  return acc64 ? launch<SPL, double>(ids, w, grad, ids_dst, w_dst, src, dst,
                                     e_count, n, m, k_pad, vec, p, out, stream)
               : launch<SPL, float>(ids, w, grad, ids_dst, w_dst, src, dst,
                                    e_count, n, m, k_pad, vec, p, out, stream);
}

}  // namespace

// Adds, for the edges src[e] -> dst[e], every candidate's edge terms into
// out (num_s, n) of float32 (acc64 = 0) or float64 (acc64 = 1), rows of n
// source nodes, on `stream`; etas is a host array of num_s floats. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for m outside
// [1, 1024], num_s outside [1, 16] or more edges than one grid takes).
extern "C" int bigclam_cand_sweep(const int* ids, const float* w,
                                  const float* grad, const int* ids_dst,
                                  const float* w_dst, const int64_t* src,
                                  const int64_t* dst, int64_t e_count, int n,
                                  int m, int k_pad, const float* etas,
                                  int num_s, float omp_lo, float omp_hi,
                                  float min_f, float max_f, int acc64,
                                  void* out, void* stream) {
  if (m < 1 || m > kMaxM || num_s < 1 || num_s > kMaxS || e_count < 0 || n < 0)
    return cudaErrorInvalidValue;
  if (e_count == 0) return cudaSuccess;
  if ((e_count + kPerBlock - 1) / kPerBlock > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StepParams p = bigclam::make_params(etas, nullptr, num_s, omp_lo, omp_hi,
                                            min_f, max_f);
  // 16-byte copies need every destination row to start on 16 bytes
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(ids_dst) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w_dst) % 16 == 0;
#define BIGCLAM_SWEEP(SPL)                                                    \
  launch_acc<SPL>(acc64 != 0, ids, w, grad, ids_dst, w_dst, src, dst, e_count, \
                  n, m, k_pad, vec, p, out, s)
  int rc;
  if (m <= 32) {
    rc = BIGCLAM_SWEEP(1);
  } else if (m <= 64) {
    rc = BIGCLAM_SWEEP(2);
  } else if (m <= 128) {
    rc = BIGCLAM_SWEEP(4);
  } else if (m <= 256) {
    rc = BIGCLAM_SWEEP(8);
  } else if (m <= 512) {
    rc = BIGCLAM_SWEEP(16);
  } else {
    rc = BIGCLAM_SWEEP(32);
  }
#undef BIGCLAM_SWEEP
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
