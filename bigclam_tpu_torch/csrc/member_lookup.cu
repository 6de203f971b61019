// Sparse member lookup of BigCLAM's top-M representation, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/sparse_members.py
// `member_lookup_pallas` (path `sparse_merge_pallas`). For every edge
// e = (u, v) of a chunk and every own slot j of u:
//   out[e, j] = w[v, p]  if ids[v, p] == ids[u, j] < k_pad for some p,
//               0        otherwise,
// with ids (N_pad, M) in [0, k_pad], sorted ascending per row, unique per
// row, and padded with the sentinel k_pad. Output: (E_chunk, M) float32.
//
// The TPU kernel merges an edge block's GATHERED member lists with M
// unrolled slot-compare sweeps over VMEM tiles (M^2 dense compares instead
// of scattered loads). Here the two rows are read straight from the state,
// and each lane finds its own slots' ids in the neighbour row: by a lower
// bound search of the row (as torch.searchsorted finds it) or, where k_pad
// is small, in a direct-address table. A hit copies the stored weight and a
// miss writes 0, so the result equals the plain version bit for bit, for
// any edge order.
//
// What bounds it on this card: memory. Per edge it must read the two
// endpoints (16 bytes of src/dst) and write M floats; the state rows
// (8 bytes per slot) come once from device memory in the best case. At
// M = 64 the write of out (256 bytes per edge, 2.2 GB a sweep of the
// N=300,000 graph's 8.5 M edges) is 88% of those bytes. Every edge also
// gathers v's row (512 bytes at M = 64), which L2 serves in part.
//
// Three layouts:
//  * M <= 16: a group of G lanes per edge, G the smallest power of two
//    >= M, 128 threads a block; lane l owns slots l, l+G, ... The rows are
//    loaded by the group, then searched.
//  * M > 16 (the main path's M = 64): a warp takes a span of 32
//    consecutive edges. It reads their src and dst once, coalesced (lane j
//    reads edge e0 + j), and broadcasts them by shuffle. Lane l owns
//    slots l, l + 32, ...: it keeps u's ids for them in registers and
//    reloads them only when the source changes, so on edges in CSR order
//    (a source's edges in a row, about 28 at N=300,000) u's row is read
//    about once a source. Then, by k_pad and M:
//    - k_pad <= kTableIds (the main path's 1,024) and M <= kTableM: a
//      table in shared memory maps a community id to {edge, weight}. Per
//      edge the warp writes v's members into it, tagged with the edge's
//      index, and each lane reads its own ids' entries: a hit is an entry
//      of this edge. No clearing: an older tag is a miss. That is 2
//      shared-memory writes and 2 reads a lane at M = 64, where a binary
//      search takes 18 reads with bank conflicts; v's row is loaded into
//      registers one edge ahead. With ids unique per row the hit is the
//      searched one.
//    - otherwise (the table would not fit, or a lane's slots would not fit
//      its registers three times over): v's ids and weights are
//      staged kMemberStages - 1 edges ahead in a per-warp ring of shared
//      memory by cp.async (16-byte copies when M % 4 == 0 and the rows
//      start on 16 bytes, else 4-byte copies), so the search of edge e
//      overlaps the loads of e + 1 and e + 2. The search takes a fixed
//      number of halving steps for all of a lane's slots at once, so their
//      shared-memory reads overlap.
// out is written with evict-first stores (st.global.cs), so that the 2.2
// GB a sweep does not push the state rows the next edges read out of the
// 50 MB L2. The row helpers (slot loads, staging, the search) live in
// member_rows.cuh, shared with the candidate sweep (cand_sweep.cu).
#include "member_rows.cuh"

namespace {

using bigclam::kFull;
using bigclam::kMemberStages;
using bigclam::kWarp;
using bigclam::padded_m;
using bigclam::slot_ids;
using bigclam::slot_row;

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kMaxM = 1024;
constexpr int kSpan = kWarp;        // edges a warp: one id per lane
constexpr int kTableIds = 1024;     // k_pad at most: 32 KB of tables a block
constexpr int kTableM = 128;        // M at most (4 slots a lane, no spill)

// Shared-memory bytes of one block of the span kernel: 96 KB at M = 1,024,
// so above 48 KB it needs the opt-in.
inline int span_smem_bytes(int m) {
  return kWarpsPerBlock * bigclam::member_ring_bytes(m);
}

// An id that indexes the table (the sentinel k_pad does not).
__device__ __forceinline__ bool in_table(int c, int k_pad) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(k_pad);
}

template <int SPL>
__global__ void __launch_bounds__(kThreads)
member_lookup_table_kernel(const int* __restrict__ ids,
                           const float* __restrict__ w,
                           const int64_t* __restrict__ src,
                           const int64_t* __restrict__ dst, int64_t e_count,
                           int m, int k_pad, float* __restrict__ out) {
  extern __shared__ int2 tables[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t e0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp) * kSpan;
  if (e0 >= e_count) return;  // whole warp
  // entry c: {the last edge whose v row holds c, c's weight there}
  int2* tab = tables + warp * k_pad;
  for (int c = lane; c < k_pad; c += kWarp) tab[c] = make_int2(-1, 0);
  __syncwarp();
  const int rem = static_cast<int>(e_count - e0 < kSpan ? e_count - e0 : kSpan);
  const int my_src = lane < rem ? bigclam::load_id(src + e0 + lane) : 0;
  const int my_dst = lane < rem ? bigclam::load_id(dst + e0 + lane) : 0;
  int vid[SPL];
  float vw[SPL];
  slot_row<SPL>(ids, w, __shfl_sync(kFull, my_dst, 0), m, k_pad, lane, vid, vw);
  int cur = -1;  // the source whose ids t holds
  int t[SPL];
  for (int j = 0; j < rem; ++j) {
    int nid[SPL];  // the next edge's v row, in flight while this one runs
    float nw[SPL];
    if (j + 1 < rem)
      slot_row<SPL>(ids, w, __shfl_sync(kFull, my_dst, j + 1), m, k_pad, lane,
                    nid, nw);
    const int u = __shfl_sync(kFull, my_src, j);
    if (u != cur) {  // the same in every lane
      cur = u;
      slot_ids<SPL>(ids, u, m, k_pad, lane, t);
    }
    const int tag = static_cast<int>(e0 + j);
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      if (in_table(vid[i], k_pad))
        tab[vid[i]] = make_int2(tag, __float_as_int(vw[i]));
    __syncwarp();
    float* o = out + (e0 + j) * m;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int2 x = in_table(t[i], k_pad) ? tab[t[i]] : make_int2(-1, 0);
      const int k = lane + kWarp * i;
      if (k < m) __stcs(o + k, x.x == tag ? __int_as_float(x.y) : 0.f);
    }
    __syncwarp();  // every lane has read before the next edge writes
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      vid[i] = nid[i];
      vw[i] = nw[i];
    }
  }
}

template <int SPL>
__global__ void __launch_bounds__(kThreads)
member_lookup_span_kernel(const int* __restrict__ ids,
                          const float* __restrict__ w,
                          const int64_t* __restrict__ src,
                          const int64_t* __restrict__ dst, int64_t e_count,
                          int m, int k_pad, bool vec,
                          float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t e0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp) * kSpan;
  if (e0 >= e_count) return;  // whole warp
  const int rem = static_cast<int>(e_count - e0 < kSpan ? e_count - e0 : kSpan);
  const int words = 2 * padded_m(m);
  float* ring = reinterpret_cast<float*>(smem4) + warp * kMemberStages * words;
  const int my_src = lane < rem ? bigclam::load_id(src + e0 + lane) : 0;
  const int my_dst = lane < rem ? bigclam::load_id(dst + e0 + lane) : 0;

  int next = 0;  // the next edge of the span whose v row is staged
  auto issue = [&](int slot) {
    if (next < rem)
      bigclam::stage_member_row(ring + slot * words, ids, w,
                                __shfl_sync(kFull, my_dst, next), m, lane, vec);
    ++next;
    bigclam::cp_async_commit();  // one group an edge, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kMemberStages - 1; ++s) issue(s);

  int cur = -1;   // the source whose ids t holds
  int t[SPL];     // u's ids at the lane's slots lane + 32 i (k_pad past m)
  int slot = 0;
  for (int j = 0; j < rem; ++j) {
    issue(slot == 0 ? kMemberStages - 1 : slot - 1);
    const int u = __shfl_sync(kFull, my_src, j);
    if (u != cur) {  // the same in every lane
      cur = u;
      slot_ids<SPL>(ids, u, m, k_pad, lane, t);
    }
    bigclam::cp_async_wait<kMemberStages - 1>();  // edge j's row has landed
    __syncwarp();
    float val[SPL];
    bigclam::staged_lookup<SPL>(ring + slot * words, m, k_pad, t, val);
    __syncwarp();  // the slot is free for the next issue
    slot = slot == kMemberStages - 1 ? 0 : slot + 1;
    float* o = out + (e0 + j) * m;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int k = lane + kWarp * i;
      if (k < m) __stcs(o + k, val[i]);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
member_lookup_group_kernel(const int* __restrict__ ids,
                           const float* __restrict__ w,
                           const int64_t* __restrict__ src,
                           const int64_t* __restrict__ dst, int64_t e_count,
                           int m, int k_pad, float* __restrict__ out) {
  constexpr int kGroups = kThreads / G;
  extern __shared__ unsigned char smem[];
  int* s_ids = reinterpret_cast<int*>(smem);
  float* s_w = reinterpret_cast<float*>(s_ids + kGroups * m);

  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kGroups + group;
  // every lane of a group shares e: a group leaves, or stays, whole
  if (e >= e_count) return;
  // the lanes of this group within the warp
  const unsigned mask = ((1u << G) - 1u) << ((threadIdx.x % kWarp) / G * G);

  int* my_ids = s_ids + group * m;
  float* my_w = s_w + group * m;
  const int64_t v = dst[e];
  const int64_t u = src[e];
  const int* __restrict__ iv = ids + v * m;
  const float* __restrict__ wv = w + v * m;
  for (int j = lane; j < m; j += G) {
    my_ids[j] = __ldg(iv + j);
    my_w[j] = __ldg(wv + j);
  }
  __syncwarp(mask);

  const int* __restrict__ iu = ids + u * m;
  float* __restrict__ o = out + e * m;
  for (int j = lane; j < m; j += G) {
    const int t = __ldg(iu + j);
    float val = 0.f;
    if (t < k_pad) {
      int lo = 0, hi = m;                 // first p with my_ids[p] >= t
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (my_ids[mid] < t) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (lo < m && my_ids[lo] == t) val = my_w[lo];
    }
    __stcs(o + j, val);
  }
}

template <int G>
void launch_groups(const int* ids, const float* w, const int64_t* src,
                   const int64_t* dst, int64_t e_count, int m, int k_pad,
                   float* out, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int64_t blocks = (e_count + kGroups - 1) / kGroups;
  const size_t smem = static_cast<size_t>(kGroups) * m * 8;
  member_lookup_group_kernel<G>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          ids, w, src, dst, e_count, m, k_pad, out);
}

// M > 16: the table kernel when k_pad <= kTableIds and M <= kTableM, else
// the staged search; a warp takes kSpan edges in both.
template <int SPL>
int launch_spans(const int* ids, const float* w, const int64_t* src,
                 const int64_t* dst, int64_t e_count, int m, int k_pad,
                 bool vec, float* out, cudaStream_t stream) {
  constexpr int64_t kPerBlock = static_cast<int64_t>(kWarpsPerBlock) * kSpan;
  const unsigned blocks =
      static_cast<unsigned>((e_count + kPerBlock - 1) / kPerBlock);
  if constexpr (SPL <= kTableM / kWarp) {
    if (k_pad <= kTableIds) {
      const size_t smem =
          static_cast<size_t>(kWarpsPerBlock) * k_pad * sizeof(int2);
      member_lookup_table_kernel<SPL><<<blocks, kThreads, smem, stream>>>(
          ids, w, src, dst, e_count, m, k_pad, out);
      return cudaSuccess;
    }
  }
  const int smem = span_smem_bytes(m);
  if (smem > bigclam::kSmemDefault) {
    const int rc = cudaFuncSetAttribute(member_lookup_span_kernel<SPL>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem);
    if (rc != cudaSuccess) return rc;
  }
  member_lookup_span_kernel<SPL><<<blocks, kThreads, smem, stream>>>(
      ids, w, src, dst, e_count, m, k_pad, vec, out);
  return cudaSuccess;
}

}  // namespace

// Writes out (e_count, m) for the edges src[e] -> dst[e] on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for m
// outside [1, 1024] or more edges than one grid takes).
extern "C" int bigclam_member_lookup(const int* ids, const float* w,
                                     const int64_t* src, const int64_t* dst,
                                     int64_t e_count, int m, int k_pad,
                                     float* out, void* stream) {
  if (m < 1 || m > kMaxM || e_count < 0) return cudaErrorInvalidValue;
  if (e_count == 0) return cudaSuccess;
  if (e_count > static_cast<int64_t>(0x7fffffff)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row of ids and w to start on 16 bytes
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int rc = cudaSuccess;
  if (m == 1) {
    launch_groups<1>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m == 2) {
    launch_groups<2>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m <= 4) {
    launch_groups<4>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m <= 8) {
    launch_groups<8>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m <= 16) {
    launch_groups<16>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m <= 32) {
    rc = launch_spans<1>(ids, w, src, dst, e_count, m, k_pad, vec, out, s);
  } else if (m <= 64) {
    rc = launch_spans<2>(ids, w, src, dst, e_count, m, k_pad, vec, out, s);
  } else if (m <= 128) {
    rc = launch_spans<4>(ids, w, src, dst, e_count, m, k_pad, vec, out, s);
  } else if (m <= 256) {
    rc = launch_spans<8>(ids, w, src, dst, e_count, m, k_pad, vec, out, s);
  } else if (m <= 512) {
    rc = launch_spans<16>(ids, w, src, dst, e_count, m, k_pad, vec, out, s);
  } else {
    rc = launch_spans<32>(ids, w, src, dst, e_count, m, k_pad, vec, out, s);
  }
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
