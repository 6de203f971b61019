// Sparse member lookup of BigCLAM's top-M representation, for Hopper.
//
// Replaces the TPU kernel bigclam_tpu/ops/sparse_members.py
// `member_lookup_pallas` (path `sparse_merge_pallas`). For every edge
// e = (u, v) of a chunk and every own slot j of u:
//   out[e, j] = w[v, p]  if ids[v, p] == ids[u, j] < k_pad for some p,
//               0        otherwise,
// with ids (N_pad, M) sorted ascending per row, unique per row, and padded
// with the sentinel k_pad. Output: (E_chunk, M) float32.
//
// The TPU kernel merges an edge block's GATHERED member lists with M
// unrolled slot-compare sweeps over VMEM tiles (M^2 dense compares instead
// of scattered loads). Here a lane group reads the two rows straight from
// the state instead: the neighbour row's M ids and weights are staged in
// shared memory (coalesced), then each lane binary-searches them for its
// own slots' ids (lower bound, as torch.searchsorted does). A hit copies
// the stored weight and a miss writes 0, so the result equals the plain
// version bit for bit.
//
// Layout: a group of G lanes per edge, G the smallest power of two >= M
// up to 32 (a whole warp for M > 16), 128 threads a block; lane l owns
// slots l, l+G, l+2G, ... Shared memory is 8 bytes per slot per group, so
// M = 1024 takes 32 KB a block.
//
// What bounds it on this card: memory. Per edge it must read the two
// endpoints (16 bytes of src/dst) and write M floats; the state rows
// (8 bytes per slot) come once from device memory in the best case. At
// M = 64 the write of vals (256 bytes per edge) is 88% of those bytes.
#include "edge_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 1024;

template <int G>
__global__ void __launch_bounds__(kThreads)
member_lookup_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                     const int64_t* __restrict__ src,
                     const int64_t* __restrict__ dst, int64_t e_count, int m,
                     int k_pad, float* __restrict__ out) {
  constexpr int kGroups = kThreads / G;
  extern __shared__ unsigned char smem[];
  int* s_ids = reinterpret_cast<int*>(smem);
  float* s_w = reinterpret_cast<float*>(s_ids + kGroups * m);

  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kGroups + group;
  // every lane of a group shares e: a group leaves, or stays, whole
  if (e >= e_count) return;
  // the lanes of this group within the warp (G % 32 keeps the shift
  // defined when G is a whole warp)
  const unsigned mask =
      G == bigclam::kWarp
          ? bigclam::kFull
          : ((1u << (G % bigclam::kWarp)) - 1u)
                << ((threadIdx.x % bigclam::kWarp) / G * G);

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
    o[j] = val;
  }
}

template <int G>
void launch(const int* ids, const float* w, const int64_t* src,
            const int64_t* dst, int64_t e_count, int m, int k_pad, float* out,
            cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int64_t blocks = (e_count + kGroups - 1) / kGroups;
  const size_t smem = static_cast<size_t>(kGroups) * m * 8;
  member_lookup_kernel<G><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      ids, w, src, dst, e_count, m, k_pad, out);
}

}  // namespace

// Writes out (e_count, m) for the edges src[e] -> dst[e] on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for m
// outside [1, 1024] or more edge blocks than one grid takes).
extern "C" int bigclam_member_lookup(const int* ids, const float* w,
                                     const int64_t* src, const int64_t* dst,
                                     int64_t e_count, int m, int k_pad,
                                     float* out, void* stream) {
  if (m < 1 || m > kMaxM || e_count < 0) return cudaErrorInvalidValue;
  if (e_count == 0) return cudaSuccess;
  if (e_count > static_cast<int64_t>(0x7fffffff)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1) {
    launch<1>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m == 2) {
    launch<2>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m <= 4) {
    launch<4>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m <= 8) {
    launch<8>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else if (m <= 16) {
    launch<16>(ids, w, src, dst, e_count, m, k_pad, out, s);
  } else {
    launch<32>(ids, w, src, dst, e_count, m, k_pad, out, s);
  }
  return cudaGetLastError();
}
