// Member rows of the sparse top-M state, shared by the member lookup
// (member_lookup.cu) and the candidate sweep (cand_sweep.cu). A row is M
// int32 ids in [0, k_pad], sorted ascending, unique and padded with the
// sentinel k_pad, beside M float32 weights. Lane l of a warp holds a row's
// slots l, l + 32, ... (SPL slots a lane). A neighbour's row is staged in
// shared memory by cp.async, M ids and then M weights from word
// padded_m(m) on, in a per-warp ring of kMemberStages rows, and each lane
// finds its own ids there by a lower-bound search.
#pragma once

#include "edge_common.cuh"

namespace bigclam {

constexpr int kMemberStages = 3;    // staged rows: one in use, two in flight

// Words (4 bytes) of one staged row pair: M ids, then M weights from word
// `padded_m(m)` on, so that both halves start on 16 bytes.
inline __host__ __device__ int padded_m(int m) { return (m + 3) & ~3; }

// Shared-memory bytes of one warp's ring of staged rows.
inline int member_ring_bytes(int m) { return 4 * kMemberStages * 2 * padded_m(m); }

// Lower bound of t in row[0, m) (the first p with row[p] >= t, or m), for
// SPL values of t at once: the same halving steps for every t (they depend
// on m alone), so the SPL chains of shared-memory reads interleave.
template <int SPL>
__device__ __forceinline__ void lower_bounds(const int* row, int m,
                                             const int (&t)[SPL],
                                             int (&pos)[SPL]) {
#pragma unroll
  for (int i = 0; i < SPL; ++i) pos[i] = 0;
  for (int n = m; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      pos[i] = row[pos[i] + half] < t[i] ? pos[i] + half : pos[i];
    n -= half;
  }
#pragma unroll
  for (int i = 0; i < SPL; ++i) pos[i] += row[pos[i]] < t[i] ? 1 : 0;
}

// Copies v's ids and weights into the row pair at `dst` (ids at word 0,
// weights at word padded_m(m)).
__device__ __forceinline__ void stage_member_row(float* dst, const int* ids,
                                                 const float* w, int v, int m,
                                                 int lane, bool vec) {
  const int64_t at = static_cast<int64_t>(v) * m;
  const float* iv = reinterpret_cast<const float*>(ids + at);
  const float* wv = w + at;
  if (vec) {  // m % 4 == 0: padded_m(m) == m, so chunk q lands at word 4q
    const int mq = m >> 2;
    for (int q = lane; q < 2 * mq; q += kWarp)
      cp_async16(dst + 4 * q, q < mq ? iv + 4 * q : wv + 4 * (q - mq), true);
  } else {
    const int mp = padded_m(m);
    for (int k = lane; k < m; k += kWarp) {
      cp_async4(dst + k, iv + k, true);
      cp_async4(dst + mp + k, wv + k, true);
    }
  }
}

// Row r's ids at the lane's slots lane + 32 i (k_pad past m).
template <int SPL>
__device__ __forceinline__ void slot_ids(const int* ids, int r, int m,
                                         int k_pad, int lane, int (&id)[SPL]) {
  const int* p = ids + static_cast<int64_t>(r) * m;
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int k = lane + kWarp * i;
    id[i] = k < m ? __ldg(p + k) : k_pad;
  }
}

// Row r of a float matrix of m columns at the lane's slots (0 past m).
template <int SPL>
__device__ __forceinline__ void slot_vals(const float* x, int r, int m,
                                          int lane, float (&v)[SPL]) {
  const float* p = x + static_cast<int64_t>(r) * m;
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int k = lane + kWarp * i;
    v[i] = k < m ? __ldg(p + k) : 0.f;
  }
}

// Row r's ids and weights at the lane's slots lane + 32 i.
template <int SPL>
__device__ __forceinline__ void slot_row(const int* ids, const float* w, int r,
                                         int m, int k_pad, int lane,
                                         int (&id)[SPL], float (&wt)[SPL]) {
  slot_ids<SPL>(ids, r, m, k_pad, lane, id);
  slot_vals<SPL>(w, r, m, lane, wt);
}

// The weight that the staged row pair `row` holds for each of the lane's
// ids t, or 0 where the row lacks it (the sentinel k_pad never matches).
template <int SPL>
__device__ __forceinline__ void staged_lookup(const float* row, int m,
                                              int k_pad, const int (&t)[SPL],
                                              float (&val)[SPL]) {
  const int* row_ids = reinterpret_cast<const int*>(row);
  int pos[SPL];
  lower_bounds<SPL>(row_ids, m, t, pos);
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int p = pos[i];
    val[i] = t[i] < k_pad && p < m && row_ids[p] == t[i] ? row[padded_m(m) + p]
                                                         : 0.f;
  }
}

}  // namespace bigclam
