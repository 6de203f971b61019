// Shared device code of the BigCLAM edge kernels for Hopper: the
// single-pass ones (fused_superstep.cu, grad_llh.cu, candidates.cu), the
// ring-phase ones (ring_grad_phase.cu, ring_cand_phase.cu), the candidate
// edge terms (candidate_edge_terms.cu) and the K-blocked ones
// (edge_dots_kb.cu, grad_from_x.cu, cand_dots_kb.cu, cand_from_x.cu), which
// take a window of at most kMaxK columns of wider rows. The candidate
// kernels (A, C, #9, #14 and cand_dots_kb) share the staged ladder below,
// B and #8 the staged neighbour gradient (staged_grad_pass), edge_dots_kb
// and grad_from_x the staged window walk (window_walk). The sparse kernels
// (member_lookup.cu, cand_sweep.cu) take its warp helpers and
// reduce16_transpose through member_rows.cuh.
//
// Layout: the kernels read the graph's CSR directly. One warp owns one
// source node u; its neighbours are the contiguous slice
// indices[indptr[u], indptr[u+1]). Lane j holds the columns
// k = j, j+32, j+64, ... of the rows it touches (KPL = columns per lane,
// a compile-time bucket of ceil(K/32)), so every row load is 32
// consecutive floats per step: coalesced 128-byte transactions. Columns
// k >= K load as 0, so any K <= 1024 works, multiple of 32 or not.
//
// Every node's update reads only OLD rows (the JAX step is a Jacobi
// update), so nodes are independent: no atomics, and each node's sums run
// in neighbour order, which makes a run reproducible bit for bit.
//
// Numerics follow bigclam_tpu/ops/objective.py `edge_terms`:
// omp = clip(-expm1(-x), 1-max_p, 1-min_p), ell = log(omp) + x, with
// expm1f/logf and IEEE division (the build uses no --use_fast_math). The
// clip bounds, the 16 step sizes and alpha*eta come from the host as the
// float32-rounded values the JAX kernels see.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bigclam {

constexpr int kWarp = 32;
constexpr int kMaxS = 16;            // Armijo candidate slots
constexpr int kMaxK = 1024;          // 32 columns per lane
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// The scalars of one launch. Kernel B reads the survival clip bounds
// only; C adds the ladder and the projection; A also the acceptance
// coefficients. One block serves all three on purpose: with the block split
// per kernel, nvcc 12.9 hoisted the 16 x KPL candidate rows of pass 2 out
// of the neighbour loop into local memory, and kernels A and C ran 7x and
// 4.4x slower on an H100 at K=1000.
struct StepParams {
  float etas[kMaxS];    // step candidates (slots >= num_s are 0, unused)
  float coefs[kMaxS];   // float32(alpha * eta), as the fused JAX kernel rounds it
  float omp_lo;         // 1 - max_p
  float omp_hi;         // 1 - min_p
  float min_f;
  float max_f;
  int num_s;
};

// Columns-per-lane bucket for K, or 0 when K is outside [1, kMaxK].
inline int kpl_bucket(int K) {
  if (K < 1 || K > kMaxK) return 0;
  const int need = (K + kWarp - 1) / kWarp;
  int b = 1;
  while (b < need) b <<= 1;
  return b;
}

// The parameter block from host arrays of num_s floats (nullptr: zeros)
// and the scalars.
inline StepParams make_params(const float* etas, const float* coefs, int num_s,
                              float omp_lo, float omp_hi, float min_f,
                              float max_f) {
  StepParams p;
  for (int s = 0; s < kMaxS; ++s) {
    p.etas[s] = etas && s < num_s ? etas[s] : 0.f;
    p.coefs[s] = coefs && s < num_s ? coefs[s] : 0.f;
  }
  p.omp_lo = omp_lo;
  p.omp_hi = omp_hi;
  p.min_f = min_f;
  p.max_f = max_f;
  p.num_s = num_s;
  return p;
}

// Butterfly all-reduce: every lane ends with the same bits (each step adds
// the same two operands in both lanes of a pair).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Transposing reduction of 16 per-lane partials in 16 shuffles (8+4+2+1+1),
// instead of 16 separate 5-shuffle all-reduces: each step halves the values
// a lane keeps and doubles the lanes they are summed over. On return the
// warp total of candidate s = lane >> 1 is in the result (lanes 2s and 2s+1
// hold the same bits), so the per-candidate transcendentals that follow are
// spread over the lanes instead of repeated in every one.
__device__ __forceinline__ float reduce16_transpose(float (&v)[kMaxS], int lane) {
  {
    const bool up = lane & 16;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float send = up ? v[j] : v[j + 8];
      const float keep = up ? v[j + 8] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float send = up ? v[j] : v[j + 4];
      const float keep = up ? v[j + 4] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, 8);
    }
  }
  {
    const bool up = lane & 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float send = up ? v[j] : v[j + 2];
      const float keep = up ? v[j + 2] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, 4);
    }
  }
  {
    const bool up = lane & 2;
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// Step size and alpha*eta of candidate s (unrolled select: no dynamic
// indexing into the parameter block).
__device__ __forceinline__ void candidate_of(const StepParams& p, int s,
                                             float& eta, float& coef) {
  eta = 0.f;
  coef = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxS; ++j) {
    if (j == s) {
      eta = p.etas[j];
      coef = p.coefs[j];
    }
  }
}

__device__ __forceinline__ float survival(float x, const StepParams& p) {
  return fminf(fmaxf(-expm1f(-x), p.omp_lo), p.omp_hi);
}

__device__ __forceinline__ float clip_f(float v, const StepParams& p) {
  return fminf(fmaxf(v, p.min_f), p.max_f);
}

template <int KPL>
__device__ __forceinline__ void load_row(const float* __restrict__ M,
                                         int64_t row, int K, int lane,
                                         float (&r)[KPL]) {
  const float* p = M + row * static_cast<int64_t>(K);
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    r[i] = k < K ? __ldg(p + k) : 0.f;
  }
}

template <int KPL>
__device__ __forceinline__ void store_row(float* __restrict__ M, int64_t row,
                                          int K, int lane,
                                          const float (&r)[KPL]) {
  float* p = M + row * static_cast<int64_t>(K);
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    if (k < K) p[k] = r[i];
  }
}

// Column windows of the K-blocked kernels (edge_dots_kb.cu, grad_from_x.cu):
// lane j holds the columns col0 + j + 32 i of `row` in a
// matrix of row stride `stride`; window columns at or past kc load as 0 and
// are not stored.
template <int KPL>
__device__ __forceinline__ void load_window(const float* __restrict__ M,
                                            int64_t row, int64_t stride,
                                            int col0, int kc, int lane,
                                            float (&r)[KPL]) {
  const float* p = M + row * stride + col0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    r[i] = k < kc ? __ldg(p + k) : 0.f;
  }
}

template <int KPL>
__device__ __forceinline__ void store_window(float* __restrict__ M,
                                             int64_t row, int64_t stride,
                                             int col0, int kc, int lane,
                                             const float (&r)[KPL]) {
  float* p = M + row * stride + col0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    if (k < kc) p[k] = r[i];
  }
}

// The window arguments every K-blocked entry takes: a window of kc in
// [1, kMaxK] columns starting at col0 inside rows of k_pad columns.
inline bool window_ok(int k_pad, int col0, int kc) {
  return kc >= 1 && kc <= kMaxK && col0 >= 0 &&
         static_cast<int64_t>(col0) + kc <= k_pad;
}

// Calls body(v) for every neighbour v of u, in CSR order. The warp reads 32
// neighbour ids at once (one per lane) and broadcasts them by shuffle, so
// the row loads do not wait on a dependent index load per edge.
template <typename Body>
__device__ __forceinline__ void for_each_neighbor(
    const int64_t* __restrict__ indptr, const int* __restrict__ indices,
    int u, int lane, Body&& body) {
  const int64_t e0 = indptr[u];
  const int64_t e1 = indptr[u + 1];
  for (int64_t base = e0; base < e1; base += kWarp) {
    const int64_t rem = e1 - base;
    const int cnt = rem < kWarp ? static_cast<int>(rem) : kWarp;
    const int mine = lane < cnt ? __ldg(indices + base + lane) : 0;
    for (int j = 0; j < cnt; ++j) body(__shfl_sync(kFull, mine, j));
  }
}

// Fold: g <- nbr - sumF + F_u in place. Returns ||g||^2; `tail` gets the
// node tail -F_u.sumF + F_u.F_u.
template <int KPL>
__device__ __forceinline__ float fold_grad(const float* __restrict__ sumF,
                                           int K, int lane,
                                           const float (&fu)[KPL],
                                           float (&g)[KPL], float& tail) {
  float gg = 0.f, fs = 0.f, ff = 0.f;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + kWarp * i;
    const float sf = k < K ? __ldg(sumF + k) : 0.f;
    g[i] = (g[i] - sf) + fu[i];
    gg = fmaf(g[i], g[i], gg);
    fs = fmaf(fu[i], sf, fs);
    ff = fmaf(fu[i], fu[i], ff);
  }
  tail = -warp_sum(fs) + warp_sum(ff);
  return warp_sum(gg);
}

// ---------------------------------------------------------------------------
// The candidate ladder on a staged gather: kernels A, C and #9 over a
// node's neighbourhood (ladder_pass), #14 over runs of edges with one source
// and cand_dots_kb over a column window of a node's neighbourhood
// (ladder_range with their own epilogues).
//
// Rebuilding nf_s = clip(F_u + eta_s g_u) for every neighbour (the design
// these kernels had before) costs an fma, a max and a min besides the dot's
// fma, where the function needs one fma, and walks one neighbour row at a
// time. The ladder computes the same sums as a blocked product on the FP32
// cores. The function needs S(2K + 2)
// operations per directed edge (about 272 GFLOP at N=300,000, K=1,024, 8.5 M
// edges: 4.1 ms at 67 TFLOP/s) and one gathered neighbour row per edge
// (34.8 GB there, which kernel B gathers with help from L2):
//
//  * the neighbours are taken in tiles of kLadderRows and K in chunks of
//    kLadderChunk columns; per (tile, chunk) stage the warp builds nf_s for
//    the chunk once in shared memory (16 x 32 values, 1/32 of a full tile's
//    fmas), and cp.async copies the next stage's rows (16-byte copies, 8
//    lanes per 128-byte row segment, coalesced; 4-byte copies when a row's
//    columns do not start on 16 bytes or K is not a multiple of 4; rows sit
//    `ld` floats apart, so the columns may be a window of wider rows, as in
//    cand_dots_kb) into the other of two buffers while this one's fmas
//    run. Rows are gathered by index, which TMA cannot do; the ladder's 16
//    candidates and a B operand that changes with every node do not fit
//    wgmma, and tensor cores would change the dots' rounding.
//  * lane = 8 cg + ng owns the 4 x 4 dots of candidates 4cg..4cg+3 with the
//    tile's neighbours ng, ng+8, ng+16, ng+24: per 4 columns it loads 4 float4
//    of nf (the same address in the 8 lanes of a group: a broadcast) and 4
//    float4 of rows (8 distinct rows per group), then issues 64 fmas. The
//    paddings (kTileStride, kNfGroupStride) put those reads on distinct banks.
//    On an H100 (chip_smoke.py) #9 takes 21.9 ms a sweep of the unbalanced
//    ring layout where kernel #8 gathers the same rows in 11.1: no one part
//    binds the pass. Builds with the copies, the fmas or the shared-memory
//    reads taken out in turn each ran faster, the last least: the copies'
//    latency is only partly hidden behind one stage of fmas, and the fma
//    issue and the per-stage work (nf, bookkeeping) share the rest.
//  * with kRowGroups, a tile of cnt < 25 edges runs only its ceil(cnt / 8)
//    row groups (a separate instantiation each): in a ring bucket a node has
//    about a quarter of its edges, at xl_k about 7 in all, and a full 32-row
//    tile would spend most of its fmas and shared-memory reads on rows
//    without an edge (#9, #14, cand_dots_kb). Kernels A and C walk whole
//    neighbourhoods and take the 4-group code only: on an H100 the three
//    extra instantiations cost A more in instruction fetch than they saved.
//  * after a tile's last chunk each lane evaluates its own dots' terms
//    ell(x) = log(clip(-expm1(-x))) + x, or takes the dots as they are. The
//    epilogue is the caller's: A, C and #9 (LadderSum) add the 4 candidate
//    sums across the 8 lanes of the group by a fixed butterfly and then over
//    the tiles in CSR order, so a hub loops over tiles and a run is
//    reproducible bit for bit; #14 stores each term as it is
//    (candidate_edge_terms.cu); cand_dots_kb adds each dot, without a term,
//    to the edge's window sum (cand_dots_kb.cu).
//
// One warp's shared memory, kLadderFloats floats: two tile buffers of
// kLadderRows rows x kTileStride floats, then nf as [group][column][4] with
// groups kNfGroupStride floats apart. ops/csr_kernels.py `ladder_launch_plan`
// mirrors these sizes; the C entries check that the two agree.
constexpr int kLadderRows = 32;                          // neighbours a tile
constexpr int kLadderChunk = 32;                         // columns a chunk
constexpr int kTileStride = kLadderChunk + 4;            // floats a tile row
constexpr int kTileFloats = kLadderRows * kTileStride;
constexpr int kNfGroupStride = 4 * kLadderChunk + 4;     // floats a group
constexpr int kNfFloats = 4 * kNfGroupStride;
constexpr int kLadderFloats = 2 * kTileFloats + kNfFloats;
constexpr int kSmemDefault = 48 * 1024;  // above: cudaFuncSetAttribute

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes, zero-filled when `on` is false.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A row id of Fd from an int32 CSR index or an int64 edge endpoint.
__device__ __forceinline__ int load_id(const int* p) { return __ldg(p); }
__device__ __forceinline__ int load_id(const int64_t* p) {
  return static_cast<int>(__ldg(reinterpret_cast<const long long*>(p)));
}

// The ids of tile t of the edge range [e0, e1) (lane r holds row r's id)
// and, in `cnt`, how many of its kLadderRows rows are edges.
template <typename Id>
__device__ __forceinline__ int tile_ids(const Id* __restrict__ indices,
                                        int64_t e0, int64_t e1, int64_t t,
                                        int lane, int& cnt) {
  const int64_t base = e0 + kLadderRows * t;
  const int64_t rem = e1 - base;
  cnt = rem < kLadderRows ? static_cast<int>(rem) : kLadderRows;
  return lane < cnt ? load_id(indices + base + lane) : 0;
}

// Copies columns [col0, col0 + kLadderChunk) of the tile's cnt rows of Fd
// (row v at Fd + v * ld) into `buf`, columns past K zero-filled; rows past
// cnt are not copied (their dots are never read). `vec`: K and ld are
// multiples of 4 and Fd is 16-byte aligned, so every 16-byte segment is
// whole.
__device__ __forceinline__ void issue_stage(float* buf, const float* Fd, int K,
                                            int ld, int ids, int cnt, int col0,
                                            int lane, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kLadderRows * kLadderChunk / (4 * kWarp); ++i) {
      const int q = lane + kWarp * i;
      const int r = q >> 3, seg = q & 7;
      const int v = __shfl_sync(kFull, ids, r);
      const int k = col0 + 4 * seg;
      if (r < cnt)
        cp_async16(buf + r * kTileStride + 4 * seg,
                   k < K ? Fd + static_cast<int64_t>(v) * ld + k : Fd, k < K);
    }
  } else {
    const int k = col0 + lane;
    for (int r = 0; r < cnt; ++r) {
      const int v = __shfl_sync(kFull, ids, r);
      cp_async4(buf + r * kTileStride + lane,
                k < K ? Fd + static_cast<int64_t>(v) * ld + k : Fd, k < K);
    }
  }
}

// nf_s for the columns of chunk c: lane j builds column c * kLadderChunk + j
// (0 past K) from F_u and g_u, which col(k, f, g) reads.
template <typename Col>
__device__ __forceinline__ void build_nf(float* nf, Col& col, int c, int K,
                                         int lane, const StepParams& p) {
  const int k = c * kLadderChunk + lane;
  const bool in = k < K;
  float f = 0.f, g = 0.f;
  if (in) col(k, f, g);
#pragma unroll
  for (int cg = 0; cg < 4; ++cg) {
    float4 v;
    v.x = in ? clip_f(fmaf(p.etas[4 * cg + 0], g, f), p) : 0.f;
    v.y = in ? clip_f(fmaf(p.etas[4 * cg + 1], g, f), p) : 0.f;
    v.z = in ? clip_f(fmaf(p.etas[4 * cg + 2], g, f), p) : 0.f;
    v.w = in ? clip_f(fmaf(p.etas[4 * cg + 3], g, f), p) : 0.f;
    *reinterpret_cast<float4*>(nf + cg * kNfGroupStride + 4 * lane) = v;
  }
}

// acc[c][j] += a[c] * b[j] for one column and the first JN rows.
template <int JN>
__device__ __forceinline__ void fma4xj(float (&acc)[4][4], const float4& a,
                                       const float (&b)[4]) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[c][j] = fmaf(av[c], b[j], acc[c][j]);
}

// One stage's dots: the lane's 4 candidates (nfg = its group's nf) against
// its rows ng + 8j, j < JN, of the tile (the tile's rows past 8 JN hold no
// edge), over the chunk's columns in order.
template <int JN>
__device__ __forceinline__ void ladder_fma(const float* tile, const float* nfg,
                                           int ng, float (&acc)[4][4]) {
#pragma unroll
  for (int k4 = 0; k4 < kLadderChunk / 4; ++k4) {
    float4 b[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j)
      b[j] = *reinterpret_cast<const float4*>(tile + (8 * j + ng) * kTileStride +
                                              4 * k4);
    float bx[4], by[4], bz[4], bw[4];
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      bx[j] = b[j].x;
      by[j] = b[j].y;
      bz[j] = b[j].z;
      bw[j] = b[j].w;
    }
    const float4* a = reinterpret_cast<const float4*>(nfg + 16 * k4);
    fma4xj<JN>(acc, a[0], bx);
    fma4xj<JN>(acc, a[1], by);
    fma4xj<JN>(acc, a[2], bz);
    fma4xj<JN>(acc, a[3], bw);
  }
}

// Where the copies of a ladder pass stand: the last issued stage (tile tn,
// chunk cn) and that tile's ids and row count.
struct LadderIssue {
  int64_t e0, e1, ntiles, st, stages;
  int64_t tn;
  int cn, nch, ids, cnt;
};

// The sum epilogue of kernels A and #9: adds the tile's ell terms to out[],
// the lane's 4 candidates summed over its rows and then across the 8 lanes
// of its group by a fixed butterfly.
struct LadderSum {
  float (&out)[4];

  template <int JN>
  __device__ __forceinline__ void tile(const float (&acc)[4][4], int cnt,
                                       int ng, int64_t, const StepParams& p) {
    float ts[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      if (8 * j + ng < cnt) {
#pragma unroll
        for (int a = 0; a < 4; ++a) ts[a] += logf(survival(acc[a][j], p)) + acc[a][j];
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a) ts[a] += __shfl_xor_sync(kFull, ts[a], o);
#pragma unroll
    for (int a = 0; a < 4; ++a) out[a] += ts[a];
  }
};

// The chunks of tile t (cnt rows, JN = ceil(cnt / 8) row groups): per
// chunk, sends the next stage's copies (the next tile's first chunk after
// the last), builds nf and waits for the chunk's rows; then hands the
// lane's dots acc[a][j] (candidate 4 (lane >> 3) + a, tile row 8j + ng) to
// epi.tile<JN>.
template <int JN, typename Id, typename Col, typename Epi>
__device__ __forceinline__ void ladder_tile(
    const float* Fd, const Id* __restrict__ indices, int K, int ld, int lane,
    bool vec, const StepParams& p, float* const (&buf)[2], float* nf,
    const float* nfg, int ng, int cnt, int64_t t, Col& col, LadderIssue& q,
    Epi& epi) {
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  for (int c = 0; c < q.nch; ++c, ++q.st) {
    if (++q.cn == q.nch) {
      q.cn = 0;
      if (++q.tn < q.ntiles) q.ids = tile_ids(indices, q.e0, q.e1, q.tn, lane, q.cnt);
    }
    if (q.st + 1 < q.stages)
      issue_stage(buf[(q.st + 1) & 1], Fd, K, ld, q.ids, q.cnt,
                  q.cn * kLadderChunk, lane, vec);
    cp_async_commit();
    build_nf(nf, col, c, K, lane, p);
    cp_async_wait_prior();
    __syncwarp();
    ladder_fma<JN>(buf[q.st & 1], nfg, ng, acc);
    __syncwarp();
  }
  epi.template tile<JN>(acc, cnt, ng, t, p);
}

// The ladder over the edge range [e0, e1) of one source u: columns [0, K)
// of the rows indices[e] of Fd (int32 CSR indices or int64 edge endpoints;
// row v at Fd + v * ld), with F_u and g_u read by col(k, f, g) for k < K;
// each tile's dots go to `epi`. `sm` is the warp's kLadderFloats floats of
// shared memory; `vec` as in issue_stage; kRowGroups: skip a tile's row
// groups without an edge.
template <bool kRowGroups, typename Id, typename Col, typename Epi>
__device__ __forceinline__ void ladder_range(
    const float* Fd, const Id* __restrict__ indices, int64_t e0, int64_t e1,
    int K, int ld, int lane, bool vec, const StepParams& p, float* sm,
    Col& col, Epi& epi) {
  LadderIssue q;
  q.e0 = e0;
  q.e1 = e1;
  if (q.e1 == q.e0) return;
  q.nch = (K + kLadderChunk - 1) / kLadderChunk;
  q.ntiles = (q.e1 - q.e0 + kLadderRows - 1) / kLadderRows;
  q.stages = q.ntiles * q.nch;
  q.st = 0;
  q.tn = 0;
  q.cn = 0;
  float* const buf[2] = {sm, sm + kTileFloats};
  float* const nf = sm + 2 * kTileFloats;
  const float* const nfg = nf + (lane >> 3) * kNfGroupStride;
  const int ng = lane & 7;
  q.ids = tile_ids(indices, q.e0, q.e1, 0, lane, q.cnt);
  issue_stage(buf[0], Fd, K, ld, q.ids, q.cnt, 0, lane, vec);
  cp_async_commit();
  for (int64_t t = 0; t < q.ntiles; ++t) {
    const int64_t rem = q.e1 - q.e0 - kLadderRows * t;
    const int cnt = rem < kLadderRows ? static_cast<int>(rem) : kLadderRows;
#define BIGCLAM_LADDER_TILE(JN)                                         \
  ladder_tile<JN>(Fd, indices, K, ld, lane, vec, p, buf, nf, nfg, ng, cnt, \
                  t, col, q, epi)
    switch (kRowGroups ? (cnt + 7) >> 3 : 4) {  // row groups with an edge
      case 1: BIGCLAM_LADDER_TILE(1); break;
      case 2: BIGCLAM_LADDER_TILE(2); break;
      case 3: BIGCLAM_LADDER_TILE(3); break;
      default: BIGCLAM_LADDER_TILE(4); break;
    }
#undef BIGCLAM_LADDER_TILE
  }
}

// For every candidate s, sum_v ell(nf_s . F_v) over u's neighbours, with F_v
// rows of Fd (as in staged_grad_pass) and F_u, g_u read by col(k, f, g) for
// k < K. On return out[c] holds the sum of candidate 4 (lane >> 3) + c, the
// same bits in the 8 lanes of the group (0 for a node without neighbours);
// the sums run over the tiles in CSR order. Arguments as in ladder_range,
// with rows of K floats (ld = K).
template <bool kRowGroups, typename Col>
__device__ __forceinline__ void ladder_pass(
    const float* Fd, const int64_t* __restrict__ indptr,
    const int* __restrict__ indices, int u, int K, int lane, bool vec,
    const StepParams& p, float* sm, Col&& col, float (&out)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = 0.f;
  LadderSum sum{out};
  ladder_range<kRowGroups>(Fd, indices, indptr[u], indptr[u + 1], K, K, lane,
                           vec, p, sm, col, sum);
}

// ---------------------------------------------------------------------------
// The staged neighbour gradient: kernels B (grad_llh.cu) and #8
// (ring_grad_phase.cu) over a node's neighbourhood, on the staged row walk
// (window_walk) that the K-blocked window passes share.
//
// Per neighbour the pass needs the dot F_u.F_v, a warp_sum, expm1f/logf and
// a division before the axpy acc += F_v / omp can run. Loading each row
// into registers and only then starting that chain leaves one row in
// flight a warp. Here the warp stages the next
// kGradStages - 1 rows of its neighbour list in shared memory by cp.async
// (16-byte copies, 4-byte when K is not a multiple of 4 or the rows are not
// 16-byte aligned) while it works on the current one. Lane j reads columns
// j, j + 32, ... of each staged row (conflict-free shared reads), so every
// dot and sum runs in neighbour order, in the same operations as a pass
// over rows in registers would.
constexpr int kGradStages = 3;  // staged rows a warp: one in use, two in flight

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the K floats of row v of Fd (row v at Fd + v * ld; a column window
// of wider rows when Fd points at the window's first column) into `dst`,
// the columns past K not written.
__device__ __forceinline__ void stage_row(float* dst, const float* Fd, int v,
                                          int K, int ld, int lane, bool vec) {
  const float* src = Fd + static_cast<int64_t>(v) * ld;
  if (vec) {
    for (int q = lane; 4 * q < K; q += kWarp)
      cp_async16(dst + 4 * q, src + 4 * q, true);
  } else {
    for (int k = lane; k < K; k += kWarp) cp_async4(dst + k, src + k, true);
  }
}

// Calls body(e, j, fv) for every edge e of [e0, e1) in order, j = (e - e0)
// mod 32 and fv the K columns of row indices[e] of Fd (rows ld apart),
// staged in `ring` (kGradStages rows of 32 KPL floats) kGradStages - 1
// edges ahead; lane j holds columns j, j + 32, ... (0 past K).
template <int KPL, typename Body>
__device__ __forceinline__ void window_walk(
    const float* __restrict__ Fd, const int* __restrict__ indices, int64_t e0,
    int64_t e1, int K, int ld, int lane, bool vec, float* ring, Body&& body) {
  constexpr int kRow = kWarp * KPL;
  int64_t ei = e0;  // the next edge whose row is staged
  int ids = 0;      // lane j: the id of edge e0 + 32 floor((ei - e0) / 32) + j
  auto issue = [&](int slot) {
    if (ei < e1) {
      const int at = static_cast<int>((ei - e0) & (kWarp - 1));
      if (at == 0) ids = ei + lane < e1 ? __ldg(indices + ei + lane) : 0;
      stage_row(ring + slot * kRow, Fd, __shfl_sync(kFull, ids, at), K, ld,
                lane, vec);
    }
    ++ei;
    cp_async_commit();  // one group an edge, empty past the end
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
    body(e, static_cast<int>((e - e0) & (kWarp - 1)), fv);
  }
}

// Over the edges [e0, e1) with the rows indices[e] of Fd staged in `ring`
// (window_walk, rows K apart): acc = sum_v F_v / omp(F_u.F_v), returns
// sum_v ell (the same in every lane); acc = 0 and 0 for an empty range. Fd
// is F itself on one device, the gathered F on a mesh's all-gather
// schedule, the rotating shard in a ring phase.
template <int KPL>
__device__ __forceinline__ float staged_grad_pass(
    const float* __restrict__ Fd, const int* __restrict__ indices, int64_t e0,
    int64_t e1, int K, int lane, bool vec, float* ring,
    const float (&fu)[KPL], float (&acc)[KPL], const StepParams& p) {
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = 0.f;
  float llh = 0.f;
  window_walk<KPL>(Fd, indices, e0, e1, K, K, lane, vec, ring,
                   [&](int64_t, int, const float (&fv)[KPL]) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) part = fmaf(fu[i], fv[i], part);
    const float x = warp_sum(part);
    const float omp = survival(x, p);
    const float coeff = 1.0f / omp;
#pragma unroll
    for (int i = 0; i < KPL; ++i) acc[i] = fmaf(fv[i], coeff, acc[i]);
    llh += logf(omp) + x;
  });
  return llh;
}

// Shared-memory bytes of one block (4 warps) of the staged gradient kernels
// and the K-blocked window passes at KPL columns a lane: 48 KB at KPL 32.
constexpr int grad_smem_bytes(int kpl) {
  return 4 * kWarpsPerBlock * kGradStages * kWarp * kpl;
}
// every KPL bucket's rings fit the default shared memory: no opt-in
static_assert(grad_smem_bytes(kMaxK / kWarp) <= kSmemDefault);

// Shared-memory bytes of one block of the ladder kernels (4 warps): kernel A
// keeps F_u (32 KPL floats) and the 16 pass-2 sums beside each warp's ladder
// buffers, C the 16 sums; #9, #14 and cand_dots_kb only the ladder buffers.
inline int fused_smem_bytes(int kpl) {
  return 4 * kWarpsPerBlock * (kWarp * kpl + kLadderFloats + kMaxS);
}
inline int candidates_smem_bytes() {
  return 4 * kWarpsPerBlock * (kLadderFloats + kMaxS);
}
inline int ring_cand_smem_bytes() {
  return 4 * kWarpsPerBlock * kLadderFloats;
}
inline int edge_terms_smem_bytes() { return ring_cand_smem_bytes(); }
inline int cand_dots_smem_bytes() { return ring_cand_smem_bytes(); }

}  // namespace bigclam

// The CUDA error text for the codes the C entries return. Every source of
// the library defines it weak, so the link keeps one copy.
extern "C" __attribute__((weak)) const char* bigclam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Instantiates LAUNCH<KPL>(args) for the bucket of K; sets `rc` to
// cudaErrorInvalidValue when K is out of range.
#define BIGCLAM_DISPATCH_KPL(K, LAUNCH, rc, ...)                     \
  switch (bigclam::kpl_bucket(K)) {                                  \
    case 1: LAUNCH<1>(__VA_ARGS__); break;                           \
    case 2: LAUNCH<2>(__VA_ARGS__); break;                           \
    case 4: LAUNCH<4>(__VA_ARGS__); break;                           \
    case 8: LAUNCH<8>(__VA_ARGS__); break;                           \
    case 16: LAUNCH<16>(__VA_ARGS__); break;                         \
    case 32: LAUNCH<32>(__VA_ARGS__); break;                         \
    default: rc = cudaErrorInvalidValue; break;                      \
  }
