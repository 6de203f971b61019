// Copy of bigclam_tpu/graph/native/native.cpp for the PyTorch port (bigclam_tpu_torch/graph/native).
// Native host-side graph kernels for tpu-bigclam.
//
// The reference (thangdnsf/BigCLAM-ApacheSpark) has no native code at all —
// its ingest was Spark GraphLoader (JVM) and its two-hop conductance sweep a
// Spark map over broadcast neighbor lists (Bigclamv2.scala:14,42-59). These
// are the framework's host-side hot paths (device kernels are JAX/Pallas):
//
//   bc_parse_edge_list — streaming SNAP edge-list parser ('#' comments,
//       whitespace-separated integer pairs); one pass, no line splitting.
//   bc_triangle_counts — tri(u) = #edges among N(u), the masked-SpGEMM-style
//       two-hop pass behind the conductance closed forms (ops/seeding.py);
//       OpenMP over nodes with per-thread flag arrays, O(sum deg^2) work.
//
// Exposed to Python via ctypes (see __init__.py); NumPy fallbacks exist for
// every entry point, so the .so is an accelerator, not a dependency.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Returns a malloc'd buffer of 2*n_pairs int64 values (caller frees with
// bc_free). On failure returns nullptr with *n_pairs_out = -1 (parse error:
// odd token count or non-integer token) or -2 (I/O error).
int64_t* bc_parse_edge_list(const char* path, int64_t* n_pairs_out) {
  *n_pairs_out = -2;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc((size_t)sz + 1);
  if (!buf) {
    fclose(f);
    return nullptr;
  }
  if (sz > 0 && fread(buf, 1, (size_t)sz, f) != (size_t)sz) {
    free(buf);
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[sz] = '\0';

  std::vector<int64_t> vals;
  vals.reserve(1 << 20);
  const char* p = buf;
  const char* end = buf + sz;
  bool line_has_token = false;  // '#' only starts a comment at line start,
                                // matching the NumPy fallback's semantics
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) {
      if (*p == '\n') line_has_token = false;
      p++;
    }
    if (p >= end) break;
    if (*p == '#') {
      if (line_has_token) {  // mid-line '#': malformed, as in NumPy path
        free(buf);
        *n_pairs_out = -1;
        return nullptr;
      }
      while (p < end && *p != '\n') p++;
      continue;
    }
    line_has_token = true;
    bool neg = false;
    if (*p == '-' || *p == '+') {
      neg = (*p == '-');
      p++;
    }
    if (p >= end || *p < '0' || *p > '9') {
      free(buf);
      *n_pairs_out = -1;
      return nullptr;
    }
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      p++;
    }
    vals.push_back(neg ? -v : v);
  }
  free(buf);
  if (vals.size() % 2 != 0) {
    *n_pairs_out = -1;
    return nullptr;
  }
  int64_t* out = (int64_t*)malloc(vals.size() * sizeof(int64_t));
  if (!out) {
    *n_pairs_out = -2;
    return nullptr;
  }
  if (!vals.empty()) memcpy(out, vals.data(), vals.size() * sizeof(int64_t));
  *n_pairs_out = (int64_t)(vals.size() / 2);
  return out;
}

void bc_free(void* p) { free(p); }

// tri(u) = #edges among N(u): mark N(u) in a flag array, then count flagged
// entries across the neighbor lists of every v in N(u); each intra-
// neighborhood edge is seen twice.
void bc_triangle_counts(const int64_t* indptr, const int32_t* indices,
                        int64_t n, int64_t* out) {
#pragma omp parallel
  {
    std::vector<uint8_t> flags((size_t)n, 0);
#pragma omp for schedule(dynamic, 64)
    for (int64_t u = 0; u < n; u++) {
      int64_t lo = indptr[u], hi = indptr[u + 1];
      for (int64_t i = lo; i < hi; i++) flags[indices[i]] = 1;
      int64_t hits = 0;
      for (int64_t i = lo; i < hi; i++) {
        int32_t v = indices[i];
        for (int64_t j = indptr[v]; j < indptr[v + 1]; j++)
          hits += flags[indices[j]];
      }
      for (int64_t i = lo; i < hi; i++) flags[indices[i]] = 0;
      out[u] = hits / 2;
    }
  }
}

// Degree-capped triangle-count ESTIMATOR (ops/seeding.py documents the
// math): each node keeps a uniform sample of at most `cap` neighbors
// (partial Fisher-Yates, per-node splitmix64 stream, O(E) total); hits are
// weighted by deg(v)/|S_v| and the per-node total rescaled by
// C(deg,2)/C(|S|,2). With cap >= max degree this equals the exact count.
// Work O(n * cap^2) instead of the exact pass's O(sum deg^2).
static inline uint64_t bc_splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

void bc_triangle_counts_capped(const int64_t* indptr, const int32_t* indices,
                               int64_t n, int64_t cap, uint64_t seed,
                               double* out) {
  std::vector<int64_t> cptr((size_t)n + 1, 0);
  for (int64_t u = 0; u < n; u++) {
    int64_t d = indptr[u + 1] - indptr[u];
    cptr[u + 1] = cptr[u] + (d < cap ? d : cap);
  }
  std::vector<int32_t> cind((size_t)cptr[n]);
#pragma omp parallel
  {
    std::vector<int32_t> scratch;
#pragma omp for schedule(dynamic, 256)
    for (int64_t u = 0; u < n; u++) {
      int64_t lo = indptr[u], d = indptr[u + 1] - lo;
      int64_t cd = cptr[u + 1] - cptr[u];
      if (d <= cap) {
        for (int64_t i = 0; i < d; i++) cind[cptr[u] + i] = indices[lo + i];
        continue;
      }
      scratch.assign(indices + lo, indices + lo + d);
      uint64_t s = bc_splitmix64(seed ^ (uint64_t)u * 0x2545f4914f6cdd1dULL);
      for (int64_t i = 0; i < cd; i++) {  // partial Fisher-Yates
        s = bc_splitmix64(s);
        int64_t j = i + (int64_t)(s % (uint64_t)(d - i));
        int32_t tmp = scratch[i];
        scratch[i] = scratch[j];
        scratch[j] = tmp;
        cind[cptr[u] + i] = scratch[i];
      }
    }
  }
#pragma omp parallel
  {
    std::vector<uint8_t> flags((size_t)n, 0);
#pragma omp for schedule(dynamic, 64)
    for (int64_t u = 0; u < n; u++) {
      int64_t lo = cptr[u], hi = cptr[u + 1];
      int64_t cd = hi - lo;
      int64_t d = indptr[u + 1] - indptr[u];
      if (cd < 2) {
        out[u] = 0.0;
        continue;
      }
      for (int64_t i = lo; i < hi; i++) flags[cind[i]] = 1;
      double hits = 0.0;
      for (int64_t i = lo; i < hi; i++) {
        int32_t v = cind[i];
        int64_t vd = indptr[v + 1] - indptr[v];
        int64_t vc = cptr[v + 1] - cptr[v];
        double w = vc ? (double)vd / (double)vc : 0.0;
        for (int64_t j = cptr[v]; j < cptr[v + 1]; j++)
          if (flags[cind[j]]) hits += w;
      }
      for (int64_t i = lo; i < hi; i++) flags[cind[i]] = 0;
      double scale =
          (double)d * (double)(d - 1) / ((double)cd * (double)(cd - 1));
      out[u] = hits / 2.0 * scale;
    }
  }
}

// Greedy coverage-aware seed selection (quality mode's seeding rule;
// Python reference implementation: ops/seeding.select_seeds_covering).
// `order` is the caller-prepared candidate ranking (locally-minimal
// nominees first, then the remaining nodes by ascending phi); the walk
// skips candidates already covered by a chosen seed's hops-neighborhood.
// The hops=2 fan caps (stride subsample of N(s), first-`cap` prefix of
// each N(v)) replicate the NumPy slicing bit-exactly so both backends
// choose identical seeds. Returns the number of seeds written (<= k).
int64_t bc_select_seeds_covering(const int64_t* indptr,
                                 const int32_t* indices, int64_t n,
                                 const int64_t* order, int64_t n_order,
                                 int64_t k, int64_t hops, int64_t cap,
                                 int64_t* seeds_out) {
  std::vector<uint8_t> covered(n, 0);
  int64_t cnt = 0;
  for (int64_t oi = 0; oi < n_order && cnt < k; ++oi) {
    int64_t s = order[oi];
    if (s < 0 || s >= n || covered[s]) continue;
    seeds_out[cnt++] = s;
    covered[s] = 1;
    int64_t lo = indptr[s], hi = indptr[s + 1], deg = hi - lo;
    for (int64_t e = lo; e < hi; ++e) covered[indices[e]] = 1;
    if (hops >= 2) {
      // nbrs[::max(deg//cap, 1)][:cap] when deg > cap, else all of N(s)
      int64_t step = 1, limit = deg;
      if (deg > cap) {
        step = deg / cap;
        if (step < 1) step = 1;
        limit = cap;
      }
      int64_t taken = 0;
      for (int64_t e = lo; e < hi && taken < limit; e += step, ++taken) {
        int64_t v = indices[e];
        int64_t vlo = indptr[v], vcnt = indptr[v + 1] - vlo;
        if (vcnt > cap) vcnt = cap;                  // row[:cap]
        for (int64_t f = vlo; f < vlo + vcnt; ++f) covered[indices[f]] = 1;
      }
    }
  }
  return cnt;
}

}  // extern "C"
