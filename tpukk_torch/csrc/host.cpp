// Host planners of tpukk_torch: the plan-construction (symbolic) phases that
// run on the CPU before any kernel launches.  Copies of the same entry points
// of tpukk/native/tpukk_native.cpp, kept here so the port depends on nothing
// of tpukk:
//   * tpukk_iluk_symbolic  ILU(k) level-of-fill pattern  (sparse/spiluk.py)
//   * tpukk_ilu_numeric    IKJ ILU numeric on a pattern   (sparse/spiluk.py)
//   * tpukk_iluk_depth     entry-dependency DAG depth     (sparse/spiluk.py)
//   * tpukk_rcm            reverse Cuthill-McKee order    (graph/ordering.py,
//                          the RCM route of sparse/spmv.py)
//   * tpukk_d1_greedy_color  distance-1 greedy coloring   (graph/coloring.py,
//                          the SERIAL algorithm)
//   * tpukk_d2_greedy_color  distance-2 greedy coloring   (graph/coloring.py,
//                          graph_color_d2), G² never materialized
//   * tpukk_spgemm_symbolic_count, tpukk_spgemm_columns  C's pattern of
//                          C = A·B                    (sparse/spgemm.py)
//   * tpukk_triangle_count  triangles per row          (graph/triangle.py)
//   * tpukk_mdf_order      minimum-discarded-fill order  (sparse/mdf.py)
// The Python plain versions beside their callers (_iluk_pattern, the
// dense-row IKJ numeric, scipy's RCM, the greedy loop serial_greedy_plain,
// the numpy SpGEMM symbolic symbolic_plain, the numpy wedge count, the heap
// loop mdf_order_plain) are what the tests hold these against.
//
// Build (tpukk_torch/_kernels.py does this at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -o build/tpukk_torch/libhost.so host.cpp
// ABI: plain C, int32 indices, int64 sizes, double values.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <tuple>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// ILU(k) level-of-fill symbolic.
// Two-phase ABI: call with out_indices == nullptr to get the required nnz;
// call again with buffers to fill.  out_indptr has n+1 entries always.
int64_t tpukk_iluk_symbolic(int64_t n, int32_t fill_k,
                            const int32_t* a_indptr, const int32_t* a_indices,
                            int32_t* out_indptr, int32_t* out_indices) {
  // per-row sorted (col, level); rows kept for later rows' updates
  std::vector<std::vector<std::pair<int32_t, int32_t>>> rows(n);
  int64_t total = 0;
  // stamped workspace: level[c] valid only when stamp[c] == current row
  std::vector<int32_t> level(n, INT32_MAX);
  std::vector<int64_t> stamp(n, -1);
  auto get = [&](int64_t i, int32_t c) {
    return stamp[c] == i ? level[c] : INT32_MAX;
  };
  for (int64_t i = 0; i < n; ++i) {
    std::vector<int32_t> work;
    work.reserve(64);
    for (int32_t e = a_indptr[i]; e < a_indptr[i + 1]; ++e) {
      int32_t c = a_indices[e];
      if (get(i, c) == INT32_MAX) work.push_back(c);
      level[c] = 0; stamp[c] = i;
    }
    if (get(i, (int32_t)i) == INT32_MAX) { work.push_back((int32_t)i); }
    level[i] = 0; stamp[i] = i;
    std::sort(work.begin(), work.end());
    // IKJ merge: traverse work in ascending order; may grow
    for (size_t wi = 0; wi < work.size(); ++wi) {
      int32_t kk = work[wi];
      if (kk >= (int32_t)i) break;
      int32_t lik = get(i, kk);
      if (lik > fill_k) continue;
      const auto& rk = rows[kk];
      for (const auto& [jj, lkj] : rk) {
        if (jj <= kk) continue;
        int32_t f = lik + lkj + 1;
        if (f <= fill_k && f < get(i, jj)) {
          if (get(i, jj) == INT32_MAX) {
            // insert keeping work sorted beyond current position
            auto it = std::lower_bound(work.begin() + wi + 1, work.end(), jj);
            work.insert(it, jj);
          }
          level[jj] = f; stamp[jj] = i;
        }
      }
    }
    auto& out = rows[i];
    out.reserve(work.size());
    for (int32_t c : work) out.emplace_back(c, get(i, c));
    if (out_indices) {
      out_indptr[i] = (int32_t)total;
      for (size_t j = 0; j < out.size(); ++j)
        out_indices[total + j] = out[j].first;
    }
    total += (int64_t)out.size();
  }
  if (out_indices) out_indptr[n] = (int32_t)total;
  return total;
}

// ---------------------------------------------------------------------------
// ILU numeric (IKJ, pattern-restricted).  pattern rows must be sorted and
// include the diagonal.  Writes LU packed values aligned with the pattern.
int32_t tpukk_ilu_numeric(int64_t n,
                          const int32_t* p_indptr, const int32_t* p_indices,
                          const int32_t* a_indptr, const int32_t* a_indices,
                          const double* a_values, double* lu_values) {
  // stamped value workspace: w[c] valid only when wstamp[c] == current row
  // (touched positions can lie outside row i's pattern; stamping makes
  // discarded fill vanish without O(n) clears)
  std::vector<double> w(n, 0.0);
  std::vector<int64_t> wstamp(n, -1);
  std::vector<int64_t> diag_pos(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    auto wget = [&](int32_t c) { return wstamp[c] == i ? w[c] : 0.0; };
    auto wset = [&](int32_t c, double v) { w[c] = v; wstamp[c] = i; };
    int32_t s = p_indptr[i], e = p_indptr[i + 1];
    for (int32_t ea = a_indptr[i]; ea < a_indptr[i + 1]; ++ea)
      wset(a_indices[ea], a_values[ea]);
    for (int32_t idx = s; idx < e; ++idx) {
      int32_t kk = p_indices[idx];
      if (kk >= (int32_t)i) break;
      int64_t dp = diag_pos[kk];
      if (dp < 0) return -1;  // missing diagonal
      double ukk = lu_values[dp];
      if (ukk == 0.0) return -2;  // zero pivot
      double lik = wget(kk) / ukk;
      wset(kk, lik);
      // update with row kk's U part
      for (int32_t kidx = (int32_t)dp + 1; kidx < p_indptr[kk + 1]; ++kidx) {
        int32_t c = p_indices[kidx];
        wset(c, wget(c) - lik * lu_values[kidx]);
      }
    }
    for (int32_t idx = s; idx < e; ++idx) {
      int32_t c = p_indices[idx];
      lu_values[idx] = wget(c);
      if (c == (int32_t)i) diag_pos[i] = idx;
    }
    if (diag_pos[i] < 0) return -1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Entry-dependency depth of the ILU(k) pattern (device-numeric planning; cf.
// the level schedule of sparse/impl/KokkosSparse_spiluk_symbolic_impl.hpp's
// level_list — this is the finer ENTRY-level DAG depth).  An entry (i,j)
// depends on L(i,k)/U(k,j) pairs with k < min(i,j) and, for i>j, on U(j,j).
// A synchronous Chow sweep makes depth-s entries exact after s+1 sweeps, so
// the returned value (max level + 1) is the sweep count for an EXACT
// device factorization.  rm/ci: pattern CSR, sorted columns, diag present.
int32_t tpukk_iluk_depth(int64_t n, const int32_t* rm, const int32_t* ci) {
  std::vector<int32_t> lvl((size_t)rm[n], 0);
  std::vector<int32_t> dpos(n, -1);
  int32_t depth = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t e = rm[i]; e < rm[i + 1]; ++e) {
      int32_t j = ci[e];
      int32_t L = 0;
      int32_t kmax = j < (int32_t)i ? j : (int32_t)i;
      for (int32_t e2 = rm[i]; e2 < rm[i + 1] && ci[e2] < kmax; ++e2) {
        int32_t k = ci[e2];
        const int32_t* lo = ci + rm[k];
        const int32_t* hi = ci + rm[k + 1];
        const int32_t* it = std::lower_bound(lo, hi, j);
        if (it != hi && *it == j) {
          int32_t pkj = (int32_t)(rm[k] + (it - lo));
          int32_t d = std::max(lvl[e2], lvl[pkj]) + 1;
          if (d > L) L = d;
        }
      }
      if (j < (int32_t)i && dpos[j] >= 0 && lvl[dpos[j]] + 1 > L)
        L = lvl[dpos[j]] + 1;
      if (j == (int32_t)i) dpos[i] = e;
      lvl[e] = L;
      if (L > depth) depth = L;
    }
  }
  return depth + 1;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering (role of graph/impl/KokkosGraph_BFS_impl.hpp:113
// and graph/src/KokkosGraph_RCM.hpp).  BFS-based: per connected component a
// George-Liu pseudo-peripheral start, then Cuthill-McKee BFS with neighbors
// visited in ascending-degree order; the whole order is reversed at the end.
// perm[new] = old (scipy reverse_cuthill_mckee convention).  Caller passes a
// symmetric pattern.
void tpukk_rcm(int64_t n, const int32_t* rm, const int32_t* ent,
               int32_t* perm) {
  std::vector<int32_t> deg(n);
  for (int64_t v = 0; v < n; ++v) deg[v] = rm[v + 1] - rm[v];
  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> level(n);
  std::vector<int32_t> frontier, next, order;
  order.reserve(n);

  // BFS from s over unvisited vertices; returns (eccentricity, min-degree
  // vertex of the last level); records the traversal in `touched`.
  std::vector<int32_t> touched;
  auto bfs = [&](int32_t s, int32_t* out_last) -> int32_t {
    touched.clear();
    frontier.clear();
    frontier.push_back(s);
    level[s] = 0;
    visited[s] = 1;
    touched.push_back(s);
    int32_t ecc = 0, last = s;
    while (!frontier.empty()) {
      next.clear();
      for (int32_t v : frontier) {
        for (int32_t e = rm[v]; e < rm[v + 1]; ++e) {
          int32_t u = ent[e];
          if (u == v || visited[u]) continue;
          visited[u] = 1;
          level[u] = level[v] + 1;
          touched.push_back(u);
          next.push_back(u);
        }
      }
      if (!next.empty()) {
        ecc = level[next[0]];
        last = next[0];
        for (int32_t v : next)
          if (deg[v] < deg[last]) last = v;
      }
      frontier.swap(next);
    }
    *out_last = last;
    return ecc;
  };

  for (int64_t seed = 0; seed < n; ++seed) {
    if (visited[seed]) continue;
    // component start: the unvisited min-degree vertex is `seed`'s job only
    // approximately; George-Liu refines it.
    int32_t start = (int32_t)seed;
    int32_t last, ecc = bfs(start, &last);
    for (int iter = 0; iter < 8; ++iter) {
      for (int32_t v : touched) visited[v] = 0;
      int32_t last2, ecc2 = bfs(last, &last2);
      if (ecc2 <= ecc) { start = last; break; }
      ecc = ecc2;
      last = last2;
      start = last;
    }
    for (int32_t v : touched) visited[v] = 0;
    // Cuthill-McKee BFS from start, neighbors in ascending-degree order.
    size_t head = order.size();
    order.push_back(start);
    visited[start] = 1;
    std::vector<int32_t> nbr;
    while (head < order.size()) {
      int32_t v = order[head++];
      nbr.clear();
      for (int32_t e = rm[v]; e < rm[v + 1]; ++e) {
        int32_t u = ent[e];
        if (u == v || visited[u]) continue;
        visited[u] = 1;
        nbr.push_back(u);
      }
      std::sort(nbr.begin(), nbr.end(), [&](int32_t a, int32_t b) {
        return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
      });
      for (int32_t u : nbr) order.push_back(u);
    }
  }
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------------
// Distance-1 greedy coloring. colors are 1-based; returns max color used.
int32_t tpukk_d1_greedy_color(int64_t n, const int32_t* row_map,
                              const int32_t* entries, int32_t* colors) {
  std::vector<int32_t> mark(n + 2, -1);
  int32_t max_color = 0;
  for (int64_t v = 0; v < n; ++v) {
    for (int32_t e = row_map[v]; e < row_map[v + 1]; ++e) {
      int32_t u = entries[e];
      if (u == v) continue;
      int32_t cu = colors[u];
      if (cu > 0) mark[cu] = (int32_t)v;
    }
    int32_t c = 1;
    while (mark[c] == (int32_t)v) ++c;
    colors[v] = c;
    if (c > max_color) max_color = c;
  }
  return max_color;
}

// ---------------------------------------------------------------------------
// Distance-2 greedy coloring WITHOUT materializing G² (role of
// graph/impl/KokkosGraph_Distance2Color_impl.hpp's forbidden-array sweep,
// O(n) memory instead of O(sum deg²) storage).  Two modes:
//   include_d1 = 1 (square symmetric graph): forbidden(v) = colors of
//     N(v) ∪ N(N(v)) — pass rm_t/ent_t == rm/ent.
//   include_d1 = 0 (bipartite/rectangular, rows colored): forbidden(v) =
//     colors of every row sharing a column with v; rm_t/ent_t is the
//     column→row transpose (m columns).
// colors 1-based (the caller passes them zeroed); returns max color used.
int32_t tpukk_d2_greedy_color(int64_t n, const int32_t* rm, const int32_t* ent,
                              int64_t m, const int32_t* rm_t,
                              const int32_t* ent_t, int32_t include_d1,
                              int32_t* colors) {
  (void)m;
  std::vector<int64_t> mark(n + 2, -1);  // mark[c] == v → color c forbidden
  int32_t max_color = 0;
  for (int64_t v = 0; v < n; ++v) {
    for (int32_t e = rm[v]; e < rm[v + 1]; ++e) {
      int32_t w = ent[e];
      if (include_d1 && w != (int32_t)v) {
        int32_t cw = colors[w];
        if (cw > 0 && cw <= (int32_t)n + 1) mark[cw] = v;
      }
      for (int32_t f = rm_t[w]; f < rm_t[w + 1]; ++f) {
        int32_t u = ent_t[f];
        if (u == (int32_t)v) continue;
        int32_t cu = colors[u];
        if (cu > 0 && cu <= (int32_t)n + 1) mark[cu] = v;
      }
    }
    int32_t c = 1;
    while (mark[c] == v) ++c;
    colors[v] = c;
    if (c > max_color) max_color = c;
  }
  return max_color;
}

// ---------------------------------------------------------------------------
// SpGEMM host symbolic (sparse/spgemm.py::_symbolic_host; role of the
// reference's StructureC hashmap symbolic, KokkosSparse_spgemm_impl_symbolic
// .hpp:528-577).  A dense-marker pattern count, then a pass that emits C's
// columns, sorted within each row.  tpukk's tpukk_spgemm_pairs also writes
// a pair plan in the same pass; the numeric kernel here (K8) works from the
// pattern alone, so this writes none.
int64_t tpukk_spgemm_symbolic_count(int64_t n, const int32_t* rmA,
                                    const int32_t* ciA, int64_t bcols,
                                    const int32_t* rmB, const int32_t* ciB,
                                    int32_t* row_map_c) {
  std::vector<int64_t> marker(bcols, -1);
  int64_t nnz_c = 0;
  row_map_c[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t cnt = 0;
    for (int32_t ap = rmA[i]; ap < rmA[i + 1]; ++ap) {
      int32_t k = ciA[ap];
      for (int32_t bp = rmB[k]; bp < rmB[k + 1]; ++bp) {
        int32_t c = ciB[bp];
        if (marker[c] != i) {
          marker[c] = i;
          ++cnt;
        }
      }
    }
    nnz_c += cnt;
    row_map_c[i + 1] = (int32_t)nnz_c;  // the caller refuses nnz_c >= 2^31
  }
  return nnz_c;
}

void tpukk_spgemm_columns(int64_t n, const int32_t* rmA, const int32_t* ciA,
                          int64_t bcols, const int32_t* rmB, const int32_t* ciB,
                          const int32_t* row_map_c, int32_t* entries_c) {
  // the sorted unique row pattern is extracted from a per-row column bitmap
  // (epoch-reset words + ctz scan)
  const int64_t nwords = (bcols + 63) >> 6;
  std::vector<uint64_t> bits(nwords, 0);
  std::vector<int64_t> wepoch(nwords, -1);
  std::vector<int32_t> touched;
  touched.reserve(nwords);
  for (int64_t i = 0; i < n; ++i) {
    touched.clear();
    int64_t npairs_row = 0;
    for (int32_t ap = rmA[i]; ap < rmA[i + 1]; ++ap) {
      int32_t k = ciA[ap];
      npairs_row += rmB[k + 1] - rmB[k];
      for (int32_t bp = rmB[k]; bp < rmB[k + 1]; ++bp) {
        int32_t c = ciB[bp];
        int64_t w = c >> 6;
        if (wepoch[w] != i) {
          wepoch[w] = i;
          bits[w] = 0;
          touched.push_back((int32_t)w);
        }
        bits[w] |= (uint64_t)1 << (c & 63);
      }
    }
    // sorted unique columns: scan all words when the row is dense enough,
    // else sort the (much shorter) touched-word list
    int32_t* out = entries_c + row_map_c[i];
    auto emit_word = [&](int64_t w) {
      uint64_t m = bits[w];
      while (m) {
        int b = __builtin_ctzll(m);
        m &= m - 1;
        *out++ = (int32_t)((w << 6) | b);
      }
    };
    if (npairs_row * 8 >= nwords) {
      for (int64_t w = 0; w < nwords; ++w)
        if (wepoch[w] == i) emit_word(w);
    } else {
      std::sort(touched.begin(), touched.end());
      for (int32_t w : touched) emit_word(w);
    }
  }
}

// ---------------------------------------------------------------------------
// Triangle counting on the strict lower triangle (graph/triangle.py):
// mark-based row intersection (the serial analog of the reference's
// mergeAnd/TriangleCount hashmap inserts, HashmapAccumulator.hpp:167-272).
// For each row i: mark N_L(i); for each k in N_L(i), count marked members of
// N_L(k).  Writes per-row counts; returns the total.
int64_t tpukk_triangle_count(int64_t n, const int32_t* row_map,
                             const int32_t* entries, int64_t* per_row) {
  std::vector<int64_t> stamp(n, -1);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = row_map[i], e = row_map[i + 1];
    for (int32_t p = s; p < e; ++p) stamp[entries[p]] = i;
    int64_t cnt = 0;
    for (int32_t p = s; p < e; ++p) {
      int32_t k = entries[p];
      for (int32_t q = row_map[k]; q < row_map[k + 1]; ++q)
        if (stamp[entries[q]] == i) ++cnt;
    }
    per_row[i] = cnt;
    total += cnt;
  }
  return total;
}

// ---------------------------------------------------------------------------
// MDF (minimum discarded fill) greedy elimination order (sparse/mdf.py;
// role of sparse/impl/KokkosSparse_mdf_impl.hpp).  Pattern-restricted
// incomplete elimination: scores cached in a lazy-invalidation min-heap,
// recomputed only for the eliminated vertex's live row/column neighbors.
// Matches the plain version's order (sparse/mdf.py: mdf_order_plain)
// exactly (same (score, stamp, vertex) tie-breaking).
void tpukk_mdf_order(int64_t n, const int32_t* rm, const int32_t* ci,
                     const double* vals_in, int32_t* order_out) {
  const int64_t nnz = rm[n];
  std::vector<double> vals(vals_in, vals_in + nnz);
  // CSC pattern
  std::vector<int64_t> cc(n + 1, 0);
  std::vector<int32_t> ri(nnz);
  for (int64_t p = 0; p < nnz; ++p) cc[ci[p] + 1]++;
  for (int64_t j = 0; j < n; ++j) cc[j + 1] += cc[j];
  {
    std::vector<int64_t> w(cc.begin(), cc.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int32_t p = rm[i]; p < rm[i + 1]; ++p) ri[w[ci[p]]++] = (int32_t)i;
  }
  auto pos = [&](int32_t i, int32_t j) -> int64_t {
    const int32_t* b = ci + rm[i];
    const int32_t* e = ci + rm[i + 1];
    const int32_t* it = std::lower_bound(b, e, j);
    return (it != e && *it == j) ? (int64_t)(it - ci) : -1;
  };
  std::vector<int64_t> diag(n);
  for (int64_t i = 0; i < n; ++i) diag[i] = pos((int32_t)i, (int32_t)i);
  std::vector<char> alive(n, 1);
  std::vector<int64_t> stamp(n, 0);
  std::vector<int32_t> R, C;
  std::vector<double> rv;
  auto gather = [&](int32_t v) {
    R.clear(); C.clear(); rv.clear();
    for (int64_t p = cc[v]; p < cc[v + 1]; ++p) {
      int32_t r = ri[p];
      if (alive[r] && r != v) R.push_back(r);
    }
    for (int32_t p = rm[v]; p < rm[v + 1]; ++p) {
      int32_t c = ci[p];
      if (alive[c] && c != v) { C.push_back(c); rv.push_back(vals[p]); }
    }
  };
  auto score = [&](int32_t v) -> double {
    int64_t dp = diag[v];
    double piv = dp >= 0 ? vals[dp] : 0.0;
    if (piv == 0.0) return std::numeric_limits<double>::infinity();
    gather(v);
    if (R.empty() || C.empty()) return 0.0;
    double s = 0.0;
    for (int32_t r : R) {
      double cv = vals[pos(r, v)];
      for (size_t t = 0; t < C.size(); ++t) {
        if (pos(r, C[t]) < 0) {
          double u = cv * rv[t] / piv;
          s += u * u;
        }
      }
    }
    return s;
  };
  using Item = std::tuple<double, int64_t, int32_t>;
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
  for (int64_t v = 0; v < n; ++v) heap.emplace(score((int32_t)v), 0, (int32_t)v);
  std::vector<int32_t> Rv, Cv;
  std::vector<double> rvv;
  std::vector<char> bumped(n, 0);
  for (int64_t step = 0; step < n; ++step) {
    int32_t v = -1;
    while (!heap.empty()) {
      Item it = heap.top();
      heap.pop();
      int32_t u = std::get<2>(it);
      if (alive[u] && std::get<1>(it) == stamp[u]) { v = u; break; }
    }
    if (v < 0)
      for (int64_t u = 0; u < n; ++u)
        if (alive[u]) { v = (int32_t)u; break; }
    order_out[step] = v;
    int64_t dp = diag[v];
    double piv = (dp >= 0 && vals[dp] != 0.0) ? vals[dp] : 1.0;
    gather(v);
    Rv = R; Cv = C; rvv = rv;
    for (int32_t r : Rv) {
      double cv = vals[pos(r, v)];
      for (size_t t = 0; t < Cv.size(); ++t) {
        int64_t pc = pos(r, Cv[t]);
        if (pc >= 0) vals[pc] -= cv * rvv[t] / piv;
      }
    }
    alive[v] = 0;
    for (int32_t u : Rv) {
      if (alive[u] && !bumped[u]) {
        bumped[u] = 1;
        stamp[u]++;
        heap.emplace(score(u), stamp[u], u);
      }
    }
    for (int32_t u : Cv) {
      if (alive[u] && !bumped[u]) {
        bumped[u] = 1;
        stamp[u]++;
        heap.emplace(score(u), stamp[u], u);
      }
    }
    for (int32_t u : Rv) bumped[u] = 0;
    for (int32_t u : Cv) bumped[u] = 0;
  }
}

}  // extern "C"
