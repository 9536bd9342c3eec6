// Host-side graph algorithms for prealps_tpu (C ABI, loaded via ctypes).
//
// Native replacements for the METIS/ParMETIS roles of the reference
// (reference: utils/cplm_v0/cplm_v0_metis_utils.c CPLM_metisKwayOrdering,
// utils/cplm_light/cplm_matcsr.c CPLM_MatCSROrderingND): k-way partitioning
// by recursive bisection (BFS-grown + Fiduccia–Mattheyses boundary
// refinement), reverse Cuthill-McKee ordering, and greedy vertex-separator
// extraction. All routines are deterministic.
//
// Graph input: symmetric CSR adjacency without self loops (indptr / indices,
// int32), n vertices.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

using std::vector;

// BFS levels within the sub-vertex set marked by mask; returns farthest vertex.
static int bfs_levels(int n, const int32_t* indptr, const int32_t* indices,
                      const vector<char>& mask, int start, vector<int>& level) {
  std::fill(level.begin(), level.end(), -1);
  vector<int> frontier, next;
  frontier.push_back(start);
  level[start] = 0;
  int last = start;
  int lv = 0;
  while (!frontier.empty()) {
    ++lv;
    next.clear();
    for (int v : frontier) {
      for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        int u = indices[e];
        if (mask[u] && level[u] < 0) {
          level[u] = lv;
          next.push_back(u);
          last = u;
        }
      }
    }
    frontier.swap(next);
  }
  return last;
}

static int pseudo_peripheral(int n, const int32_t* indptr, const int32_t* indices,
                             const vector<char>& mask, int seed,
                             vector<int>& level) {
  int start = seed;
  for (int it = 0; it < 3; ++it) {
    int far = bfs_levels(n, indptr, indices, mask, start, level);
    if (far == start) break;
    start = far;
  }
  return start;
}

// FM-style refinement of a 2-way split restricted to `verts`.
static void fm_refine(int n, const int32_t* indptr, const int32_t* indices,
                      const vector<int>& verts, vector<char>& side,
                      const vector<char>& mask, int target, int slack,
                      int passes) {
  int nv = static_cast<int>(verts.size());
  vector<int64_t> counts(2, 0);
  for (int v : verts) counts[side[v]]++;
  for (int pass = 0; pass < passes; ++pass) {
    // gains of boundary vertices
    vector<std::pair<int, int>> cand;  // (-gain, vertex) for stable sort
    for (int v : verts) {
      int same = 0, diff = 0;
      for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        int u = indices[e];
        if (!mask[u]) continue;
        if (side[u] == side[v]) same++; else diff++;
      }
      if (diff > 0) cand.emplace_back(-(diff - same), v);
    }
    if (cand.empty()) break;
    std::stable_sort(cand.begin(), cand.end());
    bool moved = false;
    for (auto& [negg, v] : cand) {
      int gain = -negg;
      if (gain <= 0) break;
      int s = side[v];
      int64_t na = counts[s] - 1, nb = counts[1 - s] + 1;
      int64_t lo = (s == 0) ? target - slack : (nv - target) - slack;
      int64_t hi = (1 - s == 0) ? target + slack : (nv - target) + slack;
      if (na < lo || nb > hi) continue;
      side[v] = 1 - s;
      counts[s]--;
      counts[1 - s]++;
      moved = true;
    }
    if (!moved) break;
  }
}

static void bisect(int n, const int32_t* indptr, const int32_t* indices,
                   const vector<int>& verts, int ka, int kk, int passes,
                   vector<int>& va, vector<int>& vb) {
  vector<char> mask(n, 0);
  for (int v : verts) mask[v] = 1;
  vector<int> level(n, -1);
  int src = pseudo_peripheral(n, indptr, indices, mask, verts[0], level);
  bfs_levels(n, indptr, indices, mask, src, level);
  int maxlv = 0;
  for (int v : verts) maxlv = std::max(maxlv, level[v]);
  for (int v : verts)
    if (level[v] < 0) level[v] = maxlv + 1;  // disconnected pieces to side B

  vector<int> order(verts);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return level[a] != level[b]
                                              ? level[a] < level[b] : a < b; });
  int nv = static_cast<int>(verts.size());
  int target = static_cast<int>((static_cast<int64_t>(nv) * ka) / kk);
  vector<char> side(n, 0);
  for (int i = target; i < nv; ++i) side[order[i]] = 1;

  int slack = std::max(1, nv / 20);
  fm_refine(n, indptr, indices, verts, side, mask, target, slack, passes);

  va.clear(); vb.clear();
  for (int v : verts) (side[v] == 0 ? va : vb).push_back(v);
}

}  // namespace

extern "C" {

// k-way partition; part_out[v] in [0, k). Returns 0 on success.
int prealps_kway(int n, const int32_t* indptr, const int32_t* indices, int k,
                 int refine_passes, int32_t* part_out) {
  if (k <= 1) {
    std::fill(part_out, part_out + n, 0);
    return 0;
  }
  struct Task { vector<int> verts; int base; int kk; };
  vector<Task> stack;
  {
    vector<int> all(n);
    for (int i = 0; i < n; ++i) all[i] = i;
    stack.push_back({std::move(all), 0, k});
  }
  while (!stack.empty()) {
    Task t = std::move(stack.back());
    stack.pop_back();
    if (t.kk == 1) {
      for (int v : t.verts) part_out[v] = t.base;
      continue;
    }
    if (t.verts.empty()) continue;
    int ka = t.kk / 2, kb = t.kk - ka;
    vector<int> va, vb;
    bisect(n, indptr, indices, t.verts, ka, t.kk, refine_passes, va, vb);
    stack.push_back({std::move(va), t.base, ka});
    stack.push_back({std::move(vb), t.base + ka, kb});
  }
  return 0;
}

// Reverse Cuthill-McKee; perm_out[i] = old index of new row i.
int prealps_rcm(int n, const int32_t* indptr, const int32_t* indices,
                int32_t* perm_out) {
  vector<char> visited(n, 0);
  vector<int> degree(n);
  for (int v = 0; v < n; ++v) degree[v] = indptr[v + 1] - indptr[v];
  int pos = 0;
  vector<char> mask(n, 1);
  vector<int> level(n, -1);
  for (int comp_seed = 0; comp_seed < n; ++comp_seed) {
    if (visited[comp_seed]) continue;
    // restrict mask to the unvisited component reachable from comp_seed
    int start = pseudo_peripheral(n, indptr, indices, mask, comp_seed, level);
    // classic Cuthill-McKee BFS with degree-sorted neighbor insertion
    std::queue<int> q;
    q.push(start);
    visited[start] = 1;
    mask[start] = 0;
    int first = pos;
    perm_out[pos++] = start;
    vector<int> nbrs;
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      nbrs.clear();
      for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        int u = indices[e];
        if (!visited[u]) { visited[u] = 1; mask[u] = 0; nbrs.push_back(u); }
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int a, int b) {
        return degree[a] != degree[b] ? degree[a] < degree[b] : a < b;
      });
      for (int u : nbrs) { perm_out[pos++] = u; q.push(u); }
    }
    std::reverse(perm_out + first, perm_out + pos);  // the "reverse" in RCM
  }
  return pos == n ? 0 : 1;
}

// Greedy vertex cover of cut edges: in_sep[v]=1 marks separator vertices.
// part: k-way part id per vertex.
int prealps_vertex_separator(int n, const int32_t* indptr,
                             const int32_t* indices, const int32_t* part,
                             int8_t* in_sep) {
  std::memset(in_sep, 0, n);
  vector<int64_t> cross_deg(n, 0);
  for (int v = 0; v < n; ++v)
    for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      int u = indices[e];
      if (u > v && part[u] != part[v]) { cross_deg[v]++; cross_deg[u]++; }
    }
  // max-heap of (cross_deg, -vertex) with lazy deletion for determinism
  std::priority_queue<std::pair<int64_t, int>> heap;
  for (int v = 0; v < n; ++v)
    if (cross_deg[v] > 0) heap.push({cross_deg[v], -v});
  while (!heap.empty()) {
    auto [d, negv] = heap.top();
    heap.pop();
    int v = -negv;
    if (in_sep[v] || d != cross_deg[v] || d == 0) continue;  // stale entry
    in_sep[v] = 1;
    for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      int u = indices[e];
      if (part[u] != part[v] && !in_sep[u] && cross_deg[u] > 0) {
        cross_deg[u]--;
        if (cross_deg[u] > 0) heap.push({cross_deg[u], -u});
      }
    }
    cross_deg[v] = 0;
  }
  return 0;
}

}  // extern "C"
