// Native merge-candidate search for strand-endpoint merging (the port's
// copy of hairgs_tpu/native/merge_candidates.cc).
//
// The candidate enumeration of the reference (scene/hair_gaussian_model.py:
// 1205-1362: a cKDTree ball query and a per-point Python filter loop) and
// its sequential greedy conflict filter (l.1236-1255). The Python loop
// visits every strand tip on every merge iteration; here a sorted grid hash
// does the ball query.
//
// The same answer as the numpy oracle (hairgs_tpu_torch.topo.merge, the
// cKDTree loop), term for term:
//   - enumeration order: points ascending, neighbours in ascending index
//     order (cKDTree return_sorted=True), so the later stable sort by
//     distance breaks ties identically;
//   - the ball test is done in double on the float32 coordinates against
//     the double threshold, as cKDTree does;
//   - the direction test compares the float32 dot product against the
//     double cosine threshold, as numpy compares a float32 array with a
//     float64 scalar;
//   - the reported distance is numpy's float32 norm: float32 differences,
//     squares summed left to right, a correctly rounded sqrt. The library
//     is built with -ffp-contract=off so that no multiply-add is fused.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Cell {
  int64_t key;
  int64_t idx;
};

inline int64_t cell_key(int64_t cx, int64_t cy, int64_t cz) {
  // pack 21-bit signed coords
  auto enc = [](int64_t v) -> int64_t { return v + (1 << 20); };
  return (enc(cx) << 42) | (enc(cy) << 21) | enc(cz);
}

inline int64_t cell_of(float p, double inv_cell) {
  return static_cast<int64_t>(std::floor(static_cast<double>(p) * inv_cell));
}

}  // namespace

extern "C" {

// Returns the number of candidates written (<= cap), or -1 if cap exceeded.
// points/dirs: (m,3) f32; tips_global/comp_global: (m,) i64 global endpoint
// ids and their strand-complementary ids. Outputs: p1/p2 (cap,) i64 global
// ids, dist (cap,) f32.
int64_t merge_candidates(const float* points, const float* dirs, int64_t m,
                         double dist_th, double dir_th, int bidirectional,
                         const int64_t* tips_global, const int64_t* comp_global,
                         int64_t* out_p1, int64_t* out_p2, float* out_dist,
                         int64_t cap) {
  if (m == 0) return 0;
  const double inv_cell = 1.0 / dist_th;
  const double th2 = dist_th * dist_th;
  std::vector<Cell> cells(m);
  for (int64_t i = 0; i < m; ++i) {
    const float* p = points + 3 * i;
    cells[i] = {cell_key(cell_of(p[0], inv_cell), cell_of(p[1], inv_cell),
                         cell_of(p[2], inv_cell)),
                i};
  }
  std::sort(cells.begin(), cells.end(),
            [](const Cell& a, const Cell& b) { return a.key < b.key; });

  // the ball query, one occupied cell at a time (the searches of
  // neighbouring cells then hit cached parts of `cells`): every point's
  // neighbours within dist_th, grouped by point below
  std::vector<int64_t> ball_i, ball_j, cand;
  for (int64_t c = 0; c < m;) {
    int64_t e = c;
    while (e < m && cells[e].key == cells[c].key) ++e;
    const float* p0 = points + 3 * cells[c].idx;
    const int64_t cx = cell_of(p0[0], inv_cell);
    const int64_t cy = cell_of(p0[1], inv_cell);
    const int64_t cz = cell_of(p0[2], inv_cell);
    cand.clear();
    // z is the key's lowest field, so the cells cz-1..cz+1 of one (x, y)
    // column are one run of keys: one search a column
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy) {
        const int64_t first = cell_key(cx + dx, cy + dy, cz - 1);
        const int64_t last = first + 2;
        auto lo = std::lower_bound(
            cells.begin(), cells.end(), first,
            [](const Cell& cl, int64_t k) { return cl.key < k; });
        for (; lo != cells.end() && lo->key <= last; ++lo) cand.push_back(lo->idx);
      }
    for (int64_t k = c; k < e; ++k) {
      const int64_t i = cells[k].idx;
      const float* pi = points + 3 * i;
      for (int64_t j : cand) {
        const float* pj = points + 3 * j;
        const double ddx = static_cast<double>(pi[0]) - pj[0];
        const double ddy = static_cast<double>(pi[1]) - pj[1];
        const double ddz = static_cast<double>(pi[2]) - pj[2];
        if (ddx * ddx + ddy * ddy + ddz * ddz <= th2) {
          ball_i.push_back(i);
          ball_j.push_back(j);
        }
      }
    }
    c = e;
  }
  std::vector<int64_t> offsets(m + 1, 0), nbrs_all(ball_i.size());
  for (int64_t i : ball_i) ++offsets[i + 1];
  for (int64_t i = 0; i < m; ++i) offsets[i + 1] += offsets[i];
  {
    std::vector<int64_t> at(offsets.begin(), offsets.end() - 1);
    for (size_t k = 0; k < ball_i.size(); ++k) nbrs_all[at[ball_i[k]]++] = ball_j[k];
  }

  int64_t count = 0;
  for (int64_t i = 0; i < m; ++i) {
    const float* pi = points + 3 * i;
    auto nb_begin = nbrs_all.begin() + offsets[i], nb_end = nbrs_all.begin() + offsets[i + 1];
    std::sort(nb_begin, nb_end);  // cKDTree return_sorted order
    const float* di = dirs + 3 * i;
    for (auto jt = nb_begin; jt != nb_end; ++jt) {
      const int64_t j = *jt;
      if (tips_global[j] == tips_global[i]) continue;  // self
      if (tips_global[j] == comp_global[i]) continue;  // own strand
      const float* dj = dirs + 3 * j;
      float dot = dj[0] * -di[0] + dj[1] * -di[1] + dj[2] * -di[2];
      if (bidirectional) dot = std::fabs(dot);
      if (static_cast<double>(dot) < dir_th) continue;
      const float* pj = points + 3 * j;
      const float ddx = pi[0] - pj[0], ddy = pi[1] - pj[1], ddz = pi[2] - pj[2];
      if (count >= cap) return -1;
      out_p1[count] = tips_global[i];
      out_p2[count] = tips_global[j];
      out_dist[count] = std::sqrt(ddx * ddx + ddy * ddy + ddz * ddz);
      ++count;
    }
  }
  return count;
}

// Sequential greedy conflict filter (hair_gaussian_model.py:1236-1255):
// pairs must already be distance-sorted and first-occurrence-deduped; once a
// pair is accepted, both partners' strand complementaries are disabled.
// comp_map: (e,) i64 (-1 where an endpoint has none); mask out: (k,) u8.
void greedy_complementary_filter(const int64_t* pairs, int64_t k,
                                 const int64_t* comp_map, int64_t e,
                                 uint8_t* mask) {
  std::vector<uint8_t> disabled(e + 1, 0);
  for (int64_t i = 0; i < k; ++i) {
    const int64_t a = pairs[2 * i], b = pairs[2 * i + 1];
    if (disabled[a] || disabled[b]) {
      mask[i] = 0;
    } else {
      mask[i] = 1;
      if (comp_map[a] >= 0) disabled[comp_map[a]] = 1;
      if (comp_map[b] >= 0) disabled[comp_map[b]] = 1;
    }
  }
}

}  // extern "C"
