// Native strand-graph walker (the port's copy of
// hairgs_tpu/native/strand_walk.cc).
//
// Walks every path component of the endpoint-pair graph into ordered
// per-strand segment lists: the host-side traversal the reference runs in
// Python (scene/hair_gaussian_model.py:1410-1498). It runs at the densify
// and merge cadence on the host.
//
// Contract (the same as hairgs_tpu_torch.topo.strands._walk_strands_np):
//   - every endpoint appears in at most two segments (a path graph; cyclic
//     components are never reached from a degree-1 start and are skipped,
//     as in the reference);
//   - strands start at the first-discovered degree-1 endpoint, in ascending
//     id order; the caller flips them to start at the root.
//
// Built by hairgs_tpu_torch/native/__init__.py with g++ -O3 -shared -fPIC.

#include <cstdint>
#include <vector>

extern "C" {

// Returns the number of strands, or -1 on a malformed graph.
// seq_out:      (num_segments, 2) ordered endpoint ids, concatenated strands
// rows_out:     (num_segments,)   segment row ids, same order
// offsets_out:  (num_segments+1,) prefix offsets; strand s = [off[s], off[s+1])
// id_to_strand: (num_endpoints,)  strand id per endpoint (-1 = unvisited)
// complementary:(num_endpoints,)  other tip of the strand for each tip
int64_t walk_strands(const int64_t* pairs, int64_t num_segments,
                     int64_t num_endpoints, int64_t* seq_out, int64_t* rows_out,
                     int64_t* offsets_out, int32_t* id_to_strand,
                     int32_t* complementary) {
  // endpoint -> up to two incident rows
  std::vector<int64_t> row0(num_endpoints, -1), row1(num_endpoints, -1);
  std::vector<uint8_t> degree(num_endpoints, 0);
  for (int64_t r = 0; r < num_segments; ++r) {
    for (int c = 0; c < 2; ++c) {
      int64_t e = pairs[2 * r + c];
      if (e < 0 || e >= num_endpoints) return -1;
      if (row0[e] == -1) {
        row0[e] = r;
      } else if (row1[e] == -1) {
        row1[e] = r;
      } else {
        return -1;  // endpoint in >2 segments: malformed graph
      }
      if (degree[e] < 3) degree[e]++;
    }
  }

  std::vector<uint8_t> visited(num_endpoints, 0);
  int64_t cursor = 0;
  int64_t num_strands = 0;
  offsets_out[0] = 0;
  // degree-1 endpoints in ascending id order (np.unique's order, the
  // reference's strand enumeration order)
  for (int64_t start = 0; start < num_endpoints; ++start) {
    if (degree[start] != 1 || visited[start]) continue;
    int64_t cur = start;
    int64_t row = row0[cur];
    int32_t strand_no = static_cast<int32_t>(num_strands);
    while (row != -1) {
      id_to_strand[cur] = strand_no;
      int64_t a = pairs[2 * row], b = pairs[2 * row + 1];
      int64_t nxt = (a != cur) ? a : b;
      seq_out[2 * cursor] = cur;
      seq_out[2 * cursor + 1] = nxt;
      rows_out[cursor] = row;
      ++cursor;
      cur = nxt;
      row = (row0[cur] != row) ? row0[cur] : row1[cur];
    }
    complementary[start] = static_cast<int32_t>(cur);
    complementary[cur] = static_cast<int32_t>(start);
    visited[start] = 1;
    visited[cur] = 1;
    id_to_strand[cur] = strand_no;
    ++num_strands;
    offsets_out[num_strands] = cursor;
  }
  return num_strands;
}

}  // extern "C"
