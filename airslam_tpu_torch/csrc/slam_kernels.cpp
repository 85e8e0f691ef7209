// Native host-side runtime kernels for airslam_tpu_torch (the port keeps its
// own copy of native/slam_kernels.cpp; the source is the same).
//
// The reference implements its host runtime in C++ (DBoW2 inverted files,
// landmark merging, grid-based feature search). The device compute path lives
// in PyTorch; these are the host-side hot loops that stay native:
//
//  - invfile_query: shared-word counting over a CSR inverted file
//    (Database::Query, src/bow/database.cc:111-123)
//  - union_find: landmark-merge grouping (MapRefiner::MergeMappoints,
//    src/map_refiner.cc:593-744)
//  - radius_search: keypoint neighborhood queries (the 64x48 feature grid of
//    frame.cc:311-336, done as a flat scan which at N<=1024 beats grid
//    bookkeeping)
//
// Built with: g++ -O3 -shared -fPIC -std=c++17 into airslam_tpu_torch/_build/
// Loaded via ctypes (airslam_tpu_torch/utils/native.py); every entry point has a
// plain numpy twin there, which the tests hold it against (no fallback).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Count shared words per frame.
//   query_words : nq word ids (deduplicated by the caller or not — counts
//                 follow the reference: one increment per (query word, frame)
//                 inverted-file entry)
//   csr_offsets : n_words+1 offsets into csr_frames
//   csr_frames  : frame ids per word
//   counts      : dense output indexed by frame id (size n_frames), zeroed here
void invfile_query(const int32_t* query_words, int64_t nq,
                   const int64_t* csr_offsets, const int32_t* csr_frames,
                   int64_t n_words, int32_t* counts, int64_t n_frames) {
  std::memset(counts, 0, sizeof(int32_t) * n_frames);
  for (int64_t i = 0; i < nq; ++i) {
    int32_t w = query_words[i];
    if (w < 0 || w >= n_words) continue;
    for (int64_t j = csr_offsets[w]; j < csr_offsets[w + 1]; ++j) {
      int32_t f = csr_frames[j];
      if (f >= 0 && f < n_frames) counts[f]++;
    }
  }
}

// Union-find over n_pairs (a, b) pairs of ids in [0, n_ids).
// roots[i] receives the final representative (smallest id in each set).
void union_find(const int64_t* pairs_a, const int64_t* pairs_b,
                int64_t n_pairs, int64_t* roots, int64_t n_ids) {
  std::vector<int64_t> parent(n_ids);
  for (int64_t i = 0; i < n_ids; ++i) parent[i] = i;

  // iterative find with path halving
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };

  for (int64_t k = 0; k < n_pairs; ++k) {
    int64_t a = pairs_a[k], b = pairs_b[k];
    if (a < 0 || b < 0 || a >= n_ids || b >= n_ids) continue;
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) continue;
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;  // keep smallest id
  }
  for (int64_t i = 0; i < n_ids; ++i) roots[i] = find(i);
}

// All keypoints within radius of (x, y): writes indices, returns count.
int64_t radius_search(const float* kpts_xy, const uint8_t* mask, int64_t n,
                      float x, float y, float radius, int32_t* out_idx) {
  float r2 = radius * radius;
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    float dx = kpts_xy[2 * i] - x;
    float dy = kpts_xy[2 * i + 1] - y;
    if (dx * dx + dy * dy <= r2) out_idx[m++] = (int32_t)i;
  }
  return m;
}

// Batched descriptor distance: out[i] = 1 - q . D[i] for i in [0, n)
// (DescriptorDistance, src/utils.cc:15-17), over 256-d rows.
void descriptor_distances(const float* query, const float* descs, int64_t n,
                          float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* d = descs + 256 * i;
    float acc = 0.f;
    for (int k = 0; k < 256; ++k) acc += query[k] * d[k];
    out[i] = 1.f - acc;
  }
}

}  // extern "C"
