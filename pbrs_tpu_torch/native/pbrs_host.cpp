// Native host-side scene-compilation code for pbrs_tpu_torch: a copy of
// native/pbrs_host.cpp (the JAX package's), built by accel/native.py into
// build/pbrs_tpu_torch_host/ so the two packages never share a library.
//
// The device compute path is PyTorch and CUDA; this library covers the
// CPU-bound scene-compile steps the reference implements in Rust:
//   * binned-SAH BVH build over primitive AABBs
//     [ref: shape/src/blas.rs:333-420, tlas/src/bvh.rs:116-152]
//   * binary little-endian PLY vertex/face ingestion
//     [ref: scene/src/plyloader.rs]
//
// Exposed as a C ABI consumed through ctypes (no pybind11 in this image).
// Output layout matches accel/bvh.py's FlatBVH exactly: depth-first node
// order, left child = node+1, skip links, permuted primitive order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 16;

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float half_area(const V3& lo, const V3& hi) {
  float dx = std::max(hi.x - lo.x, 0.f);
  float dy = std::max(hi.y - lo.y, 0.f);
  float dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dy * dz + dz * dx;
}

struct Node {
  V3 lo, hi;
  int32_t is_leaf;
  int32_t first;  // leaf: offset into order; interior: right child
  int32_t count;
  int32_t skip;
};

struct Builder {
  const float* blo;
  const float* bhi;
  std::vector<V3> centroid;
  std::vector<int32_t> order;
  std::vector<Node> nodes;
  int max_leaf;
  int max_depth = 0;

  V3 prim_lo(int32_t p) const { return {blo[3 * p], blo[3 * p + 1], blo[3 * p + 2]}; }
  V3 prim_hi(int32_t p) const { return {bhi[3 * p], bhi[3 * p + 1], bhi[3 * p + 2]}; }

  int32_t recurse(int32_t start, int32_t end, int depth) {
    max_depth = std::max(max_depth, depth);
    V3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    V3 clo = lo, chi = hi;
    for (int32_t i = start; i < end; ++i) {
      int32_t p = order[i];
      lo = vmin(lo, prim_lo(p));
      hi = vmax(hi, prim_hi(p));
      clo = vmin(clo, centroid[p]);
      chi = vmax(chi, centroid[p]);
    }
    int32_t n = end - start;
    int32_t me = (int32_t)nodes.size();
    nodes.push_back({lo, hi, 0, 0, 0, -1});
    if (n <= max_leaf || depth > 60) {
      nodes[me] = {lo, hi, 1, start, n, -1};
      return me;
    }

    float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    int32_t mid;
    if (ext[axis] <= 1e-12f) {
      mid = start + n / 2;
    } else {
      float cmin = axis == 0 ? clo.x : (axis == 1 ? clo.y : clo.z);
      float scale = kBins * (1.0f - 1e-6f) / ext[axis];
      int32_t counts[kBins] = {0};
      V3 bin_lo[kBins], bin_hi[kBins];
      for (int b = 0; b < kBins; ++b) {
        bin_lo[b] = {1e30f, 1e30f, 1e30f};
        bin_hi[b] = {-1e30f, -1e30f, -1e30f};
      }
      auto bin_of = [&](int32_t p) {
        const V3& c = centroid[p];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = (int)((v - cmin) * scale);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int32_t i = start; i < end; ++i) {
        int32_t p = order[i];
        int b = bin_of(p);
        counts[b]++;
        bin_lo[b] = vmin(bin_lo[b], prim_lo(p));
        bin_hi[b] = vmax(bin_hi[b], prim_hi(p));
      }
      float left_area[kBins - 1];
      int32_t left_count[kBins - 1];
      {
        V3 alo = {1e30f, 1e30f, 1e30f}, ahi = {-1e30f, -1e30f, -1e30f};
        int32_t cnt = 0;
        for (int b = 0; b < kBins - 1; ++b) {
          if (counts[b]) {
            alo = vmin(alo, bin_lo[b]);
            ahi = vmax(ahi, bin_hi[b]);
          }
          cnt += counts[b];
          left_area[b] = cnt ? half_area(alo, ahi) : 0.0f;
          left_count[b] = cnt;
        }
      }
      float best_cost = std::numeric_limits<float>::infinity();
      int best = -1;
      {
        V3 alo = {1e30f, 1e30f, 1e30f}, ahi = {-1e30f, -1e30f, -1e30f};
        int32_t cnt = 0;
        for (int b = kBins - 1; b >= 1; --b) {
          if (counts[b]) {
            alo = vmin(alo, bin_lo[b]);
            ahi = vmax(ahi, bin_hi[b]);
          }
          cnt += counts[b];
          float right_area = cnt ? half_area(alo, ahi) : 0.0f;
          float cost =
              left_area[b - 1] * left_count[b - 1] + right_area * (float)cnt;
          if (cost < best_cost) {
            best_cost = cost;
            best = b - 1;
          }
        }
      }
      if (best < 0 || !std::isfinite(best_cost)) {
        mid = start + n / 2;
      } else {
        auto it = std::partition(
            order.begin() + start, order.begin() + end,
            [&](int32_t p) { return bin_of(p) <= best; });
        mid = (int32_t)(it - order.begin());
        if (mid == start || mid == end) mid = start + n / 2;
      }
    }
    recurse(start, mid, depth + 1);
    int32_t right = recurse(mid, end, depth + 1);
    nodes[me].first = right;
    return me;
  }

  void assign_skip(int32_t i, int32_t after) {
    nodes[i].skip = after;
    if (!nodes[i].is_leaf) {
      int32_t right = nodes[i].first;
      assign_skip(i + 1, right);
      assign_skip(right, after);
    }
  }
};

struct BvhHandle {
  std::vector<Node> nodes;
  std::vector<int32_t> order;
  int depth;
};

}  // namespace

extern "C" {

// Build: returns an opaque handle (call bvh_counts / bvh_export / bvh_free).
void* bvh_build(const float* bbox_min, const float* bbox_max, int32_t n,
                int32_t max_leaf) {
  Builder b;
  b.blo = bbox_min;
  b.bhi = bbox_max;
  b.max_leaf = max_leaf;
  b.centroid.resize(n);
  b.order.resize(n);
  for (int32_t i = 0; i < n; ++i) {
    b.order[i] = i;
    b.centroid[i] = {0.5f * (bbox_min[3 * i] + bbox_max[3 * i]),
                     0.5f * (bbox_min[3 * i + 1] + bbox_max[3 * i + 1]),
                     0.5f * (bbox_min[3 * i + 2] + bbox_max[3 * i + 2])};
  }
  b.nodes.reserve(2 * n);
  b.recurse(0, n, 0);
  b.assign_skip(0, (int32_t)b.nodes.size());
  auto* h = new BvhHandle{std::move(b.nodes), std::move(b.order), b.max_depth};
  return h;
}

void bvh_counts(void* handle, int32_t* n_nodes, int32_t* n_prims,
                int32_t* depth) {
  auto* h = (BvhHandle*)handle;
  *n_nodes = (int32_t)h->nodes.size();
  *n_prims = (int32_t)h->order.size();
  *depth = h->depth;
}

void bvh_export(void* handle, float* bbox_min, float* bbox_max,
                int32_t* is_leaf, int32_t* first, int32_t* count,
                int32_t* skip, int32_t* prim_order) {
  auto* h = (BvhHandle*)handle;
  for (size_t i = 0; i < h->nodes.size(); ++i) {
    const Node& nd = h->nodes[i];
    bbox_min[3 * i] = nd.lo.x;
    bbox_min[3 * i + 1] = nd.lo.y;
    bbox_min[3 * i + 2] = nd.lo.z;
    bbox_max[3 * i] = nd.hi.x;
    bbox_max[3 * i + 1] = nd.hi.y;
    bbox_max[3 * i + 2] = nd.hi.z;
    is_leaf[i] = nd.is_leaf;
    first[i] = nd.first;
    count[i] = nd.count;
    skip[i] = nd.skip;
  }
  std::memcpy(prim_order, h->order.data(), h->order.size() * sizeof(int32_t));
}

void bvh_free(void* handle) { delete (BvhHandle*)handle; }

}  // extern "C"
