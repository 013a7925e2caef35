// Native binned-SAH BVH builder.
//
// TPU-native counterpart of Mitsuba's C++ SAH kd-tree builder
// (src/librender/skdtree.cpp + include/mitsuba/render/gkdtree.h): the
// device consumes flat BVH arrays (see scene/bvh.py for the layout); this
// builder produces them at native speed for large scenes where the numpy
// builder's Python-level recursion dominates scene load time.
// Semantics match scene/bvh.py::build exactly (same SAH cost model, same
// leaf encoding) so the two builders are interchangeable.
//
// Exposed C ABI (ctypes): bvh_build(...) -> number of nodes, filling
// caller-allocated arrays.  Thread-free, allocation-light, single pass
// over an explicit work stack.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int N_BINS = 16;
constexpr int MAX_LEAF = 4;
constexpr int LEAF_BITS = 5;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct BBox {
  V3 lo{std::numeric_limits<float>::infinity(),
        std::numeric_limits<float>::infinity(),
        std::numeric_limits<float>::infinity()};
  V3 hi{-std::numeric_limits<float>::infinity(),
        -std::numeric_limits<float>::infinity(),
        -std::numeric_limits<float>::infinity()};
  void grow(const BBox &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

static inline int leaf_code(int offset, int count) {
  return -((offset << LEAF_BITS) | count) - 1;
}

struct Task {
  int node, start, end, depth;
};

}  // namespace

extern "C" {

// Returns the node count (<= 2*T), or -1 on error.  Arrays are
// caller-allocated with capacity 2*T nodes.  prim_order has length T and
// is initialized by the caller to identity.
int bvh_build(const float *v0, const float *v1, const float *v2, int T,
              float *c0min, float *c0max, float *c1min, float *c1max,
              int32_t *child0, int32_t *child1, int32_t *prim_order,
              int32_t *out_depth) {
  if (T <= 0) return -1;
  std::vector<BBox> prim(T);
  std::vector<V3> centroid(T);
  for (int i = 0; i < T; ++i) {
    V3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    V3 b{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    V3 c{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    prim[i].lo = vmin(vmin(a, b), c);
    prim[i].hi = vmax(vmax(a, b), c);
    centroid[i] = {(prim[i].lo.x + prim[i].hi.x) * 0.5f,
                   (prim[i].lo.y + prim[i].hi.y) * 0.5f,
                   (prim[i].lo.z + prim[i].hi.z) * 0.5f};
  }

  int n_nodes = 0;
  int max_depth = 0;
  std::vector<Task> stack;
  stack.reserve(128);
  auto node_bbox = [&](int s, int e) {
    BBox b;
    for (int i = s; i < e; ++i) b.grow(prim[prim_order[i]]);
    return b;
  };

  const int root = n_nodes++;
  stack.push_back({root, 0, T, 1});

  std::vector<int32_t> tmp(T);

  while (!stack.empty()) {
    Task tk = stack.back();
    stack.pop_back();
    max_depth = std::max(max_depth, tk.depth);
    const int count = tk.end - tk.start;

    int split_pos = -1;
    if (count > MAX_LEAF) {
      // centroid extent
      V3 cmin{1e30f, 1e30f, 1e30f}, cmax{-1e30f, -1e30f, -1e30f};
      for (int i = tk.start; i < tk.end; ++i) {
        const V3 &c = centroid[prim_order[i]];
        cmin = vmin(cmin, c);
        cmax = vmax(cmax, c);
      }
      const float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y,
                            cmax.z - cmin.z};
      int axis = 0;
      if (ext[1] > ext[axis]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;

      if (ext[axis] > 1e-12f) {
        const float cmin_a = axis == 0 ? cmin.x : (axis == 1 ? cmin.y
                                                             : cmin.z);
        const float scale = N_BINS * (1.0f - 1e-6f) / ext[axis];
        int bin_cnt[N_BINS] = {0};
        BBox bins[N_BINS];
        auto bin_of = [&](int p) {
          const V3 &c = centroid[p];
          float ca = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
          int b = (int)((ca - cmin_a) * scale);
          return b < 0 ? 0 : (b >= N_BINS ? N_BINS - 1 : b);
        };
        for (int i = tk.start; i < tk.end; ++i) {
          int p = prim_order[i];
          int b = bin_of(p);
          bin_cnt[b]++;
          bins[b].grow(prim[p]);
        }
        // prefix/suffix sweeps
        float larea[N_BINS - 1], rarea[N_BINS - 1];
        int lcnt[N_BINS - 1], rcnt[N_BINS - 1];
        {
          BBox acc;
          int c = 0;
          for (int b = 0; b < N_BINS - 1; ++b) {
            acc.grow(bins[b]);
            c += bin_cnt[b];
            larea[b] = acc.half_area();
            lcnt[b] = c;
          }
          acc = BBox();
          c = 0;
          for (int b = N_BINS - 1; b >= 1; --b) {
            acc.grow(bins[b]);
            c += bin_cnt[b];
            rarea[b - 1] = acc.half_area();
            rcnt[b - 1] = c;
          }
        }
        int best = -1;
        float best_sah = std::numeric_limits<float>::infinity();
        for (int b = 0; b < N_BINS - 1; ++b) {
          if (lcnt[b] == 0 || rcnt[b] == 0) continue;
          float sah = lcnt[b] * larea[b] + rcnt[b] * rarea[b];
          if (sah < best_sah) {
            best_sah = sah;
            best = b;
          }
        }
        if (best >= 0) {
          BBox parent = node_bbox(tk.start, tk.end);
          float parent_area = std::max(parent.half_area(), 1e-20f);
          float split_cost = 1.0f + best_sah / parent_area;
          if (split_cost < (float)count ||
              count > ((1 << LEAF_BITS) - 1)) {
            // partition (stable, matching numpy boolean selection)
            int l = 0;
            for (int i = tk.start; i < tk.end; ++i)
              if (bin_of(prim_order[i]) <= best) tmp[l++] = prim_order[i];
            int r = l;
            for (int i = tk.start; i < tk.end; ++i)
              if (bin_of(prim_order[i]) > best) tmp[r++] = prim_order[i];
            if (l > 0 && l < count) {
              std::memcpy(prim_order + tk.start, tmp.data(),
                          count * sizeof(int32_t));
              split_pos = tk.start + l;
            }
          }
        }
      }
      if (split_pos < 0) {
        // forced median split on the widest axis (stable by centroid)
        std::stable_sort(
            prim_order + tk.start, prim_order + tk.end,
            [&](int a, int b) {
              const V3 &ca = centroid[a];
              const V3 &cb = centroid[b];
              float fa = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
              float fb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
              return fa < fb;
            });
        split_pos = tk.start + count / 2;
      }
    }

    if (split_pos < 0) {
      // small leaf-pair node (count <= MAX_LEAF)
      int half = count > 1 ? count / 2 : 1;
      if (half < 1) half = 1;
      BBox b0 = node_bbox(tk.start, tk.start + half);
      c0min[3 * tk.node] = b0.lo.x;
      c0min[3 * tk.node + 1] = b0.lo.y;
      c0min[3 * tk.node + 2] = b0.lo.z;
      c0max[3 * tk.node] = b0.hi.x;
      c0max[3 * tk.node + 1] = b0.hi.y;
      c0max[3 * tk.node + 2] = b0.hi.z;
      child0[tk.node] = leaf_code(tk.start, half);
      if (count - half > 0) {
        BBox b1 = node_bbox(tk.start + half, tk.end);
        c1min[3 * tk.node] = b1.lo.x;
        c1min[3 * tk.node + 1] = b1.lo.y;
        c1min[3 * tk.node + 2] = b1.lo.z;
        c1max[3 * tk.node] = b1.hi.x;
        c1max[3 * tk.node + 1] = b1.hi.y;
        c1max[3 * tk.node + 2] = b1.hi.z;
        child1[tk.node] = leaf_code(tk.start + half, count - half);
      } else {
        for (int k = 0; k < 3; ++k) {
          c1min[3 * tk.node + k] = std::numeric_limits<float>::infinity();
          c1max[3 * tk.node + k] = -std::numeric_limits<float>::infinity();
        }
        child1[tk.node] = leaf_code(0, 0);
      }
      continue;
    }

    BBox b0 = node_bbox(tk.start, split_pos);
    BBox b1 = node_bbox(split_pos, tk.end);
    c0min[3 * tk.node] = b0.lo.x;
    c0min[3 * tk.node + 1] = b0.lo.y;
    c0min[3 * tk.node + 2] = b0.lo.z;
    c0max[3 * tk.node] = b0.hi.x;
    c0max[3 * tk.node + 1] = b0.hi.y;
    c0max[3 * tk.node + 2] = b0.hi.z;
    c1min[3 * tk.node] = b1.lo.x;
    c1min[3 * tk.node + 1] = b1.lo.y;
    c1min[3 * tk.node + 2] = b1.lo.z;
    c1max[3 * tk.node] = b1.hi.x;
    c1max[3 * tk.node + 1] = b1.hi.y;
    c1max[3 * tk.node + 2] = b1.hi.z;

    const int nl = split_pos - tk.start;
    const int nr = tk.end - split_pos;
    if (nl <= MAX_LEAF) {
      child0[tk.node] = leaf_code(tk.start, nl);
    } else {
      int ch = n_nodes++;
      child0[tk.node] = ch;
      stack.push_back({ch, tk.start, split_pos, tk.depth + 1});
    }
    if (nr <= MAX_LEAF) {
      child1[tk.node] = leaf_code(split_pos, nr);
    } else {
      int ch = n_nodes++;
      child1[tk.node] = ch;
      stack.push_back({ch, split_pos, tk.end, tk.depth + 1});
    }
  }

  *out_depth = max_depth;
  return n_nodes;
}

}  // extern "C"
