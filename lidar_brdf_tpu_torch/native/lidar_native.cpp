// Native host-side runtime of lidar_brdf_tpu_torch: the port's own copy of
// the JAX package's `native/lidar_native.cpp`, with the same functions.
//
// The reference implements its scene pipeline in C++ + GLSL compute
// (Morton codes + GPU radix sort + PLOC merging, Group3D.cpp:41-181).  The
// BVH is built once per scene on the host; this library builds it at
// production speed (the vectorized numpy version in geom/bvh.py stays as
// the portable reference implementation).
//
// Exposed via a C ABI for ctypes (io/native.py):
//   lbt_build_bvh:  triangle soup -> threaded LBVH in DFS pre-order
//                   (node_min/max, leaf face ids, skip links)
//   lbt_parse_obj_sizes / lbt_parse_obj: fast Wavefront OBJ reader
//   lbt_cull: the host beam cull (`cull_candidates_native`); the port's
//             scans cull on the card instead (kernels/csrc/beam_cull.cu,
//             the same test and order bit for bit)
//
// Build (io/native.py, at first use):
//   g++ -O3 -march=native -ffp-contract=off -fopenmp -shared -fPIC
//       -o build/native/liblidar_native.so lidar_native.cpp
// -ffp-contract=off keeps every multiply and add apart, as the card's
// kernel does (--fmad=false).

#include <cmath>
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

// 30-bit Morton code, parity with computeMortonCodes-comp.glsl:17-46.
static inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

static inline uint32_t morton3d(float nx, float ny, float nz) {
  auto q = [](float f) {
    int v = static_cast<int>(f * 1024.0f);
    return static_cast<uint32_t>(std::min(std::max(v, 0), 1023));
  };
  return expand_bits(q(nx)) * 4 + expand_bits(q(ny)) * 2 + expand_bits(q(nz));
}

static inline int clz64(uint64_t x) {
  return x ? __builtin_clzll(x) : 64;
}

struct RadixTree {
  // children encoding: id < n-1 internal, else leaf (id - (n-1)) in sorted
  // order (same convention as geom/bvh.py::_karras_radix_tree)
  std::vector<int64_t> left, right;
};

// Karras 2012 internal-node construction over unique 64-bit keys.
static RadixTree karras(const std::vector<uint64_t>& keys) {
  const int64_t n = static_cast<int64_t>(keys.size());
  const int64_t ni = n - 1;
  RadixTree t;
  t.left.resize(ni);
  t.right.resize(ni);

  auto delta = [&](int64_t i, int64_t j) -> int {
    if (j < 0 || j >= n) return -1;
    uint64_t x = keys[i] ^ keys[j];
    return clz64(x);
  };

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < ni; ++i) {
    int d = (delta(i, i + 1) - delta(i, i - 1)) > 0 ? 1 : -1;
    int delta_min = delta(i, i - d);
    int64_t lmax = 2;
    while (delta(i, i + lmax * d) > delta_min) lmax *= 2;
    int64_t l = 0;
    for (int64_t step = lmax / 2; step >= 1; step /= 2) {
      if (delta(i, i + (l + step) * d) > delta_min) l += step;
    }
    int64_t j = i + l * d;
    int delta_node = delta(i, j);
    int64_t s = 0;
    for (int64_t div = 2;; div *= 2) {
      int64_t step = (l + div - 1) / div;
      if (step < 1) break;
      if (delta(i, i + (s + step) * d) > delta_node) s += step;
      if (step == 1) break;
    }
    int64_t gamma = i + s * d + std::min<int64_t>(d, 0);
    int64_t lo = std::min(i, j);
    int64_t hi = std::max(i, j);
    t.left[i] = (lo == gamma) ? ni + gamma : gamma;
    t.right[i] = (hi == gamma + 1) ? ni + gamma + 1 : gamma + 1;
  }
  return t;
}

}  // namespace

extern "C" {

// Build a threaded LBVH.  Outputs must be pre-allocated for 2*num_faces-1
// nodes: node_min/node_max (3 floats each), node_face, node_skip (int32).
// Returns 0 on success.
int lbt_build_bvh(const float* vertices, int64_t num_vertices,
                  const int32_t* faces, int64_t num_faces, float* node_min,
                  float* node_max, int32_t* node_face, int32_t* node_skip) {
  if (num_faces < 1) return 1;
  const int64_t n = num_faces;
  const int64_t ni = n - 1;
  const int64_t total = 2 * n - 1;

  std::vector<V3> fmin(n), fmax(n);
  V3 smin = {3.4e38f, 3.4e38f, 3.4e38f}, smax = {-3.4e38f, -3.4e38f, -3.4e38f};
  for (int64_t f = 0; f < n; ++f) {
    const int32_t* tri = faces + 3 * f;
    V3 a = {vertices[3 * tri[0]], vertices[3 * tri[0] + 1],
            vertices[3 * tri[0] + 2]};
    V3 b = {vertices[3 * tri[1]], vertices[3 * tri[1] + 1],
            vertices[3 * tri[1] + 2]};
    V3 c = {vertices[3 * tri[2]], vertices[3 * tri[2] + 1],
            vertices[3 * tri[2] + 2]};
    fmin[f] = vmin(a, vmin(b, c));
    fmax[f] = vmax(a, vmax(b, c));
    smin = vmin(smin, fmin[f]);
    smax = vmax(smax, fmax[f]);
  }

  if (n == 1) {
    std::memcpy(node_min, &fmin[0], 12);
    std::memcpy(node_max, &fmax[0], 12);
    node_face[0] = 0;
    node_skip[0] = 1;
    return 0;
  }

  V3 ext = {std::max(smax.x - smin.x, 1e-12f),
            std::max(smax.y - smin.y, 1e-12f),
            std::max(smax.z - smin.z, 1e-12f)};

  // sort keys: morton(30) << 32 | index  (unique)
  std::vector<uint64_t> keys(n);
  for (int64_t f = 0; f < n; ++f) {
    float cx = 0.5f * (fmin[f].x + fmax[f].x);
    float cy = 0.5f * (fmin[f].y + fmax[f].y);
    float cz = 0.5f * (fmin[f].z + fmax[f].z);
    uint32_t m = morton3d((cx - smin.x) / ext.x, (cy - smin.y) / ext.y,
                          (cz - smin.z) / ext.z);
    keys[f] = (static_cast<uint64_t>(m) << 32) | static_cast<uint64_t>(f);
  }
  std::sort(keys.begin(), keys.end());
  std::vector<int64_t> order(n);
  std::vector<uint64_t> sorted_keys(n);
  for (int64_t i = 0; i < n; ++i) {
    order[i] = static_cast<int64_t>(keys[i] & 0xFFFFFFFFull);
    sorted_keys[i] = keys[i];
  }

  RadixTree tree = karras(sorted_keys);

  // node arrays: internal 0..ni-1, leaves ni..2n-2
  std::vector<V3> nmin(total), nmax(total);
  std::vector<int64_t> size(total, 1), parent(total, -1);
  for (int64_t i = 0; i < ni; ++i) {
    parent[tree.left[i]] = i;
    parent[tree.right[i]] = i;
  }
  for (int64_t i = 0; i < n; ++i) {
    nmin[ni + i] = fmin[order[i]];
    nmax[ni + i] = fmax[order[i]];
  }
  // bottom-up AABB/size: children of internal node always have higher
  // post-order rank than... not guaranteed by index; do an explicit
  // topological pass: count children resolved.
  {
    std::vector<int8_t> pending(ni, 2);
    std::vector<int64_t> stack;
    stack.reserve(n);
    for (int64_t leaf = ni; leaf < total; ++leaf) {
      int64_t cur = leaf;
      while (true) {
        int64_t p = parent[cur];
        if (p < 0) break;
        if (--pending[p] > 0) break;  // wait for sibling
        nmin[p] = vmin(nmin[tree.left[p]], nmin[tree.right[p]]);
        nmax[p] = vmax(nmax[tree.left[p]], nmax[tree.right[p]]);
        size[p] = 1 + size[tree.left[p]] + size[tree.right[p]];
        cur = p;
      }
    }
  }

  // DFS pre-order + skip links, iterative.
  std::vector<int64_t> pre(total), skip(total);
  {
    struct Item {
      int64_t node, preorder, skipto;
    };
    std::vector<Item> stack;
    stack.push_back({0, 0, total});
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      pre[it.node] = it.preorder;
      skip[it.node] = it.skipto;
      if (it.node < ni) {
        int64_t l = tree.left[it.node], r = tree.right[it.node];
        int64_t rpre = it.preorder + 1 + size[l];
        stack.push_back({r, rpre, it.skipto});
        stack.push_back({l, it.preorder + 1, rpre});
      }
    }
  }

  for (int64_t i = 0; i < total; ++i) {
    int64_t p = pre[i];
    node_min[3 * p] = nmin[i].x;
    node_min[3 * p + 1] = nmin[i].y;
    node_min[3 * p + 2] = nmin[i].z;
    node_max[3 * p] = nmax[i].x;
    node_max[3 * p + 1] = nmax[i].y;
    node_max[3 * p + 2] = nmax[i].z;
    node_skip[p] = static_cast<int32_t>(skip[i]);
    node_face[p] =
        (i >= ni) ? static_cast<int32_t>(order[i - ni]) : int32_t(-1);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Fast OBJ reader (positions + triangulated faces only; attribute resolution
// stays in Python).  Two-phase: sizes, then fill.
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> positions;
  std::vector<int32_t> faces;        // triangle vertex indices (position ids)
  std::vector<int64_t> comp_start;   // face index where each component starts
};

static bool parse_obj_impl(const char* path, ObjData* out) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return false;
  char line[8192];
  std::vector<int64_t> poly;
  bool new_comp = true;
  while (std::fgets(line, sizeof(line), fh)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x = 0, y = 0, z = 0;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        out->positions.push_back(x);
        out->positions.push_back(y);
        out->positions.push_back(z);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      if (new_comp) {
        out->comp_start.push_back(
            static_cast<int64_t>(out->faces.size() / 3));
        new_comp = false;
      }
      poly.clear();
      const char* p = line + 2;
      const int64_t nverts =
          static_cast<int64_t>(out->positions.size() / 3);
      while (*p) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        long vi = std::strtol(p, const_cast<char**>(&p), 10);
        if (vi < 0) vi = nverts + vi + 1;
        poly.push_back(vi - 1);
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') ++p;  // skip /vt/vn
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) {
        out->faces.push_back(static_cast<int32_t>(poly[0]));
        out->faces.push_back(static_cast<int32_t>(poly[k]));
        out->faces.push_back(static_cast<int32_t>(poly[k + 1]));
      }
    } else if (line[0] == 'o' || line[0] == 'g') {
      new_comp = true;
    }
  }
  std::fclose(fh);
  return true;
}

static ObjData* g_last_obj = nullptr;

int lbt_parse_obj_sizes(const char* path, int64_t* num_vertices,
                        int64_t* num_faces, int64_t* num_components) {
  delete g_last_obj;
  g_last_obj = new ObjData();
  if (!parse_obj_impl(path, g_last_obj)) {
    delete g_last_obj;
    g_last_obj = nullptr;
    return 1;
  }
  *num_vertices = static_cast<int64_t>(g_last_obj->positions.size() / 3);
  *num_faces = static_cast<int64_t>(g_last_obj->faces.size() / 3);
  *num_components = static_cast<int64_t>(g_last_obj->comp_start.size());
  return 0;
}

int lbt_parse_obj_fill(float* vertices, int32_t* faces,
                       int64_t* comp_start) {
  if (!g_last_obj) return 1;
  std::memcpy(vertices, g_last_obj->positions.data(),
              g_last_obj->positions.size() * sizeof(float));
  std::memcpy(faces, g_last_obj->faces.data(),
              g_last_obj->faces.size() * sizeof(int32_t));
  std::memcpy(comp_start, g_last_obj->comp_start.data(),
              g_last_obj->comp_start.size() * sizeof(int64_t));
  delete g_last_obj;
  g_last_obj = nullptr;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Beam culling: per-tile candidate collection over the threaded LBVH.
// Native half of geom/beamcull.py (same conservative beam/AABB test: grow
// the box by the tile's origin radius, slab fast-accept along the axis,
// otherwise ternary-search the convex gap dist(axis(s), box) - s*tan).
// ---------------------------------------------------------------------------

namespace {

struct Beam {
  V3 c, a;
  float tan_half, radius;
};

static inline float beam_gap(const Beam& b, const V3& gmin, const V3& gmax,
                             float s) {
  V3 p = {b.c.x + s * b.a.x, b.c.y + s * b.a.y, b.c.z + s * b.a.z};
  float qx = std::min(std::max(p.x, gmin.x), gmax.x) - p.x;
  float qy = std::min(std::max(p.y, gmin.y), gmax.y) - p.y;
  float qz = std::min(std::max(p.z, gmin.z), gmax.z) - p.z;
  return std::sqrt(qx * qx + qy * qy + qz * qz) - s * b.tan_half;
}

static inline bool beam_box_overlap(const Beam& b, const float* bmin,
                                    const float* bmax, float t_max) {
  V3 gmin = {bmin[0] - b.radius, bmin[1] - b.radius, bmin[2] - b.radius};
  V3 gmax = {bmax[0] + b.radius, bmax[1] + b.radius, bmax[2] + b.radius};
  // slab fast-accept: axis ray passes through the grown box
  float t_near = -3.4e38f, t_far = 3.4e38f;
  const float* c = &b.c.x;
  const float* a = &b.a.x;
  const float* gl = &gmin.x;
  const float* gh = &gmax.x;
  for (int k = 0; k < 3; ++k) {
    float ak = a[k];
    float inv = 1.0f / (std::fabs(ak) < 1e-12f ? (ak < 0 ? -1e-12f : 1e-12f)
                                               : ak);
    float t0 = (gl[k] - c[k]) * inv;
    float t1 = (gh[k] - c[k]) * inv;
    t_near = std::max(t_near, std::min(t0, t1));
    t_far = std::min(t_far, std::max(t0, t1));
  }
  if (t_far >= std::max(t_near, 0.0f) && t_near <= t_max) return true;
  // convex minimization of the beam/box gap over s in [0, t_max]
  float lo = 0.0f, hi = t_max;
  for (int it = 0; it < 24; ++it) {
    float m1 = lo + (hi - lo) * (1.0f / 3.0f);
    float m2 = hi - (hi - lo) * (1.0f / 3.0f);
    if (beam_gap(b, gmin, gmax, m1) < beam_gap(b, gmin, gmax, m2)) hi = m2;
    else lo = m1;
  }
  float slack = 1e-4f + 1e-5f * t_max;
  return beam_gap(b, gmin, gmax, 0.5f * (lo + hi)) <= slack;
}

}  // namespace

extern "C" {

// Collect candidate faces per beam tile.  Two-phase protocol: call with
// cap == 0 to fill `counts` only; allocate sum(counts); call again with the
// same inputs and cap == total to fill `faces_out`/`dnear_out`
// (concatenated per tile, sorted by conservative near distance ascending).
// Returns the total candidate count, or -1 when cap is insufficient.
int64_t lbt_cull(const float* node_min, const float* node_max,
                 const int32_t* node_face, const int32_t* node_skip,
                 int64_t num_nodes, const float* center, const float* axis,
                 const float* tan_half, const float* radius,
                 const uint8_t* valid, int64_t num_tiles, float t_max,
                 int32_t* counts, int32_t* faces_out, float* dnear_out,
                 int64_t cap) {
  std::vector<std::vector<std::pair<float, int32_t>>> per_tile(
      cap > 0 ? (size_t)num_tiles : 0);

#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t t = 0; t < num_tiles; ++t) {
    counts[t] = 0;
    if (!valid[t]) continue;
    Beam b;
    b.c = {center[3 * t], center[3 * t + 1], center[3 * t + 2]};
    b.a = {axis[3 * t], axis[3 * t + 1], axis[3 * t + 2]};
    b.tan_half = tan_half[t];
    b.radius = radius[t];
    int64_t node = 0;
    int32_t n_hits = 0;
    while (node < num_nodes) {
      if (beam_box_overlap(b, node_min + 3 * node, node_max + 3 * node,
                           t_max)) {
        int32_t face = node_face[node];
        if (face >= 0) {
          ++n_hits;
          if (cap > 0) {
            // conservative near distance: axis projection of the box,
            // minus origin radius (matches PallasCulledTraverser bounds)
            const float* lo = node_min + 3 * node;
            const float* hi = node_max + 3 * node;
            float cx = 0.5f * (lo[0] + hi[0]), hx = 0.5f * (hi[0] - lo[0]);
            float cy = 0.5f * (lo[1] + hi[1]), hy = 0.5f * (hi[1] - lo[1]);
            float cz = 0.5f * (lo[2] + hi[2]), hz = 0.5f * (hi[2] - lo[2]);
            float proj = (cx - b.c.x) * b.a.x + (cy - b.c.y) * b.a.y +
                         (cz - b.c.z) * b.a.z;
            float slack = hx * std::fabs(b.a.x) + hy * std::fabs(b.a.y) +
                          hz * std::fabs(b.a.z);
            float dn = std::max(proj - slack - b.radius, 0.0f);
            per_tile[t].push_back({dn, face});
          }
          node = node_skip[node];
        } else {
          node = node + 1;
        }
      } else {
        node = node_skip[node];
      }
    }
    counts[t] = n_hits;
    if (cap > 0) {
      std::sort(per_tile[t].begin(), per_tile[t].end());
    }
  }

  int64_t total = 0;
  for (int64_t t = 0; t < num_tiles; ++t) total += counts[t];
  if (cap > 0) {
    if (total > cap) return -1;
    int64_t off = 0;
    for (int64_t t = 0; t < num_tiles; ++t) {
      for (const auto& pr : per_tile[t]) {
        dnear_out[off] = pr.first;
        faces_out[off] = pr.second;
        ++off;
      }
    }
  }
  return total;
}

}  // extern "C"
