// Packet-walk kernel (K4) for Hopper (sm_90a).
//
// Computes what `lidar_brdf_tpu/geom/packet.py::intersect_packed_scene`
// computes (an XLA `lax.while_loop` in the JAX package, not a Pallas
// kernel): for every ray, the nearest (t, face) over the whole scene, found
// by one shared walk of the threaded BVH (geom/bvh.py, DFS pre-order with
// skip links) per tile of 128 consecutive rays.  The walk descends into a
// node when any ray of the tile hits its box closer than that ray's best
// hit so far, and tests a leaf's triangle on every ray of the tile.  The
// JAX package and its plain version (kernels/packet.py::
// packet_traverse_plain) run the walk as a loop with one step per visited
// node; in eager PyTorch each step of that loop is a dozen launches and a
// host sync, so the walk gets a kernel of its own.
//
// What bounds it on this card: operations and latency.  A step costs the
// tile a box test (~26 f32 operations a ray) or a triangle test (~60), and
// a walk over the `als` terrain's 10M-node tree is thousands of steps long,
// each waiting on its node row before it can decide the next.  The bytes
// are small beside that: 32 B a ray in and out, and node and triangle rows
// that every ray of a tile shares.  This design:
//
//   * one block of 128 threads per tile, one thread per ray, the whole walk
//     in one launch.  A ray's best (t, face) stays in registers;
//   * the node row (box, skip link, leaf face) and a leaf's triangle row are
//     read by every thread of the block from the same address (a broadcast
//     load: one transaction a warp, through L1);
//   * an internal node runs the slab test only and a leaf the triangle test
//     only (the other's result is not used there);
//   * the descend decision is `__syncthreads_or` over the tile's 128 rays;
//   * padding rays (origin 1e10, direction 0) take part as they do in the
//     JAX walk: their slab tests fail, so they never steer it.
//
// Exactness contract (the plain PyTorch version gives identical (t, face),
// bit for bit): the same f32 operations in the same order, built with
// --fmad=false (no multiply-add is contracted), IEEE division:
//   * inv_d = 1 / d_safe, d_safe = d where |d| >= 1e-12, else +-1e-12;
//   * slab test: t0 = (bmin - o) * inv_d, t1 = (bmax - o) * inv_d,
//     t_near = max over axes of min(t0, t1), t_far = min of max(t0, t1);
//     hit = t_far >= max(t_near, 0) and t_near < t_best;
//   * Moller-Trumbore on the row [v0, e1, e2]: h = d x e2, a = e1 . h,
//     f = 1 / (a, or +-1 where |a| < 1e-8), s = o - v0, u = f (s . h),
//     q = s x e1, v = f (d . q), t = f (e2 . q), each dot product summed
//     ((x0 y0 + x1 y1) + x2 y2); accept |a| >= 1e-8, 0 <= u <= 1, v >= 0,
//     u + v <= 1, t >= -1e-8; a hit replaces the best only at strict
//     t < t_best (so the first leaf in walk order wins a tie);
//   * next node: node + 1 when an internal node's box is hit by any ray of
//     the tile, else its skip link.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;          // rays of a tile = threads of a block
constexpr float EPSILON = 1e-8f;
constexpr float TINY_DIR = 1e-12f;
constexpr float BIG = 3.4e38f;

struct Params {
  const float* node_box;    // (n_nodes, 6) [min.xyz max.xyz]
  const int32_t* node_skip;  // (n_nodes,)
  const int32_t* node_face;  // (n_nodes,) leaf face, -1 internal
  const float* tri_rows;    // (F, 9) [v0 e1 e2]
  const float* origin;      // (n_tiles * TILE, 3)
  const float* direction;
  float* out_t;             // (n_tiles * TILE,)
  int32_t* out_f;
  int32_t* steps;           // (n_tiles, 2) [node steps, leaf steps] or null
  int n_nodes;
};

__device__ __forceinline__ float safe_inv(float x) {
  const float s = fabsf(x) < TINY_DIR ? (x < 0.0f ? -TINY_DIR : TINY_DIR)
                                      : x;
  return __fdiv_rn(1.0f, s);
}

__global__ void __launch_bounds__(TILE)
packet_traverse_kernel(const __grid_constant__ Params p) {
  const int64_t g = (int64_t)blockIdx.x * TILE + threadIdx.x;
  const float ox = __ldg(p.origin + 3 * g), oy = __ldg(p.origin + 3 * g + 1),
              oz = __ldg(p.origin + 3 * g + 2);
  const float dx = __ldg(p.direction + 3 * g),
              dy = __ldg(p.direction + 3 * g + 1),
              dz = __ldg(p.direction + 3 * g + 2);
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_best = BIG;
  int32_t f_best = -1;
  int32_t node_steps = 0, leaf_steps = 0;
  // Skip links point forward in a threaded tree, so a walk takes at most
  // n_nodes steps; the bound only guards against a malformed tree.
  int node = 0;
  for (int it = 0; node < p.n_nodes && it < p.n_nodes; ++it) {
    const int32_t face = __ldg(p.node_face + node);
    const int32_t skip = __ldg(p.node_skip + node);
    ++node_steps;
    if (face >= 0) {                   // leaf: its triangle, on every ray
      ++leaf_steps;
      const float* r = p.tri_rows + 9 * (int64_t)face;
      const float v0x = __ldg(r), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
      const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
      const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float a = (e1x * hx + e1y * hy) + e1z * hz;
      const bool ok_det = fabsf(a) >= EPSILON;
      const float f = __fdiv_rn(1.0f, ok_det ? a : (a < 0.0f ? -1.0f : 1.0f));
      const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
      const float u = f * ((sx * hx + sy * hy) + sz * hz);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = f * ((dx * qx + dy * qy) + dz * qz);
      const float t = f * ((e2x * qx + e2y * qy) + e2z * qz);
      if (ok_det && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
          t >= -EPSILON && t < t_best) {
        t_best = t;
        f_best = face;
      }
      node = skip;
    } else {                           // internal: descend if any ray hits
      const float* b = p.node_box + 6 * (int64_t)node;
      const float t0x = (__ldg(b) - ox) * ix, t1x = (__ldg(b + 3) - ox) * ix;
      const float t0y = (__ldg(b + 1) - oy) * iy,
                  t1y = (__ldg(b + 4) - oy) * iy;
      const float t0z = (__ldg(b + 2) - oz) * iz,
                  t1z = (__ldg(b + 5) - oz) * iz;
      const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fminf(t0z, t1z));
      const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fmaxf(t0z, t1z));
      const bool hit = t_far >= fmaxf(t_near, 0.0f) && t_near < t_best;
      node = __syncthreads_or(hit) ? node + 1 : skip;
    }
  }
  p.out_t[g] = t_best;
  p.out_f[g] = f_best;
  if (p.steps != nullptr && threadIdx.x == 0) {
    p.steps[2 * (int64_t)blockIdx.x] = node_steps;
    p.steps[2 * (int64_t)blockIdx.x + 1] = leaf_steps;
  }
}

}  // namespace

extern "C" {

// One launch over ``n_tiles`` tiles of 128 rays (kernels/packet.py::
// packet_traverse): a grid of ``n_tiles`` blocks of 128 threads.  ``steps``
// may be null.  Returns the cudaError_t of the launch (0 on success); the
// kernel runs asynchronously on `stream`.
int lbt_packet_traverse(const float* node_box, const int32_t* node_skip,
                        const int32_t* node_face, const float* tri_rows,
                        int n_nodes, const float* origin,
                        const float* direction, int64_t n_tiles, float* out_t,
                        int32_t* out_f, int32_t* steps, void* stream) {
  if (n_nodes < 0 || n_tiles < 0 || n_tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  Params p{node_box, node_skip, node_face, tri_rows, origin,
           direction, out_t, out_f, steps, n_nodes};
  packet_traverse_kernel<<<static_cast<unsigned>(n_tiles), TILE, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
