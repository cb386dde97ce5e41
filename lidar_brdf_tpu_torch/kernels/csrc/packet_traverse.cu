// Packet-walk kernel (K4) for Hopper (sm_90a).
//
// Computes what `lidar_brdf_tpu/geom/packet.py::intersect_packed_scene`
// computes (an XLA `lax.while_loop` in the JAX package, not a Pallas
// kernel): for every ray, the nearest (t, face) over the whole scene, found
// by a walk of the threaded BVH (geom/bvh.py, DFS pre-order with skip
// links).  The JAX package walks tiles of 128 rays together: a tile
// descends into a node when any of its rays hits the node's box closer than
// that ray's best hit so far, and tests a leaf's triangle on every ray of
// the tile.  Here the rays walk in packets of `width` (1 or 128): a
// packet of 1 is each ray's own stackless walk over the same skip links,
// as the reference's GLSL walked one ray per thread (DESIGN.md).  The JAX
// package and the plain version (kernels/packet.py::packet_traverse_plain)
// run the walk as a loop with one step per visited node; in eager PyTorch
// each step of that loop is a dozen launches and a host sync, so the walk
// gets a kernel of its own.
//
// What bounds it on this card: instruction issue and the latency of each
// step's dependent record load.  A step costs a ray a 32-byte record, the
// slab test (~26 f32 operations) or a leaf's triangle test (~60) and a
// branch, and a walk over the `als` terrain's 10M-node tree is a few
// hundred steps long.  The bytes are small beside that: 32 B a ray in and
// out.  The first version (128-ray block tiles, a block barrier a node,
// every ray walked) ran 4.2x the operations of its tile walks; what a ray
// needs is its own walk, 2.2-3.5x fewer operations than a 128-ray tile
// spends on it (PERF.md).  This design:
//
//   * only the rays the caller asks for walk.  An optional `active` mask
//     comes with the active rays' indices, compacted in order on the device
//     by the wrapper (`order`, its count `n_active` read here: no host
//     sync).  Packets are cut from that list, and every inactive ray gets
//     (BIG, -1) without a test (at a water scan's bounce levels half the
//     rays or more are done, and those from the sensor would walk the tree
//     again);
//   * one lane a ray (width 1, the default): no vote, no lane tests a leaf
//     or a box for another ray's sake; a warp takes 32 rays of the list
//     and runs until its longest walk ends.  Width 128 (one warp a packet,
//     four rays a lane, `__any_sync` for the descend decision) is the JAX
//     package's tile, which a caller that walks moved triangles under the
//     unmoved boxes needs (examples/fit_geometry.py).  Warp packets of 32
//     were slower than one lane a walk on every input measured
//     (scripts/k4_variants.py packet32, PERF.md);
//   * no block barrier, and persistent warps: the grid is sized to the
//     card's resident warps, and each warp takes its next 32 rays (or its
//     next packet) from a global counter (`work`) when it is done, so a
//     long walk holds no wave (Aila and Laine, "Understanding the
//     efficiency of ray traversal on GPUs", HPG 2009);
//   * a node is one 32-byte record [min.xyz max.xyz skip face] (the two
//     ints bit for bit in f32 lanes): two 16-byte loads.  A triangle row is
//     48 bytes [v0 e1 e2 pad]: three loads;
//   * the record is loaded at the top of its step.  Loading both
//     successors' records before the decision (node + 1 and the skip link,
//     so that the next one is in flight) was measured slower at every
//     width (scripts/k4_variants.py, PERF.md): the resident warps already
//     hide the load's latency, and the second load costs issue slots.
//
// Not used, and why: the tensor cores (the walk is exact f32 compare and
// branch, built with --fmad=false and no TF32); TMA (the rows are 32-48
// byte scattered reads, not tiles); shared memory for the tree (the city's
// ~80k nodes are ~2.5 MB and the terrain's ~10M are ~320 MB, both beyond a
// block's 227 KB; the 50 MB L2 holds the city's tree, not the terrain's).
//
// Exactness contract (the plain PyTorch version gives identical (t, face)
// and walk lengths, bit for bit, at every width): the same f32 operations
// in the same order, built with --fmad=false (no multiply-add is
// contracted), IEEE division:
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
//     the packet, else its skip link;
//   * packet k holds rays k * width .. k * width + width - 1 of the active
//     list; a lane past the list's end holds a ray at 1e10 of direction 0,
//     which never hits (the plain version pads so).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int BLOCK = 128;         // threads of a block: 4 persistent warps
// Width 1's blocks an SM: caps its registers at 40 (47 uncapped, 10
// blocks; 16 bytes spilled) for 20% more resident warps, measured 5%
// faster on the water and `als` rays (scripts/k4_variants.py, PERF.md)
constexpr int SOLO_MIN_BLOCKS = 12;
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPSILON = 1e-8f;
constexpr float TINY_DIR = 1e-12f;
constexpr float BIG = 3.4e38f;
constexpr float PAD_ORIGIN = 1e10f;

struct Params {
  const float4* node_rec;   // (n_nodes, 8) f32: [min.xyz max.x][max.yz skip face]
  const float4* tri_rows;   // (F, 12) f32: [v0.xyz e1.x][e1.yz e2.xy][e2.z pad]
  const float* origin;      // (n_rays, 3)
  const float* direction;
  const int32_t* order;     // active rays' indices in order, or null: all
  const int32_t* n_active;  // length of `order` (on the device), or null
  const uint8_t* active;    // (n_rays,) mask, or null
  int32_t* work;            // the next packet to take (zeroed by the caller)
  float* out_t;             // (n_rays,)
  int32_t* out_f;
  int32_t* steps;           // (packets, 2) [node steps, leaf steps] or null
  int64_t n_rays;
  int n_nodes;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float t;
  int32_t f;
};

__device__ __forceinline__ float safe_inv(float x) {
  const float s = fabsf(x) < TINY_DIR ? (x < 0.0f ? -TINY_DIR : TINY_DIR)
                                      : x;
  return __fdiv_rn(1.0f, s);
}

// Ray ``r`` of the input, or the padding ray where ``r`` < 0.
__device__ __forceinline__ Ray load_ray(const Params& p, int64_t r) {
  Ray y;
  if (r >= 0) {
    y.ox = __ldg(p.origin + 3 * r);
    y.oy = __ldg(p.origin + 3 * r + 1);
    y.oz = __ldg(p.origin + 3 * r + 2);
    y.dx = __ldg(p.direction + 3 * r);
    y.dy = __ldg(p.direction + 3 * r + 1);
    y.dz = __ldg(p.direction + 3 * r + 2);
  } else {
    y.ox = y.oy = y.oz = PAD_ORIGIN;
    y.dx = y.dy = y.dz = 0.0f;
  }
  y.ix = safe_inv(y.dx);
  y.iy = safe_inv(y.dy);
  y.iz = safe_inv(y.dz);
  y.t = BIG;
  y.f = -1;
  return y;
}

__device__ __forceinline__ bool box_hit(const Ray& r, float4 lo, float4 hi) {
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (lo.w - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.x - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.y - r.oz) * r.iz;
  const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
  const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fmaxf(t0z, t1z));
  return t_far >= fmaxf(t_near, 0.0f) && t_near < r.t;
}

__device__ __forceinline__ void tri_test(Ray& r, float4 a, float4 b,
                                         float4 c, int32_t face) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = (e1x * hx + e1y * hy) + e1z * hz;
  const bool ok_det = fabsf(det) >= EPSILON;
  const float f =
      __fdiv_rn(1.0f, ok_det ? det : (det < 0.0f ? -1.0f : 1.0f));
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  const float u = f * ((sx * hx + sy * hy) + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * ((r.dx * qx + r.dy * qy) + r.dz * qz);
  const float t = f * ((e2x * qx + e2y * qy) + e2z * qz);
  if (ok_det && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
      t >= -EPSILON && t < r.t) {
    r.t = t;
    r.f = face;
  }
}

// The record of ``node`` (< n_nodes).
__device__ __forceinline__ void load_rec(const Params& p, int node,
                                         float4& lo, float4& hi) {
  lo = __ldg(p.node_rec + 2 * (int64_t)node);
  hi = __ldg(p.node_rec + 2 * (int64_t)node + 1);
}

// (BIG, -1) for every inactive ray, grid-stride.
__device__ __forceinline__ void fill_inactive(const Params& p) {
  if (p.active == nullptr) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.n_rays; i += stride) {
    if (p.active[i] == 0) {
      p.out_t[i] = BIG;
      p.out_f[i] = -1;
    }
  }
}

__device__ __forceinline__ int64_t active_count(const Params& p) {
  return p.n_active != nullptr ? (int64_t)*p.n_active : p.n_rays;
}

// The input index of entry ``j`` of the active list, or -1 past its end.
__device__ __forceinline__ int64_t ray_at(const Params& p, int64_t j,
                                          int64_t n) {
  if (j >= n) return -1;
  return p.order != nullptr ? (int64_t)__ldg(p.order + j) : j;
}

// The next packet (or batch) for this warp, from the global counter.
__device__ __forceinline__ int64_t take(const Params& p, int lane) {
  int32_t k = 0;
  if (lane == 0) k = atomicAdd(p.work, 1);
  return __shfl_sync(FULL, k, 0);
}

// Packets of WARP * RPL rays, one warp a packet, RPL rays a lane.
template <int RPL>
__global__ void __launch_bounds__(BLOCK)
packet_kernel(const __grid_constant__ Params p) {
  fill_inactive(p);
  constexpr int W = WARP * RPL;
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t n = active_count(p);
  const int64_t n_packets = (n + W - 1) / W;
  for (int64_t pk = take(p, lane); pk < n_packets; pk = take(p, lane)) {
    int64_t idx[RPL];
    Ray ray[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      idx[k] = ray_at(p, pk * W + k * WARP + lane, n);
      ray[k] = load_ray(p, idx[k]);
    }
    int32_t node_steps = 0, leaf_steps = 0;
    int node = 0;
    // Skip links point forward in a threaded tree, so a walk takes at most
    // n_nodes steps; the bound only guards against a malformed tree.
    for (int it = 0; node < p.n_nodes && it < p.n_nodes; ++it) {
      float4 lo, hi;
      load_rec(p, node, lo, hi);
      const int32_t skip = __float_as_int(hi.z);
      const int32_t face = __float_as_int(hi.w);
      ++node_steps;
      if (face >= 0) {                 // leaf: its triangle, on every ray
        ++leaf_steps;
        const float4* row = p.tri_rows + 3 * (int64_t)face;
        const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
#pragma unroll
        for (int k = 0; k < RPL; ++k) tri_test(ray[k], a, b, c, face);
        node = skip;
      } else {                         // internal: descend if any ray hits
        bool hit = false;
#pragma unroll
        for (int k = 0; k < RPL; ++k) hit = box_hit(ray[k], lo, hi) || hit;
        node = __any_sync(FULL, hit) ? node + 1 : skip;
      }
    }
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      if (idx[k] >= 0) {
        p.out_t[idx[k]] = ray[k].t;
        p.out_f[idx[k]] = ray[k].f;
      }
    }
    if (p.steps != nullptr && lane == 0) {
      p.steps[2 * pk] = node_steps;
      p.steps[2 * pk + 1] = leaf_steps;
    }
  }
}

// Width 1: every lane walks its own ray; a warp takes 32 rays at a time.
__global__ void __launch_bounds__(BLOCK, SOLO_MIN_BLOCKS)
solo_kernel(const __grid_constant__ Params p) {
  fill_inactive(p);
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t n = active_count(p);
  const int64_t n_batches = (n + WARP - 1) / WARP;
  for (int64_t b = take(p, lane); b < n_batches; b = take(p, lane)) {
    const int64_t j = b * WARP + lane;
    const int64_t r = ray_at(p, j, n);
    Ray ray = load_ray(p, r);
    int32_t node_steps = 0, leaf_steps = 0;
    int node = r >= 0 ? 0 : p.n_nodes;   // a lane without a ray stays put
    for (int it = 0; node < p.n_nodes && it < p.n_nodes; ++it) {
      float4 lo, hi;
      load_rec(p, node, lo, hi);
      const int32_t skip = __float_as_int(hi.z);
      const int32_t face = __float_as_int(hi.w);
      ++node_steps;
      if (face >= 0) {
        ++leaf_steps;
        const float4* row = p.tri_rows + 3 * (int64_t)face;
        tri_test(ray, __ldg(row), __ldg(row + 1), __ldg(row + 2), face);
        node = skip;
      } else {
        node = box_hit(ray, lo, hi) ? node + 1 : skip;
      }
    }
    if (r >= 0) {
      p.out_t[r] = ray.t;
      p.out_f[r] = ray.f;
      if (p.steps != nullptr) {
        p.steps[2 * j] = node_steps;
        p.steps[2 * j + 1] = leaf_steps;
      }
    }
  }
}

// Blocks that fill the card with resident warps (once per kernel).
template <typename Kernel>
int resident_blocks(Kernel kernel, int& cached) {
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
    cached = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return cached;
}

}  // namespace

extern "C" {

// One launch over the rays (kernels/packet.py::packet_traverse).
// ``order``/``n_active``/``active``: the compacted active list, its count
// on the device and the mask, or all three null (every ray walks).
// ``work``: one zeroed int.  ``width``: rays of a packet, 1 or 128.
// ``steps`` may be null.  Returns the cudaError_t of the launch (0 on
// success); the kernel runs asynchronously on `stream`.
int lbt_packet_traverse(const float* node_rec, const float* tri_rows,
                        int n_nodes, const float* origin,
                        const float* direction, int64_t n_rays,
                        const int32_t* order, const int32_t* n_active,
                        const uint8_t* active, int32_t* work, float* out_t,
                        int32_t* out_f, int32_t* steps, int width,
                        void* stream) {
  static int blocks_solo = 0, blocks_128 = 0;
  if (n_nodes < 0 || n_rays < 0 || n_rays > 0x7fffffff ||
      (width != 1 && width != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return 0;
  Params p{reinterpret_cast<const float4*>(node_rec),
           reinterpret_cast<const float4*>(tri_rows),
           origin, direction, order, n_active, active, work, out_t, out_f,
           steps, n_rays, n_nodes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // no more warps than the packets (or batches) of all rays
  const int64_t per_warp = width == 1 ? WARP : width;
  const int64_t warps = (n_rays + per_warp - 1) / per_warp;
  const int64_t needed = (warps + BLOCK / WARP - 1) / (BLOCK / WARP);
  int grid = 0;
  if (width == 1) {
    grid = resident_blocks(solo_kernel, blocks_solo);
  } else {
    grid = resident_blocks(packet_kernel<4>, blocks_128);
  }
  if (needed < grid) grid = static_cast<int>(needed);
  if (width == 1) {
    solo_kernel<<<grid, BLOCK, 0, s>>>(p);
  } else {
    packet_kernel<4><<<grid, BLOCK, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
