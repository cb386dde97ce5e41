// Beam-cull kernel (K5) for Hopper (sm_90a).
//
// Computes what the host C++ `native/lidar_native.cpp::lbt_cull` computes
// (OpenMP over beams, called from `lidar_brdf_tpu/geom/beamcull.py::
// _collect_candidates`; not a Pallas kernel: a TPU does not walk a BVH per
// beam, so the JAX package culls on the host): for every valid beam (an
// origin sphere of radius `radius` around `center`, a cone of half-angle
// tangent `tan_half` about the unit `axis`), every leaf face of the
// threaded BVH whose box, grown by the radius, the beam can reach within
// `t_max`, with its conservative near distance `dnear`; each beam's list
// sorted by (dnear, face) ascending, as `std::sort` of the pairs sorts it.
//
// The test is `beam_box_overlap` of the host source, operation for
// operation in f32: the box grown by the radius, the slab fast-accept of
// the axis ray, else 24 ternary-search steps on the convex gap
// dist(center + s axis, box) - s tan_half over [0, t_max] and the slack
// 1e-4 + 1e-5 t_max.  Every operation is an `__f*_rn` intrinsic (never
// contracted into an FMA) and the library is built with --fmad=false, so
// a beam's candidates and near distances are bit-equal to the plain
// version's (kernels/cull.py::cull_plain) and to the port's host build of
// `lbt_cull` (built with -ffp-contract=off).  `std::min(a, b)` is
// `(b < a) ? b : a` and `std::max(a, b)` is `(a < b) ? b : a`, kept as
// written (they differ from fminf/fmaxf at signed zeros).
//
// What bounds it on this card: instruction throughput and dependent
// latency.  A
// node test is 46 f32 operations on its slab path and 1,323 more when it
// reaches the ternary search (half to three quarters of the tests on the
// scans' chunks); a node is one 32-byte record (the layout K4 reads,
// kernels/packet.py::node_records), two 16-byte loads.  The bytes are small
// beside that.  This first design is simple, not fast:
//
//   * one thread per beam, walking the threaded BVH in the host's order
//     (descend to node + 1 on a hit of an internal node, else follow the
//     skip link), twice: `count_kernel` counts each beam's leaves, the
//     wrapper scans the counts into offsets (torch.cumsum), and
//     `fill_kernel` walks again and writes the faces and near distances at
//     the beam's offset (no atomics, no per-beam scratch);
//   * a list of at most SMALL entries is sorted by its fill thread
//     (insertion sort in place); a longer one by a block of `sort_kernel`
//     (bitonic network of ascending comparators: shared memory up to
//     SORT_SMEM entries, device memory beyond, so any length is sorted);
//   * a `tls` chunk has 2,048 beams: 64 warps on 132 SMs, each thread
//     making ~281 node tests in sequence, 15 ms a call, 856x the bound; an
//     `als` chunk's 131,072 beams fill the card, 10 ms, 11.9x (PERF.md).
//     A warp per tile, or one pass with a per-beam scratch, is later work.
//
// Not used: the tensor cores (exact f32 compares and branches), TMA (32-byte
// scattered records), shared memory for the tree (~320 MB on `als`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMALL = 32;        // lists sorted by their fill thread
constexpr int SORT_THREADS = 256;
constexpr int SORT_SMEM = 4096;  // entries a block sorts in shared memory
constexpr int ITERS = 24;        // ternary-search steps

struct Params {
  const float4* nodes;   // (N, 8) f32 records as 2N float4
  const float* center;   // (T, 3)
  const float* axis;     // (T, 3)
  const float* tan_half; // (T,)
  const float* radius;   // (T,)
  const uint8_t* valid;  // (T,)
  int n_nodes;
  int n_beams;
  float t_max;
  int32_t* counts;        // (T,)      count pass: written
  const int64_t* offsets; // (T + 1,)  fill and sort passes
  int32_t* faces;         // (total,)
  float* dnear;           // (total,)
};

struct Beam {
  float cx, cy, cz, ax, ay, az, tan_half, radius;
};

__device__ __forceinline__ float min_std(float a, float b) {
  return (b < a) ? b : a;
}

__device__ __forceinline__ float max_std(float a, float b) {
  return (a < b) ? b : a;
}

struct Box {
  float x0, y0, z0, x1, y1, z1;
};

__device__ __forceinline__ float beam_gap(const Beam& b, const Box& g,
                                          float s) {
  const float px = __fadd_rn(b.cx, __fmul_rn(s, b.ax));
  const float py = __fadd_rn(b.cy, __fmul_rn(s, b.ay));
  const float pz = __fadd_rn(b.cz, __fmul_rn(s, b.az));
  const float qx = __fsub_rn(min_std(max_std(px, g.x0), g.x1), px);
  const float qy = __fsub_rn(min_std(max_std(py, g.y0), g.y1), py);
  const float qz = __fsub_rn(min_std(max_std(pz, g.z0), g.z1), pz);
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));
  return __fsub_rn(__fsqrt_rn(ss), __fmul_rn(s, b.tan_half));
}

__device__ __forceinline__ float safe_inv(float a) {
  const float d = fabsf(a) < 1e-12f ? (a < 0.0f ? -1e-12f : 1e-12f) : a;
  return __fdiv_rn(1.0f, d);
}

__device__ __forceinline__ void slab(float lo, float hi, float c, float a,
                                     float& t_near, float& t_far) {
  const float inv = safe_inv(a);
  const float t0 = __fmul_rn(__fsub_rn(lo, c), inv);
  const float t1 = __fmul_rn(__fsub_rn(hi, c), inv);
  t_near = max_std(t_near, min_std(t0, t1));
  t_far = min_std(t_far, max_std(t0, t1));
}

__device__ bool beam_box_overlap(const Beam& b, const Box& box, float t_max) {
  const Box g{__fsub_rn(box.x0, b.radius), __fsub_rn(box.y0, b.radius),
              __fsub_rn(box.z0, b.radius), __fadd_rn(box.x1, b.radius),
              __fadd_rn(box.y1, b.radius), __fadd_rn(box.z1, b.radius)};
  float t_near = -3.4e38f, t_far = 3.4e38f;
  slab(g.x0, g.x1, b.cx, b.ax, t_near, t_far);
  slab(g.y0, g.y1, b.cy, b.ay, t_near, t_far);
  slab(g.z0, g.z1, b.cz, b.az, t_near, t_far);
  if (t_far >= max_std(t_near, 0.0f) && t_near <= t_max) return true;
  float lo = 0.0f, hi = t_max;
  const float third = 1.0f / 3.0f;
  for (int it = 0; it < ITERS; ++it) {
    const float m1 = __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), third));
    const float m2 = __fsub_rn(hi, __fmul_rn(__fsub_rn(hi, lo), third));
    if (beam_gap(b, g, m1) < beam_gap(b, g, m2)) {
      hi = m2;
    } else {
      lo = m1;
    }
  }
  const float slack = __fadd_rn(1e-4f, __fmul_rn(1e-5f, t_max));
  return beam_gap(b, g, __fmul_rn(0.5f, __fadd_rn(lo, hi))) <= slack;
}

// conservative near distance of a leaf's box along the beam axis
__device__ __forceinline__ float near_distance(const Beam& b, const Box& box) {
  const float cx = __fmul_rn(0.5f, __fadd_rn(box.x0, box.x1));
  const float hx = __fmul_rn(0.5f, __fsub_rn(box.x1, box.x0));
  const float cy = __fmul_rn(0.5f, __fadd_rn(box.y0, box.y1));
  const float hy = __fmul_rn(0.5f, __fsub_rn(box.y1, box.y0));
  const float cz = __fmul_rn(0.5f, __fadd_rn(box.z0, box.z1));
  const float hz = __fmul_rn(0.5f, __fsub_rn(box.z1, box.z0));
  const float proj = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(cx, b.cx), b.ax),
                __fmul_rn(__fsub_rn(cy, b.cy), b.ay)),
      __fmul_rn(__fsub_rn(cz, b.cz), b.az));
  const float slack = __fadd_rn(
      __fadd_rn(__fmul_rn(hx, fabsf(b.ax)), __fmul_rn(hy, fabsf(b.ay))),
      __fmul_rn(hz, fabsf(b.az)));
  return max_std(__fsub_rn(__fsub_rn(proj, slack), b.radius), 0.0f);
}

__device__ __forceinline__ Beam load_beam(const Params& p, int t) {
  return Beam{p.center[3 * t], p.center[3 * t + 1], p.center[3 * t + 2],
              p.axis[3 * t],   p.axis[3 * t + 1],   p.axis[3 * t + 2],
              p.tan_half[t],   p.radius[t]};
}

// The host's walk: `visit(face, box)` for every leaf the beam reaches, in
// the threaded order.
template <typename Visit>
__device__ void walk(const Params& p, const Beam& b, Visit& visit) {
  int node = 0;
  while (node < p.n_nodes) {
    const float4 r0 = p.nodes[2 * node];
    const float4 r1 = p.nodes[2 * node + 1];
    const Box box{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y};
    const int skip = __float_as_int(r1.z);
    const int face = __float_as_int(r1.w);
    if (beam_box_overlap(b, box, p.t_max)) {
      if (face >= 0) {
        visit(face, box);
        node = skip;
      } else {
        node = node + 1;
      }
    } else {
      node = skip;
    }
  }
}

struct Count {
  int n;
  __device__ void operator()(int, const Box&) { ++n; }
};

struct Fill {
  const Beam* beam;
  int32_t* faces;
  float* dnear;
  int n;
  __device__ void operator()(int face, const Box& box) {
    faces[n] = face;
    dnear[n] = near_distance(*beam, box);
    ++n;
  }
};

// (d, f) after (e, g) in the order of std::pair<float, int32_t>
__device__ __forceinline__ bool after(float d, int f, float e, int g) {
  return e < d || (d == e && g < f);
}

__global__ void count_kernel(Params p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.n_beams) return;
  Count c{0};
  if (p.valid[t]) {
    const Beam b = load_beam(p, t);
    walk(p, b, c);
  }
  p.counts[t] = c.n;
}

__global__ void fill_kernel(Params p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.n_beams || !p.valid[t]) return;
  const Beam b = load_beam(p, t);
  const int64_t off = p.offsets[t];
  Fill fill{&b, p.faces + off, p.dnear + off, 0};
  walk(p, b, fill);
  if (fill.n > SMALL) return;             // sort_kernel takes it
  for (int i = 1; i < fill.n; ++i) {      // insertion sort in place
    const float d = fill.dnear[i];
    const int f = fill.faces[i];
    int j = i - 1;
    while (j >= 0 && after(fill.dnear[j], fill.faces[j], d, f)) {
      fill.dnear[j + 1] = fill.dnear[j];
      fill.faces[j + 1] = fill.faces[j];
      --j;
    }
    fill.dnear[j + 1] = d;
    fill.faces[j + 1] = f;
  }
}

// Ascending bitonic network over n entries padded (virtually) with +inf to
// n2, a power of two: every comparator puts the smaller entry at the lower
// index, so one that touches an index >= n is a no-op and is skipped.
template <typename D, typename F>
__device__ void bitonic(D* d, F* f, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  const int pairs = n2 >> 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        int lo, hi;
        if (j == (k >> 1)) {           // flip: i against its mirror in k
          const int blk = q / j, off = q % j;
          lo = blk * k + off;
          hi = blk * k + k - 1 - off;
        } else {                       // half-cleaner: i against i + j
          const int blk = q / j, off = q % j;
          lo = blk * 2 * j + off;
          hi = lo + j;
        }
        if (hi < n) {
          const float a = d[lo], b = d[hi];
          const int fa = f[lo], fb = f[hi];
          if (after(a, fa, b, fb)) {
            d[lo] = b;
            d[hi] = a;
            f[lo] = fb;
            f[hi] = fa;
          }
        }
      }
      __syncthreads();
    }
  }
}

// One block a list longer than SMALL; blocks stride over the beams.
__global__ void __launch_bounds__(SORT_THREADS) sort_kernel(Params p) {
  __shared__ float sd[SORT_SMEM];
  __shared__ int sf[SORT_SMEM];
  for (int t = blockIdx.x; t < p.n_beams; t += gridDim.x) {
    const int64_t off = p.offsets[t];
    const int n = static_cast<int>(p.offsets[t + 1] - off);
    if (n <= SMALL) continue;              // uniform across the block
    float* d = p.dnear + off;
    int32_t* f = p.faces + off;
    if (n <= SORT_SMEM) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        sd[i] = d[i];
        sf[i] = f[i];
      }
      __syncthreads();
      bitonic(sd, sf, n);
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        d[i] = sd[i];
        f[i] = sf[i];
      }
    } else {
      bitonic(d, f, n);                    // in device memory
    }
    __syncthreads();
  }
}

int beam_block(int n_beams) { return n_beams <= 8192 ? 32 : 128; }

int sort_grid(int n_beams) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int grid = 8 * sms;
  return n_beams < grid ? (n_beams > 0 ? n_beams : 1) : grid;
}

Params make_params(const float* node_rec, int n_nodes, const float* center,
                   const float* axis, const float* tan_half,
                   const float* radius, const uint8_t* valid, int n_beams,
                   float t_max) {
  Params p{};
  p.nodes = reinterpret_cast<const float4*>(node_rec);
  p.center = center;
  p.axis = axis;
  p.tan_half = tan_half;
  p.radius = radius;
  p.valid = valid;
  p.n_nodes = n_nodes;
  p.n_beams = n_beams;
  p.t_max = t_max;
  return p;
}

}  // namespace

extern "C" {

// Count pass (kernels/cull.py::beam_cull): `counts` (T,) i32 written, one
// launch.  Returns the cudaError_t of the launch (0 on success); the kernel
// runs asynchronously on `stream`.
int lbt_beam_cull_count(const float* node_rec, int n_nodes,
                        const float* center, const float* axis,
                        const float* tan_half, const float* radius,
                        const uint8_t* valid, int n_beams, float t_max,
                        int32_t* counts, void* stream) {
  if (n_nodes < 0 || n_beams < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_beams == 0) return 0;
  Params p = make_params(node_rec, n_nodes, center, axis, tan_half, radius,
                         valid, n_beams, t_max);
  p.counts = counts;
  const int block = beam_block(n_beams);
  count_kernel<<<(n_beams + block - 1) / block, block, 0,
                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Fill and sort passes: each valid beam's faces and near distances at
// `offsets[t]` (the exclusive scan of the counts, T + 1 entries), each
// list sorted by (dnear, face).  Two launches.
int lbt_beam_cull_fill(const float* node_rec, int n_nodes,
                       const float* center, const float* axis,
                       const float* tan_half, const float* radius,
                       const uint8_t* valid, int n_beams, float t_max,
                       const int64_t* offsets, int32_t* faces, float* dnear,
                       void* stream) {
  if (n_nodes < 0 || n_beams < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_beams == 0) return 0;
  Params p = make_params(node_rec, n_nodes, center, axis, tan_half, radius,
                         valid, n_beams, t_max);
  p.offsets = offsets;
  p.faces = faces;
  p.dnear = dnear;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block = beam_block(n_beams);
  fill_kernel<<<(n_beams + block - 1) / block, block, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_kernel<<<sort_grid(n_beams), SORT_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
