// Beam-cull kernel (K5) for Hopper (sm_90a).
//
// Replaces the host C++ `native/lidar_native.cpp::lbt_cull` (OpenMP over
// beams, called from `lidar_brdf_tpu/geom/beamcull.py::
// _collect_candidates`).  It is not a TPU kernel: a TPU does not walk a BVH
// per beam, so the JAX package culls on the host.  For every valid beam
// (an origin sphere of radius `radius` around `center`, a cone of
// half-angle tangent `tan_half` about the unit `axis`) it lists every leaf
// face of the threaded BVH whose box, grown by the radius, the beam can
// reach within `t_max`, with its conservative near distance `dnear`; each
// beam's list sorted by (dnear, face) ascending, as `std::sort` of the
// pairs sorts it.  Output: CSR (kernels/cull.py::CullLists).
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
// latency.  A node test is 46 f32 operations on its slab path and 1,323
// more when it reaches the ternary search (half to three quarters of the
// tests on the scans' chunks), a chain of 24 dependent steps each holding
// two square roots; a node is one 32-byte record (the layout K4 reads,
// kernels/packet.py::node_records), two 16-byte loads.  The bytes are
// small beside that.  A beam's walk is as long as its chain of dependent
// tests, so the beams with the most tests set the time of a call.
//
// Only the schedule is designed; the test is the host's.  A leaf is listed
// exactly when it and all its ancestors pass, whatever order the walk
// takes, and a face is at most once in a list, so (dnear, face) orders a
// list totally and appends in any order sort to the same bits.
//
//   * One walk, not two.  Each beam walks once into a scratch of
//     `capacity` entries a beam and writes its count (`walk_*_kernel`).
//     The wrapper scans the counts (torch.cumsum) and reads the total, the
//     size classes and the number of beams over capacity in one read.
//     `place_*_kernel` then writes each list at its CSR offset: copied
//     from the scratch, or, for a beam over capacity, walked again straight
//     into its offset, in the same launch; a list of at most SMALL entries
//     is put in order as it is written (by rank, or insertion sort after a
//     second walk).  `sort_kernel` sorts the longer lists (a block a list,
//     bitonic network of ascending comparators: shared memory up to
//     SORT_SMEM entries, device memory beyond).  Three launches a call
//     whatever the data: walk, place, sort.
//   * Tile beams (few, wide: a `tls` chunk has 2,048 beams of 640 rays, a
//     list of up to 684 faces, 281 node tests a beam on average and
//     thousands on the widest): a block of 128 lanes a beam.  Each round
//     the group pops up to 128 nodes from its stack, tests them side by
//     side (the lanes that reach the ternary search run it in lockstep),
//     pushes the two children (node + 1 and that child's skip link, as
//     cull_plain expands them) of every internal node that passes and
//     appends every leaf that passes (ballot, popc, and the warps' counts
//     in shared memory).  The stack holds at most lanes * (depth + 2)
//     nodes (kernels/cull.py::stack_entries: of each push batch at most
//     `lanes` stay below the next, one batch a level); it lives in shared
//     memory, or in a device-memory scratch from the wrapper where a deep
//     tree would not fit.  The widest beam's chain of tests is cut by the
//     lanes it walks on.
//   * Pulse beams (many, narrow: an `als` chunk has 131,072 beams of 10
//     rays, a list of up to 10 faces): one thread a beam, since the beams
//     alone fill the card, walking the threaded BVH in the host's order
//     with the ternary search postponed (Aila and Laine's postponed work):
//     a lane whose node fails the slab fast-accept waits while the others
//     go on with slab steps, and the warp runs the search on all waiting
//     lanes at once when every live lane waits.  Half the tests take the
//     search, so a warp that searches as soon as one lane needs it leaves
//     the other half idle for 24 steps.
//   * Which path a call takes, and its capacity, is a rule on the number
//     of beams (kernels/cull.py::schedule).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; walk kernel's device time, ms,
// on the `tls` / `als` chunks; scripts/k5_variants.py, two rounds in
// turns): this source 0.229-0.249 / 3.625-3.629; a warp a beam 0.336-0.346
// on `tls` (7.0 on `als`); 64 lanes 0.306-0.315 (14.1); 256 lanes
// 0.346-0.355 (two waves of blocks; 23.3); 16 lanes 0.59-0.60 (4.54); 4
// lanes 2.09 (3.96-3.99); a thread a beam 7.59-7.84 on `tls`; the pulse
// walk without postponing 4.99-5.02, postponed at 16 waiting lanes
// 3.79-3.80.  The earlier design (a thread a beam, a count walk and a
// fill walk; chip_smoke.py --k5-chunk on its tree) took 14.9-15.4 and
// 9.9-10.1 ms a call, this one 0.50 and 4.09-4.22.
//
// Not used: the tensor cores (exact f32 compares and branches), TMA (32-byte
// scattered records), shared memory for the tree (~320 MB on `als`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMALL = 32;        // lists put in order by the place kernel
constexpr int BLOCK = 128;       // threads a block of the walk and place
constexpr int SORT_THREADS = 256;
constexpr int SORT_SMEM = 4096;  // entries a block sorts in shared memory
constexpr int ITERS = 24;        // ternary-search steps
constexpr int STACK_SMEM = 48 * 1024;  // shared bytes a block's stacks take
constexpr unsigned FULL = 0xffffffffu;
constexpr int POSTPONE = 32;     // waiting lanes that start the search

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
  int capacity;           // scratch entries a beam
  int stack_cap;          // stack entries a group (lanes * (depth + 2))
  int32_t* gstack;        // device-memory stacks, or null: shared memory
  int32_t* counts;        // (T,)  walk: written
  int32_t* sfaces;        // scratch, T * capacity
  float* sdnear;
  const int64_t* offsets; // (T + 1,)  place and sort
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

// the box grown by the beam's radius
__device__ __forceinline__ Box grow(const Beam& b, const Box& box) {
  return Box{__fsub_rn(box.x0, b.radius), __fsub_rn(box.y0, b.radius),
             __fsub_rn(box.z0, b.radius), __fadd_rn(box.x1, b.radius),
             __fadd_rn(box.y1, b.radius), __fadd_rn(box.z1, b.radius)};
}

// the slab fast-accept of the axis ray against the grown box
__device__ __forceinline__ bool slab_accept(const Beam& b, const Box& g,
                                            float t_max) {
  float t_near = -3.4e38f, t_far = 3.4e38f;
  slab(g.x0, g.x1, b.cx, b.ax, t_near, t_far);
  slab(g.y0, g.y1, b.cy, b.ay, t_near, t_far);
  slab(g.z0, g.z1, b.cz, b.az, t_near, t_far);
  return t_far >= max_std(t_near, 0.0f) && t_near <= t_max;
}

// the ternary search on the gap to the grown box, and the slack
__device__ bool ternary_accept(const Beam& b, const Box& g, float t_max) {
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

__device__ __forceinline__ bool beam_box_overlap(const Beam& b,
                                                 const Box& box,
                                                 float t_max) {
  const Box g = grow(b, box);
  return slab_accept(b, g, t_max) || ternary_accept(b, g, t_max);
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

__device__ __forceinline__ void load_node(const Params& p, int node, Box& box,
                                          int& skip, int& face) {
  const float4 r0 = __ldg(p.nodes + 2 * (int64_t)node);
  const float4 r1 = __ldg(p.nodes + 2 * (int64_t)node + 1);
  box = Box{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y};
  skip = __float_as_int(r1.z);
  face = __float_as_int(r1.w);
}

// Where a walk writes a beam's entries: entry k at k * stride from the
// base, the first `cap` of them (the scratch), or all (the CSR lists).
struct Out {
  int32_t* faces;
  float* dnear;
  int64_t stride;
  int cap;
  __device__ __forceinline__ void put(int k, int face, float d) const {
    if (k < cap) {
      faces[k * stride] = face;
      dnear[k * stride] = d;
    }
  }
};

// One thread a beam: the host's walk, in the threaded order (descend to
// node + 1 on a hit of an internal node, else follow the skip link), with
// the ternary search postponed: a lane whose node fails the slab test
// waits, the other lanes go on with slab steps, and the warp runs the
// search on every waiting lane together once POSTPONE lanes wait or every
// live lane does.  Every thread of the warp calls it (``active`` false:
// nothing walked).  Returns the beam's count.
__device__ int walk_thread(const Params& p, const Beam& b, bool active,
                           const Out& out) {
  int n = 0;
  int node = active ? 0 : p.n_nodes;
  bool wait = false;            // the node's slab test failed: search due
  Box box{}, g{};
  int skip = 0, face = -1;
  for (;;) {
    bool decided = false, hit = false;
    if (node < p.n_nodes && !wait) {
      load_node(p, node, box, skip, face);
      g = grow(b, box);
      decided = slab_accept(b, g, p.t_max);
      hit = decided;
      wait = !decided;
    }
    const unsigned live = __ballot_sync(FULL, node < p.n_nodes);
    const unsigned waiting = __ballot_sync(FULL, wait);
    if (live != 0 && (waiting == live || __popc(waiting) >= POSTPONE) &&
        wait) {
      hit = ternary_accept(b, g, p.t_max);
      decided = true;
      wait = false;
    }
    if (decided) {
      if (hit && face >= 0) {
        out.put(n++, face, near_distance(b, box));
        node = skip;
      } else {
        node = hit ? node + 1 : skip;
      }
    }
    if (live == 0) break;
  }
  return n;
}

// Threads of a block of the group path: BLOCK / G groups of up to a warp,
// or one wider group (its barrier is the block's).
template <int G>
constexpr int group_block() {
  return G > 32 ? G : BLOCK;
}

// Where the group's pushes and appends go: the group's count of each
// below this lane, and in all.  Up to a warp a group, from the warp's
// ballots; wider, also from the other warps' counts in shared memory
// (`sync`: the group's barrier, which also orders the pops before the
// pushes).
template <int G>
__device__ __forceinline__ void group_scan(bool leaf, bool inner, bool two,
                                           int& leaf_at, int& push_at,
                                           int& leaves, int& pushes) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  unsigned gmask = FULL;
  if constexpr (G < 32)
    gmask = ((1u << G) - 1u) << (lane & ~static_cast<unsigned>(G - 1));
  const unsigned lb = __ballot_sync(FULL, leaf) & gmask;
  const unsigned ib = __ballot_sync(FULL, inner) & gmask;
  const unsigned tb = __ballot_sync(FULL, two) & gmask;
  leaf_at = __popc(lb & below);
  push_at = __popc(ib & below) + __popc(tb & below);
  leaves = __popc(lb);
  pushes = __popc(ib) + __popc(tb);
  if constexpr (G <= 32) {
    __syncwarp();
  } else {
    constexpr int W = G / 32;
    __shared__ int sums[2][W];
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
      sums[0][warp] = leaves;
      sums[1][warp] = pushes;
    }
    __syncthreads();
    leaves = pushes = 0;
    for (int w = 0; w < W; ++w) {
      if (w == warp) {
        leaf_at += leaves;
        push_at += pushes;
      }
      leaves += sums[0][w];
      pushes += sums[1][w];
    }
  }
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// G lanes a beam (G a power of two: up to 32, consecutive lanes of one
// warp; wider, a block).  Each round the group pops up to G nodes from the
// top of its stack, tests them side by side, appends the leaves that pass
// and pushes both children of each internal node that passes.  Every
// thread of the warp (of the block, G > 32) calls it.  Returns the beam's
// count (the same on every lane of the group).
template <int G>
__device__ int walk_group(const Params& p, const Beam& b, bool active,
                          int32_t* stack, const Out& out) {
  const int gl = static_cast<int>(threadIdx.x & (G - 1));
  int sp = 0, n = 0;
  if (active && p.n_nodes > 0) {
    if (gl == 0) stack[0] = 0;
    sp = 1;
  }
  group_sync<G>();
  for (;;) {
    bool more = sp > 0;
    if constexpr (G <= 32) {
      more = __any_sync(FULL, more);
    }
    if (!more) break;                 // uniform over the warp or block
    const int take = min(sp, G);
    int node = -1;
    if (gl < take) node = stack[sp - 1 - gl];
    sp -= take;
    bool hit = false;
    Box box{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int skip = 0, face = -1;
    if (node >= 0) {
      load_node(p, node, box, skip, face);
      hit = beam_box_overlap(b, box, p.t_max);
    }
    const bool leaf = hit && face >= 0;
    const bool inner = hit && face < 0;
    int right = p.n_nodes;
    if (inner) right = __float_as_int(__ldg(p.nodes + 2 * (int64_t)node + 3).z);
    const bool two = inner && right < p.n_nodes;
    int leaf_at, push_at, leaves, pushes;
    group_scan<G>(leaf, inner, two, leaf_at, push_at, leaves, pushes);
    if (leaf) out.put(n + leaf_at, face, near_distance(b, box));
    if (inner) {
      stack[sp + push_at] = node + 1;
      if (two) stack[sp + push_at + 1] = right;
    }
    n += leaves;
    sp += pushes;
    group_sync<G>();
  }
  return n;
}

// (d, f) after (e, g) in the order of std::pair<float, int32_t>
__device__ __forceinline__ bool after(float d, int f, float e, int g) {
  return e < d || (d == e && g < f);
}

// entries of a list of n (at stride) that come before entry i
__device__ __forceinline__ int rank_of(const int32_t* f, const float* d,
                                       int64_t stride, int n, int i) {
  const float di = d[i * stride];
  const int fi = f[i * stride];
  int r = 0;
  for (int j = 0; j < n; ++j) r += after(di, fi, d[j * stride], f[j * stride]);
  return r;
}

// insertion sort of a list in place (one thread)
__device__ void insertion_sort(int32_t* f, float* d, int n) {
  for (int i = 1; i < n; ++i) {
    const float di = d[i];
    const int fi = f[i];
    int j = i - 1;
    while (j >= 0 && after(d[j], f[j], di, fi)) {
      d[j + 1] = d[j];
      f[j + 1] = f[j];
      --j;
    }
    d[j + 1] = di;
    f[j + 1] = fi;
  }
}

// entry i of a beam's list from the scratch to its CSR offset: at its rank
// where the list is short (its final place), else where it stands, for
// sort_kernel
__device__ __forceinline__ void place_entry(const Params& p, const int32_t* sf,
                                            const float* sd, int64_t stride,
                                            int n, int i, int64_t off) {
  const int at = n <= SMALL ? rank_of(sf, sd, stride, n, i) : i;
  p.faces[off + at] = sf[i * stride];
  p.dnear[off + at] = sd[i * stride];
}

// The thread path's scratch is entry-major (entry k of beam t at
// k * T + t), so that a warp's writes of one entry fall side by side.
__global__ void __launch_bounds__(BLOCK) walk_thread_kernel(Params p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = t < p.n_beams && p.valid[t];
  const Beam b = on ? load_beam(p, t) : Beam{};
  const Out out{p.sfaces + (on ? t : 0), p.sdnear + (on ? t : 0),
                p.n_beams, p.capacity};
  const int n = walk_thread(p, b, on, out);
  if (t < p.n_beams) p.counts[t] = n;
}

__global__ void __launch_bounds__(BLOCK) place_thread_kernel(Params p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = t < p.n_beams;
  const int n = in ? p.counts[t] : 0;
  const int64_t off = in ? p.offsets[t] : 0;
  const bool over = n > p.capacity;
  const Beam b = over ? load_beam(p, t) : Beam{};
  walk_thread(p, b, over, Out{p.faces + off, p.dnear + off, 1, n});
  if (!in) return;
  if (over) {
    if (n <= SMALL) insertion_sort(p.faces + off, p.dnear + off, n);
    return;
  }
  for (int i = 0; i < n; ++i)
    place_entry(p, p.sfaces + t, p.sdnear + t, p.n_beams, n, i, off);
}

// The group path's scratch is beam-major (entry k of beam t at
// t * capacity + k): a group appends side by side.
template <int G>
__device__ __forceinline__ int32_t* group_stack(const Params& p, int group) {
  extern __shared__ int32_t stacks[];   // BLOCK / G stacks, or one
  return p.gstack ? p.gstack + (int64_t)group * p.stack_cap
                  : stacks + (threadIdx.x / G) * p.stack_cap;
}

template <int G>
__global__ void __launch_bounds__(group_block<G>()) walk_group_kernel(Params p) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool on = t < p.n_beams && p.valid[t];
  const Beam b = on ? load_beam(p, t) : Beam{};
  const int64_t base = on ? (int64_t)t * p.capacity : 0;
  const Out out{p.sfaces + base, p.sdnear + base, 1, p.capacity};
  const int n = walk_group<G>(p, b, on, group_stack<G>(p, t), out);
  if (t < p.n_beams && (threadIdx.x & (G - 1)) == 0) p.counts[t] = n;
}

template <int G>
__global__ void __launch_bounds__(group_block<G>())
    place_group_kernel(Params p) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int gl = threadIdx.x & (G - 1);
  const bool in = t < p.n_beams;
  const int n = in ? p.counts[t] : 0;
  const int64_t off = in ? p.offsets[t] : 0;
  const bool over = n > p.capacity;
  const Beam b = over ? load_beam(p, t) : Beam{};
  walk_group<G>(p, b, over, group_stack<G>(p, t),
                Out{p.faces + off, p.dnear + off, 1, n});
  if (!in) return;
  if (over) {
    if (n <= SMALL && gl == 0)
      insertion_sort(p.faces + off, p.dnear + off, n);
    return;
  }
  const int64_t base = (int64_t)t * p.capacity;
  for (int i = gl; i < n; i += G)
    place_entry(p, p.sfaces + base, p.sdnear + base, 1, n, i, off);
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

int sort_grid(int n_beams) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int grid = 8 * sms;
  return n_beams < grid ? (n_beams > 0 ? n_beams : 1) : grid;
}

// blocks of `block` threads for G lanes a beam
int grid_of(int n_beams, int G, int block) {
  const int64_t threads = (int64_t)n_beams * G;
  return static_cast<int>((threads + block - 1) / block);
}

// The walk (place = false) or the place launch of G lanes a beam.
template <int G>
int launch(const Params& p, bool place, cudaStream_t s) {
  constexpr int block = group_block<G>();
  const int grid = grid_of(p.n_beams, G, block);
  if constexpr (G == 1) {
    if (place) {
      place_thread_kernel<<<grid, BLOCK, 0, s>>>(p);
    } else {
      walk_thread_kernel<<<grid, BLOCK, 0, s>>>(p);
    }
  } else {
    // shared bytes of a block's stacks (0: in device memory)
    const int smem = p.gstack ? 0 : block / G * p.stack_cap * 4;
    if (p.stack_cap < G || smem > STACK_SMEM)
      return static_cast<int>(cudaErrorInvalidValue);
    if (place) {
      place_group_kernel<G><<<grid, block, smem, s>>>(p);
    } else {
      walk_group_kernel<G><<<grid, block, smem, s>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_lanes(const Params& p, int lanes, bool place, cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch<1>(p, place, s);
    case 128:
      return launch<128>(p, place, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make_params(const float* node_rec, int n_nodes, const float* center,
                   const float* axis, const float* tan_half,
                   const float* radius, const uint8_t* valid, int n_beams,
                   float t_max, int capacity, int stack_cap,
                   int32_t* gstack, int32_t* counts, int32_t* sfaces,
                   float* sdnear) {
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
  p.capacity = capacity;
  p.stack_cap = stack_cap;
  p.gstack = gstack;
  p.counts = counts;
  p.sfaces = sfaces;
  p.sdnear = sdnear;
  return p;
}

}  // namespace

extern "C" {

// Walk (kernels/cull.py::beam_cull): each valid beam's count into
// `counts` (T,) i32 and its first `capacity` entries into the scratch
// (`sfaces`, `sdnear`, T * capacity), `lanes` lanes a beam (1 or 32);
// `stack_cap` stack entries a group (lanes > 1), in `gstack` when not
// null, else in shared memory.  One launch.  Returns the cudaError_t of
// the launch (0 on success); the kernel runs asynchronously on `stream`.
int lbt_beam_cull_walk(const float* node_rec, int n_nodes,
                       const float* center, const float* axis,
                       const float* tan_half, const float* radius,
                       const uint8_t* valid, int n_beams, float t_max,
                       int lanes, int capacity, int stack_cap,
                       int32_t* gstack, int32_t* counts, int32_t* sfaces,
                       float* sdnear, void* stream) {
  if (n_nodes < 0 || n_beams < 0 || capacity < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_beams == 0) return 0;
  const Params p = make_params(node_rec, n_nodes, center, axis, tan_half,
                               radius, valid, n_beams, t_max, capacity,
                               stack_cap, gstack, counts, sfaces, sdnear);
  return launch_lanes(p, lanes, false, static_cast<cudaStream_t>(stream));
}

// Place and sort: each beam's list at `offsets[t]` (the exclusive scan of
// the counts, T + 1 entries), from the scratch of the walk with the same
// arguments, or walked again where the count is over `capacity`; each
// list sorted by (dnear, face).  Two launches.
int lbt_beam_cull_place(const float* node_rec, int n_nodes,
                        const float* center, const float* axis,
                        const float* tan_half, const float* radius,
                        const uint8_t* valid, int n_beams, float t_max,
                        int lanes, int capacity, int stack_cap,
                        int32_t* gstack, const int32_t* counts,
                        const int32_t* sfaces, const float* sdnear,
                        const int64_t* offsets, int32_t* faces, float* dnear,
                        void* stream) {
  if (n_nodes < 0 || n_beams < 0 || capacity < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_beams == 0) return 0;
  Params p = make_params(node_rec, n_nodes, center, axis, tan_half, radius,
                         valid, n_beams, t_max, capacity, stack_cap, gstack,
                         const_cast<int32_t*>(counts),
                         const_cast<int32_t*>(sfaces),
                         const_cast<float*>(sdnear));
  p.offsets = offsets;
  p.faces = faces;
  p.dnear = dnear;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_lanes(p, lanes, true, s);
  if (err != 0) return err;
  sort_kernel<<<sort_grid(n_beams), SORT_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
