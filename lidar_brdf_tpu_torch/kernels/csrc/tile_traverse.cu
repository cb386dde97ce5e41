// Tile intersection kernel (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lidar_brdf_tpu/kernels/traverse_pallas.py::
// _kernel` (launched by `_run`, driven by `PallasCulledTraverser.__call__`).
// It computes what that kernel computes, not how: for every ray of a ray
// tile, the nearest (t, face) over the tile's near-to-far sorted candidate
// list, with the Wald test in full f32 and the same tie rule.
//
// What bounds it on this card.  Instruction throughput, not memory: each
// (ray, candidate) test runs its dot products as separate multiplies and adds
// (no contraction), the IEEE division as a reciprocal, five FMAs and a
// range check with a branch to a slow path, and a row of compares, while
// 52 bytes per candidate serve a unit's 128 rays; and a warp runs as long
// as its slowest ray.  The `tls` chunk needs ~15.5 M tests
// (chip_smoke.py).  The earlier design (one 640-thread block per bucket
// row, one launch per bucket) ran ~24x over its bound because of balance:
// its heaviest buckets had fewer rows than the card has SMs and each launch
// waited for its slowest tile.  This design:
//
//   * one launch per call over all buckets.  The host
//     (kernels/traverse.py::tile_schedule) orders the buckets by list
//     length, longest first, and gives each a block offset, passed by value
//     in the kernel's parameter block (no device copy, no sync).  Long lists
//     start at time zero and short ones fill the card behind them;
//   * the work is cut into units of 128 consecutive rays of one tile, so a
//     640-ray row of a long list is spread over five groups; a block is 4
//     groups of 128 threads, one thread per ray, each group one unit,
//     synchronised by its own named barrier (never the block's), so units
//     that end early do not wait for the others;
//   * candidates are staged 128 at a time, double-buffered: the ids and
//     bounds of the next chunk are loaded a chunk ahead into registers, and
//     each 48-byte Wald row arrives by three 16-byte cp.async copies, so the
//     gather of chunk k + 1 overlaps the tests of chunk k.  The tests read a
//     staged row as three float4 (one broadcast each for a warp).  A unit's
//     stage is ~13 KB of shared memory whatever the list length.
//
// What is left on the `tls` chunk is the test work itself, the longest
// rays' serial walks starting first (PERF.md, K1).

// Exactness contract (the plain PyTorch version in kernels/traverse.py and
// the Pallas kernel give identical faces):
//   * the Wald test and tie rule of wald.cuh, shared with K2;
//   * early exit: a ray stops at the first block whose lower distance bound
//     exceeds its best t (the bounds are a conservative, monotone prefix, so
//     no skipped block can hold the winner), and the unit stops once none of
//     its rays is live.  Results do not depend on where or when it exits;
//   * dummy rows (tidx outside [0, n_tiles)) write nothing, as
//     `.at[].set(mode="drop")` does; tiles in no bucket keep the wrapper's
//     (BIG, -1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wald.cuh"

namespace {

using lbt::BIG;
using lbt::CAND_BLOCK;
using lbt::cp_async16;
using lbt::cp_async_commit;
using lbt::cp_async_wait;
constexpr int GROUP = 128;                         // threads of a group
constexpr int GROUPS = 4;                          // groups of a block
constexpr int THREADS = GROUP * GROUPS;
constexpr int CHUNK = GROUP;                       // candidates per stage
constexpr int CHUNK_BLOCKS = CHUNK / CAND_BLOCK;   // blocks of 8 per stage
constexpr int MAX_BUCKETS = 32;
constexpr int ARGS_PER_BUCKET = 7;

struct Bucket {
  const int32_t* tidx;   // (B,)
  const int32_t* cand;   // (B, C), -1 padded
  const float* bnd;      // (B, C / 8)
  int rows;              // B
  int n_cand;            // C
  int first_block;       // the bucket's first block in the grid
  int units_per_row;     // tile_rays / GROUP
};

struct Params {
  const float4* wald;    // (F, 12) f32 read as (F, 3) float4
  const float* origin;   // (n_tiles * tile_rays, 3)
  const float* direction;
  float* out_t;          // (n_tiles * tile_rays,)
  int32_t* out_f;
  int n_tiles, tile_rays, n_buckets;
  float t_max;
  Bucket bucket[MAX_BUCKETS];   // longest lists first
};

struct Stage {
  float4 rows[CHUNK * 3];        // Wald rows, 3 float4 per candidate
  int32_t ids[CHUNK];
  float bnd[CHUNK_BLOCKS];
};

constexpr int DYNAMIC_SMEM = GROUPS * 2 * static_cast<int>(sizeof(Stage));

// Barrier of one unit's `n` threads (named barrier `id` >= 1).
__device__ __forceinline__ void unit_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The same barrier, returning whether `pred` holds in any of the threads.
__device__ __forceinline__ bool unit_sync_or(int id, int n, bool pred) {
  int any;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n"
      " bar.red.or.pred q, %2, %3, p;\n selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(any) : "r"(static_cast<int>(pred)), "r"(id), "r"(n)
      : "memory");
  return any != 0;
}

// Candidate `lane` of a chunk into `st`: its id and (for the first
// CHUNK_BLOCKS lanes) a block bound, loaded a chunk ahead, and its Wald row
// by three async 16-byte copies (zeros for padding).
__device__ __forceinline__ void stage_chunk(Stage& st,
                                            const float4* __restrict__ wald,
                                            int lane, int32_t id,
                                            float bound) {
  st.ids[lane] = id;
  if (lane < CHUNK_BLOCKS) st.bnd[lane] = bound;
  float4* dst = st.rows + 3 * lane;
  if (id >= 0) {
    const float4* src = wald + 3 * (int64_t)id;
    cp_async16(dst, src);
    cp_async16(dst + 1, src + 1);
    cp_async16(dst + 2, src + 2);
  } else {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[0] = z;
    dst[1] = z;
    dst[2] = z;
  }
}

// Staged candidate c: its Wald row into w[12] (three float4 reads, one
// broadcast each for a warp) and its id.
__device__ __forceinline__ int32_t staged_row(const Stage& st, int c,
                                              float* w) {
  const float4 a = st.rows[3 * c];
  const float4 b = st.rows[3 * c + 1];
  const float4 e = st.rows[3 * c + 2];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  w[8] = e.x; w[9] = e.y; w[10] = e.z; w[11] = e.w;
  return st.ids[c];
}

__global__ void __launch_bounds__(THREADS, 2)
tile_traverse_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];

  // block -> bucket (uniform); group -> unit
  int k = 0;
  while (k + 1 < p.n_buckets &&
         static_cast<int>(blockIdx.x) >= p.bucket[k + 1].first_block)
    ++k;
  const Bucket& bk = p.bucket[k];
  const int group = threadIdx.x / GROUP;
  const int lane = threadIdx.x - group * GROUP;
  const int unit =
      (static_cast<int>(blockIdx.x) - bk.first_block) * GROUPS + group;
  if (unit >= bk.rows * bk.units_per_row) return;    // past the last unit
  const int row = unit / bk.units_per_row;
  const int tile = __ldg(bk.tidx + row);
  if (tile < 0 || tile >= p.n_tiles) return;         // dummy row
  const int bar = 1 + group;                          // the unit's barrier
  Stage* stage = reinterpret_cast<Stage*>(smem) + 2 * group;

  const int64_t g = (int64_t)tile * p.tile_rays +
                    (int64_t)(unit - row * bk.units_per_row) * GROUP + lane;
  const lbt::Ray ray = {__ldg(p.origin + 3 * g), __ldg(p.origin + 3 * g + 1),
                        __ldg(p.origin + 3 * g + 2),
                        __ldg(p.direction + 3 * g),
                        __ldg(p.direction + 3 * g + 1),
                        __ldg(p.direction + 3 * g + 2)};
  const int C = bk.n_cand;
  const int n_blk = C / CAND_BLOCK;
  const int n_chunks = (C + CHUNK - 1) / CHUNK;
  const int32_t* cand_row = bk.cand + (int64_t)row * C;
  const float* bnd_row = bk.bnd + (int64_t)row * n_blk;
  const float t_max = p.t_max;
  const float inf = __int_as_float(0x7f800000);
  // the unit stages its candidates, one per thread
  auto fetch = [&](int ch, int32_t& id, float& bound) {
    const int c = ch * CHUNK + lane;
    id = c < C ? __ldg(cand_row + c) : -1;
    const int b = ch * CHUNK_BLOCKS + lane;
    bound = (lane < CHUNK_BLOCKS && b < n_blk) ? __ldg(bnd_row + b) : inf;
  };

  float t_best = t_max;
  int32_t f_best = -1;
  bool done = false;
  int32_t id;
  float bound;
  fetch(0, id, bound);
  stage_chunk(stage[0], p.wald, lane, id, bound);
  if (n_chunks > 1) fetch(1, id, bound);
  cp_async_commit();

  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage_chunk(stage[(ch + 1) & 1], p.wald, lane, id, bound);
      if (ch + 2 < n_chunks) fetch(ch + 2, id, bound);
    }
    cp_async_commit();
    cp_async_wait<1>();             // this thread's copies of chunk ch
    // barrier: all of chunk ch is in shared memory; the unit stops when no
    // ray of it is live at the chunk's first bound
    const float b0 = __ldg(bnd_row + ch * CHUNK_BLOCKS);
    const bool live = !done && !(b0 > t_best);
    if (!unit_sync_or(bar, GROUP, live)) break;
    if (!done) {
      const Stage& st = stage[ch & 1];
      const int nb = min(CHUNK_BLOCKS, n_blk - ch * CHUNK_BLOCKS);
      for (int lb = 0; lb < nb; ++lb) {
        if (st.bnd[lb] > t_best) {
          done = true;              // the bounds only grow from here
          break;
        }
        float t_c;
        int32_t f_c;
        lbt::wald_block_min(ray, [&](int m, float* w) {
          return staged_row(st, lb * CAND_BLOCK + m, w);
        }, t_max, t_c, f_c);
        if (t_c < t_best) {
          t_best = t_c;
          f_best = f_c;
        }
      }
    }
    unit_sync(bar, GROUP);          // chunk ch's buffer is refilled next
  }
  cp_async_wait<0>();
  p.out_t[g] = f_best < 0 ? BIG : t_best;
  p.out_f[g] = f_best;
}

}  // namespace

extern "C" {

// One launch over all buckets of a call.  ``args`` holds ARGS_PER_BUCKET
// int64 per bucket, in launch order (kernels/traverse.py::tile_schedule):
// tidx, cand and bnd pointers, rows B, C, first block, units per row.
// Returns the cudaError_t of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int lbt_tile_traverse(const float* wald, const float* origin,
                      const float* direction, int n_tiles, int tile_rays,
                      float t_max, float* out_t, int32_t* out_f,
                      int n_buckets, const int64_t* args, int n_blocks,
                      void* stream) {
  if (n_blocks == 0) return 0;
  if (n_blocks < 0 || n_buckets < 1 || n_buckets > MAX_BUCKETS ||
      tile_rays <= 0 || tile_rays % GROUP ||
      (reinterpret_cast<uintptr_t>(wald) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.wald = reinterpret_cast<const float4*>(wald);
  p.origin = origin;
  p.direction = direction;
  p.out_t = out_t;
  p.out_f = out_f;
  p.n_tiles = n_tiles;
  p.tile_rays = tile_rays;
  p.n_buckets = n_buckets;
  p.t_max = t_max;
  int64_t next = 0;                 // the blocks must tile the grid exactly
  for (int i = 0; i < n_buckets; ++i) {
    const int64_t* a = args + ARGS_PER_BUCKET * i;
    Bucket& b = p.bucket[i];
    b.tidx = reinterpret_cast<const int32_t*>(a[0]);
    b.cand = reinterpret_cast<const int32_t*>(a[1]);
    b.bnd = reinterpret_cast<const float*>(a[2]);
    b.rows = static_cast<int>(a[3]);
    b.n_cand = static_cast<int>(a[4]);
    b.first_block = static_cast<int>(a[5]);
    b.units_per_row = static_cast<int>(a[6]);
    if (a[3] <= 0 || b.n_cand <= 0 || b.n_cand % CAND_BLOCK ||
        b.first_block != next ||
        (int64_t)b.units_per_row * GROUP != tile_rays)
      return static_cast<int>(cudaErrorInvalidValue);
    next += (a[3] * b.units_per_row + GROUPS - 1) / GROUPS;
  }
  if (next != n_blocks) return static_cast<int>(cudaErrorInvalidValue);
  static uint64_t smem_set = 0;     // once per card (bit = device index)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(tile_traverse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DYNAMIC_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set |= uint64_t{1} << dev;
  }
  tile_traverse_kernel<<<static_cast<unsigned>(n_blocks), THREADS,
                         DYNAMIC_SMEM, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
