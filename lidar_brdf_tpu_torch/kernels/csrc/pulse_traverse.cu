// Pulse-ladder intersection kernel (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lidar_brdf_tpu/kernels/pulse_pallas.py::
// _kernel` (launched by `_run`, driven by `PulseLadderTraverser.__call__`
// and `_call_permuted`).  It computes what that kernel computes: for every
// ray of a pulse group, the nearest (t, face) over the group's own
// near-to-far candidate ladder, with the Wald test and tie rule of wald.cuh
// (the same ones K1 uses).
//
// What bounds it on this card: bytes.  On the `als` workload a pulse group
// of 10 rays has ~2.3 real candidates in a ladder padded to K = 8, so the
// function needs ~470 bytes per group (24 B a ray in, 8 B a ray out, the
// ladder, 48 B a real candidate's Wald row) against ~23 Wald tests.  The
// earlier design (one thread per ray, one launch per bucket) ran 4.5x over
// that bound: 71% of its tests were on padding, each of the ten rays of a
// group gathered every candidate's row by 12 scalar loads behind a
// dependent load of its id, and two more kernels filled the outputs.  Few
// bytes and little arithmetic per thread leave the latency of two
// dependent loads (ladder id, then Wald row) and the instructions around
// the tests as what is left to cut.  This design:
//
//   * one launch per call over all buckets.  The host
//     (kernels/pulse.py::pulse_schedule) orders the buckets by ladder
//     length, longest first, and gives each a block offset, passed by value
//     in the kernel's parameter block (no device copy, no sync);
//   * a block of (rays, rows) threads takes `blockDim.y` bucket rows of
//     one bucket (12 groups of 10 rays on `als`), one thread per ray, with
//     no integer division anywhere.  The threads of a row load its pulse id
//     and its ladder ids themselves, and each real candidate's Wald row is
//     copied once per row (not once per ray) into shared memory by three
//     16-byte cp.async.ca copies: through L1, because the neighbouring
//     pulses of a block, and of the SM's other blocks, share most of their
//     candidates, and copies through L2 alone queue at the one L2 slice
//     that holds such a row (the `tls` city chunk ran 2.9x slower so).  A
//     test reads its row as three float4.  Ladders go through in stages of
//     STAGE candidates, one barrier each, so shared memory does not grow
//     with K;
//   * a padding id (-1) is never tested, wherever it sits: its t_m is
//     t_max, which can neither lower a block's min below t_max nor win a
//     merge (strict < from t_max).  A block of 8 that holds padding only is
//     skipped and the row goes on to K (a stop there would be exact only
//     for rows padded at the tail);
//   * 128 threads a block at most and at most 40 registers a thread, so 12
//     blocks share an SM and hide each other's loads;
//   * when the caller names the range of groups in no bucket (the
//     Simulator's bucket-contiguous layout leaves them at the tail), extra
//     blocks of the same launch write (BIG, -1) there, so the wrapper needs
//     no fill kernels.
//
// Exactness contract (the plain PyTorch version in kernels/pulse.py and the
// Pallas kernel give identical faces):
//   * the Wald test and tie rule of wald.cuh, restricted to the real
//     candidates of a block: its min t_m (t_max when none is accepted below
//     it), then the min face id among the candidates at that min; blocks
//     merged by strict <.  Skipping padding is exact wherever it sits;
//   * dummy rows (pidx outside [0, n_pulses)) are tested and written
//     nowhere, as `.at[].set(mode="drop")` drops them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wald.cuh"

namespace {

using lbt::BIG;
using lbt::CAND_BLOCK;
using lbt::INT_MISS;
constexpr int MAX_THREADS = 128;   // threads of a block at most
constexpr int MIN_BLOCKS = 12;     // blocks an SM holds: <= 40 registers
constexpr int MAX_ROWS = 32;       // bucket rows of a block at most
constexpr int STAGE = 16;          // candidates of a row staged at a time
constexpr int MAX_BUCKETS = 32;
constexpr int ARGS_PER_BUCKET = 5;
constexpr int FILL_PER_THREAD = 4;  // (BIG, -1) pairs a fill thread writes

struct Bucket {
  const int32_t* pidx;   // (B,)
  const int32_t* cand;   // (B, K), -1 padded anywhere in a row
  int rows;              // B
  int n_cand;            // K
  int first_block;       // the bucket's first block in the grid's x
};

struct Params {
  const float4* wald;    // (F, 12) f32 read as (F, 3) float4
  const float* origin;   // (n_pulses * kernel_rays, 3)
  const float* direction;
  float* out_t;          // (n_pulses * kernel_rays,)
  int32_t* out_f;
  int n_pulses, kernel_rays;
  int n_buckets;
  int fill_first_block;  // blocks from here on in x write (BIG, -1)
  int64_t fill_begin;    // first output element they write
  int64_t fill_count;
  float t_max;
  Bucket bucket[MAX_BUCKETS];   // longest ladders first
};

// Shared memory of a block with `rb` rows: the staged Wald rows (three
// float4 per candidate), then the staged ids.
__host__ __device__ constexpr int smem_bytes(int rb) {
  return rb * STAGE * (3 * 16 + 4);
}

// Candidates [s, s + w) of one live row into ids[0, w) and their Wald rows
// into rows[0, 3w), by the row's threads (thread tx takes candidates tx,
// tx + blockDim.x, ...): ids by plain loads, the rows of real candidates
// by three async 16-byte copies each.
__device__ __forceinline__ void stage(int32_t* ids, float4* rows,
                                      const int32_t* __restrict__ ladder,
                                      const float4* __restrict__ wald, int s,
                                      int w) {
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    const int32_t id = __ldg(ladder + s + c);
    if (id >= 0) {
      const float4* src = wald + 3 * (int64_t)id;
      lbt::cp_async16_l1(rows + 3 * c, src);
      lbt::cp_async16_l1(rows + 3 * c + 1, src + 1);
      lbt::cp_async16_l1(rows + 3 * c + 2, src + 2);
    }
    ids[c] = id;
  }
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
pulse_traverse_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x = static_cast<int>(blockIdx.x);
  if (x >= p.fill_first_block) {
    // groups in no bucket: (BIG, -1), by the first slice's blocks
    if (blockIdx.y) return;
    const int n = blockDim.x * blockDim.y;
    const int64_t base = (int64_t)(x - p.fill_first_block) * n *
                         FILL_PER_THREAD + threadIdx.y * blockDim.x +
                         threadIdx.x;
#pragma unroll
    for (int j = 0; j < FILL_PER_THREAD; ++j) {
      const int64_t e = base + j * n;
      if (e < p.fill_count) {
        p.out_t[p.fill_begin + e] = BIG;
        p.out_f[p.fill_begin + e] = -1;
      }
    }
    return;
  }
  // block x -> bucket (uniform) -> rows; y -> ray slice; thread -> (ray,
  // row)
  int k = 0;
  while (k + 1 < p.n_buckets && x >= p.bucket[k + 1].first_block) ++k;
  const Bucket& bk = p.bucket[k];
  const int lrow = threadIdx.y;
  const int row = (x - bk.first_block) * blockDim.y + lrow;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  const int K = bk.n_cand;
  const float t_max = p.t_max;
  int32_t* ids = reinterpret_cast<int32_t*>(
                     reinterpret_cast<float4*>(smem) +
                     blockDim.y * STAGE * 3) + lrow * STAGE;
  float4* rows = reinterpret_cast<float4*>(smem) + 3 * lrow * STAGE;

  // the row's pulse id and first stage, loaded together (a dummy row's
  // stage is loaded too, so that neither load waits for the other)
  const int32_t* ladder = bk.cand + (int64_t)row * K;
  int w = min(K, STAGE);
  int q = -1;
  if (row < bk.rows) {
    q = __ldg(bk.pidx + row);
    stage(ids, rows, ladder, p.wald, 0, w);
  }
  if (q >= p.n_pulses) q = -1;                  // dummy row: dropped
  const bool live = q >= 0;                     // the same for the row
  const bool ray_ok = live && r < p.kernel_rays;
  const int64_t g = (int64_t)q * p.kernel_rays + r;
  lbt::Ray ray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (ray_ok)
    ray = lbt::Ray{__ldg(p.origin + 3 * g), __ldg(p.origin + 3 * g + 1),
                   __ldg(p.origin + 3 * g + 2), __ldg(p.direction + 3 * g),
                   __ldg(p.direction + 3 * g + 1),
                   __ldg(p.direction + 3 * g + 2)};
  float t_best = t_max;
  int32_t f_best = -1;
  for (int s = 0;;) {
    lbt::cp_async_commit();
    lbt::cp_async_wait<0>();
    __syncthreads();                  // stage s is in shared memory
    if (ray_ok) {
      for (int b = 0; b < w; b += CAND_BLOCK) {
        const int4 lo = *reinterpret_cast<const int4*>(ids + b);
        const int4 hi = *reinterpret_cast<const int4*>(ids + b + 4);
        const int32_t c[CAND_BLOCK] = {lo.x, lo.y, lo.z, lo.w,
                                       hi.x, hi.y, hi.z, hi.w};
        if (max(max(max(c[0], c[1]), max(c[2], c[3])),
                max(max(c[4], c[5]), max(c[6], c[7]))) < 0)
          continue;                   // padding only: nothing to test
        // the block's min t_m over its real candidates (t_max if none is
        // lower), then the min id at that min
        float t_c = t_max;
        int32_t f_c = INT_MISS;
#pragma unroll
        for (int m = 0; m < CAND_BLOCK; ++m) {
          if (c[m] < 0) continue;     // padding: t_m = t_max, no test
          const float4 a = rows[3 * (b + m)];
          const float4 e = rows[3 * (b + m) + 1];
          const float4 f = rows[3 * (b + m) + 2];
          const float wr[12] = {a.x, a.y, a.z, a.w, e.x, e.y,
                                e.z, e.w, f.x, f.y, f.z, f.w};
          const float t_m = lbt::wald_t_m(ray, wr, c[m], t_max);
          if (t_m < t_c) {
            t_c = t_m;
            f_c = c[m];
          } else if (t_m == t_c && c[m] < f_c) {
            f_c = c[m];
          }
        }
        if (t_c < t_best) {           // strict <: an earlier block wins
          t_best = t_c;
          f_best = f_c;
        }
      }
    }
    s += w;
    // (s >= K is uniform over the block.)  The barrier: stage s's buffers
    // are refilled next; the block stops when none of its rows is live.
    if (s >= K || !__syncthreads_or(live)) break;
    w = min(K - s, STAGE);
    if (live) stage(ids, rows, ladder, p.wald, s, w);
  }
  if (ray_ok) {
    p.out_t[g] = f_best < 0 ? BIG : t_best;
    p.out_f[g] = f_best;
  }
}

}  // namespace

extern "C" {

// One launch over all buckets of a call (kernels/pulse.py::pulse_schedule):
// a grid of (row blocks, ray slices) blocks of (slice_rays, rows_per_block)
// threads.  ``args`` holds ARGS_PER_BUCKET int64 per bucket, in launch
// order: pidx and cand pointers, rows B, K, first row block.  ``n_blocks``
// row blocks cover the buckets; when ``fill_count`` > 0, more write (BIG,
// -1) to the outputs' elements [fill_begin, fill_begin + fill_count).
// Padding (-1) may sit anywhere in a ladder row.
// Returns the cudaError_t of the launch (0 on success); the kernel runs
// asynchronously on `stream`.
int lbt_pulse_traverse(const float* wald, const float* origin,
                       const float* direction, int n_pulses, int kernel_rays,
                       float t_max, float* out_t, int32_t* out_f,
                       int n_buckets, const int64_t* args, int n_blocks,
                       int rows_per_block, int slice_rays,
                       int64_t fill_begin, int64_t fill_count, void* stream) {
  if (n_blocks < 0 || n_buckets < 0 || n_buckets > MAX_BUCKETS ||
      (n_blocks > 0) != (n_buckets > 0) || kernel_rays <= 0 ||
      rows_per_block < 1 || rows_per_block > MAX_ROWS || slice_rays < 1 ||
      slice_rays > kernel_rays ||
      rows_per_block * slice_rays > MAX_THREADS || fill_begin < 0 ||
      fill_count < 0 ||
      fill_begin + fill_count > (int64_t)n_pulses * kernel_rays ||
      (reinterpret_cast<uintptr_t>(wald) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.wald = reinterpret_cast<const float4*>(wald);
  p.origin = origin;
  p.direction = direction;
  p.out_t = out_t;
  p.out_f = out_f;
  p.n_pulses = n_pulses;
  p.kernel_rays = kernel_rays;
  p.n_buckets = n_buckets;
  p.t_max = t_max;
  int64_t next = 0;                 // the blocks must tile the grid exactly
  for (int i = 0; i < n_buckets; ++i) {
    const int64_t* a = args + ARGS_PER_BUCKET * i;
    Bucket& b = p.bucket[i];
    b.pidx = reinterpret_cast<const int32_t*>(a[0]);
    b.cand = reinterpret_cast<const int32_t*>(a[1]);
    b.rows = static_cast<int>(a[2]);
    b.n_cand = static_cast<int>(a[3]);
    b.first_block = static_cast<int>(a[4]);
    if (a[2] <= 0 || b.n_cand <= 0 || b.n_cand % CAND_BLOCK ||
        b.first_block != next)
      return static_cast<int>(cudaErrorInvalidValue);
    next += (a[2] + rows_per_block - 1) / rows_per_block;
  }
  if (next != n_blocks) return static_cast<int>(cudaErrorInvalidValue);
  p.fill_first_block = n_blocks;
  p.fill_begin = fill_begin;
  p.fill_count = fill_count;
  const int64_t per_block =
      (int64_t)rows_per_block * slice_rays * FILL_PER_THREAD;
  const int64_t grid = n_blocks + (fill_count + per_block - 1) / per_block;
  if (grid == 0) return 0;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(static_cast<unsigned>(grid),
                    (kernel_rays + slice_rays - 1) / slice_rays);
  pulse_traverse_kernel<<<blocks, dim3(slice_rays, rows_per_block),
                          smem_bytes(rows_per_block),
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
