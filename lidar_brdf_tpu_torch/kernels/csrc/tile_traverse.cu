// Tile intersection kernel (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lidar_brdf_tpu/kernels/traverse_pallas.py::
// _kernel` (launched by `_run`, driven by `PallasCulledTraverser.__call__`).
// It computes what that kernel computes, not how: for every ray of a ray
// tile, the nearest (t, face) over the tile's near-to-far sorted candidate
// list, with the Wald triangle test in full f32 and the same tie rule.
//
// Design, one CUDA block per bucket row (= one ray tile):
//   * each thread owns RPT rays of the tile and keeps (t_best, f_best) in
//     registers for the whole walk;
//   * the block gathers the Wald rows of its candidates straight from the
//     (F, 12) table into shared memory, CHUNK candidates at a time, and
//     reads its own `cand`/`tidx`/`bnd` rows (the TPU wrapper's row padding
//     to 16, the 128-lane id broadcast and the MAX_CB pass split are gone:
//     a block walks its whole list in one launch);
//   * results go straight to out[tidx]; dummy rows (tidx == n_tiles) write
//     nothing, as `.at[].set(mode="drop")` does.
//
// What bounds it on this card: f32 ALU work, about 50 operations per
// (ray, candidate) pair (the multiply/add chains of t, u and v, one IEEE
// division, the compares and the tie rule), against 52 bytes per candidate
// (12 f32 Wald values and one i32 id) that the block reads once per tile
// and shares across the tile's rays from shared memory.  At 640 rays per
// tile that is ~600 operations per byte read, far above the card's ~20 f32
// operations per byte of memory bandwidth, so the kernel is compute bound.
// The early exit (below) is the main saving; `cp.async` staging and tuning
// are left for later work.
//
// Exactness contract (the plain PyTorch version in kernels/traverse.py and
// the Pallas kernel give identical faces):
//   * the Wald test and tie rule of wald.cuh, shared with K2;
//   * early exit: a ray skips every block whose lower distance bound
//     exceeds its best t (the bounds are a conservative, monotone prefix,
//     so no skipped block can hold a nearer hit), and the block stops once
//     no ray of the tile is live (__syncthreads_or).  Results do not depend
//     on where it exits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wald.cuh"

namespace {

using lbt::BIG;
using lbt::CAND_BLOCK;
constexpr int CHUNK = 256;        // candidates staged in shared memory
constexpr int CHUNK_BLOCKS = CHUNK / CAND_BLOCK;

template <int RPT>
__global__ void __launch_bounds__(1024)
tile_traverse_kernel(const float* __restrict__ wald,      // (F, 12)
                     const float* __restrict__ origin,    // (T*tile_rays, 3)
                     const float* __restrict__ direction, // (T*tile_rays, 3)
                     const int32_t* __restrict__ tidx,    // (B,)
                     const int32_t* __restrict__ cand,    // (B, C)
                     const float* __restrict__ bnd,       // (B, C/8)
                     int n_cand, int n_tiles, int tile_rays, float t_max,
                     float* __restrict__ out_t,           // (T*tile_rays,)
                     int32_t* __restrict__ out_f) {
  __shared__ float s_rows[CHUNK * 12];
  __shared__ int32_t s_ids[CHUNK];
  __shared__ float s_bnd[CHUNK_BLOCKS];

  const int row = blockIdx.x;
  const int tile = tidx[row];
  if (tile < 0 || tile >= n_tiles) return;   // dummy row: uniform per block

  lbt::Ray ray[RPT];
  float t_best[RPT];
  int32_t f_best[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int64_t g = (int64_t)tile * tile_rays + threadIdx.x + k * blockDim.x;
    ray[k] = {origin[3 * g + 0], origin[3 * g + 1], origin[3 * g + 2],
              direction[3 * g + 0], direction[3 * g + 1],
              direction[3 * g + 2]};
    t_best[k] = t_max;
    f_best[k] = -1;
  }

  const int n_blk = n_cand / CAND_BLOCK;
  const int32_t* cand_row = cand + (int64_t)row * n_cand;
  const float* bnd_row = bnd + (int64_t)row * n_blk;

  for (int blk0 = 0; blk0 < n_blk; blk0 += CHUNK_BLOCKS) {
    // block-wide exit: continue while any ray has t_best >= bound
    const float b0 = bnd_row[blk0];
    int live = 0;
#pragma unroll
    for (int k = 0; k < RPT; ++k) live |= (t_best[k] >= b0);
    if (!__syncthreads_or(live)) break;

    const int nb = min(CHUNK_BLOCKS, n_blk - blk0);
    const int nc = nb * CAND_BLOCK;
    for (int i = threadIdx.x; i < nc * 12; i += blockDim.x) {
      const int c = i / 12;
      const int j = i - c * 12;
      const int32_t id = cand_row[blk0 * CAND_BLOCK + c];
      s_rows[i] = id >= 0 ? wald[(int64_t)id * 12 + j] : 0.0f;
    }
    for (int i = threadIdx.x; i < nc; i += blockDim.x)
      s_ids[i] = cand_row[blk0 * CAND_BLOCK + i];
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      s_bnd[i] = bnd_row[blk0 + i];
    __syncthreads();

#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      for (int b = 0; b < nb; ++b) {
        if (s_bnd[b] > t_best[k]) break;     // nothing nearer in this block
        auto load = [&](int m, float* w) {
          const float* r = s_rows + (b * CAND_BLOCK + m) * 12;
#pragma unroll
          for (int j = 0; j < 12; ++j) w[j] = r[j];
          return s_ids[b * CAND_BLOCK + m];
        };
        lbt::wald_block(ray[k], load, t_max, t_best[k], f_best[k]);
      }
    }
    __syncthreads();   // the next chunk overwrites shared memory
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int64_t g = (int64_t)tile * tile_rays + threadIdx.x + k * blockDim.x;
    out_t[g] = f_best[k] < 0 ? BIG : t_best[k];
    out_f[g] = f_best[k];
  }
}

template <int RPT>
void launch(const float* wald, const float* origin, const float* direction,
            const int32_t* tidx, const int32_t* cand, const float* bnd,
            int n_rows, int n_cand, int n_tiles, int tile_rays, float t_max,
            float* out_t, int32_t* out_f, cudaStream_t stream) {
  tile_traverse_kernel<RPT><<<n_rows, tile_rays / RPT, 0, stream>>>(
      wald, origin, direction, tidx, cand, bnd, n_cand, n_tiles, tile_rays,
      t_max, out_t, out_f);
}

}  // namespace

extern "C" {

// Rays per thread for a tile: the smallest power of two keeping the block
// at <= 1024 threads (0 when the tile is too large).
int lbt_tile_traverse_rays_per_thread(int tile_rays) {
  for (int rpt = 1; rpt <= 8; rpt *= 2)
    if (tile_rays % rpt == 0 && tile_rays / rpt <= 1024 &&
        (tile_rays / rpt) % 32 == 0)
      return rpt;
  return 0;
}

// One launch over the B rows of one bucket.  Returns the cudaError_t of
// the launch (0 on success); the kernel runs asynchronously on `stream`.
int lbt_tile_traverse(const float* wald, const float* origin,
                      const float* direction, const int32_t* tidx,
                      const int32_t* cand, const float* bnd, int n_rows,
                      int n_cand, int n_tiles, int tile_rays, float t_max,
                      float* out_t, int32_t* out_f, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lbt_tile_traverse_rays_per_thread(tile_rays)) {
    case 1: launch<1>(wald, origin, direction, tidx, cand, bnd, n_rows,
                      n_cand, n_tiles, tile_rays, t_max, out_t, out_f, s);
            break;
    case 2: launch<2>(wald, origin, direction, tidx, cand, bnd, n_rows,
                      n_cand, n_tiles, tile_rays, t_max, out_t, out_f, s);
            break;
    case 4: launch<4>(wald, origin, direction, tidx, cand, bnd, n_rows,
                      n_cand, n_tiles, tile_rays, t_max, out_t, out_f, s);
            break;
    case 8: launch<8>(wald, origin, direction, tidx, cand, bnd, n_rows,
                      n_cand, n_tiles, tile_rays, t_max, out_t, out_f, s);
            break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
