// Pulse-ladder intersection kernel (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lidar_brdf_tpu/kernels/pulse_pallas.py::
// _kernel` (launched by `_run`, driven by `PulseLadderTraverser.__call__`
// and `_call_permuted`).  It computes what that kernel computes: for every
// ray of a pulse group, the nearest (t, face) over the group's own
// near-to-far candidate ladder, with the Wald test and tie rule of wald.cuh
// (the same ones K1 uses).
//
// Design, one thread per (bucket row, ray):
//   * bucket row b holds pulse group pidx[b] and its ladder cand[b, :K]
//     (K % 8 == 0, -1 padded); the kernel_rays threads of one group sit
//     side by side in a warp, so they read the same candidate id and the
//     same Wald row together (one transaction, broadcast);
//   * Wald rows are gathered straight from the (F, 12) table through the
//     read-only cache (__ldg).  The TPU wrapper's per-pulse copy of every
//     candidate's row into an (NB, KB, 12, 8, 128) block, which existed for
//     VMEM and the (8, 128) tiling, is gone;
//   * each thread walks its whole ladder in order, in blocks of 8, and keeps
//     (t_best, f_best) in registers.  One sequential walk merged by strict <
//     equals the JAX package's MAX_KB = 64 block passes merged by strict <,
//     so there is no pass split here;
//   * results go straight to out[pidx * kernel_rays + r]; dummy rows
//     (pidx outside [0, n_pulses)) write nothing, as `.at[].set(mode=
//     "drop")` does, and rays of groups in no bucket keep the wrapper's
//     (BIG, -1).
//
// What bounds it on this card: bytes, not arithmetic.  On the `als`
// workload a pulse group has about 2 real candidates (K = 8 for almost all
// of them), so a ray does ~16 Wald tests (~50 f32 operations each) against
// 24 bytes of ray in, 8 bytes of result out and its share of the ladder and
// gathered Wald rows: a few operations per byte, far below the card's ~20
// f32 operations per byte of memory bandwidth.  The design keeps every
// byte read once per warp (coalesced rays, broadcast ladders and rows);
// shared-memory staging, cp.async and tuning are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wald.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pulse_traverse_kernel(const float* __restrict__ wald,       // (F, 12)
                      const float* __restrict__ origin,     // (P*R, 3)
                      const float* __restrict__ direction,  // (P*R, 3)
                      const int32_t* __restrict__ pidx,     // (B,)
                      const int32_t* __restrict__ cand,     // (B, K)
                      int64_t n_threads, int n_cand, int n_pulses,
                      int kernel_rays, float t_max,
                      float* __restrict__ out_t,            // (P*R,)
                      int32_t* __restrict__ out_f) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_threads) return;
  const int64_t row = i / kernel_rays;
  const int r = static_cast<int>(i - row * kernel_rays);
  const int p = __ldg(pidx + row);
  if (p < 0 || p >= n_pulses) return;                 // dummy row: dropped
  const int64_t g = (int64_t)p * kernel_rays + r;
  const lbt::Ray ray = {__ldg(origin + 3 * g), __ldg(origin + 3 * g + 1),
                        __ldg(origin + 3 * g + 2), __ldg(direction + 3 * g),
                        __ldg(direction + 3 * g + 1),
                        __ldg(direction + 3 * g + 2)};
  const int32_t* cand_row = cand + row * n_cand;
  float t_best = t_max;
  int32_t f_best = -1;
  for (int b = 0; b < n_cand; b += lbt::CAND_BLOCK) {
    auto load = [&](int m, float* w) {
      const int32_t id = __ldg(cand_row + b + m);
      if (id >= 0) {
        const float* src = wald + (int64_t)id * 12;
#pragma unroll
        for (int j = 0; j < 12; ++j) w[j] = __ldg(src + j);
      } else {
#pragma unroll
        for (int j = 0; j < 12; ++j) w[j] = 0.0f;   // pad: n.d == 0
      }
      return id;
    };
    lbt::wald_block(ray, load, t_max, t_best, f_best);
  }
  out_t[g] = f_best < 0 ? lbt::BIG : t_best;
  out_f[g] = f_best;
}

}  // namespace

extern "C" {

// One launch over the B rows of one bucket.  Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
int lbt_pulse_traverse(const float* wald, const float* origin,
                       const float* direction, const int32_t* pidx,
                       const int32_t* cand, int n_rows, int n_cand,
                       int n_pulses, int kernel_rays, float t_max,
                       float* out_t, int32_t* out_f, void* stream) {
  if (n_rows == 0) return 0;
  if (kernel_rays <= 0 || n_cand % lbt::CAND_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_threads = (int64_t)n_rows * kernel_rays;
  const int64_t blocks = (n_threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  pulse_traverse_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      wald, origin, direction, pidx, cand, n_threads, n_cand, n_pulses,
      kernel_rays, t_max, out_t, out_f);
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
