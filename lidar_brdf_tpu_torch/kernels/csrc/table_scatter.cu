// Table-gradient scatter-add (K6) for Hopper (sm_90a):
//     out[idx[i]] += g[i]   for i < total,   out zeroed by the caller,
// over f32 cotangents g and int32 flat table indices idx, both the
// row-major (N, W) layout of a table read (W = 8 Hermite, 4 bilinear, 1
// raw).
//
// Replaces the XLA element scatter-add of the JAX package's custom
// backwards `lidar_brdf_tpu/physics/brdf.py::_hermite_windows_bwd`
// (:195-200) and `_bilinear_windows_bwd` (:99-103):
// `jnp.zeros(cells).at[idx].add(g)`, the table gradient of a measured-BRDF
// read, formed with no sort.  PyTorch's own differentiation of a gather
// (`index_put_(accumulate=True)`) sorts the indices and then walks each run
// of equal indices serially; a step's masked slots all read one cell with
// a zero cotangent, and real reads crowd onto few cells, so those runs are
// millions long.
//
// What bounds it on this card: bytes.  Each contribution is 8 bytes read
// (index and cotangent) and the table 4 bytes a cell written, against one
// add; the least time is (8 total + 8 cells) bytes / 3.35 TB/s.  What can
// hold it far above that is contention: atomics on one address serialise
// in L2.  Design:
// - one lane a contribution, row-major, so a warp's loads are coalesced
//   and its 32 lanes hold 32 / W neighbouring reads, which share cells
//   (a Hermite read's rx0 and ry0 are the same cell, and neighbouring rays
//   mostly fall in the same table cell);
// - a zero cotangent is skipped: adding +-0 to a sum that starts at +0
//   changes no bit of it (a NaN is not zero and still propagates);
// - `__match_any_sync` groups the live lanes that share a cell; each group
//   sums its values in ascending lane order through shuffles (a loop over
//   the lanes of groups of two or more only, the same for the whole warp),
//   and the group's lowest lane issues the one `atomicAdd` of the cell;
// - a grid-stride loop of warp-aligned steps over at most one wave of
//   blocks, so every lane of a warp takes each step together.
//
// Determinism: a warp's sum is fixed, but warps reach a cell's atomics in
// no fixed order, so a cell that more than one warp adds to is NOT bit-
// stable from run to run (nor equal bit for bit to the plain version,
// `kernels/scatter.py::table_scatter_add_plain`).  Two orders of n f32
// additions differ by at most about n * 2^-23 * sum |g|, the tolerance the
// checks use.
//
// An index outside [0, n_cells) on a live lane traps (the launch's error
// then surfaces at the next synchronise); the port's table reads form
// their indices in range by construction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;    // one wave: 132 SMs x 2,048 threads
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
table_scatter_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ g, int64_t total,
                     int32_t n_cells, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  // base is a warp's first contribution: the loop is warp-uniform
  for (int64_t base = (int64_t)blockIdx.x * THREADS + (threadIdx.x & ~31);
       base < total; base += stride) {
    const int64_t i = base + lane;
    float v = 0.0f;
    int32_t cell = -1;
    if (i < total) {
      v = __ldg(g + i);
      cell = __ldg(idx + i);
    }
    const bool live = v != 0.0f;
    const unsigned live_mask = __ballot_sync(FULL, live);
    if (live_mask == 0) continue;
    if (live && (cell < 0 || cell >= n_cells)) __trap();
    const unsigned group =
        __match_any_sync(FULL, live ? cell : -1) & live_mask;
    const bool shared = live && group != (1u << lane);
    unsigned todo = __ballot_sync(FULL, shared);
    float sum = v;
    if (todo) {
      // every lane walks the same lanes in ascending order; each adds the
      // values of its own group (0 + v is v exactly, so the sum is the
      // left fold of the group's values in lane order)
      float acc = 0.0f;
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const float vj = __shfl_sync(FULL, v, j);
        if (group & (1u << j)) acc = __fadd_rn(acc, vj);
      }
      if (shared) sum = acc;
    }
    if (live && lane == __ffs(group) - 1) atomicAdd(out + cell, sum);
  }
}

}  // namespace

extern "C" {

// One launch over `total` contributions into `out` (n_cells floats, zeroed
// by the caller).  Returns the cudaError_t of the launch (0 on success);
// the kernel runs asynchronously on `stream`.  total == 0 launches nothing.
int lbt_table_scatter(const int32_t* idx, const float* g, int64_t total,
                      int32_t n_cells, float* out, void* stream) {
  if (total == 0) return 0;
  if (total < 0 || n_cells <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  void* args[] = {&idx, &g, &total, &n_cells, &out};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(table_scatter_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream)));
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
