// Row gather (K7) for Hopper (sm_90a):
//     out[i, :] = src[idx[i], :]   for i < n,
// over a row-major (rows, C) source of a 4-byte type (f32 or int32, moved
// as bits) and int64 indices.  The return extraction's forward row gathers
// call it (`kernels/gather.py::row_gather`): the face rows [v0, v1, v2,
// comp], the noise streams' 16-column rows, the winner rays' origin and
// direction rows, the face pack's rows, the corner vertices and the face
// neighbour lists.
//
// Replaces no TPU kernel: the JAX package's gathers are XLA's.  It exists
// because PyTorch's gather for rows whose size is a multiple of 16 bytes
// (`vectorized_gather_kernel<16>`) launches one block per index and gives
// each thread one 16-byte chunk, so a 16-byte row keeps 1 lane of a
// 32-thread block busy and the card's rate of issuing blocks, not its
// bytes, sets the pace: 0.56-0.60 ns an index whatever the row's size.
//
// What bounds it on this card: bytes.  Each row costs its 8-byte index,
// at least one 32-byte sector of the source read at random, and its row
// written; the least time is those bytes / 3.35 TB/s.  The reads are
// random, so what holds it above that is latency.  Design:
// - one thread a chunk of an output row: 16 bytes (`uint4`) where the
//   row's size is a multiple of 16 bytes and both pointers are 16-byte
//   aligned, else one 4-byte element; neighbouring threads write
//   neighbouring addresses, so a warp's stores are coalesced;
// - the source and the indices are read through the read-only path
//   (`__ldg`);
// - 256-thread blocks over at most one wave of the card (132 SMs x 8
//   blocks), in a grid-stride loop that loads UNROLL chunks' indices, then
//   their rows, then stores them, so UNROLL random reads a thread are in
//   flight together; never a block per index;
// - flat chunk numbers are 32-bit where the output holds fewer than 2^32
//   chunks (a 32-bit division a chunk), else 64-bit.
//
// Bit for bit ``src[idx]``: a gather moves bits and computes nothing.  An
// index outside [0, rows) traps (the launch's error then surfaces at the
// next synchronise), as PyTorch's gather asserts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int64_t MAX_BLOCKS = 132 * 8;  // one wave: 132 SMs x 2,048 threads

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const T* __restrict__ src,
                  const int64_t* __restrict__ idx, I total, I chunks,
                  uint64_t rows, T* __restrict__ out) {
  const I stride = (I)gridDim.x * THREADS;
  for (I base = (I)blockIdx.x * THREADS + threadIdx.x; base < total;
       base += stride * UNROLL) {
    int64_t row[UNROLL];
    I col[UNROLL];
    bool bad = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const I j = base + u * stride;
      row[u] = 0;
      col[u] = 0;
      if (j < total) {
        const I r = j / chunks;
        col[u] = j - r * chunks;
        row[u] = __ldg(reinterpret_cast<const long long*>(idx + r));
        bad |= (uint64_t)row[u] >= rows;
      }
    }
    if (bad) __trap();
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * stride < total)
        v[u] = __ldg(src + row[u] * (int64_t)chunks + col[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const I j = base + u * stride;
      if (j < total) out[j] = v[u];
    }
  }
}

template <typename T>
int launch(const void* src, const int64_t* idx, int64_t n, int64_t chunks,
           int64_t rows, void* out, cudaStream_t stream) {
  const int64_t total = n * chunks;
  int64_t blocks = (total + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const uint64_t r = static_cast<uint64_t>(rows);
  if (total < (int64_t(1) << 32) - THREADS * UNROLL * MAX_BLOCKS) {
    uint32_t t32 = static_cast<uint32_t>(total);
    uint32_t c32 = static_cast<uint32_t>(chunks);
    row_gather_kernel<T, uint32_t><<<dim3(static_cast<unsigned>(blocks)),
                                     THREADS, 0, stream>>>(s, idx, t32, c32,
                                                           r, o);
  } else {
    uint64_t t64 = static_cast<uint64_t>(total);
    uint64_t c64 = static_cast<uint64_t>(chunks);
    row_gather_kernel<T, uint64_t><<<dim3(static_cast<unsigned>(blocks)),
                                     THREADS, 0, stream>>>(s, idx, t64, c64,
                                                           r, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch gathering n rows of `cols` 4-byte values from `src` (rows,
// cols) at `idx` (n int64) into `out` (n, cols).  Returns the cudaError_t
// of the launch (0 on success); the kernel runs asynchronously on
// `stream`.  n == 0 or cols == 0 launches nothing.
int lbt_row_gather(const void* src, const int64_t* idx, int64_t n,
                   int64_t cols, int64_t rows, void* out, void* stream) {
  if (n == 0 || cols == 0) return 0;
  if (n < 0 || cols < 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = cols % 4 == 0
      && reinterpret_cast<uintptr_t>(src) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (wide) return launch<uint4>(src, idx, n, cols / 4, rows, out, s);
  return launch<uint32_t>(src, idx, n, cols, rows, out, s);
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
