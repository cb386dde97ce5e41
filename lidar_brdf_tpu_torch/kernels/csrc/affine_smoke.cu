// Pre-flight kernel (K3) for Hopper (sm_90a): y = 2x + 1, elementwise.
//
// Replaces the Pallas TPU kernel `bench.py::pallas_smoke` (body `_k`,
// launched by `pl.pallas_call`), which the JAX package's bench runs on one
// (8, 128) f32 tile before it builds any workload, so that a kernel-compile
// fault fails fast with a named error instead of a zero in the record.  The
// port's bench (`lidar_brdf_tpu_torch/bench.py::kernel_smoke`) does the same
// with this kernel: it proves that nvcc built a library for this card and
// that a launch on PyTorch's stream runs and returns the right values.
//
// Design: one thread per element over a contiguous f32 buffer, 256 threads a
// block.  What bounds it on this card: on the (8, 128) tile, the launch
// itself (4 KB in, 4 KB out take nanoseconds at 3.35 TB/s); on large inputs,
// bytes (8 bytes moved per 2 operations).  The multiply and add are written
// with round-to-nearest intrinsics, so no contraction into an FMA can make
// the result differ from the plain PyTorch version `x * 2 + 1` (both are
// exact to the last bit: 2x is exact, the add rounds once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
affine_smoke_kernel(const float* __restrict__ x, float* __restrict__ y,
                    int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __fadd_rn(__fmul_rn(__ldg(x + i), 2.0f), 1.0f);
}

}  // namespace

extern "C" {

// One launch over n elements.  Returns the cudaError_t of the launch (0 on
// success); the kernel runs asynchronously on `stream`.
int lbt_affine_smoke(const float* x, float* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (n < 0 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  affine_smoke_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
