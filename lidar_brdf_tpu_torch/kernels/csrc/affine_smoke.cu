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
// What bounds it on this card: on the (8, 128) tile, the launch path on the
// host (4 KB in, 4 KB out take nanoseconds at 3.35 TB/s), which
// kernels/cuda_build.py and kernels/smoke.py keep short; on large inputs,
// bytes (8 bytes moved per 2 operations).  Design: each thread moves one
// float4 (16-byte loads and stores) when both buffers are 16-byte aligned,
// and the last n % 4 elements go one per thread to the threads after the
// vector range; a misaligned buffer takes one element per thread.  256
// threads a block.  The multiply and add are written with round-to-nearest
// intrinsics, so no contraction into an FMA can make the result differ from
// the plain PyTorch version `x * 2 + 1` (both are exact to the last bit: 2x
// is exact, the add rounds once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float affine(float v) {
  return __fadd_rn(__fmul_rn(v, 2.0f), 1.0f);
}

// n4 float4 items, then the n - 4 * n4 tail elements one per thread.
__global__ void __launch_bounds__(THREADS)
affine_smoke_vec4(const float4* __restrict__ x, float4* __restrict__ y,
                  int64_t n4, const float* __restrict__ xs,
                  float* __restrict__ ys, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    float4 v = __ldg(x + i);
    v.x = affine(v.x);
    v.y = affine(v.y);
    v.z = affine(v.z);
    v.w = affine(v.w);
    y[i] = v;
  } else {
    const int64_t e = 4 * n4 + (i - n4);
    if (e < n) ys[e] = affine(__ldg(xs + e));
  }
}

__global__ void __launch_bounds__(THREADS)
affine_smoke_scalar(const float* __restrict__ x, float* __restrict__ y,
                    int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = affine(__ldg(x + i));
}

}  // namespace

extern "C" {

// One launch over n elements.  Returns the cudaError_t of the launch (0 on
// success); the kernel runs asynchronously on `stream`.
int lbt_affine_smoke(const float* x, float* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  int64_t n4 = aligned ? n / 4 : 0;
  const int64_t threads = n4 + (n - 4 * n4);
  const int64_t blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // cudaLaunchKernel directly: the <<<>>> form adds a push and a pop of
  // the launch configuration to every launch's host time
  void* vec_args[] = {&x, &y, &n4, &x, &y, &n};
  void* scalar_args[] = {&x, &y, &n};
  return static_cast<int>(cudaLaunchKernel(
      aligned ? reinterpret_cast<const void*>(affine_smoke_vec4)
              : reinterpret_cast<const void*>(affine_smoke_scalar),
      dim3(static_cast<unsigned>(blocks)), dim3(THREADS),
      aligned ? vec_args : scalar_args, 0,
      static_cast<cudaStream_t>(stream)));
}

const char* lbt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
