// Small helpers shared by the port's kernels: element loads/stores that
// convert between the storage type (float or bf16) and fp32 arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dtype codes the Python wrappers pass: 0 = float32, 1 = bfloat16
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Multiprocessors of the current device, read once per device (host side:
// the kernels that plan their grid from it).
inline int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    counts[dev].store(n, std::memory_order_relaxed);
  return n > 0 ? n : 1;  // a failed query is reported by the launch's cudaGetLastError
}

}  // namespace repro
