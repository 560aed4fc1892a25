// Helpers shared by the kernels of paddle_tpu_torch: dtype codes, float
// conversion with round-to-nearest-even (and from the int8 / fp8 e4m3
// codes of quantized KV pools), 16-byte vectors and warp/block
// reductions. Every kernel file exposes a plain C entry point that
// returns cudaGetLastError() after its launch, so the Python wrapper
// (loaded with ctypes) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes passed from Python (ops/kernels/_build.py: dtype_code)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
// quantized KV pool codes (ops/kernels/_build.py: pool_code)
constexpr int kInt8 = 2;
constexpr int kFloat8E4M3 = 3;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T: one vectorised load or store per thread
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; blockDim.x is a multiple of 32 and at most 1024.
// `scratch` holds 32 floats of shared memory. Every thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? scratch[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) scratch[0] = s;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace ptt
