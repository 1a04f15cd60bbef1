// Pieces shared by the port's kernels, for Hopper (sm_90a): 4-element
// vector loads and stores of f32 or bf16, an alignment test and a block sum
// in a fixed order.  No float atomics anywhere: every sum is the same on
// every run, which bit-exact resume and every rank proposing the same
// batch size depend on.  The multi-bucket launch of the streaming kernels
// is in buckets.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 consecutive elements as floats: one 16-byte load for f32, 8 for bf16.
__device__ __forceinline__ void load4(const float* src, float out[kVec]) {
  float4 x = *reinterpret_cast<const float4*>(src);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float out[kVec]) {
  uint2 raw = *reinterpret_cast<const uint2*>(src);
  __nv_bfloat16 h[kVec];
  memcpy(h, &raw, sizeof(raw));
#pragma unroll
  for (int j = 0; j < kVec; ++j) out[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void store4(float* dst, const float in[kVec]) {
  *reinterpret_cast<float4*>(dst) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float in[kVec]) {
  __nv_bfloat16 h[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) h[j] = __float2bfloat16_rn(in[j]);
  uint2 raw;
  memcpy(&raw, h, sizeof(raw));
  *reinterpret_cast<uint2*>(dst) = raw;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// Sum over the block in a fixed order; thread 0 gets the result.  Every
// thread of the block must call it.  The leading barrier lets a kernel call
// it twice in a row: no warp overwrites warp_sums while warp 0 still reads
// the previous call's.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
  __syncthreads();
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.0f;
  if (warp == 0) {
    x = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    x = warp_sum(x);
  }
  return x;
}

inline bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
