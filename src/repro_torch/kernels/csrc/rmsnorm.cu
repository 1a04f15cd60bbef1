// Row-wise RMSNorm for Hopper (sm_90a):
//
//     out[r, :] = x[r, :] / sqrt(mean(x[r, :]^2) + eps) * scale
//
// Replaces the TPU kernel `rmsnorm` in src/repro/kernels/rmsnorm.py (its
// pl.pallas_call at line 38).  x is (rows, d) in f32 or bf16, the scale (d,)
// in f32 or bf16 (each its own); the sum of squares and the arithmetic are
// f32 and the result has x's type.  As the TPU kernel does, it divides by
// sqrtf(var + eps) (IEEE division and square root), not rsqrtf.
//
// Bound: memory.  Each element is read once and written once against ~4
// flops.  The design:
//   * one block of 256 threads per row; the row is read twice (the sum of
//     squares, then the scaled write), the second read from L1/L2, since a
//     row of d_model floats is a few KB;
//   * 16-byte vector loads and stores when x, out and the scale start on a
//     16-byte boundary (8 for bf16) and d is a multiple of 4, so that every
//     row does; otherwise a scalar loop — any d, any offset (the TPU kernel
//     needed d % 128 == 0 and padded rows);
//   * the row sum in a fixed order (per-thread strided sums, a warp tree,
//     the warps' sums in order): no atomics, so repeated calls are
//     bit-identical.

#include "common.cuh"

namespace {

template <typename X, typename S, bool kVector>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const X* __restrict__ x, const S* __restrict__ scale,
               X* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const X* xr = x + row * d;
  X* outr = out + row * d;
  __shared__ float denom;

  float ss = 0.0f;
  if (kVector) {
    for (int k = threadIdx.x; k < d / kVec; k += kThreads) {
      float v[kVec];
      load4(xr + k * kVec, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) ss += v[j] * v[j];
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
  }
  ss = block_sum(ss);
  if (threadIdx.x == 0) denom = sqrtf(ss / static_cast<float>(d) + eps);
  __syncthreads();
  const float den = denom;

  if (kVector) {
    for (int k = threadIdx.x; k < d / kVec; k += kThreads) {
      float v[kVec], s[kVec];
      load4(xr + k * kVec, v);
      load4(scale + k * kVec, s);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = v[j] / den * s[j];
      store4(outr + k * kVec, v);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      outr[i] = from_f32<X>(to_f32(xr[i]) / den * to_f32(scale[i]));
  }
}

template <typename X, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int d,
                   float eps, cudaStream_t stream) {
  const bool vector = d % kVec == 0 && aligned(x, kVec * sizeof(X)) &&
                      aligned(out, kVec * sizeof(X)) && aligned(scale, kVec * sizeof(S));
  const X* xp = static_cast<const X*>(x);
  const S* sp = static_cast<const S*>(scale);
  X* op = static_cast<X*>(out);
  const unsigned grid = static_cast<unsigned>(rows);
  if (vector)
    rmsnorm_kernel<X, S, true><<<grid, kThreads, 0, stream>>>(xp, sp, op, d, eps);
  else
    rmsnorm_kernel<X, S, false><<<grid, kThreads, 0, stream>>>(xp, sp, op, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  x_bf16 / s_bf16: 1 for bfloat16,
// 0 for float32; out has x's type.  rows in [1, 2^31 - 1], d >= 1.
int repro_rmsnorm(const void* x, int x_bf16, const void* scale, int s_bf16, void* out,
                  long long rows, int d, float eps, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (x_bf16 && s_bf16)
    err = launch<bf16, bf16>(x, scale, out, rows, d, eps, s);
  else if (x_bf16)
    err = launch<bf16, float>(x, scale, out, rows, d, eps, s);
  else if (s_bf16)
    err = launch<float, bf16>(x, scale, out, rows, d, eps, s);
  else
    err = launch<float, float>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(err);
}

}  // extern "C"
