// Fused flat-buffer AdamW with the pre-clip sum of squared gradients as a
// byproduct, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_adamw_stats` in
// src/repro/kernels/fused_adamw.py (its pl.pallas_call at line 127).
// Per element, with g = g_raw * clip:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = (1 - lr*wd)*p - lr*(m'/c1) / (sqrt(v'/c2) + eps)
// and, over the whole buffer, sum(g_raw^2) in f32.  p is f32 or bf16 (its
// dtype is kept), g is f32 or bf16, m and v are f32; p, m and v are updated
// in place.  lr, c1, c2 and clip are read from a 4-float device array, so a
// launch needs no host synchronisation and can be captured in a graph.
//
// Bound: memory.  Each element reads p, g, m, v and writes p, m, v: 28 bytes
// at f32, against ~20 flops.  The design only has to stream those bytes:
//   * a 1-D grid; block b walks one contiguous chunk of the buffer with
//     16-byte vector loads (4 elements a thread) when the pointers allow,
//     and a masked scalar loop for the ragged tail (no padded copy, unlike
//     the TPU wrapper's pad_to_blocks);
//   * each block writes one f32 partial of sum(g_raw^2) to partials[b]; a
//     second single-block launch adds the partials in a fixed order.  No
//     float atomics: the result is the same on every run, which bit-exact
//     resume depends on.
// Build with -fmad=false so each expression rounds where the op-by-op plain
// version does (the kernel then agrees with it to the last bit, except for
// the order of the sum).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

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

__device__ __forceinline__ void adamw_one(float& p, float g_raw, float& m, float& v,
                                          float lr, float c1, float c2, float clip,
                                          const Hyper& h) {
  const float g = g_raw * clip;
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  const float mhat = m / c1;
  const float vhat = v / c2;
  p = (1.0f - lr * h.wd) * p - lr * mhat / (sqrtf(vhat) + h.eps);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// Sum over the block in a fixed order; thread 0 gets the result.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
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

template <typename P, typename G, bool kVector>
__global__ void __launch_bounds__(kThreads)
adamw_stats_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                   float* __restrict__ v, const float* __restrict__ scalars,
                   float* __restrict__ partials, long long n, long long chunk, Hyper h) {
  const float lr = scalars[0], c1 = scalars[1], c2 = scalars[2], clip = scalars[3];
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = start + chunk < n ? start + chunk : n;
  float acc = 0.0f;
  long long tail = start;
  if (kVector && end > start) {
    // chunk is a multiple of kVec and the bases are aligned, so every
    // group below starts on a 16-byte boundary of m and v
    const long long groups = (end - start) / kVec;
    for (long long k = threadIdx.x; k < groups; k += kThreads) {
      const long long i = start + k * kVec;
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load4(p + i, pf);
      load4(g + i, gf);
      load4(m + i, mf);
      load4(v + i, vf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        acc += gf[j] * gf[j];
        adamw_one(pf[j], gf[j], mf[j], vf[j], lr, c1, c2, clip, h);
      }
      store4(p + i, pf);
      store4(m + i, mf);
      store4(v + i, vf);
    }
    tail = start + groups * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pf = to_f32(p[i]), gf = to_f32(g[i]), mf = m[i], vf = v[i];
    acc += gf * gf;
    adamw_one(pf, gf, mf, vf, lr, c1, c2, clip, h);
    p[i] = from_f32<P>(pf);
    m[i] = mf;
    v[i] = vf;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int count, float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename P, typename G>
cudaError_t launch(void* p, const void* g, float* m, float* v, const float* scalars,
                   float* partials, float* gsq, long long n, int grid, const Hyper& h,
                   cudaStream_t stream) {
  long long chunk = (n + grid - 1) / grid;
  chunk = (chunk + kVec - 1) / kVec * kVec;
  const bool vec = aligned(p, kVec * sizeof(P)) && aligned(g, kVec * sizeof(G)) &&
                   aligned(m, 16) && aligned(v, 16);
  if (vec) {
    adamw_stats_kernel<P, G, true><<<grid, kThreads, 0, stream>>>(
        static_cast<P*>(p), static_cast<const G*>(g), m, v, scalars, partials, n, chunk, h);
  } else {
    adamw_stats_kernel<P, G, false><<<grid, kThreads, 0, stream>>>(
        static_cast<P*>(p), static_cast<const G*>(g), m, v, scalars, partials, n, chunk, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, grid, gsq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `partials` holds `grid` floats;
// `gsq` one float.  p_bf16 / g_bf16: 1 for bfloat16, 0 for float32.
int repro_fused_adamw_stats(void* p, int p_bf16, const void* g, int g_bf16, void* m,
                            void* v, const void* scalars, void* partials, void* gsq,
                            long long n, int grid, float beta1, float one_minus_beta1,
                            float beta2, float one_minus_beta2, float eps,
                            float weight_decay, void* stream) {
  if (grid < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay};
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scalars);
  float* part = static_cast<float*>(partials);
  float* out = static_cast<float*>(gsq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p_bf16 && g_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  else if (p_bf16)
    err = launch<__nv_bfloat16, float>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  else if (g_bf16)
    err = launch<float, __nv_bfloat16>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  else
    err = launch<float, float>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
