// Fused AdamW for Hopper (sm_90a), two entry points sharing one element
// loop:
//
// * repro_fused_adamw_stats replaces the TPU kernel `fused_adamw_stats` in
//   src/repro/kernels/fused_adamw.py (its pl.pallas_call at line 127): the
//   flat-buffer update with the global-norm clip folded in and the pre-clip
//   sum of squared gradients as a byproduct;
// * repro_fused_adamw replaces the TPU kernel `fused_adamw` in the same
//   file (its pl.pallas_call at line 91): the same update on one tensor,
//   with no clip and no byproduct.
//
// Per element, with g = g_raw * clip (clip = 1 in fused_adamw):
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = (1 - lr*wd)*p - lr*(m'/c1) / (sqrt(v'/c2) + eps)
// and, in fused_adamw_stats, sum(g_raw^2) in f32 over the whole buffer.  p
// is f32 or bf16 (its dtype is kept), g is f32 or bf16, m and v are f32;
// p, m and v are updated in place.  lr, c1, c2 and clip are read from a
// 4-float device array, so a launch needs no host synchronisation and can
// be captured in a graph.
//
// Bound: memory.  Each element reads p, g, m, v and writes p, m, v: 28 bytes
// at f32, against ~20 flops.  The design only has to stream those bytes:
//   * a 1-D grid; block b walks one contiguous chunk of the buffer with
//     16-byte vector loads (4 elements a thread) when the pointers allow,
//     and a masked scalar loop for the ragged tail (no padded copy, unlike
//     the TPU wrapper's pad_to_blocks);
//   * fused_adamw_stats: each block writes one f32 partial of sum(g_raw^2)
//     to partials[b]; a second single-block launch adds the partials in a
//     fixed order.  No float atomics: the result is the same on every run,
//     which bit-exact resume depends on.
// Build with -fmad=false so each expression rounds where the op-by-op plain
// version does (the kernel then agrees with it to the last bit, except for
// the order of the sum).

#include "common.cuh"

namespace {

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_one(float& p, float g, float& m, float& v,
                                          float lr, float c1, float c2,
                                          const Hyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  const float mhat = m / c1;
  const float vhat = v / c2;
  p = (1.0f - lr * h.wd) * p - lr * mhat / (sqrtf(vhat) + h.eps);
}

// kStats: fold the clip scale into g and write this block's partial of
// sum(g_raw^2); otherwise the plain per-tensor update.
template <typename P, typename G, bool kVector, bool kStats>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
             float* __restrict__ v, const float* __restrict__ scalars,
             float* __restrict__ partials, long long n, long long chunk, Hyper h) {
  const float lr = scalars[0], c1 = scalars[1], c2 = scalars[2];
  const float clip = kStats ? scalars[3] : 1.0f;
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
        if (kStats) acc += gf[j] * gf[j];
        adamw_one(pf[j], kStats ? gf[j] * clip : gf[j], mf[j], vf[j], lr, c1, c2, h);
      }
      store4(p + i, pf);
      store4(m + i, mf);
      store4(v + i, vf);
    }
    tail = start + groups * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pf = to_f32(p[i]), gf = to_f32(g[i]), mf = m[i], vf = v[i];
    if (kStats) acc += gf * gf;
    adamw_one(pf, kStats ? gf * clip : gf, mf, vf, lr, c1, c2, h);
    p[i] = from_f32<P>(pf);
    m[i] = mf;
    v[i] = vf;
  }
  if (kStats) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  }
}

template <typename P, typename G, bool kStats>
cudaError_t launch(void* p, const void* g, float* m, float* v, const float* scalars,
                   float* partials, float* gsq, long long n, int grid, const Hyper& h,
                   cudaStream_t stream) {
  const long long chunk = chunk_for(n, grid);
  const bool vec = aligned(p, kVec * sizeof(P)) && aligned(g, kVec * sizeof(G)) &&
                   aligned(m, 16) && aligned(v, 16);
  if (vec) {
    adamw_kernel<P, G, true, kStats><<<grid, kThreads, 0, stream>>>(
        static_cast<P*>(p), static_cast<const G*>(g), m, v, scalars, partials, n, chunk, h);
  } else {
    adamw_kernel<P, G, false, kStats><<<grid, kThreads, 0, stream>>>(
        static_cast<P*>(p), static_cast<const G*>(g), m, v, scalars, partials, n, chunk, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !kStats) return err;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, grid, gsq);
  return cudaGetLastError();
}

template <bool kStats>
int launch_any(void* p, int p_bf16, const void* g, int g_bf16, void* m, void* v,
               const void* scalars, void* partials, void* gsq, long long n, int grid,
               const Hyper& h, void* stream) {
  if (grid < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scalars);
  float* part = static_cast<float*>(partials);
  float* out = static_cast<float*>(gsq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (p_bf16 && g_bf16)
    err = launch<bf16, bf16, kStats>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  else if (p_bf16)
    err = launch<bf16, float, kStats>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  else if (g_bf16)
    err = launch<float, bf16, kStats>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  else
    err = launch<float, float, kStats>(p, g, mf, vf, sc, part, out, n, grid, h, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success).  p_bf16 / g_bf16: 1 for
// bfloat16, 0 for float32.

// `partials` holds `grid` floats; `gsq` one float.
int repro_fused_adamw_stats(void* p, int p_bf16, const void* g, int g_bf16, void* m,
                            void* v, const void* scalars, void* partials, void* gsq,
                            long long n, int grid, float beta1, float one_minus_beta1,
                            float beta2, float one_minus_beta2, float eps,
                            float weight_decay, void* stream) {
  const Hyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay};
  return launch_any<true>(p, p_bf16, g, g_bf16, m, v, scalars, partials, gsq, n, grid,
                          h, stream);
}

// scalars[3] (the clip scale) is not read.
int repro_fused_adamw(void* p, int p_bf16, const void* g, int g_bf16, void* m, void* v,
                      const void* scalars, long long n, int grid, float beta1,
                      float one_minus_beta1, float beta2, float one_minus_beta2,
                      float eps, float weight_decay, void* stream) {
  const Hyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay};
  return launch_any<false>(p, p_bf16, g, g_bf16, m, v, scalars, nullptr, nullptr, n,
                           grid, h, stream);
}

}  // extern "C"
