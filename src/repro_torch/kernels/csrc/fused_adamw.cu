// Fused AdamW for Hopper (sm_90a): one kernel over a table of buckets
// (buckets.cuh), with two variants:
//
// * with the statistic, it replaces the TPU kernel `fused_adamw_stats` in
//   src/repro/kernels/fused_adamw.py (its pl.pallas_call at line 127): the
//   flat-buffer update with the global-norm clip folded in and the pre-clip
//   sum of squared gradients as a byproduct.  A training step runs it once
//   over every bucket of the layout (one launch per dtype group of p and g);
//   the one-bucket wrapper runs it over a table of one row;
// * without, it replaces the TPU kernel `fused_adamw` in the same file (its
//   pl.pallas_call at line 91): the same update on one tensor, with no clip
//   and no byproduct.
//
// Per element, with g = g_raw * clip (clip = 1 in fused_adamw):
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   p' = (1 - lr*wd)*p - lr*(m'/c1) / (sqrt(v'/c2) + eps)
// and, with the statistic, sum(g_raw^2) in f32 over every bucket.  p is
// f32 or bf16 (its dtype is kept), g is f32 or bf16, m and v are f32; p, m
// and v are updated in place.  lr, c1, c2 and clip are read once from a
// 4-float device array, so a launch needs no host synchronisation.
//
// Bound: memory.  Each element reads p, g, m, v and writes p, m, v: 28 bytes
// at f32, against ~20 flops, so microllama-300m's 290 743 296 elements take
// at least 2.43 ms at 3.35 TB/s.  One launch per bucket left the card
// waiting on the host for most of the 98 buckets (buckets.cuh); the
// persistent grid over the table streams the whole layout in one launch,
// two vector groups of each operand loaded before either is used.
// Built with -fmad=false so each expression rounds where the op-by-op
// plain version does: p, m and v agree with it to the last bit; only the
// order of the sum differs.

#include "buckets.cuh"

namespace {

constexpr int kUnroll = 2;     // vector groups of each operand in flight a thread
static_assert(kGroupsPerThread % kUnroll == 0, "whole rounds a tile");

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
// sum(g_raw^2) to partials[blockIdx.x]; otherwise the plain update.
template <typename P, typename G, bool kStats>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const Bucket* __restrict__ table, int rows, long long tiles,
             const float* __restrict__ scalars, float* __restrict__ partials, Hyper h) {
  const float lr = scalars[0], c1 = scalars[1], c2 = scalars[2];
  const float clip = kStats ? scalars[3] : 1.0f;
  float acc = 0.0f;
  int cur = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt at = tile_at(table, rows, t, cur);
    cur = at.row;
    const Bucket& b = table[cur];
    P* p = reinterpret_cast<P*>(b.ptr[0]) + at.start;
    const G* g = reinterpret_cast<const G*>(b.ptr[1]) + at.start;
    float* m = reinterpret_cast<float*>(b.ptr[2]) + at.start;
    float* v = reinterpret_cast<float*>(b.ptr[3]) + at.start;
    int tail = 0;
    if (b.aligned) {
      const int groups = at.len / kVec;
#pragma unroll
      for (int k0 = 0; k0 < kGroupsPerThread; k0 += kUnroll) {
        float pf[kUnroll][kVec], gf[kUnroll][kVec], mf[kUnroll][kVec], vf[kUnroll][kVec];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = ((k0 + u) * kThreads + threadIdx.x) * kVec;
          if (i < groups * kVec) {
            load4(p + i, pf[u]);
            load4(g + i, gf[u]);
            load4(m + i, mf[u]);
            load4(v + i, vf[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = ((k0 + u) * kThreads + threadIdx.x) * kVec;
          if (i < groups * kVec) {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              if (kStats) acc += gf[u][j] * gf[u][j];
              adamw_one(pf[u][j], kStats ? gf[u][j] * clip : gf[u][j], mf[u][j], vf[u][j],
                        lr, c1, c2, h);
            }
            store4(p + i, pf[u]);
            store4(m + i, mf[u]);
            store4(v + i, vf[u]);
          }
        }
      }
      tail = groups * kVec;
    }
    for (int i = tail + threadIdx.x; i < at.len; i += kThreads) {
      float pf = to_f32(p[i]), gf = to_f32(g[i]), mf = m[i], vf = v[i];
      if (kStats) acc += gf * gf;
      adamw_one(pf, kStats ? gf * clip : gf, mf, vf, lr, c1, c2, h);
      p[i] = from_f32<P>(pf);
      m[i] = mf;
      v[i] = vf;
    }
  }
  if (kStats) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  }
}

template <bool kStats>
int launch_any(const void* table, int rows, long long tiles, int grid, int p_bf16,
               int g_bf16, const void* scalars, void* partials, const Hyper& h,
               void* stream) {
  if (rows < 1 || tiles < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Bucket* tb = static_cast<const Bucket*>(table);
  const float* sc = static_cast<const float*>(scalars);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (p_bf16 && g_bf16)
    adamw_kernel<bf16, bf16, kStats><<<grid, kThreads, 0, s>>>(tb, rows, tiles, sc, part, h);
  else if (p_bf16)
    adamw_kernel<bf16, float, kStats><<<grid, kThreads, 0, s>>>(tb, rows, tiles, sc, part, h);
  else if (g_bf16)
    adamw_kernel<float, bf16, kStats><<<grid, kThreads, 0, s>>>(tb, rows, tiles, sc, part, h);
  else
    adamw_kernel<float, float, kStats><<<grid, kThreads, 0, s>>>(tb, rows, tiles, sc, part, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch over `rows` rows of a table (one dtype group: p_bf16 / g_bf16
// 1 for bfloat16, 0 for float32; m and v float32) that hold `tiles` tiles,
// on `grid` blocks.  Returns a cudaError_t (0 on success).  With stats = 1,
// `partials` gets `grid` floats (the sum_partials pass adds them) and
// scalars[3] is the clip scale; with stats = 0 neither is touched.
int repro_fused_adamw(const void* table, int rows, long long tiles, int grid, int p_bf16,
                      int g_bf16, int stats, const void* scalars, void* partials,
                      float beta1, float one_minus_beta1, float beta2,
                      float one_minus_beta2, float eps, float weight_decay,
                      void* stream) {
  const Hyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay};
  return stats ? launch_any<true>(table, rows, tiles, grid, p_bf16, g_bf16, scalars,
                                  partials, h, stream)
               : launch_any<false>(table, rows, tiles, grid, p_bf16, g_bf16, scalars,
                                   partials, h, stream);
}

}  // extern "C"
