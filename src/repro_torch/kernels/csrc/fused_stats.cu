// The norm test's reductions for Hopper (sm_90a): one kernel over a table
// of buckets (buckets.cuh), with two variants:
//
// * both sums, (sum((x-y)^2), sum(y^2)) in f32, reading each operand once —
//   the eq. 5 statistic pair ||g_j - g||^2 and ||g||^2 of FSDP-Norm.  It
//   replaces the TPU kernel `fused_stats` in src/repro/kernels/fused_stats.py
//   (its pl.pallas_call at line 44).  A training step runs it once over
//   every bucket of the layout (one launch per dtype group of x and y); the
//   one-bucket wrapper runs it over a table of one row;
// * sum((x-y)^2) alone: it replaces the TPU kernel `sqdiff_norm` in
//   src/repro/kernels/sqdiff_norm.py (its pl.pallas_call at line 36), one
//   tensor a launch.
//
// x and y are f32 or bf16 (each its own), of the same element count.
//
// Bound: memory.  Each element reads x and y (8 bytes at f32) against 3-5
// flops, so microllama-300m's 290 743 296 elements take at least 0.69 ms
// at 3.35 TB/s.  One launch per bucket left the card waiting on the host
// for nearly every bucket (buckets.cuh); the persistent grid over the table
// streams the whole layout in one launch, each thread loading all four of
// its vector groups of a tile (four loads of each operand) before using
// any.  Each block writes one partial per sum; the sum_partials pass adds
// them in a fixed order.

#include "buckets.cuh"

namespace {

template <typename X, typename Y, bool kYsq>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const Bucket* __restrict__ table, int rows, long long tiles,
             float* __restrict__ partials, int stride) {
  float dsq = 0.0f, ysq = 0.0f;
  int cur = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt at = tile_at(table, rows, t, cur);
    cur = at.row;
    const Bucket& b = table[cur];
    const X* x = reinterpret_cast<const X*>(b.ptr[0]) + at.start;
    const Y* y = reinterpret_cast<const Y*>(b.ptr[1]) + at.start;
    int tail = 0;
    if (b.aligned) {
      const int groups = at.len / kVec;
      float xf[kGroupsPerThread][kVec], yf[kGroupsPerThread][kVec];
#pragma unroll
      for (int u = 0; u < kGroupsPerThread; ++u) {
        const int i = (u * kThreads + threadIdx.x) * kVec;
        if (i < groups * kVec) {
          load4(x + i, xf[u]);
          load4(y + i, yf[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroupsPerThread; ++u) {
        const int i = (u * kThreads + threadIdx.x) * kVec;
        if (i < groups * kVec) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float d = xf[u][j] - yf[u][j];
            dsq += d * d;
            if (kYsq) ysq += yf[u][j] * yf[u][j];
          }
        }
      }
      tail = groups * kVec;
    }
    for (int i = tail + threadIdx.x; i < at.len; i += kThreads) {
      const float xf = to_f32(x[i]), yf = to_f32(y[i]);
      const float d = xf - yf;
      dsq += d * d;
      if (kYsq) ysq += yf * yf;
    }
  }
  dsq = block_sum(dsq);
  if (threadIdx.x == 0) partials[blockIdx.x] = dsq;
  if (kYsq) {
    ysq = block_sum(ysq);
    if (threadIdx.x == 0) partials[stride + blockIdx.x] = ysq;
  }
}

template <bool kYsq>
cudaError_t launch(const Bucket* table, int rows, long long tiles, int grid, int x_bf16,
                   int y_bf16, float* partials, int stride, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (x_bf16 && y_bf16)
    stats_kernel<bf16, bf16, kYsq><<<grid, kThreads, 0, s>>>(table, rows, tiles, partials, stride);
  else if (x_bf16)
    stats_kernel<bf16, float, kYsq><<<grid, kThreads, 0, s>>>(table, rows, tiles, partials, stride);
  else if (y_bf16)
    stats_kernel<float, bf16, kYsq><<<grid, kThreads, 0, s>>>(table, rows, tiles, partials, stride);
  else
    stats_kernel<float, float, kYsq><<<grid, kThreads, 0, s>>>(table, rows, tiles, partials, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over `rows` rows of a table (one dtype group: x_bf16 / y_bf16
// 1 for bfloat16, 0 for float32) that hold `tiles` tiles, on `grid` blocks.
// Returns a cudaError_t (0 on success).  Block b writes its partial of
// sum((x-y)^2) to partials[b] and, with ysq = 1, its partial of sum(y^2)
// to partials[stride + b].
int repro_fused_stats(const void* table, int rows, long long tiles, int grid, int x_bf16,
                      int y_bf16, int ysq, void* partials, int stride, void* stream) {
  if (rows < 1 || tiles < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Bucket* tb = static_cast<const Bucket*>(table);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      ysq ? launch<true>(tb, rows, tiles, grid, x_bf16, y_bf16, part, stride, s)
          : launch<false>(tb, rows, tiles, grid, x_bf16, y_bf16, part, stride, s);
  return static_cast<int>(err);
}

}  // extern "C"
