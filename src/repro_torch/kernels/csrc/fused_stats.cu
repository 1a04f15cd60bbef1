// The norm test's reductions for Hopper (sm_90a), two entry points sharing
// one streaming loop:
//
// * repro_fused_stats replaces the TPU kernel `fused_stats` in
//   src/repro/kernels/fused_stats.py (its pl.pallas_call at line 44):
//   (sum((x-y)^2), sum(y^2)) in f32, reading each operand once — the
//   eq. 5 statistic pair ||g_j - g||^2 and ||g||^2 of FSDP-Norm;
// * repro_sqdiff_norm replaces the TPU kernel `sqdiff_norm` in
//   src/repro/kernels/sqdiff_norm.py (its pl.pallas_call at line 36):
//   sum((x-y)^2) alone.
//
// x and y are f32 or bf16 (each its own), of the same element count.
//
// Bound: memory.  Each element reads x and y (8 bytes at f32) against 3-5
// flops.  The design streams those bytes once:
//   * a 1-D grid; block b walks one contiguous chunk with 16-byte vector
//     loads (4 elements a thread) when both pointers allow, and a masked
//     scalar loop for the ragged tail — no padded copy, unlike the TPU
//     wrappers' pad_to_blocks;
//   * each block writes one f32 partial per sum; a second launch adds the
//     partials in a fixed order.  No float atomics: the statistic, and with
//     it the batch size every rank proposes, is the same on every run.

#include "common.cuh"

namespace {

template <typename X, typename Y, bool kVector, bool kYsq>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const X* __restrict__ x, const Y* __restrict__ y,
             float* __restrict__ partials, long long n, long long chunk) {
  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = start + chunk < n ? start + chunk : n;
  float dsq = 0.0f, ysq = 0.0f;
  long long tail = start;
  if (kVector && end > start) {
    const long long groups = (end - start) / kVec;
    for (long long k = threadIdx.x; k < groups; k += kThreads) {
      const long long i = start + k * kVec;
      float xf[kVec], yf[kVec];
      load4(x + i, xf);
      load4(y + i, yf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = xf[j] - yf[j];
        dsq += d * d;
        if (kYsq) ysq += yf[j] * yf[j];
      }
    }
    tail = start + groups * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    const float xf = to_f32(x[i]), yf = to_f32(y[i]);
    const float d = xf - yf;
    dsq += d * d;
    if (kYsq) ysq += yf * yf;
  }
  dsq = block_sum(dsq);
  if (threadIdx.x == 0) partials[blockIdx.x] = dsq;
  if (kYsq) {
    ysq = block_sum(ysq);
    if (threadIdx.x == 0) partials[gridDim.x + blockIdx.x] = ysq;
  }
}

template <typename X, typename Y, bool kYsq>
cudaError_t launch(const void* x, const void* y, float* partials, float* out, long long n,
                   int grid, cudaStream_t stream) {
  const long long chunk = chunk_for(n, grid);
  const X* xp = static_cast<const X*>(x);
  const Y* yp = static_cast<const Y*>(y);
  if (aligned(x, kVec * sizeof(X)) && aligned(y, kVec * sizeof(Y)))
    stats_kernel<X, Y, true, kYsq><<<grid, kThreads, 0, stream>>>(xp, yp, partials, n, chunk);
  else
    stats_kernel<X, Y, false, kYsq><<<grid, kThreads, 0, stream>>>(xp, yp, partials, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<kYsq ? 2 : 1, kThreads, 0, stream>>>(partials, grid, out);
  return cudaGetLastError();
}

template <bool kYsq>
int launch_any(const void* x, int x_bf16, const void* y, int y_bf16, void* partials,
               void* out, long long n, int grid, void* stream) {
  if (grid < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (x_bf16 && y_bf16)
    err = launch<bf16, bf16, kYsq>(x, y, part, o, n, grid, s);
  else if (x_bf16)
    err = launch<bf16, float, kYsq>(x, y, part, o, n, grid, s);
  else if (y_bf16)
    err = launch<float, bf16, kYsq>(x, y, part, o, n, grid, s);
  else
    err = launch<float, float, kYsq>(x, y, part, o, n, grid, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success).  x_bf16 / y_bf16: 1 for
// bfloat16, 0 for float32.

// `partials` holds 2*grid floats; `out` two: sum((x-y)^2), sum(y^2).
int repro_fused_stats(const void* x, int x_bf16, const void* y, int y_bf16,
                      void* partials, void* out, long long n, int grid, void* stream) {
  return launch_any<true>(x, x_bf16, y, y_bf16, partials, out, n, grid, stream);
}

// `partials` holds grid floats; `out` one: sum((x-y)^2).
int repro_sqdiff_norm(const void* x, int x_bf16, const void* y, int y_bf16,
                      void* partials, void* out, long long n, int grid, void* stream) {
  return launch_any<false>(x, x_bf16, y, y_bf16, partials, out, n, grid, stream);
}

}  // extern "C"
