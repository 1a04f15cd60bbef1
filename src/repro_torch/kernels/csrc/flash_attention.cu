// Forward attention with an online softmax for Hopper (sm_90a):
//
//     out[b, i, h, :] = sum_j softmax_j(mask(cap(q_i . k_j / sqrt(d)))) v_j
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (its pl.pallas_call at line 123).
// q is (b, t, h, d); k and v are (b, s, kvh, d) with h % kvh == 0, all f32
// or all bf16, each with its own strides (the last dimension contiguous);
// out is a contiguous (b, t, h, d) of q's type; any head dim 1 <= d <= 128
// (the dense configs use 64 and openllama-3b's 100).  Every product and sum is
// f32.  The semantics are the TPU kernel's:
//   * causal masks are aligned top-left: key j is visible to query i when
//     j <= i, both counted from 0, whatever t and s are;
//   * `window` > 0 also hides keys j <= i - window; `softcap` > 0 maps a
//     logit x to softcap * tanh(x / softcap) before masking;
//   * GQA: q head hh reads kv head hh / (h / kvh) (`kv_map`, the
//     repeat_interleave order);
//   * masked logits are the finite -2e38, not -inf.  A visited tile whose
//     keys are all masked for a row adds exp(0) = 1 per key to that row's
//     denominator; the correction exp(-2e38 - m) = 0 wipes it exactly once
//     a visible key arrives — the TPU kernel's order of operations, kept;
//   * whole kv tiles beyond the causal diagonal or before the window are
//     skipped, as the TPU kernel's `run` predicate skips blocks.
// A row that sees no key at all (possible only with a window and t > s, or
// a window without causality) gets the plain version's answer: uniform
// weights over all s keys, i.e. the mean of v.  (The TPU kernel's answer
// there depends on its block size.)
//
// Bound: f32 operations.  The two products take 4*b*h*t*s*d flops (half of
// it with a causal mask) against (q + k + v + out) bytes once; at d = 64 and
// t = s = 2048 that is ~1000 flops a byte, far above the card's ~20 f32
// flops per byte.  The design, simple and exact first (no tensor cores,
// TMA or wgmma yet):
//   * one block of 256 threads per (b*h, 64-row q tile), the q tiles with
//     the most causal work scheduled first;
//   * the q tile and one 64-key K and V tile at a time staged in shared
//     memory as f32, the head dim zero-filled up to DP, the next multiple
//     of 16 (the zeros add exact zeros to both products), rows padded by
//     4 more floats against bank conflicts;
//   * thread (r, c), r = tid / 4, c = tid % 4, owns query row r: the 16
//     logits of keys c, c+4, ..., c+60 and the output columns
//     4c + 16j .. 4c + 16j + 3 (those < d are stored); the running max,
//     denominator and the
//     accumulator live in registers, the row max and sum are reduced over
//     the 4 threads of a row with shuffles;
//   * explicit fmaf for both products (the library is built with
//     -fmad=false for the optimizers' sake);
//   * the t and s tails are masked in the tile loads and the logits; no
//     padding, no copy.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // q rows a block
constexpr int kBK = 64;          // keys a tile
constexpr int kFT = 256;         // threads a block: 4 per q row
constexpr int kPad = 4;          // floats of padding per shared row
constexpr float kNegInf = -2.0e38f;

constexpr int kMaxD = 128;       // largest head dim

template <int DP>
constexpr int smem_bytes() {
  return (3 * kBQ * (DP + kPad) + kBQ * (kBK + kPad)) * static_cast<int>(sizeof(float));
}

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int t, s, h, kvh, d;
  long long q_sb, q_st, q_sh;    // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale, softcap;
  int causal, window;
};

// rows [first, first + 64) of src into dst (row stride DP + kPad): the
// columns past d and the rows past `limit` as zeros
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int first, int limit, int d) {
  for (int idx = threadIdx.x; idx < kBK * DP; idx += kFT) {
    const int row = idx / DP, col = idx - row * DP;
    const int g = first + row;
    dst[row * (DP + kPad) + col] =
        g < limit && col < d ? to_f32(src[static_cast<long long>(g) * row_stride + col])
                             : 0.0f;
  }
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kFT)
flash_kernel(Args a) {
  static_assert(DP % 16 == 0 && DP <= kMaxD, "DP: a multiple of 16, at most 128");
  constexpr int LD = DP + kPad;         // shared row stride of Q, K, V
  constexpr int LP = kBK + kPad;        // shared row stride of P
  constexpr int NO = DP / 16;           // float4 output groups a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int q_tile = gridDim.x - 1 - blockIdx.x;     // most causal work first
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hh = bh - bi * a.h;
  const int kv_head = hh / (a.h / a.kvh);
  const int q0 = q_tile * kBQ;
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int qpos = q0 + r;

  const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + hh * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + kv_head * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + bi * a.v_sb + kv_head * a.v_sh;

  load_tile<DP>(Qs, q, a.q_st, q0, a.t, a.d);

  float m = kNegInf, l = 0.0f;
  float acc[4 * NO];
#pragma unroll
  for (int i = 0; i < 4 * NO; ++i) acc[i] = 0.0f;

  const int n_tiles = (a.s + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    // the TPU kernel's block predicate: any (i, j) of the tile pair visible?
    if (a.causal && k0 > q0 + kBQ - 1) break;
    if (a.window > 0 && k0 + kBK - 1 <= q0 - a.window) continue;

    __syncthreads();                      // the previous tile is consumed
    load_tile<DP>(Ks, k, a.k_ss, k0, a.s, a.d);
    load_tile<DP>(Vs, v, a.v_ss, k0, a.s, a.d);
    __syncthreads();

    float sc[16];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) sc[jj] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < DP; kk += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + kk);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (c + 4 * jj) * LD + kk);
        float x = sc[jj];
        x = fmaf(qv.x, kv.x, x);
        x = fmaf(qv.y, kv.y, x);
        x = fmaf(qv.z, kv.z, x);
        x = fmaf(qv.w, kv.w, x);
        sc[jj] = x;
      }
    }

    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int kpos = k0 + c + 4 * jj;
      float x = sc[jj] * a.scale;
      if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
      bool ok = kpos < a.s;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      sc[jj] = ok ? x : kNegInf;
      mx = fmaxf(mx, sc[jj]);
    }
    const float m_new = fmaxf(m, row_max4(mx));
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float p = expf(sc[jj] - m_new);
      psum += p;
      Ps[r * LP + c + 4 * jj] = p;
    }
    const float corr = expf(m - m_new);
    l = corr * l + row_sum4(psum);
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) acc[i] *= corr;
    __syncthreads();                      // the whole P tile is written

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + r * LP + kk);
      const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * LD + 4 * c;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 16 * j);
          acc[4 * j + 0] = fmaf(p4[u], vv.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(p4[u], vv.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(p4[u], vv.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(p4[u], vv.w, acc[4 * j + 3]);
        }
      }
    }
  }

  // Rows that saw no key: the mean of v over all s keys (see the header).
  const bool dead = m == kNegInf && qpos < a.t;
  if (__syncthreads_or(dead)) {
    if (dead) {
#pragma unroll
      for (int i = 0; i < 4 * NO; ++i) acc[i] = 0.0f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kBK;
      __syncthreads();
      load_tile<DP>(Vs, v, a.v_ss, k0, a.s, a.d);
      __syncthreads();
      if (dead) {
        for (int j = 0; j < kBK && k0 + j < a.s; ++j) {
#pragma unroll
          for (int g = 0; g < NO; ++g) {
            const float4 vv = *reinterpret_cast<const float4*>(Vs + j * LD + 4 * c + 16 * g);
            acc[4 * g + 0] += vv.x;
            acc[4 * g + 1] += vv.y;
            acc[4 * g + 2] += vv.z;
            acc[4 * g + 3] += vv.w;
          }
        }
      }
    }
    if (dead) l = static_cast<float>(a.s);
  }

  if (qpos < a.t) {
    const float inv_l = l == 0.0f ? 1.0f : l;   // the TPU kernel's l == 0 guard
    T* o = static_cast<T*>(a.out) +
           ((static_cast<long long>(bi) * a.t + qpos) * a.h + hh) * a.d;
#pragma unroll
    for (int g = 0; g < NO; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * c + 16 * g + e;
        if (col < a.d) o[col] = from_f32<T>(acc[4 * g + e] / inv_l);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t + kBQ - 1) / kBQ, b * a.h);
  flash_kernel<T, DP><<<grid, kFT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// the head dim padded to the next multiple of 16
template <typename T>
cudaError_t launch_d(const Args& a, int b, cudaStream_t stream) {
  switch ((a.d + 15) / 16) {
    case 1: return launch<T, 16>(a, b, stream);
    case 2: return launch<T, 32>(a, b, stream);
    case 3: return launch<T, 48>(a, b, stream);
    case 4: return launch<T, 64>(a, b, stream);
    case 5: return launch<T, 80>(a, b, stream);
    case 6: return launch<T, 96>(a, b, stream);
    case 7: return launch<T, 112>(a, b, stream);
    case 8: return launch<T, 128>(a, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  bf16: 1 when q, k, v and out are
// bfloat16, 0 for float32.  strides: the (b, t|s, head) strides in elements
// of q, k and v, nine values; the last dimension of each is contiguous.
// 1 <= d <= 128; b * h <= 65535; t, s >= 1.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int bf16,
                          int b, int t, int s, int h, int kvh, int d,
                          const long long* strides, float scale, float softcap,
                          int causal, int window, void* stream) {
  if (b < 1 || t < 1 || s < 1 || kvh < 1 || h % kvh != 0 || b * h > 65535 || d < 1 ||
      d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, t, s, h, kvh, d,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_d<__nv_bfloat16>(a, b, st)
                               : launch_d<float>(a, b, st);
  return static_cast<int>(err);
}

}  // extern "C"
