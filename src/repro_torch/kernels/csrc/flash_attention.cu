// Forward attention with an online softmax on Hopper's tensor cores (sm_90a):
//
//     out[b, i, h, :] = sum_j softmax_j(mask(cap(q_i . k_j / sqrt(d)))) v_j
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py:88 (its pl.pallas_call at line 123,
// body `_kernel` at line 32).  q is (b, t, h, d); k and v are (b, s, kvh, d)
// with h % kvh == 0, all f32 or all bf16, each with its own strides (the
// last dimension contiguous); out is a contiguous (b, t, h, d) of q's type;
// any head dim 1 <= d <= 256 (the dense configs use 64, openllama-3b 100,
// recurrentgemma-9b 256).  The semantics are the TPU kernel's:
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
// Bounds (prefill: b 4, t = s = 2048, 32 q / 8 kv heads, d 64, causal, f32):
// the two products take 4*b*h*d*t(t+1)/2 = 68.7 GFLOP against 8.4 MB of q,
// k, v and out, ~8000 flops a byte, so operations bound it: 1.03 ms at the
// 67 TFLOP/s of f32 on CUDA cores, 0.42 ms for three TF32 products at the
// 495 TFLOP/s of dense TF32 on the tensor cores.
//
// f32: split TF32 ("3xTF32") on wgmma.  Plain TF32 keeps 10 mantissa bits
// (~5e-4 relative per operand), which cannot hold the 2e-5 that f32
// outputs are held to.  Each operand is split as x = hi + lo, hi = x
// rounded to TF32, lo = x - hi rounded again, and each product is lo*hi +
// hi*lo + hi*hi with f32 accumulation (the dropped lo*lo and the rounding
// of lo leave ~2^-22 relative a product, f32's order).
//   * Accumulation: wgmma adds each k8 step into its f32 accumulator, and
//     those additions lose more than round-to-nearest: an O accumulated by
//     wgmma across every tile of gemma2-27b's global layer (t 8192, q
//     scaled to |logit| 50) erred 9.2e-5 against f64, the plain f32
//     version 2.5e-5 (chip_smoke.py; H100 80GB HBM3 at 700 W).  So
//     each tile's P.V lands in a fresh accumulator OT, which the CUDA cores
//     add to O (rounded to nearest) before the rescale; and within both
//     products the small terms (lo*hi, hi*lo) go first, while the sum is
//     small, and hi*hi last.  The kernel then errs less than the plain f32
//     version against f64 (chip_smoke.py's `archs` shapes; the card test's
//     large logits).
//   * A block is one or two warpgroups of 64 q rows (BQ 128 up to d 64, else
//     64) of one (batch, head); it walks the 64-key tiles (32 past d 80, 16
//     at some d past 176) its rows can see, the q tiles with the most causal
//     work first.
//   * Head dims past 128 (DP 144-256): O's 128 f32 accumulators a thread at
//     n256, twice over with the fresh tile accumulator, do not fit in 255
//     registers, nor do Q, K and V at DP 256 fit in shared memory with
//     64-key tiles.  So O's columns are cut in two halves of DO = DP/2
//     (rounded up to 16) columns, each computed by its own block
//     (gridDim.z): both blocks compute the whole S = Q K^T and the same P,
//     and each multiplies P by its half of V.  Registers stay those of
//     d 128; S costs twice its work (the products' operations grow by half
//     at t = s); shared memory holds Q and K at the full DP and V at DO.
//     The accumulation order within a product is the same at every d, but
//     S sums twice as many terms: accumulated by wgmma across all of them,
//     it erred 2.8e-5 against f64 at d 256 and |logit| 50 in the CPU
//     emulation (tests/test_torch_flash_split.py), the plain f32 version
//     3.7e-5.  So past d 128 S is computed in chunks of 32 columns of d
//     (16 where DP is an odd multiple of 16),
//     each in a fresh accumulator (two, alternating, so that chunk c+1 runs
//     while chunk c is added), and the chunks are summed on the CUDA cores
//     with a compensated addition (two-sum) and rounded once: 7e-6 in the
//     emulation.  P(kt-1) V(kt-1) is issued ahead of the chunks there.
//   * Q, K and V^T sit in shared memory in the layout wgmma reads without a
//     swizzle: core matrices of 8 rows x 16 bytes, K-major (the summed
//     dimension contiguous).  Q and K land in it straight from cp.async.
//     TF32 wgmma takes B only K-major, so V, which lands row by row, is
//     transposed by the split pass.  Q is split once a block; K and V once a
//     tile, by the whole block, into hi and lo planes (not once a warp).
//   * The S -> P layout: the accumulator of S holds keys 2c, 2c+1 of each
//     8-key group (c = lane % 4), while P as the register A operand of the
//     next product must sit at columns c and c+4.  The split pass writes V^T
//     with its keys relabelled (column c of each group is key 2c, column c+4
//     key 2c+1), so P is used where it lies; the sum over keys does not care
//     about their order.
//   * Software pipeline: S(k) = Q K(k)^T is issued, then P(k-1) V(k-1) behind
//     it; the softmax of S(k) runs while P(k-1) V(k-1) is on the tensor
//     cores.  The softmax statistics (m, l), the rescaling and O stay f32 in
//     registers.
// bf16: mma.sync (m16n8k16, f32 accumulation), a warp per 16 q rows, 64 q
// rows and 64-key tiles a block.  P is rounded to bf16 for P.V, as
// FlashAttention does (the denominator sums the f32 P).  For m16n8k16 the
// accumulator of two neighbouring 8-key groups already is the A layout; V's
// fragments come from ldmatrix.trans.  S and P stay in registers.  Past
// d 128 O is cut in two halves, one a block, as in f32.
//
// K/V ring (both): two stages of K and V tiles in shared memory filled with
// cp.async, so tile k+1 lands while tile k is multiplied.  The copy width is
// decided per launch from the pointers and strides: 16 bytes when every row
// starts on 16 bytes, else 4; bf16 rows that start on an odd element are
// copied by plain loads.  Rows past t or s and columns past d land as zeros
// (cp.async's zero fill), so the tails are masked, not padded, and the head
// dim runs to DP, the next multiple of 16, with exact zeros in both
// products.  Masks are applied only on tiles that cross the diagonal, the
// window edge or the end of s.

#include "wgmma.cuh"

namespace {

constexpr int kMaxD = 256;              // largest head dim
constexpr int kSmemMax = 232448;        // shared memory a block may have (227 KB)
constexpr float kNegInf = -2.0e38f;

// O's columns a block computes at padded head dim dp: all of them up to
// 128; past that half of them, rounded up to 16, the halves in two blocks
__host__ __device__ constexpr int out_cols(int dp) {
  return dp <= 128 ? dp : (dp + 31) / 32 * 16;
}

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int t, s, h, kvh, d;
  long long q_sb, q_st, q_sh;    // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale, softcap;
  int causal, window;
  int vec;                       // bytes a copy: 16, 4, or 2 (plain loads)
};

// Rows [first, first + nrows) of src into dst, row-major with row stride LD:
// columns d..DP-1 and rows at or past `limit` land as zeros.  VEC bytes a
// copy; 2 means plain loads (bf16 rows that start on an odd element).
template <typename T, int DP, int LD, int NT, int VEC>
__device__ __forceinline__ void rows_v(T* dst, const T* src, long long stride, int first,
                                       int limit, int d, int nrows) {
  constexpr int E = static_cast<int>(sizeof(T));
  constexpr int PER = VEC / E > 0 ? VEC / E : 1;     // elements a copy
  constexpr int CHUNKS = DP / PER;
  for (int idx = threadIdx.x; idx < nrows * CHUNKS; idx += NT) {
    const int row = idx / CHUNKS, col = (idx - row * CHUNKS) * PER;
    const int g = first + row;
    T* at = dst + row * LD + col;
    if constexpr (VEC == 2) {
      *at = g < limit && col < d ? src[g * stride + col] : from_f32<T>(0.0f);
    } else {
      const int left = (d - col) * E;
      const int bytes = g < limit && left > 0 ? min(left, VEC) : 0;
      cp_async<VEC>(at, bytes > 0 ? src + g * stride + col : src, bytes);
    }
  }
}

template <typename T, int DP, int LD, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride, int first,
                                          int limit, int d, int nrows, int vec) {
  if (vec == 16) rows_v<T, DP, LD, NT, 16>(dst, src, stride, first, limit, d, nrows);
  else if (vec == 4) rows_v<T, DP, LD, NT, 4>(dst, src, stride, first, limit, d, nrows);
  else rows_v<T, DP, LD, NT, 2>(dst, src, stride, first, limit, d, nrows);
}

// The same rows of an f32 matrix into the K-major core-matrix layout that
// wgmma reads: element (r, x) at ((x / 4) * nrows + r) * 4 + x % 4, so 8
// rows of 4 columns are one 128-byte core matrix.
template <int DP, int NT, int VEC>
__device__ __forceinline__ void kmajor_v(float* dst, const float* src, long long stride,
                                         int first, int limit, int d, int nrows) {
  constexpr int PER = VEC / 4;
  for (int idx = threadIdx.x; idx < nrows * (DP / PER); idx += NT) {
    const int r = idx % nrows, x = (idx / nrows) * PER;   // neighbours take neighbouring rows
    const int g = first + r;
    const int left = (d - x) * 4;
    const int bytes = g < limit && left > 0 ? min(left, VEC) : 0;
    cp_async<VEC>(dst + ((x >> 2) * nrows + r) * 4 + (x & 3),
                  bytes > 0 ? src + g * stride + x : src, bytes);
  }
}

template <int DP, int NT>
__device__ __forceinline__ void load_kmajor(float* dst, const float* src, long long stride,
                                            int first, int limit, int d, int nrows, int vec) {
  if (vec == 16) kmajor_v<DP, NT, 16>(dst, src, stride, first, limit, d, nrows);
  else kmajor_v<DP, NT, 4>(dst, src, stride, first, limit, d, nrows);
}


__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of one tile of a warp's logits, in the accumulator
// layout of both MMAs (lane = 4 g + c): s[4j + e] is row row0 + 8 (e >> 1),
// key k0 + 8j + 2c + (e & 1).  Scales, caps and, on a tile that crosses an
// edge, masks the logits; turns them into p = exp(x - m_new) in place;
// updates m and l; returns in corr the rescale of the earlier output.
template <int NS>
__device__ __forceinline__ void softmax_tile(float* s, float m[2], float l[2], float corr[2],
                                             const Args& a, int k0, int row0, int c,
                                             bool edge) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * a.scale;
      if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
      if (edge) {
        const int kpos = k0 + 8 * j + 2 * c + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        bool ok = kpos < a.s;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        x = ok ? x : kNegInf;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * j + e] = __expf(s[4 * j + e] - m_new);
        psum += s[4 * j + e];
      }
    }
    corr[r] = __expf(m[r] - m_new);
    l[r] = corr[r] * l[r] + quad_sum(psum);
    m[r] = m_new;
  }
}

// Rows that saw no key get the mean of v over all s keys (see the header),
// read straight from device memory: a rare path.  Then o / l, stored.  o is
// in the accumulator layout, NO groups of 8 columns from column vo.
template <typename T, int NO>
__device__ __forceinline__ void finish(float* o, const float m[2], float l[2], const Args& a,
                                       const T* v, int bi, int hh, int row0, int c, int vo) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= a.t) continue;
    if (m[r] == kNegInf) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = vo + 8 * n + 2 * c + e;
          float sum = 0.0f;
          if (col < a.d)
            for (int j = 0; j < a.s; ++j) sum += to_f32(v[j * a.v_ss + col]);
          o[4 * n + 2 * r + e] = sum;
        }
      }
      l[r] = static_cast<float>(a.s);
    }
    const float inv_l = l[r] == 0.0f ? 1.0f : l[r];   // the TPU kernel's l == 0 guard
    T* out = static_cast<T*>(a.out) +
             ((static_cast<long long>(bi) * a.t + qpos) * a.h + hh) * a.d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = vo + 8 * n + 2 * c + e;
        if (col < a.d) out[col] = from_f32<T>(o[4 * n + 2 * r + e] / inv_l);
      }
    }
  }
}

// ---------------------------------------------------------------- f32: wgmma

// Tile sizes of the f32 kernel by padded head dim: two warpgroups (128 q
// rows) and 64-key tiles where they fit in shared memory, else one
// warpgroup, else 32-key, else 16-key tiles.  Shared memory, in floats: Q's
// hi and lo; two stages of K (landed, then split in place into hi) and one
// of K's lo; two stages of V as landed and two of V^T's hi and lo, each DO
// columns wide (the block's half of O past d 128).
template <int DP>
struct F32Tiles {
  static constexpr int DO = out_cols(DP);           // O's columns a block
  static constexpr int SPLIT = (DP + DO - 1) / DO;  // blocks a (q tile, head)
  static __host__ __device__ constexpr int bytes(int bq, int bk) {
    return 4 * (2 * bq * DP + 3 * bk * DP + 6 * bk * DO);
  }
  static constexpr int BQ = bytes(128, 64) <= kSmemMax ? 128 : 64;
  static constexpr int BK = bytes(BQ, 64) <= kSmemMax   ? 64
                            : bytes(BQ, 32) <= kSmemMax ? 32
                                                        : 16;
  static constexpr int NT = 2 * BQ;                 // a warpgroup per 64 rows
  static constexpr int KT = BK * DP;                // one K plane
  static constexpr int VKT = BK * DO;               // one V plane
  static constexpr int Q_LO = BQ * DP;
  static constexpr int K = 2 * BQ * DP;
  static constexpr int K_LO = K + 2 * KT;
  static constexpr int V = K_LO + KT;
  static constexpr int VT = V + 2 * VKT;            // stage st: hi at VT + 2 st VKT, lo after
  static constexpr int SMEM = bytes(BQ, BK);
  static_assert(VT + 4 * VKT == SMEM / 4, "shared-memory layout");
  static_assert(SMEM <= kSmemMax, "shared memory");
};

template <int DP>
__global__ void __launch_bounds__(F32Tiles<DP>::NT, 1)
flash_f32(Args a) {
  using L = F32Tiles<DP>;
  static_assert(DP % 16 == 0 && DP <= kMaxD, "DP: a multiple of 16, at most 256");
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::NT, KT = L::KT, DO = L::DO, VKT = L::VKT;
  constexpr int NO = DO / 8;            // 8-column groups of the block's O
  constexpr int NS = BK / 8;            // 8-key groups of S
  constexpr int SCH = DP % 32 ? 16 : 32;  // columns of d a chunk of S (DP > 128)
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int q_tile = gridDim.x - 1 - blockIdx.x;     // most causal work first
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hh = bh - bi * a.h;
  const int kv_head = hh / (a.h / a.kvh);
  const int q0 = q_tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = q0 + 16 * warp + g;               // rows row0 and row0 + 8
  const int vo = blockIdx.z * DO;                    // the block's first column of O

  const float* q = static_cast<const float*>(a.q) + bi * a.q_sb + hh * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + bi * a.k_sb + kv_head * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + bi * a.v_sb + kv_head * a.v_sh;

  // the kv tiles the block can see: the TPU kernel's block predicate
  const int n_tiles = (a.s + BK - 1) / BK;
  int kt_lo = 0, kt_hi = n_tiles;
  if (a.window > 0) kt_lo = max(0, (q0 - a.window + 1) / BK);
  if (a.causal) kt_hi = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  auto load_tile = [&](int kt) {
    const int st = (kt - kt_lo) & 1;
    load_kmajor<DP, NT>(sm + L::K + st * KT, k, a.k_ss, kt * BK, a.s, a.d, BK, a.vec);
    load_rows<float, DO, DO, NT>(sm + L::V + st * VKT, v + vo, a.v_ss, kt * BK, a.s,
                                 a.d - vo, BK, a.vec);
    cp_async_commit();
  };
  // Q: each warpgroup's 64 rows as one K-major block
  for (int w = 0; w < BQ / 64; ++w)
    load_kmajor<DP, NT>(sm + w * 64 * DP, q, a.q_st, q0 + 64 * w, a.t, a.d, 64, a.vec);
  cp_async_commit();
  if (kt_lo < kt_hi) load_tile(kt_lo);
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * DP / 4; i += NT) {     // Q's split, once a block
    float4 hi, lo;
    split4(reinterpret_cast<const float4*>(sm)[i], hi, lo);
    reinterpret_cast<float4*>(sm)[i] = hi;
    reinterpret_cast<float4*>(sm + L::Q_LO)[i] = lo;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[4 * NO], ot[4 * NO];          // O, and one tile's P.V
#pragma unroll
  for (int i = 0; i < 4 * NO; ++i) o[i] = ot[i] = 0.0f;
  float sc[4 * NS];
  unsigned ph[NS][4], pl[NS][4];       // P of the previous tile, for its P.V
  const float* qhi = sm + (warp >> 2) * 64 * DP;
  const float* qlo = qhi + L::Q_LO;

  // OT = P V(tile in stage st), three TF32 products a group of 8 keys: the
  // small ones first, then hi*hi (see "Accumulation" in the header)
  auto issue_pv = [&](int st) {
    const float* vthi = sm + L::VT + st * 2 * VKT;
    const float* vtlo = vthi + VKT;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const uint64_t bh = desc(vthi + kk * 8 * DO, DO * 16, 128);
      const uint64_t bl = desc(vtlo + kk * 8 * DO, DO * 16, 128);
      Wgmma<DO>::rs(ot, pl[kk], bh, kk > 0);
      Wgmma<DO>::rs(ot, ph[kk], bl, 1);
    }
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      Wgmma<DO>::rs(ot, ph[kk], desc(vthi + kk * 8 * DO, DO * 16, 128), 1);
    wg_commit();
  };

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    cp_async_wait_all();
    __syncthreads();            // tile kt landed; S(kt-1) and P.V(kt-2) are done
    if (kt + 1 < kt_hi) load_tile(kt + 1);
    const int st = (kt - kt_lo) & 1;
    float* khi = sm + L::K + st * KT;
    float* klo = sm + L::K_LO;
    const float* vraw = sm + L::V + st * VKT;
    float* vthi = sm + L::VT + st * 2 * VKT;
    float* vtlo = vthi + VKT;
    // split K in place; V transposed and split: element (x, pos) of V^T at
    // ((pos / 4) * DO + x) * 4 + pos % 4, pos the relabelled key
    for (int i = threadIdx.x; i < KT / 4; i += NT) {
      float4 hi, lo;
      split4(reinterpret_cast<const float4*>(khi)[i], hi, lo);
      reinterpret_cast<float4*>(khi)[i] = hi;
      reinterpret_cast<float4*>(klo)[i] = lo;
    }
    for (int i = threadIdx.x; i < VKT / 4; i += NT) {
      const int x = i % DO, pq = i / DO;           // positions 4 pq .. 4 pq + 3
      const int key = 8 * (pq >> 1) + (pq & 1);    // position 4 pq + p is key + 2 p
      float4 raw = make_float4(vraw[key * DO + x], vraw[(key + 2) * DO + x],
                               vraw[(key + 4) * DO + x], vraw[(key + 6) * DO + x]);
      float4 hi, lo;
      split4(raw, hi, lo);
      reinterpret_cast<float4*>(vthi)[i] = hi;
      reinterpret_cast<float4*>(vtlo)[i] = lo;
    }
    fence_async_smem();
    __syncthreads();

    if constexpr (DP > 128) {
      // P(kt-1) V(kt-1) first, then S(kt) = Q K^T in chunks of SCH columns
      // of d, each chunk in a fresh accumulator (the small products first,
      // then hi*hi), the chunks summed on the CUDA cores with a compensated
      // addition (see "Head dims past 128" in the header)
      pin(ot);
      wg_fence();
      if (kt > kt_lo) issue_pv(st ^ 1);
      float s_lo[4 * NS], part[2][4 * NS];
      auto issue_chunk = [&](int ch, float* acc) {
#pragma unroll
        for (int ks = ch * SCH / 8; ks < (ch + 1) * SCH / 8; ++ks) {
          const uint64_t ah = desc(qhi + ks * 8 * 64, 64 * 16, 128);
          const uint64_t al = desc(qlo + ks * 8 * 64, 64 * 16, 128);
          const uint64_t bh = desc(khi + ks * 8 * BK, BK * 16, 128);
          const uint64_t bl = desc(klo + ks * 8 * BK, BK * 16, 128);
          Wgmma<BK>::ss(acc, al, bh, ks > ch * SCH / 8);
          Wgmma<BK>::ss(acc, ah, bl, 1);
        }
#pragma unroll
        for (int ks = ch * SCH / 8; ks < (ch + 1) * SCH / 8; ++ks)
          Wgmma<BK>::ss(acc, desc(qhi + ks * 8 * 64, 64 * 16, 128),
                        desc(khi + ks * 8 * BK, BK * 16, 128), 1);
        wg_commit();
      };
      issue_chunk(0, part[0]);
#pragma unroll
      for (int ch = 0; ch < DP / SCH; ++ch) {
        if (ch + 1 < DP / SCH) {
          pin(part[(ch + 1) & 1]);
          wg_fence();
          issue_chunk(ch + 1, part[(ch + 1) & 1]);
          wg_wait<1>();         // chunk ch (and P.V(kt-1)) are done
        } else {
          wg_wait<0>();
        }
        pin(part[ch & 1]);
#pragma unroll
        for (int i = 0; i < 4 * NS; ++i) {
          if (ch == 0) {
            sc[i] = part[0][i];
            s_lo[i] = 0.0f;
          } else {
            two_sum(sc[i], s_lo[i], part[ch & 1][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4 * NS; ++i) sc[i] = __fadd_rn(sc[i], s_lo[i]);
    } else {
    // S(kt) = Q K^T (the small products first, then hi*hi), then
    // P(kt-1) V(kt-1) behind it
    pin(ot);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      const uint64_t ah = desc(qhi + ks * 8 * 64, 64 * 16, 128);
      const uint64_t al = desc(qlo + ks * 8 * 64, 64 * 16, 128);
      const uint64_t bh = desc(khi + ks * 8 * BK, BK * 16, 128);
      const uint64_t bl = desc(klo + ks * 8 * BK, BK * 16, 128);
      Wgmma<BK>::ss(sc, al, bh, ks > 0);
      Wgmma<BK>::ss(sc, ah, bl, 1);
    }
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks)
      Wgmma<BK>::ss(sc, desc(qhi + ks * 8 * 64, 64 * 16, 128),
                    desc(khi + ks * 8 * BK, BK * 16, 128), 1);
    wg_commit();
    if (kt > kt_lo) {
      issue_pv(st ^ 1);
      wg_wait<1>();             // S(kt) is done; P.V(kt-1) may still run
    } else {
      wg_wait<0>();
    }
    }
    pin(sc);

    const int k0 = kt * BK;
    const bool edge = k0 + BK > a.s || (a.causal && k0 + BK - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + BQ - 1 - a.window);
    float corr[2];
    softmax_tile<NS>(sc, m, l, corr, a, k0, row0, c, edge);
    wg_wait<0>();               // P.V(kt-1) is done: OT and P's registers are free
    pin(ot);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[4 * n + 0] = (o[4 * n + 0] + ot[4 * n + 0]) * corr[0];
      o[4 * n + 1] = (o[4 * n + 1] + ot[4 * n + 1]) * corr[0];
      o[4 * n + 2] = (o[4 * n + 2] + ot[4 * n + 2]) * corr[1];
      o[4 * n + 3] = (o[4 * n + 3] + ot[4 * n + 3]) * corr[1];
    }
    // P as the A operand: column c is key 2c, column c + 4 key 2c + 1
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const int at[4] = {0, 2, 1, 3};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float hi, lo;
        split(sc[4 * kk + at[i]], hi, lo);
        ph[kk][i] = __float_as_uint(hi);
        pl[kk][i] = __float_as_uint(lo);
      }
    }
  }
  if (kt_lo < kt_hi) {
    pin(ot);
    wg_fence();
    issue_pv((kt_hi - 1 - kt_lo) & 1);
    wg_wait<0>();
    pin(ot);
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) o[i] += ot[i];
  }
  finish<float, NO>(o, m, l, a, v, bi, hh, row0, c, vo);
}

// ----------------------------------------------------------- bf16: mma.sync

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  unsigned r;
  memcpy(&r, &p, sizeof(r));
  return r;
}

constexpr int kBQ16 = 64;               // bf16: q rows a block, a warp per 16
constexpr int kBK16 = 64;               // bf16: keys a tile
constexpr int kNT16 = 2 * kBQ16;

// shared row stride in bf16 elements: rows 16 bytes apart modulo 128, so 8
// rows' fragment loads hit different banks
template <int DP>
__host__ __device__ constexpr int ld16() { return DP + 8; }

template <int DP>
__host__ __device__ constexpr int smem16() { return (kBQ16 + 4 * kBK16) * ld16<DP>() * 2; }

template <int DP>
__global__ void __launch_bounds__(kNT16, 1)
flash_bf16(Args a) {
  static_assert(DP % 16 == 0 && DP <= kMaxD, "DP: a multiple of 16, at most 256");
  using T = __nv_bfloat16;
  constexpr int LD = ld16<DP>(), LW = LD / 2;       // row stride in elements, in words
  constexpr int DO = out_cols(DP);                  // O's columns a block
  constexpr int NO = DO / 8, NS = kBK16 / 8;
  constexpr int STAGE = 2 * kBK16 * LD;             // K, then V
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* ring = Qs + kBQ16 * LD;

  const int q_tile = gridDim.x - 1 - blockIdx.x;     // most causal work first
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hh = bh - bi * a.h;
  const int kv_head = hh / (a.h / a.kvh);
  const int q0 = q_tile * kBQ16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = q0 + 16 * warp + g;               // rows row0 and row0 + 8
  const int vo = blockIdx.z * DO;                    // the block's first column of O

  const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + hh * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + kv_head * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + bi * a.v_sb + kv_head * a.v_sh;

  const int n_tiles = (a.s + kBK16 - 1) / kBK16;
  int kt_lo = 0, kt_hi = n_tiles;
  if (a.window > 0) kt_lo = max(0, (q0 - a.window + 1) / kBK16);
  if (a.causal) kt_hi = min(n_tiles, (q0 + kBQ16 - 1) / kBK16 + 1);

  auto load_tile = [&](int kt) {
    T* st = ring + ((kt - kt_lo) & 1) * STAGE;
    load_rows<T, DP, LD, kNT16>(st, k, a.k_ss, kt * kBK16, a.s, a.d, kBK16, a.vec);
    load_rows<T, DO, LD, kNT16>(st + kBK16 * LD, v + vo, a.v_ss, kt * kBK16, a.s,
                                a.d - vo, kBK16, a.vec);
    cp_async_commit();
  };
  load_rows<T, DP, LD, kNT16>(Qs, q, a.q_st, q0, a.t, a.d, kBQ16, a.vec);
  cp_async_commit();
  if (kt_lo < kt_hi) load_tile(kt_lo);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[4 * NO];
#pragma unroll
  for (int i = 0; i < 4 * NO; ++i) o[i] = 0.0f;
  const unsigned* qw = reinterpret_cast<const unsigned*>(Qs + (16 * warp + g) * LD) + c;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    cp_async_wait_all();
    __syncthreads();            // tile kt has landed; tile kt-1 is consumed
    if (kt + 1 < kt_hi) load_tile(kt + 1);
    const T* Ks = ring + ((kt - kt_lo) & 1) * STAGE;
    const T* Vs = Ks + kBK16 * LD;

    // S = Q K^T, 16 rows x 64 keys a warp
    float sc[4 * NS];
#pragma unroll
    for (int i = 0; i < 4 * NS; ++i) sc[i] = 0.0f;
    const unsigned* kw = reinterpret_cast<const unsigned*>(Ks + g * LD) + c;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int x = 8 * ks;             // word offset of column 16 ks
      const unsigned qa[4] = {qw[x], qw[8 * LW + x], qw[x + 4], qw[8 * LW + x + 4]};
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma_bf16(sc + 4 * j, qa, kw[8 * j * LW + x], kw[8 * j * LW + x + 4]);
    }

    const int k0 = kt * kBK16;
    const bool edge = k0 + kBK16 > a.s || (a.causal && k0 + kBK16 - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + kBQ16 - 1 - a.window);
    float corr[2];
    softmax_tile<NS>(sc, m, l, corr, a, k0, row0, c, edge);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[4 * n + 0] *= corr[0]; o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1]; o[4 * n + 3] *= corr[1];
    }

    // O += P V, P rounded to bf16 in registers.  ldmatrix.x4.trans: lanes
    // 8i..8i+7 address rows of matrix i = (keys +0 / +8) x (columns +0 / +8)
    const int mi = lane >> 3;
    const T* vl = Vs + ((lane & 7) + 8 * (mi & 1)) * LD + 8 * (mi >> 1);
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const float* p = sc + 8 * kk;
      const unsigned pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                              pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vl + 16 * kk * LD + 8 * n);
        mma_bf16(o + 4 * n, pa, vb[0], vb[1]);
        mma_bf16(o + 4 * (n + 1), pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait_all();          // no copy outlives the block (no tile visited)
  finish<T, NO>(o, m, l, a, v, bi, hh, row0, c, vo);
}

// ------------------------------------------------------------------- launch

template <int DP>
cudaError_t launch(const Args& a, int b, int bf16, cudaStream_t stream) {
  const auto kernel = bf16 ? flash_bf16<DP> : flash_f32<DP>;
  const int smem = bf16 ? smem16<DP>() : F32Tiles<DP>::SMEM;
  const int bq = bf16 ? kBQ16 : F32Tiles<DP>::BQ;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t + bq - 1) / bq, b * a.h, (DP + out_cols(DP) - 1) / out_cols(DP));
  kernel<<<grid, 2 * bq, smem, stream>>>(a);
  return cudaGetLastError();
}

// the head dim padded to the next multiple of 16
cudaError_t launch_d(const Args& a, int b, int bf16, cudaStream_t stream) {
  switch ((a.d + 15) / 16) {
    case 1: return launch<16>(a, b, bf16, stream);
    case 2: return launch<32>(a, b, bf16, stream);
    case 3: return launch<48>(a, b, bf16, stream);
    case 4: return launch<64>(a, b, bf16, stream);
    case 5: return launch<80>(a, b, bf16, stream);
    case 6: return launch<96>(a, b, bf16, stream);
    case 7: return launch<112>(a, b, bf16, stream);
    case 8: return launch<128>(a, b, bf16, stream);
    case 9: return launch<144>(a, b, bf16, stream);
    case 10: return launch<160>(a, b, bf16, stream);
    case 11: return launch<176>(a, b, bf16, stream);
    case 12: return launch<192>(a, b, bf16, stream);
    case 13: return launch<208>(a, b, bf16, stream);
    case 14: return launch<224>(a, b, bf16, stream);
    case 15: return launch<240>(a, b, bf16, stream);
    case 16: return launch<256>(a, b, bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the widest copy every row start of q, k and v allows: 16 or 4 bytes, or
// 2 (bf16 rows starting on an odd element: plain loads)
int copy_bytes(const void* q, const void* k, const void* v, const long long* strides,
               int elem) {
  const int widths[2] = {16, 4};
  for (int vec : widths) {
    bool ok = aligned(q, vec) && aligned(k, vec) && aligned(v, vec);
    for (int i = 0; i < 9; ++i) ok = ok && strides[i] * elem % vec == 0;
    if (ok) return vec;
  }
  return 2;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  bf16: 1 when q, k, v and out are
// bfloat16, 0 for float32.  strides: the (b, t|s, head) strides in elements
// of q, k and v, nine values; the last dimension of each is contiguous.
// 1 <= d <= 256; b * h <= 65535; t, s >= 1.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int bf16,
                          int b, int t, int s, int h, int kvh, int d,
                          const long long* strides, float scale, float softcap,
                          int causal, int window, void* stream) {
  if (b < 1 || t < 1 || s < 1 || kvh < 1 || h % kvh != 0 || b * h > 65535 || d < 1 ||
      d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = copy_bytes(q, k, v, strides, bf16 ? 2 : 4);
  Args a{q, k, v, out, t, s, h, kvh, d,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], scale, softcap, causal, window, vec};
  return static_cast<int>(launch_d(a, b, bf16, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
