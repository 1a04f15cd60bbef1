// f32 matrix product on Hopper's tensor cores (sm_90a), in split TF32:
//
//     C[m, n] = sum_k A[m, k] B[k, n]
//
// The training step's dense projections (q, k, v and the output projection,
// the MLP's gate, up and down, the head) and both of their gradients:
// forward Y = X W, dX = dY W^T, dW = X^T dY.  It replaces no TPU kernel (the
// reference leaves these products to XLA): in the f32 training cells they
// were three quarters of the card's time, on the CUDA cores at close to
// their 67 TFLOP/s (cuBLAS and CUTLASS FFMA kernels).
//
// A is (M, K) and B is (K, N), each with its own two strides, one of them 1:
// A K-major (the summed dimension contiguous) or M-major, B K-major or
// N-major.  The forward reads X K-major and W (d, ...) N-major; dX reads dY
// and W^T K-major; dW reads X^T and dY M- and N-major; the head's table
// (v, d) is B K-major in the forward.  Nothing is copied or transposed in
// device memory: the transposes happen in shared memory.  C is a new
// contiguous (M, N).  No workspace, no atomics: each output tile is one
// block's, summed in a fixed order, so reruns are bit-identical.
//
// Bound: 2 M N K operations against (M K + K N + M N) 4 bytes, operations
// bound at the main path's shapes (M 4096, N and K 3072-32064).  Three TF32
// products at the 495 TFLOP/s of dense TF32 give 165 TFLOP/s of f32 work,
// 2.5 x the CUDA cores' f32 rate.
//
// Precision (as flash_attention.cu's f32 path):
//   * each operand is split as x = hi + lo, hi = x rounded to TF32 (to
//     nearest), lo = x - hi rounded again, and each product is lo*hi +
//     hi*lo + hi*hi (the dropped lo*lo and lo's rounding leave ~2^-22
//     relative a product);
//   * wgmma's own accumulation loses more than round-to-nearest (see
//     flash_attention.cu's "Accumulation"), so each 32-deep slice of K goes
//     into a fresh accumulator, the small products first and hi*hi last,
//     and the CUDA cores add the slices into the f32 result, rounded to
//     nearest.
//
// Shape: a block is two warpgroups and one 128 x 128 tile of C, each
// warpgroup 64 rows.  A ring of four stages of raw f32 tiles (128 x 32 of A
// and of B) is filled by cp.async (16-byte copies when every row start
// allows it, else 4; rows and columns past M, N or K land as zeros, so the
// edges are masked, not padded).  Per 32-deep slice:
//   * the split pass writes B's hi and lo planes in the K-major core-matrix
//     layout wgmma reads (TF32 wgmma takes B only K-major; an N-major B is
//     transposed here), double-buffered;
//   * each thread reads its A fragments from the raw tile (a padded row
//     stride, free of bank conflicts in both layouts) and splits them in
//     registers, two slices' worth: A is wgmma's register operand;
//   * twelve m64n128k8 products a warpgroup (three a k8 step) run while the
//     next slice's copies land and its split pass runs.
// One accumulator a slice, drained before the next slice's products: a
// second one does not fit beside the result's 64 registers a thread, and
// reading one accumulator while products into another are in flight makes
// ptxas serialize every wgmma (C7514).
// Output tiles go in groups of 8 along M, so that the blocks in flight share
// their B columns in L2.

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kNT = 256;                  // two warpgroups
constexpr int kStages = 4;                // raw tiles in flight
constexpr int kGroupM = 8;                // output tiles a group along M
constexpr int LD_K = BK + 4;              // raw tile [row][k]: 36 floats a row
constexpr int LD_MN = BM + 8;             // raw tile [k][row]: 136 floats a row
constexpr int RAW = BM * LD_K > BK * LD_MN ? BM * LD_K : BK * LD_MN;   // floats
constexpr int PLANE = BN * BK;            // one of B's hi / lo planes, floats
constexpr int SMEM = 4 * (kStages * 2 * RAW + 4 * PLANE);
static_assert(SMEM <= 232448, "shared memory");
static_assert(BM == BN, "one raw tile size serves A and B");

struct Args {
  const float* a; const float* b; float* c;
  int m, n, k;
  long long sa_m, sa_k, sb_k, sb_n;       // strides in elements
  int pair;                               // C's rows allow 8-byte stores
};

template <int N>
__device__ __forceinline__ void pin_u(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// One operand's 32-deep slice [k0, k0 + 32) of rows [r0, r0 + 128) (M for A,
// N for B) into a raw tile: K-major sources land as [row][k] (LD_K), the
// others as [k][row] (LD_MN).  `stride` is the source's non-unit stride.
template <bool KMAJ, int VEC>
__device__ __forceinline__ void load_slice(float* dst, const float* src, long long stride,
                                           int r0, int rlim, int k0, int klim) {
  constexpr int PER = VEC / 4;
  if constexpr (KMAJ) {
    constexpr int CH = BK / PER;          // copies a row
    for (int idx = threadIdx.x; idx < BM * CH; idx += kNT) {
      const int r = idx / CH, x = (idx - r * CH) * PER;
      const int gr = r0 + r, gk = k0 + x;
      const int n = gr < rlim ? min(klim - gk, PER) : 0;
      const int bytes = n > 0 ? 4 * n : 0;
      cp_async<VEC>(dst + r * LD_K + x, bytes ? src + gr * stride + gk : src, bytes);
    }
  } else {
    constexpr int CH = BM / PER;
    for (int idx = threadIdx.x; idx < BK * CH; idx += kNT) {
      const int kk = idx / CH, x = (idx - kk * CH) * PER;
      const int gk = k0 + kk, gr = r0 + x;
      const int n = gk < klim ? min(rlim - gr, PER) : 0;
      const int bytes = n > 0 ? 4 * n : 0;
      cp_async<VEC>(dst + kk * LD_MN + x, bytes ? src + gk * stride + gr : src, bytes);
    }
  }
}

// B's raw slice split into its hi and lo planes: element (n, kk) at
// ((kk / 4) * BN + n) * 4 + kk % 4, so 8 rows of 4 k are one 128-byte core
// matrix.  Neighbouring threads take neighbouring n.
template <bool KMAJ>
__device__ __forceinline__ void split_b(float* hi, float* lo, const float* raw) {
  for (int i = threadIdx.x; i < BN * BK / 4; i += kNT) {
    const int n = i % BN, q = i / BN;
    float4 x;
    if constexpr (KMAJ) {
      x = *reinterpret_cast<const float4*>(raw + n * LD_K + 4 * q);
    } else {
      const float* col = raw + 4 * q * LD_MN + n;
      x = make_float4(col[0], col[LD_MN], col[2 * LD_MN], col[3 * LD_MN]);
    }
    float4 h, l;
    split4(x, h, l);
    reinterpret_cast<float4*>(hi)[q * BN + n] = h;
    reinterpret_cast<float4*>(lo)[q * BN + n] = l;
  }
}

// A thread's A fragments of a slice, raw: for k8 step s, wgmma's register
// layout (lane = 4 g + c): rows r and r + 8, columns 8 s + c and 8 s + c + 4.
template <bool KMAJ>
__device__ __forceinline__ void load_a(float (&f)[16], const float* raw, int r, int c) {
  auto at = [&](int row, int kk) {
    return KMAJ ? raw[row * LD_K + kk] : raw[kk * LD_MN + row];
  };
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    f[4 * s + 0] = at(r, 8 * s + c);
    f[4 * s + 1] = at(r + 8, 8 * s + c);
    f[4 * s + 2] = at(r, 8 * s + c + 4);
    f[4 * s + 3] = at(r + 8, 8 * s + c + 4);
  }
}

template <bool A_K, bool B_K, int VEC>
__global__ void __launch_bounds__(kNT, 1) dense_f32(Args p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* planes = sm + kStages * 2 * RAW;    // buffer j: hi at 2 j PLANE, lo after

  // the output tile: groups of kGroupM tiles along M, N within a group
  const int tiles_m = (p.m + BM - 1) / BM, tiles_n = (p.n + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int t = blockIdx.x;
  const int first_m = t / per_group * kGroupM;
  const int gm = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + t % per_group % gm) * BM;
  const int n0 = t % per_group / gm * BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r = 16 * warp + g;               // rows r and r + 8 of the tile
  const int nk = (p.k + BK - 1) / BK;

  auto raw_a = [&](int slot) { return sm + slot * 2 * RAW; };
  auto raw_b = [&](int slot) { return sm + slot * 2 * RAW + RAW; };
  // one commit group a slice (empty past the last), so that waiting for all
  // but the newest kStages - 2 groups means slice j has landed
  auto load = [&](int j) {
    if (j < nk) {
      const int slot = j % kStages;
      load_slice<A_K, VEC>(raw_a(slot), p.a, A_K ? p.sa_m : p.sa_k, m0, p.m, j * BK, p.k);
      load_slice<B_K, VEC>(raw_b(slot), p.b, B_K ? p.sb_n : p.sb_k, n0, p.n, j * BK, p.k);
    }
    cp_async_commit();
  };

  float sum[64], acc[64];
  unsigned ahi[2][16], alo[2][16];           // A fragments: two slices
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = acc[i] = 0.0f;

  // slice j has landed: copy slice j + kStages - 1 into the slot of slice
  // j - 1 (everyone is past it), split B into plane buffer j % 2 and this
  // thread's A fragments into register buffer BUF (the last reader of
  // both, slice j - 2's products, is done)
  auto prep = [&](auto buf, int j) {
    constexpr int BUF = decltype(buf)::value;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load(j + kStages - 1);
    float* hi = planes + (j & 1) * 2 * PLANE;
    split_b<B_K>(hi, hi + PLANE, raw_b(j % kStages));
    float fa[16];
    load_a<A_K>(fa, raw_a(j % kStages), r, c);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float h, l;
      split(fa[i], h, l);
      ahi[BUF][i] = __float_as_uint(h);
      alo[BUF][i] = __float_as_uint(l);
    }
  };
  // slice kt's products in a fresh accumulator, lo*hi and hi*lo of every k8
  // step first, then hi*hi; slice kt + 1 is prepared while they run, and
  // the CUDA cores add the accumulator to the result once they are done
  auto step = [&](auto buf, int kt) {
    constexpr int BUF = decltype(buf)::value;
    const float* bhi = planes + (kt & 1) * 2 * PLANE;
    const float* blo = bhi + PLANE;
    pin(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      Wgmma<128>::rs(acc, alo[BUF] + 4 * s, desc(bhi + s * 8 * BN, BN * 16, 128), s > 0);
      Wgmma<128>::rs(acc, ahi[BUF] + 4 * s, desc(blo + s * 8 * BN, BN * 16, 128), 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      Wgmma<128>::rs(acc, ahi[BUF] + 4 * s, desc(bhi + s * 8 * BN, BN * 16, 128), 1);
    wg_commit();
    if (kt + 1 < nk) prep(std::integral_constant<int, BUF ^ 1>(), kt + 1);
    wg_wait<0>();
    pin(acc);
    pin_u(ahi[BUF]);
    pin_u(alo[BUF]);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    if (kt + 1 < nk) {
      fence_async_smem();
      __syncthreads();
    }
  };

  for (int j = 0; j < kStages - 1; ++j) load(j);
  prep(std::integral_constant<int, 0>(), 0);
  fence_async_smem();
  __syncthreads();
  // two slices an iteration, so that the register buffers are named
  for (int kt = 0; kt < nk; kt += 2) {
    step(std::integral_constant<int, 0>(), kt);
    if (kt + 1 < nk) step(std::integral_constant<int, 1>(), kt + 1);
  }
  cp_async_wait_all();

  // the accumulator layout: sum[4 j + e] is row r + 8 (e >> 1), column
  // 8 j + 2 c + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r + 8 * h;
    if (row >= p.m) continue;
    float* out = p.c + static_cast<long long>(row) * p.n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * c;
      const float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
      if (p.pair && col + 1 < p.n) {
        *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
      } else {
        if (col < p.n) out[col] = v0;
        if (col + 1 < p.n) out[col + 1] = v1;
      }
    }
  }
}

template <bool A_K, bool B_K, int VEC>
cudaError_t launch(const Args& p, long long blocks, cudaStream_t stream) {
  const auto kernel = dense_f32<A_K, B_K, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kNT, SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_layout(const Args& p, long long blocks, cudaStream_t stream) {
  const bool a_k = p.sa_k == 1, b_k = p.sb_k == 1;
  if (a_k && b_k) return launch<true, true, VEC>(p, blocks, stream);
  if (a_k) return launch<true, false, VEC>(p, blocks, stream);
  if (b_k) return launch<false, true, VEC>(p, blocks, stream);
  return launch<false, false, VEC>(p, blocks, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  c: a contiguous (m, n) f32
// output; a (m, k) and b (k, n) f32 with strides in elements, sa_k or sa_m
// equal to 1 and sb_k or sb_n equal to 1 (K-major when the k stride is 1).
int repro_dense(const float* a, const float* b, float* c, int m, int n, int k,
                long long sa_m, long long sa_k, long long sb_k, long long sb_n,
                void* stream) {
  if (m < 1 || n < 1 || k < 1 || (sa_k != 1 && sa_m != 1) || (sb_k != 1 && sb_n != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long a_rows = sa_k == 1 ? sa_m : sa_k, b_rows = sb_k == 1 ? sb_n : sb_k;
  const bool wide = aligned(a, 16) && aligned(b, 16) && a_rows % 4 == 0 && b_rows % 4 == 0;
  const Args p{a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n, aligned(c, 8) && n % 2 == 0};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wide ? launch_layout<16>(p, blocks, s)
                               : launch_layout<4>(p, blocks, s));
}

}  // extern "C"
