// One launch over many buckets, shared by fused_adamw.cu and fused_stats.cu
// (Hopper, sm_90a).
//
// The flat layout of a model is many buckets (microllama-300m: 98, from
// 1 024 to 32 768 000 elements).  Launched one bucket at a time, these
// streaming kernels were limited by the host, not the card: at 85 % of
// 3.35 TB/s a 1 M-element bucket is ~10 us of AdamW (28 B an element) and
// ~3 us of statistics (8 B an element), while each call cost the host
// 20-50 us (checks, allocations, the ctypes call, a second launch for the
// partials).  So a step's tail now runs as one launch per operand dtype
// group, plus one launch that adds the partials:
//
//   * the table: one row per bucket (Bucket below), built by
//     kernels/buckets.py and kept on the card across steps, keyed by the
//     operands' addresses (a launch copies nothing and waits for nothing;
//     a table passed by value would not fit a launch's 4 KB of parameters
//     at 98 rows, and chunking it would cost a launch a chunk);
//   * the grid: a fixed number of blocks (kernels/buckets.py GRID, never
//     read from the device); block b walks tiles b, b + G, b + 2G, ... of
//     the group's global tile index, finds each tile's bucket by advancing
//     a cursor over the rows' first tiles, and a tile never straddles two
//     buckets;
//   * inside a tile: 16-byte vector accesses (4 elements a thread) where
//     every pointer of the bucket allows them, several groups of them
//     loaded before any is used so that each thread keeps more than one
//     load of each operand in flight; otherwise a masked scalar loop
//     (shard views of odd-sized buckets).  Nothing is padded or copied;
//   * the sums: each thread adds its elements in walk order, each block
//     writes one partial per sum, and sum_partials_kernel adds the call's
//     partials in a fixed order.  No float atomics: repeated calls give
//     the same bits, and every rank the same statistic.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 4096;                              // TILE in buckets.py
constexpr int kGroupsPerThread = kTile / (kThreads * kVec);
static_assert(kGroupsPerThread * kThreads * kVec == kTile, "tile of whole groups");

// One row of the table (ROW int64 words in buckets.py).
struct Bucket {
  unsigned long long ptr[4];   // operand addresses; unused ones are 0
  long long n;                 // elements
  long long first_tile;        // tiles of the rows before it, in its launch
  long long aligned;           // 1: every operand allows a vector access
  long long unused;
};
static_assert(sizeof(Bucket) == 64, "Bucket must match buckets.ROW");

// Tile t of a launch: its bucket's row (found from `cur` onwards, since a
// block walks its tiles in increasing order), the tile's first element in
// that bucket and its length (kTile, less at the end of a bucket).
struct TileAt {
  int row;
  long long start;
  int len;
};

__device__ __forceinline__ TileAt tile_at(const Bucket* __restrict__ table, int rows,
                                          long long t, int cur) {
  while (cur + 1 < rows && table[cur + 1].first_tile <= t) ++cur;
  const long long start = (t - table[cur].first_tile) * kTile;
  const long long left = table[cur].n - start;
  return {cur, start, static_cast<int>(left < kTile ? left : kTile)};
}

// The second pass: block k adds partials[k*count .. (k+1)*count) in a fixed
// order into out[k] (one block per output sum).
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int count, float* __restrict__ out) {
  const float* mine = partials + static_cast<long long>(blockIdx.x) * count;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += mine[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `partials` holds outputs * count
// floats, output k's at [k*count, (k+1)*count); `out` gets `outputs` sums.
int repro_sum_partials(const void* partials, int count, int outputs, void* out,
                       void* stream) {
  if (count < 0 || outputs < 1) return static_cast<int>(cudaErrorInvalidValue);
  sum_partials_kernel<<<outputs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), count, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
