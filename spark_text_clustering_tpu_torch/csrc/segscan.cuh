// Block-wide segmented sum over a run-sorted piece of token slots.
//
// Used by the fused EM sweep (emsweep.cu).
// Inside one vocab tile the plan (plan_em_scatter) stores tokens sorted by
// their column `lid`, so every column's tokens form ONE contiguous run of
// the piece.
// Each thread owns ITEMS consecutive slots.  A segmented inclusive scan
// (thread-local, then warp shuffles, then across the block's warps in
// warp order) leaves the run's total in the run's last slot; that slot's
// thread alone adds it to the tile accumulator.  So there are no atomics,
// each column has one writer per piece, and the order of every float add
// is fixed by the layout: the result is the same bit for bit on every run.

#pragma once

#include <cuda_runtime.h>

namespace stc {

constexpr int kItems = 4;

// v[i] in: slot values; out: inclusive segmented sums within the piece.
// head[i]: slot i starts a run (the piece's first slot always does).
// s_flag / s_val: shared scratch of one entry per warp.
// Ends with __syncthreads(), so the scratch can be reused at once.
__device__ __forceinline__ void block_segmented_scan(
    float (&v)[kItems], const bool (&head)[kItems],
    int* s_flag, float* s_val) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  bool any_head = false;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i > 0 && !head[i]) v[i] = v[i - 1] + v[i];
    any_head = any_head || head[i];
  }
  // inclusive warp scan of the thread aggregates (flag, value)
  int f = any_head ? 1 : 0;
  float a = v[kItems - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int fo = __shfl_up_sync(0xffffffffu, f, off);
    const float ao = __shfl_up_sync(0xffffffffu, a, off);
    if (lane >= off) {
      if (!f) a = ao + a;
      f = f | fo;
    }
  }
  if (lane == 31) {
    s_flag[warp] = f;
    s_val[warp] = a;
  }
  __syncthreads();
  // exclusive prefix of this warp: the earlier warps, in warp order
  int pf = 0;
  float pa = 0.0f;
  for (int u = 0; u < warp; ++u) {
    if (s_flag[u]) {
      pa = s_val[u];
    } else {
      pa = pa + s_val[u];
    }
    pf = pf | s_flag[u];
  }
  const int fl = __shfl_up_sync(0xffffffffu, f, 1);
  const float al = __shfl_up_sync(0xffffffffu, a, 1);
  float excl = pa;
  if (lane > 0) excl = fl ? al : pa + al;
  (void)pf;
  bool seen = false;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    seen = seen || head[i];
    if (!seen) v[i] = excl + v[i];
  }
  __syncthreads();
}

// First block index b in [0, nb) with block_vtile[b] >= t (block_vtile is
// nondecreasing: a tile's blocks are consecutive).
__device__ __forceinline__ int lower_bound_blocks(const int* block_vtile,
                                                  int nb, int t) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (block_vtile[mid] < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace stc
