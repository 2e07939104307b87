// Vocab-tiled scatter of EM token posteriors into the term-topic table.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_emscatter.py,
//   scatter_add_vtiles (_scatter_kernel), which computes
//   zeros[k, shard_v].at[:, ids].add(wphi.T) over posteriors already in
//   the plan's vocab-sorted order.
//
// What bounds it on the H100: bytes.  It reads the k posteriors of each
// live token once (pad slots are skipped before their posteriors are
// read), every slot's column and the block map once, and writes the
// [k, shard_v] table once; there is one add per posterior.  At the 20NG
// shape (~0.53M live tokens in 1,287 blocks of 1,024 slots, k=20,
// V=2^18) that is ~42 MB of posteriors, ~5 MB of columns and ~21 MB of
// table: ~68 MB, about 20 us at 3.35 TB/s.
//
// Design: the TPU kernel built a [vt, tb] one-hot in VMEM and contracted
// it on the MXU because Mosaic has no scatter.  Here one thread block
// owns one vocab tile (grid.x) and one slice of the k topics (grid.y,
// so k=500 fits: a [k, vt] f32 tile would be 512 KB).  The block walks
// the tile's consecutive token blocks (the loop replaces the TPU's
// sequential grid) and keeps the [kc, vt] accumulator in shared memory.
// Tokens inside a tile are sorted by column, so each column's sum is a
// segmented scan with one writer (segscan.cuh): deterministic, no
// atomics.  The accumulator is written to device memory once.

#include <cuda_runtime.h>

#include "segscan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = kThreads * stc::kItems;

__global__ void scatter_vtiles_kernel(
    const float* __restrict__ wphi,      // [nb * tb, k]
    const int* __restrict__ lids,        // [nb * tb]  (-1 = pad)
    const int* __restrict__ block_vtile, // [nb]
    int nb, int tb, int k, int kc, int vt, int shard_v,
    float* __restrict__ out) {           // [k, shard_v]
  extern __shared__ float smem[];
  float* acc = smem;                                  // [kc, vt]
  int* s_flag = reinterpret_cast<int*>(acc + kc * vt);  // [warps]
  float* s_val = reinterpret_cast<float*>(s_flag + 32); // [warps]

  const int tile = blockIdx.x;
  const int j0 = blockIdx.y * kc;
  const int jn = min(kc, k - j0);
  for (int i = threadIdx.x; i < kc * vt; i += blockDim.x) acc[i] = 0.0f;

  const long long begin =
      static_cast<long long>(stc::lower_bound_blocks(block_vtile, nb, tile)) * tb;
  const long long end =
      static_cast<long long>(stc::lower_bound_blocks(block_vtile, nb, tile + 1)) * tb;
  __syncthreads();

  for (long long p0 = begin; p0 < end; p0 += kPiece) {
    const long long p1 = min(end, p0 + kPiece);
    const long long g0 = p0 + static_cast<long long>(threadIdx.x) * stc::kItems;
    int key[stc::kItems];
    bool head[stc::kItems];
    bool tail[stc::kItems];
#pragma unroll
    for (int i = 0; i < stc::kItems; ++i) {
      const long long g = g0 + i;
      key[i] = g < p1 ? lids[g] : -1;
    }
    const int prev = (g0 > p0 && g0 - 1 < p1) ? lids[g0 - 1] : -2;
    const int next = (g0 + stc::kItems < p1) ? lids[g0 + stc::kItems] : -2;
#pragma unroll
    for (int i = 0; i < stc::kItems; ++i) {
      head[i] = key[i] != (i == 0 ? prev : key[i - 1]);
      tail[i] = key[i] != (i == stc::kItems - 1 ? next : key[i + 1]);
    }
    for (int jj = 0; jj < jn; ++jj) {
      float v[stc::kItems];
#pragma unroll
      for (int i = 0; i < stc::kItems; ++i) {
        v[i] = key[i] >= 0 ? wphi[(g0 + i) * k + j0 + jj] : 0.0f;
      }
      stc::block_segmented_scan(v, head, s_flag, s_val);
#pragma unroll
      for (int i = 0; i < stc::kItems; ++i) {
        if (key[i] >= 0 && tail[i]) acc[jj * vt + key[i]] += v[i];
      }
    }
    __syncthreads();
  }

  const int col0 = tile * vt;
  for (int i = threadIdx.x; i < jn * vt; i += blockDim.x) {
    const int jj = i / vt;
    const int c = i - jj * vt;
    if (col0 + c < shard_v) {
      out[static_cast<long long>(j0 + jj) * shard_v + col0 + c] = acc[i];
    }
  }
}

}  // namespace

extern "C" int stc_scatter_add_vtiles(
    const void* wphi, const void* lids, const void* block_vtile,
    int nb, int tb, int k, int kc, int vt, int n_vtiles, int shard_v,
    void* out, void* stream) {
  const int smem = (kc * vt + 64) * 4;  // accumulator + scan scratch
  cudaError_t err = cudaFuncSetAttribute(
      scatter_vtiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_vtiles, (k + kc - 1) / kc);
  scatter_vtiles_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wphi), static_cast<const int*>(lids),
      static_cast<const int*>(block_vtile), nb, tb, k, kc, vt, shard_v,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
