// One whole EM sweep over the vocab-sorted token blocks, fused.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_emsweep.py,
//   em_sweep_fused (_sweep_kernel).  Per token:
//     term = N_wk[:, tile*vt + lid] + eta - 1
//     doc  = (N_dk + alpha - 1)[seg, :]
//     phi  = term * doc * inv_denom, normalized over k;  wphi = cts * phi
//   and the sweep returns N_wk'[k, shard_v] (per vocab tile) and
//   N_dk'[d_pad, k].  Pad slots (lid == -1, cts == 0) add exactly 0.
//
// What bounds it on the H100: bytes.  The sweep reads each token's lid,
// seg and cts once (12 bytes) and the [k, shard_v] table once, and writes
// the table and the [d_pad, k] doc counts once; it does ~6k operations a
// token.  At the EN books shape (~0.57M tokens, k=5, V=39,380) that is
// ~9 MB, under 3 us: far below the time of one launch, so the kernel is
// bound by latency and by the blocks the card can fill.
//
// Design: the TPU kernel built two one-hots in VMEM (vocab and doc) and
// ran four MXU products, because Mosaic has neither gather nor scatter.
// Here one thread block owns one vocab tile and walks that tile's
// consecutive token blocks (the loop replaces the TPU's sequential grid).
//   * The tile's [k, vt] slice of N_wk and the whole [d_pad, k] doc
//     factor live in shared memory; both gathers are shared-memory reads.
//   * N_wk' for the tile is a segmented sum over runs of equal lid
//     (tokens are sorted by lid inside a tile; segscan.cuh) into a
//     [k, vt] shared accumulator, written once.
//   * N_dk' crosses tiles.  Inside a block, each warp groups its lanes by
//     doc (__match_any_sync); the lowest lane sums the group in lane
//     order into that warp's private [d_pad, k] copy.  The copies are
//     summed in warp order into a per-tile partial [n_vtiles, d_pad, k],
//     and a second small kernel sums the partials in tile order.  No
//     float add has a run-dependent order: the sweep is deterministic.
//   * The warp count is the largest (<= 8) whose copies fit the block's
//     227 KB of shared memory.  stc_em_sweep_warps exports that choice
//     (0: no count fits), so the fused gate in ops/emsweep.py asks this
//     file and the layout is written down only here.

#include <cuda_runtime.h>

#include "segscan.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 232448;  // 227 KB a block may opt in to

// The layout em_sweep_kernel carves: term_s, acc_s, docf_s, invd_s, one
// N_dk copy and one 32-float buffer per warp, then the scan's scratch.
int sweep_smem_bytes(int k, int vt, int d_pad, int warps) {
  return 4 * (2 * k * vt + d_pad * k + k + warps * d_pad * k + warps * 32 +
              64);
}

int sweep_warps(int k, int vt, int d_pad) {
  for (int w = kMaxWarps; w > 0; --w) {
    if (sweep_smem_bytes(k, vt, d_pad, w) <= kSmemLimit) return w;
  }
  return 0;
}

__global__ void em_sweep_kernel(
    const float* __restrict__ nwk,        // [k, shard_v]
    const float* __restrict__ docf,       // [k, d_pad] (N_dk + alpha - 1)^T
    const float* __restrict__ inv_denom,  // [k]
    const int* __restrict__ lids,         // [nb * tb] (-1 = pad)
    const int* __restrict__ seg,          // [nb * tb]
    const float* __restrict__ cts,        // [nb * tb]
    const int* __restrict__ block_vtile,  // [nb]
    int nb, int tb, int k, int vt, int d_pad, int shard_v, float eta_m1,
    float* __restrict__ nwk_out,          // [k, shard_v]
    float* __restrict__ ndk_part) {       // [n_vtiles, d_pad, k]
  extern __shared__ float smem[];
  const int n_warps = blockDim.x >> 5;
  float* term_s = smem;                       // [k, vt] N_wk tile + eta - 1
  float* acc_s = term_s + k * vt;             // [k, vt] N_wk' tile
  float* docf_s = acc_s + k * vt;             // [d_pad, k]
  float* invd_s = docf_s + d_pad * k;         // [k]
  float* ndk_s = invd_s + k;                  // [n_warps, d_pad, k]
  float* wbuf = ndk_s + n_warps * d_pad * k;  // [n_warps, 32]
  int* s_flag = reinterpret_cast<int*>(wbuf + n_warps * 32);
  float* s_val = reinterpret_cast<float*>(s_flag + 32);

  const int tile = blockIdx.x;
  const int col0 = tile * vt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < k * vt; i += blockDim.x) {
    const int j = i / vt;
    const int c = i - j * vt;
    term_s[i] = (col0 + c < shard_v
                     ? nwk[static_cast<long long>(j) * shard_v + col0 + c]
                     : 0.0f) + eta_m1;
    acc_s[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < d_pad * k; i += blockDim.x) {
    const int d = i / k;
    const int j = i - d * k;
    docf_s[i] = docf[static_cast<long long>(j) * d_pad + d];
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) invd_s[i] = inv_denom[i];
  for (int i = threadIdx.x; i < n_warps * d_pad * k; i += blockDim.x) {
    ndk_s[i] = 0.0f;
  }
  const long long begin =
      static_cast<long long>(stc::lower_bound_blocks(block_vtile, nb, tile)) * tb;
  const long long end =
      static_cast<long long>(stc::lower_bound_blocks(block_vtile, nb, tile + 1)) * tb;
  __syncthreads();

  const int piece = blockDim.x * stc::kItems;
  float* my_ndk = ndk_s + warp * d_pad * k;
  float* my_buf = wbuf + warp * 32;
  for (long long p0 = begin; p0 < end; p0 += piece) {
    const long long p1 = min(end, p0 + piece);
    const long long g0 = p0 + static_cast<long long>(threadIdx.x) * stc::kItems;
    int key[stc::kItems];
    int doc[stc::kItems];
    float wt[stc::kItems];   // cts / (sum_j phi_j + 1e-30)
    unsigned peers[stc::kItems];
    bool head[stc::kItems];
    bool tail[stc::kItems];
#pragma unroll
    for (int i = 0; i < stc::kItems; ++i) {
      const long long g = g0 + i;
      key[i] = g < p1 ? lids[g] : -1;
      doc[i] = key[i] >= 0 ? seg[g] : 0;
      float s = 0.0f;
      if (key[i] >= 0) {
        for (int j = 0; j < k; ++j) {
          s += term_s[j * vt + key[i]] * docf_s[doc[i] * k + j] * invd_s[j];
        }
        wt[i] = cts[g] / (s + 1e-30f);
      } else {
        wt[i] = 0.0f;
      }
      // lanes holding the same doc (pads form their own group, key -1)
      peers[i] = __match_any_sync(0xffffffffu, key[i] >= 0 ? doc[i] : -1);
    }
    const int prev = (g0 > p0 && g0 - 1 < p1) ? lids[g0 - 1] : -2;
    const int next = (g0 + stc::kItems < p1) ? lids[g0 + stc::kItems] : -2;
#pragma unroll
    for (int i = 0; i < stc::kItems; ++i) {
      head[i] = key[i] != (i == 0 ? prev : key[i - 1]);
      tail[i] = key[i] != (i == stc::kItems - 1 ? next : key[i + 1]);
    }
    for (int j = 0; j < k; ++j) {
      float v[stc::kItems];
#pragma unroll
      for (int i = 0; i < stc::kItems; ++i) {
        v[i] = key[i] >= 0
                   ? wt[i] * (term_s[j * vt + key[i]] * docf_s[doc[i] * k + j] *
                              invd_s[j])
                   : 0.0f;
      }
      // N_dk': per item, each doc group of the warp sums in lane order
#pragma unroll
      for (int i = 0; i < stc::kItems; ++i) {
        my_buf[lane] = v[i];
        __syncwarp();
        if (key[i] >= 0 && (__ffs(peers[i]) - 1) == lane) {
          float s = 0.0f;
          unsigned m = peers[i];
          while (m) {
            const int src = __ffs(m) - 1;
            s += my_buf[src];
            m &= m - 1;
          }
          my_ndk[doc[i] * k + j] += s;
        }
        __syncwarp();
      }
      // N_wk': segmented sum over the runs of equal lid
      stc::block_segmented_scan(v, head, s_flag, s_val);
#pragma unroll
      for (int i = 0; i < stc::kItems; ++i) {
        if (key[i] >= 0 && tail[i]) acc_s[j * vt + key[i]] += v[i];
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < k * vt; i += blockDim.x) {
    const int j = i / vt;
    const int c = i - j * vt;
    if (col0 + c < shard_v) {
      nwk_out[static_cast<long long>(j) * shard_v + col0 + c] = acc_s[i];
    }
  }
  float* part = ndk_part + static_cast<long long>(tile) * d_pad * k;
  for (int i = threadIdx.x; i < d_pad * k; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w) s += ndk_s[w * d_pad * k + i];
    part[i] = s;
  }
}

// N_dk'[d, j] = sum over tiles, in tile order, of the per-tile partials.
__global__ void ndk_reduce_kernel(const float* __restrict__ ndk_part,
                                  int n_vtiles, int n,
                                  float* __restrict__ ndk_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int t = 0; t < n_vtiles; ++t) {
    s += ndk_part[static_cast<long long>(t) * n + i];
  }
  ndk_out[i] = s;
}

}  // namespace

// Warps of a fused-sweep block for this geometry; 0 when none fits.
extern "C" int stc_em_sweep_warps(int k, int vt, int d_pad) {
  return sweep_warps(k, vt, d_pad);
}

extern "C" int stc_em_sweep_fused(
    const void* nwk, const void* docf, const void* inv_denom,
    const void* lids, const void* seg, const void* cts,
    const void* block_vtile, int nb, int tb, int k, int vt, int n_vtiles,
    int d_pad, int shard_v, float eta_m1, void* nwk_out, void* ndk_part,
    void* ndk_out, void* stream) {
  const int warps = sweep_warps(k, vt, d_pad);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sweep_smem_bytes(k, vt, d_pad, warps);
  cudaError_t err = cudaFuncSetAttribute(
      em_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  em_sweep_kernel<<<n_vtiles, warps * 32, smem, s>>>(
      static_cast<const float*>(nwk), static_cast<const float*>(docf),
      static_cast<const float*>(inv_denom), static_cast<const int*>(lids),
      static_cast<const int*>(seg), static_cast<const float*>(cts),
      static_cast<const int*>(block_vtile), nb, tb, k, vt, d_pad, shard_v,
      eta_m1, static_cast<float*>(nwk_out), static_cast<float*>(ndk_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = d_pad * k;
  ndk_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(ndk_part), n_vtiles, n,
      static_cast<float*>(ndk_out));
  return static_cast<int>(cudaGetLastError());
}
