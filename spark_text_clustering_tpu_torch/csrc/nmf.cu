// Lee-Seung multiplicative W update of NMF over token-packed tiles.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_nmf.py,
//   nmf_mu_update_tiles (_mu_kernel).  Per tile of tt token slots and d doc
//   slots, with hg [k, tt] the tile's columns of H gathered at its tokens:
//     xht[s, j] = sum over the slot's tokens of hg[j, t] * cts[t]
//     w_new     = w * xht / (w @ hht + eps)           for all d slots
//     vals[t]   = cts[t] * w_new[seg[t]], 0 for a pad token (seg == d)
//   The plan (plan_tile_pack) puts a tile's live tokens first,
//   doc-contiguous with seg nondecreasing, and its pad tokens (seg == d,
//   cts == 0) at the end.  A slot no token reaches (a pad slot, or a doc
//   whose tokens all had cts == 0) gets w * 0 / (den + eps) == 0, as in JAX.
//
// What bounds it on the H100: bytes.  Per live token it reads hg's k
// values, cts and seg and writes k vals; per live slot it reads and writes
// a W row: ~90 MB a sweep on the 20NG shape (k=20), ~27 us at 3.35 TB/s.
// The arithmetic (~2k a token, ~2k^2 a slot) is far below that.
//
// Design: the TPU kernel built a [d, tt] one-hot and ran both segment
// operations as MXU matmuls, because Mosaic has no gather or scatter.  Here
// one block owns one tile and streams its live tokens in pieces.  Per
// topic, the block-wide segmented scan of segscan.cuh over each doc's
// contiguous run leaves the run's total in its last slot, whose thread
// alone adds it to xht; xht lives in the tile's rows of the W output.  So
// there are no atomics, each slot has one writer per piece, and the sums
// repeat bit for bit.  Only hht [k, k] is kept in shared memory (read from
// global memory where it does not fit); nothing [d, k] or [k, tt] is
// cached, so every geometry the planner returns runs (k, d and tt are
// bounded by the plan alone).  After a barrier each (slot, topic) of the
// tile is updated by the thread that reads its numerator; after another,
// the tile's tt rows of vals are written, coalesced, pad tokens included.

#include <cuda_runtime.h>

#include "segscan.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
// the H100's opt-in shared memory for one block (227 KB)
constexpr int kSmemLimit = 232448;

// scan flags and values (one entry a warp each) and n_tok
int scratch_bytes() { return 4 * (2 * kMaxWarps + 1); }

// Dynamic shared memory of a launch: the scratch, and hht when it fits.
int smem_bytes(int k) {
  const long long with_hht = scratch_bytes() + 4LL * k * k;
  return static_cast<int>(with_hht <= kSmemLimit ? with_hht : scratch_bytes());
}

__global__ void __launch_bounds__(kMaxThreads) mu_kernel(
    const float* __restrict__ hg,    // [k, n_tiles * tt]
    const float* __restrict__ cts,   // [n_tiles, tt]
    const int* __restrict__ seg,     // [n_tiles, tt] (pad == d)
    const float* __restrict__ w,     // [n_tiles * d, k]
    const float* __restrict__ hht,   // [k, k]
    int n_tiles, int k, int tt, int d, float eps, int cache_hht,
    float* __restrict__ w_out,       // [n_tiles * d, k]
    float* __restrict__ vals) {      // [n_tiles * tt, k]
  extern __shared__ float smem[];
  int* flag_s = reinterpret_cast<int*>(smem);               // [warps]
  float* val_s = smem + kMaxWarps;                          // [warps]
  int* misc_s = reinterpret_cast<int*>(val_s + kMaxWarps);  // n_tok
  float* hht_s = reinterpret_cast<float*>(misc_s + 1);      // [k, k]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int piece = nthreads * stc::kItems;
  const long long tile = blockIdx.x;
  const long long ld_hg = static_cast<long long>(n_tiles) * tt;
  const int* seg_t = seg + tile * tt;
  const float* cts_t = cts + tile * tt;
  const float* hg_t = hg + tile * tt;
  const float* w_t = w + tile * d * k;
  // the tile's [d, k] rows of the output: xht first, then w_new
  float* xw = w_out + tile * d * k;

  const float* hht_p = hht;
  if (cache_hht) {
    for (int i = tid; i < k * k; i += nthreads) hht_s[i] = hht[i];
    hht_p = hht_s;
  }
  if (tid == 0) {
    // live tokens are a prefix: the first slot with seg >= d ends it
    int lo = 0, hi = tt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (seg_t[mid] < d) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    misc_s[0] = lo;
  }
  for (int i = tid; i < d * k; i += nthreads) xw[i] = 0.0f;
  __syncthreads();
  const int n_tok = misc_s[0];

  // 1. the numerator: per topic, one segmented scan a piece
  for (int p0 = 0; p0 < n_tok; p0 += piece) {
    int sg[stc::kItems];
    float c[stc::kItems];
    bool head[stc::kItems];
    bool tail[stc::kItems];
    const int t0 = p0 + tid * stc::kItems;
#pragma unroll
    for (int i = 0; i < stc::kItems; ++i) {
      const int t = t0 + i;
      sg[i] = t < n_tok ? seg_t[t] : d;
      const int prev = (t > 0 && t - 1 < n_tok) ? seg_t[t - 1] : d;
      const int next = (t + 1 < n_tok) ? seg_t[t + 1] : d;
      head[i] = t == p0 || prev != sg[i];
      tail[i] = t == p0 + piece - 1 || next != sg[i];
      c[i] = sg[i] < d ? cts_t[t] : 0.0f;
    }
    for (int j = 0; j < k; ++j) {
      float v[stc::kItems];
#pragma unroll
      for (int i = 0; i < stc::kItems; ++i) {
        v[i] = sg[i] < d ? hg_t[j * ld_hg + t0 + i] * c[i] : 0.0f;
      }
      stc::block_segmented_scan(v, head, flag_s, val_s);
#pragma unroll
      for (int i = 0; i < stc::kItems; ++i) {
        if (tail[i] && sg[i] < d) xw[sg[i] * k + j] += v[i];
      }
    }
  }
  __syncthreads();

  // 2. the update, for all d slots: w * xht / (w @ hht + eps)
  for (int e = tid; e < d * k; e += nthreads) {
    const int s = e / k;
    const int j = e - s * k;
    float den = 0.0f;
    for (int i = 0; i < k; ++i) den += w_t[s * k + i] * hht_p[i * k + j];
    xw[e] = w_t[e] * xw[e] / (den + eps);
  }
  __syncthreads();

  // 3. the H update's scatter values in token order, pad tokens 0
  float* vals_t = vals + tile * tt * k;
  for (int e = tid; e < tt * k; e += nthreads) {
    const int t = e / k;
    const int j = e - t * k;
    const int s = seg_t[t];
    vals_t[e] = s < d ? cts_t[t] * xw[s * k + j] : 0.0f;
  }
}

}  // namespace

extern "C" int stc_nmf_mu_update_tiles(
    const void* hg, const void* cts, const void* seg, const void* w,
    const void* hht, int n_tiles, int k, int tt, int d, float eps, void* w_out,
    void* vals, void* stream) {
  if (n_tiles < 1 || k < 1 || tt < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(k);
  const int cache_hht = smem > scratch_bytes() ? 1 : 0;
  // one thread per kItems token slots of a piece, a warp multiple
  int threads = tt / stc::kItems;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  threads = (threads / 32) * 32;
  cudaError_t err = cudaFuncSetAttribute(
      mu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mu_kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hg), static_cast<const float*>(cts),
      static_cast<const int*>(seg), static_cast<const float*>(w),
      static_cast<const float*>(hht), n_tiles, k, tt, d, eps, cache_hht,
      static_cast<float*>(w_out), static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}
