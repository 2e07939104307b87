// Variational gamma fixed point of the LDA E-step, padded [B, k, L] layout.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_estep.py,
//   gamma_fixed_point_pallas_bkl (_estep_kernel, inline digamma_approx).
//   Per doc:  gamma <- alpha + exp(E[log theta]) * sum_l eb[:, l] * cts[l]
//                                                 / phinorm[l],
//   phinorm[l] = sum_j eb[j, l] * exp(E[log theta])_j + 1e-30.  A tile of
//   tile_b docs stops when its worst mean|delta gamma| < tol, or at
//   max_inner.  The batch is padded to a tile multiple with empty docs
//   (cts = 0, gamma0 = 1), exactly as the TPU wrapper pads it, so the
//   stop rule of the last tile sees the same docs.
//
// What bounds it on the H100, on the buckets the main path makes: not
// device memory.  Every inner iteration reads the eb values of the
// tile's live slots (2 flops a value for phinorm, 2 for the update).
// The 20NG shape's most populated bucket, [4652, 20, 64], is a 24 MB
// slab that stays in the 50 MB L2 across iterations.  The EN books
// buckets are wide and sparsely populated ([12-22, 5, 16384-32768]):
// 2-3 tiles, so 2-3 blocks on 132 SMs, and the time is that of a few
// blocks walking their serial iteration loop (occupancy and latency).
//
// Design: the TPU kernel pinned a [tile_b, k, L] block in VMEM for the
// whole loop.  Here one thread block owns one tile and gives each of its
// docs a group of threads; a thread keeps the k values of one slot in
// registers, so the slab is read once per iteration, and the per-doc sums
// are reduced with warp shuffles and then across the group's warps in a
// fixed order (deterministic).  The slab streams from L2 / device memory
// every iteration: keeping a tile's slab in shared memory where it fits
// (tile_b*k*L*4 <= 160 KB) measured no faster on the 20NG buckets, whose
// slabs are L2-resident anyway (PERF.md).  The stop decision is taken
// once per iteration by the block.  digamma is the same six-step
// recurrence and asymptotic series as the TPU kernel (digamma.cuh).

#include <cuda_runtime.h>

#include "digamma.cuh"

namespace {

using stc::digamma_approx;

// A block holds one tile; at up to 252 registers a thread (KMAX=64) the
// SM's 65,536 registers cap the block at 256 threads.
constexpr int kMaxThreads = 256;
constexpr int kMaxTileB = kMaxThreads / 32;

// KMAX: registers a thread keeps for one slot's k values (k <= KMAX).
template <int KMAX>
__global__ void __launch_bounds__(kMaxThreads) estep_kernel(
    const float* __restrict__ eb,      // [B, k, L]
    const float* __restrict__ cts,     // [B, L]
    const float* __restrict__ alpha,   // [k]
    const float* __restrict__ gamma0,  // [B, k]
    int b, int k, int l, int tile_b, int group, int max_inner, float tol,
    float* __restrict__ gamma_out) {   // [B, k]
  extern __shared__ float smem[];
  const int warps_per_doc = group >> 5;
  float* gamma_s = smem;                           // [tile_b, k]
  float* et_s = gamma_s + tile_b * k;              // [tile_b, k]
  float* part_s = et_s + tile_b * k;               // [tile_b, warps, k]
  float* change_s = part_s + tile_b * warps_per_doc * k;  // [tile_b]
  int* go_s = reinterpret_cast<int*>(change_s + tile_b);

  const int t = threadIdx.x / group;       // doc of the tile
  const int r = threadIdx.x - t * group;   // thread within the doc group
  const int lane = threadIdx.x & 31;
  const int wg = r >> 5;                   // warp within the doc group
  const int d = blockIdx.x * tile_b + t;   // global doc (>= b: pad doc)
  const bool real = d < b;

  for (int i = threadIdx.x; i < tile_b * k; i += blockDim.x) {
    const int dd = blockIdx.x * tile_b + i / k;
    gamma_s[i] = dd < b ? gamma0[static_cast<long long>(dd) * k + i % k]
                        : 1.0f;
  }
  if (threadIdx.x == 0) *go_s = max_inner > 0 ? 1 : 0;
  __syncthreads();

  const float* eb_d = eb + static_cast<long long>(real ? d : 0) * k * l;
  const float* cts_d = cts + static_cast<long long>(real ? d : 0) * l;
  int it = 0;
  while (*go_s) {
    // exp(E[log theta]) of each doc, one thread per doc
    if (r == 0) {
      float tot = 0.0f;
      for (int j = 0; j < k; ++j) tot += gamma_s[t * k + j];
      const float dg_tot = digamma_approx(tot);
      for (int j = 0; j < k; ++j) {
        et_s[t * k + j] = expf(digamma_approx(gamma_s[t * k + j]) - dg_tot);
      }
    }
    __syncthreads();
    float acc[KMAX];
    float et[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      acc[j] = 0.0f;
      et[j] = j < k ? et_s[t * k + j] : 0.0f;
    }
    if (real) {
      for (int s = r; s < l; s += group) {
        const float c = cts_d[s];
        if (c == 0.0f) continue;  // a pad slot adds exactly 0
        float e[KMAX];
        float phin = 0.0f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          e[j] = j < k ? eb_d[static_cast<long long>(j) * l + s] : 0.0f;
          phin += e[j] * et[j];
        }
        const float ratio = c / (phin + 1e-30f);
#pragma unroll
        for (int j = 0; j < KMAX; ++j) acc[j] += e[j] * ratio;
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        float v = acc[j];
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) part_s[(t * warps_per_doc + wg) * k + j] = v;
      }
    }
    __syncthreads();
    // gamma update and this doc's mean |delta|, one thread per doc
    if (r == 0) {
      float change = 0.0f;
      for (int j = 0; j < k; ++j) {
        float s = 0.0f;
        for (int w = 0; w < warps_per_doc; ++w) {
          s += part_s[(t * warps_per_doc + w) * k + j];
        }
        const float g_new = alpha[j] + et_s[t * k + j] * s;
        change += fabsf(g_new - gamma_s[t * k + j]);
        gamma_s[t * k + j] = g_new;
      }
      change_s[t] = change / k;
    }
    __syncthreads();
    ++it;
    if (threadIdx.x == 0) {
      float worst = 0.0f;
      for (int u = 0; u < tile_b; ++u) worst = fmaxf(worst, change_s[u]);
      *go_s = (it < max_inner && worst >= tol) ? 1 : 0;
    }
    __syncthreads();
  }
  if (real) {
    for (int j = r; j < k; j += group) {
      gamma_out[static_cast<long long>(d) * k + j] = gamma_s[t * k + j];
    }
  }
}

template <int KMAX>
int launch(const float* eb, const float* cts, const float* alpha,
           const float* gamma0, int b, int k, int l, int tile_b, int group,
           int max_inner, float tol, float* out, cudaStream_t stream) {
  const int warps_per_doc = group / 32;
  const int smem =
      4 * (2 * tile_b * k + tile_b * warps_per_doc * k + tile_b + 1);
  cudaError_t err = cudaFuncSetAttribute(
      estep_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (b + tile_b - 1) / tile_b;
  estep_kernel<KMAX><<<n_tiles, tile_b * group, smem, stream>>>(
      eb, cts, alpha, gamma0, b, k, l, tile_b, group, max_inner, tol, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest k the kernel takes (a thread keeps k values in registers).
extern "C" int stc_estep_max_k() { return 64; }

// Largest tile_b the kernel takes (one block per tile).
extern "C" int stc_estep_max_tile_b() { return kMaxTileB; }

extern "C" int stc_gamma_fixed_point_bkl(
    const void* eb, const void* cts, const void* alpha, const void* gamma0,
    int b, int k, int l, int tile_b, int max_inner, float tol, void* out,
    void* stream) {
  if (k < 1 || k > 64 || tile_b < 1 || tile_b > kMaxTileB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // threads per doc: a warp multiple, tile_b * group <= kMaxThreads
  const int group = (kMaxThreads / tile_b / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(eb);
  const float* c = static_cast<const float*>(cts);
  const float* a = static_cast<const float*>(alpha);
  const float* g = static_cast<const float*>(gamma0);
  float* o = static_cast<float*>(out);
  if (k <= 8) return launch<8>(e, c, a, g, b, k, l, tile_b, group, max_inner, tol, o, s);
  if (k <= 32) return launch<32>(e, c, a, g, b, k, l, tile_b, group, max_inner, tol, o, s);
  return launch<64>(e, c, a, g, b, k, l, tile_b, group, max_inner, tol, o, s);
}
