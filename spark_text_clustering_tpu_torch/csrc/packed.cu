// Variational gamma fixed point of the LDA E-step over token-packed tiles.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_packed.py,
//   gamma_fixed_point_tiles (_tiles_kernel).  Per tile of tt token slots
//   and d doc slots:
//     et      = exp(digamma(gamma) - digamma(sum_k gamma))       [k, d]
//     phinorm = sum_k eb[:, t] * et[:, seg[t]] + 1e-30           per token
//     gamma  <- alpha + et * sum over the slot's tokens of eb * cts / phinorm
//   until the tile's worst (max over its d slots) mean|delta gamma| over k
//   drops below tol, or at max_inner; at least one iteration.  The plan
//   (plan_tile_pack) puts a tile's live tokens first, doc-contiguous with
//   seg nondecreasing, and its pad tokens (seg == d, cts == 0) at the end;
//   live doc slots are 0..n_live-1.
//
// What bounds it on the H100: neither memory nor arithmetic.  The main
// path's minibatch is 56 tiles of tt=512, k=20 (~10 live docs a tile): a
// 56-block grid on 132 SMs, each block walking its serial iteration loop
// (20 segmented scans a pass).  Latency and occupancy, not bytes: the
// tile's eb slab is read from device memory once.
//
// Design: the TPU kernel built a [d, tt] one-hot and ran both segment
// operations as MXU matmuls, because Mosaic has no gather or scatter.
// Here one block owns one tile and keeps gamma, exp(E[log theta]) and the
// per-slot sums ([k, d] each) in shared memory, and the tile's live
// eb [k, tt], cts and seg there too when they fit (the TPU kept eb in
// VMEM), else re-reads them from global memory every iteration.  The
// gather et[:, seg[t]] is a shared-memory read.  The per-slot sum is a
// block-wide segmented scan over each doc's contiguous token run
// (segscan.cuh): the run's last slot adds its total, so each slot has one
// writer per piece and no atomics are used; results repeat bit for bit.
// Pad slots get alpha in the first iteration (their sum is 0) and are
// left out of digamma/exp and of the update after it, where JAX's change
// on them is exactly 0.  digamma is digamma.cuh's, the TPU kernel's
// series.

#include <cuda_runtime.h>

#include "digamma.cuh"
#include "segscan.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
// the H100's opt-in shared memory for one block (227 KB)
constexpr int kSmemLimit = 232448;
// the plan's doc-slot floor: the largest k is the one whose [k, d] state
// fits at this d
constexpr int kMinTileDocs = 128;

// gamma, et, the per-slot sums [k, d] each; scan flags and values and the
// max-reduction scratch (one entry a warp each); n_tok and n_act
int state_bytes(int k, int d) {
  return 4 * (3 * k * d + 3 * kMaxWarps + 2);
}

// the tile's live eb [k, tt], cts [tt] and seg [tt]
int slab_bytes(int k, int tt) { return 4 * (k + 2) * tt; }

int max_k() {
  return (kSmemLimit / 4 - 3 * kMaxWarps - 2) / (3 * kMinTileDocs);
}

// Dynamic shared memory of a launch (with the slab when it fits), or 0
// for a geometry the kernel refuses.
int smem_bytes(int k, int d, int tt) {
  if (k < 1 || k > max_k() || d < 1 || tt < 1) return 0;
  const long long base = state_bytes(k, d);
  if (base > kSmemLimit) return 0;
  const long long cached = base + slab_bytes(k, tt);
  return static_cast<int>(cached <= kSmemLimit ? cached : base);
}

// Max of v over the block; every thread gets it.  Ends with
// __syncthreads(), so red_s can be reused at once.
__device__ __forceinline__ float block_max(float v, float* red_s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  float m = red_s[0];
  for (int u = 1; u < static_cast<int>(blockDim.x >> 5); ++u) {
    m = fmaxf(m, red_s[u]);
  }
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kMaxThreads) tiles_kernel(
    const float* __restrict__ eb,      // [k, n_tiles * tt]
    const float* __restrict__ cts,     // [n_tiles, tt]
    const int* __restrict__ seg,       // [n_tiles, tt] (pad == d)
    const float* __restrict__ alpha,   // [k]
    const float* __restrict__ gamma0,  // [k, n_tiles * d]
    int n_tiles, int k, int tt, int d, int max_inner, float tol, int cache,
    float* __restrict__ gamma_out) {   // [k, n_tiles * d]
  extern __shared__ float smem[];
  float* gamma_s = smem;                          // [k, d]
  float* et_s = gamma_s + k * d;                  // [k, d]
  float* sum_s = et_s + k * d;                    // [k, d]
  int* flag_s = reinterpret_cast<int*>(sum_s + k * d);       // [warps]
  float* val_s = reinterpret_cast<float*>(flag_s + kMaxWarps);
  float* red_s = val_s + kMaxWarps;               // [warps]
  int* misc_s = reinterpret_cast<int*>(red_s + kMaxWarps);   // n_tok, n_act
  float* slab = reinterpret_cast<float*>(misc_s + 2);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int piece = nthreads * stc::kItems;
  const long long tile = blockIdx.x;
  const long long ld_eb = static_cast<long long>(n_tiles) * tt;
  const long long ld_gamma = static_cast<long long>(n_tiles) * d;

  for (int i = tid; i < k * d; i += nthreads) {
    const int j = i / d;
    gamma_s[i] = gamma0[j * ld_gamma + tile * d + (i - j * d)];
  }
  const int* seg_g = seg + tile * tt;
  const float* cts_g = cts + tile * tt;
  if (tid == 0) {
    // live tokens are a prefix: the first slot with seg == d ends it
    int lo = 0, hi = tt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (seg_g[mid] < d) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    misc_s[0] = lo;
    misc_s[1] = lo > 0 ? seg_g[lo - 1] + 1 : 0;
  }
  __syncthreads();
  const int n_tok = misc_s[0];
  const int n_act = misc_s[1];

  // the tile's live slab: shared memory when it fits, else global
  const float* eb_t = eb + tile * tt;
  long long ld = ld_eb;
  const float* cts_t = cts_g;
  const int* seg_t = seg_g;
  if (cache) {
    float* eb_c = slab;
    float* cts_c = eb_c + k * tt;
    int* seg_c = reinterpret_cast<int*>(cts_c + tt);
    for (int j = 0; j < k; ++j) {
      for (int t = tid; t < n_tok; t += nthreads) {
        eb_c[j * tt + t] = eb_t[j * ld_eb + t];
      }
    }
    for (int t = tid; t < n_tok; t += nthreads) {
      cts_c[t] = cts_g[t];
      seg_c[t] = seg_g[t];
    }
    eb_t = eb_c;
    ld = tt;
    cts_t = cts_c;
    seg_t = seg_c;
    __syncthreads();
  }

  int it = 0;
  bool go = max_inner > 0;
  while (go) {
    // slots in play: all d in the first iteration (pad slots go to
    // alpha), the live ones after it
    const int ns = it == 0 ? d : n_act;
    for (int s = tid; s < ns; s += nthreads) {
      float tot = 0.0f;
      for (int j = 0; j < k; ++j) tot += gamma_s[j * d + s];
      const float dg_tot = stc::digamma_approx(tot);
      for (int j = 0; j < k; ++j) {
        et_s[j * d + s] = expf(stc::digamma_approx(gamma_s[j * d + s]) - dg_tot);
        sum_s[j * d + s] = 0.0f;
      }
    }
    __syncthreads();

    for (int p0 = 0; p0 < n_tok; p0 += piece) {
      int sg[stc::kItems];
      float ratio[stc::kItems];
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
        ratio[i] = 0.0f;
        if (sg[i] < d) {
          float phin = 0.0f;
          for (int j = 0; j < k; ++j) {
            phin += eb_t[j * ld + t] * et_s[j * d + sg[i]];
          }
          ratio[i] = cts_t[t] / (phin + 1e-30f);
        }
      }
      for (int j = 0; j < k; ++j) {
        float v[stc::kItems];
#pragma unroll
        for (int i = 0; i < stc::kItems; ++i) {
          v[i] = sg[i] < d ? eb_t[j * ld + t0 + i] * ratio[i] : 0.0f;
        }
        stc::block_segmented_scan(v, head, flag_s, val_s);
#pragma unroll
        for (int i = 0; i < stc::kItems; ++i) {
          if (tail[i] && sg[i] < d) sum_s[j * d + sg[i]] += v[i];
        }
      }
    }
    __syncthreads();

    float worst = 0.0f;
    for (int s = tid; s < ns; s += nthreads) {
      float change = 0.0f;
      for (int j = 0; j < k; ++j) {
        const float g_new = alpha[j] + et_s[j * d + s] * sum_s[j * d + s];
        change += fabsf(g_new - gamma_s[j * d + s]);
        gamma_s[j * d + s] = g_new;
      }
      worst = fmaxf(worst, change / k);
    }
    worst = block_max(worst, red_s);
    ++it;
    go = it < max_inner && worst >= tol;
  }

  for (int i = tid; i < k * d; i += nthreads) {
    const int j = i / d;
    gamma_out[j * ld_gamma + tile * d + (i - j * d)] = gamma_s[i];
  }
}

}  // namespace

// Largest k the kernel takes: its [k, d] state must fit shared memory at
// the plan's smallest d.
extern "C" int stc_tiles_max_k() { return max_k(); }

// The gate: dynamic shared memory a launch at (k, d, tt) uses, or 0 when
// the kernel refuses the geometry.
extern "C" int stc_tiles_smem_bytes(int k, int d, int tt) {
  return smem_bytes(k, d, tt);
}

extern "C" int stc_gamma_fixed_point_tiles(
    const void* eb, const void* cts, const void* seg, const void* alpha,
    const void* gamma0, int n_tiles, int k, int tt, int d, int max_inner,
    float tol, void* out, void* stream) {
  const int smem = smem_bytes(k, d, tt);
  if (smem == 0 || n_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cache = smem > state_bytes(k, d) ? 1 : 0;
  // one thread per kItems token slots of a piece, a warp multiple
  int threads = tt / stc::kItems;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  threads = (threads / 32) * 32;
  cudaError_t err = cudaFuncSetAttribute(
      tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tiles_kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(eb), static_cast<const float*>(cts),
      static_cast<const int*>(seg), static_cast<const float*>(alpha),
      static_cast<const float*>(gamma0), n_tiles, k, tt, d, max_inner, tol,
      cache, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
