// Variational gamma fixed point of the LDA E-step over token-packed tiles.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_packed.py,
//   gamma_fixed_point_tiles (_tiles_kernel).  Per tile of tt token slots
//   and d doc slots:
//     et      = exp(digamma(gamma) - digamma(sum_k gamma))       [d, k]
//     phinorm = sum_k eb[k, t] * et[seg[t], k] + 1e-30           per token
//     gamma  <- alpha + et * sum over the slot's tokens of eb * cts / phinorm
//   until the tile's worst (max over its d slots) mean|delta gamma| over k
//   drops below tol, or at max_inner; at least one iteration when
//   max_inner > 0, and gamma0 as it is when max_inner == 0.  The first
//   iteration moves every slot (pad slots to alpha, their change counted);
//   later ones move only live slots.  The plan (plan_tile_pack) puts a
//   tile's live tokens first, doc-contiguous with seg nondecreasing, and its
//   pad tokens (seg == d, cts == 0) at the end; live doc slots are
//   0..n_act-1.
//
// What bounds it on the H100: the latency of one iteration, not bytes or
// operations.  The online fit's minibatch is 55 tiles of tt=512, d=128,
// k=20 with ~10 docs and ~480 live tokens a tile: a 55-block grid on 132
// SMs in which each tile walks its own serial loop of 5-100 iterations.
// The slab is read from device memory once a launch.
//
// Design: one CTA of up to 16 warps (ops/packed.py tile_warps) a tile.
// - Prologue: one pass over the tile's token slots finds the live prefix
//   (n_tok tokens, n_act slots) and each live slot's token run, and copies
//   eb [k, tt] (row stride tt+1 rounded to 32, so lanes on 32 topics of one
//   token hit 32 banks), cts and seg of live tokens, alpha and gamma0 into
//   shared memory.  Pad slots go to alpha there, once, a thread each; their
//   change enters the first iteration's stop test.
// - Phase 1 of an iteration: warp w owns live tokens [w R, (w+1) R), R a
//   multiple of 32 that covers n_tok with the CTA's warps.  Lanes over
//   tokens compute ratio = cts / phinorm (a token's et is a shared read);
//   then for each doc run inside the warp's range (a piece) lanes over
//   topics sum eb * ratio over the piece's tokens.  Piece (slot s, warp w)
//   writes its k sums to row s + w of a piece table: unique, because slots
//   and warps both grow along the tokens.
// - One barrier.  Phase 2: warp s % W updates live slot s with lanes over
//   topics (a lane loops j = lane + 32m past k = 32): the slot's pieces in
//   warp order, the new gamma, its change and sum by warp shuffles in a
//   fixed order, and the next et.  Each warp writes its worst change.
// - One barrier; every thread reads the W words in order, so the block
//   takes one stop decision.  Two barriers an iteration, where the CUDA
//   kernel this replaced took ~44 (a block-wide segmented scan per topic).
// - Every sum runs in a fixed order and nothing is atomic: results repeat
//   bit for bit.  Where the shared layout does not fit (d or k large), the
//   same code keeps the state in a scratch buffer the wrapper allocates and
//   reads eb, cts and seg from the inputs; no geometry is refused.
// digamma is digamma.cuh's, the TPU kernel's series.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W power limit):
// config C's iteration-5 minibatch (55 tiles, 9 iterations in its slowest)
// 0.036 ms a call, against 0.231 for the kernel this replaced; the fit's
// heaviest launch (100 iterations) 0.33 ms; 0.078 ms a launch over the
// profiled fit (0.550 before).  About 3.3 us an iteration and 4 us of
// prologue, where the byte bound is 0.0007 ms.

#include <cuda_runtime.h>

#include <climits>

#include "digamma.cuh"

namespace {

constexpr int kMaxWarps = 16;
// the H100's opt-in shared memory for one block (227 KB)
constexpr int kSmemLimit = 232448;
constexpr float kPhiEps = 1e-30f;

// Row stride of the shared eb slab: tt rounded up to 32, plus one, so the
// lanes of a warp reading one token of 32 topics hit 32 banks.
__host__ __device__ inline int slab_ld(int tt) { return (tt + 31) / 32 * 32 + 1; }

// The tile's state: gamma and et [d, k], the piece table [d + warps, k],
// ratio [tt] and the slot runs [d + 1].
__host__ __device__ inline long long state_words(int k, int d, int tt, int warps) {
  return 2LL * d * k + static_cast<long long>(d + warps) * k + tt + d + 1;
}

// The shared slab: eb [k, slab_ld], cts and seg [tt], alpha [k].
long long slab_words(int k, int tt) {
  return static_cast<long long>(k) * slab_ld(tt) + 2LL * tt + k;
}

// Each warp's worst change, n_tok and n_act.
long long control_words(int warps) { return warps + 2; }

bool valid(int k, int d, int tt, int warps) {
  return k >= 1 && d >= 1 && tt >= 1 && warps >= 1 && warps <= kMaxWarps &&
         state_words(k, d, tt, warps) < INT_MAX / 4;
}

bool fits_shared(int k, int d, int tt, int warps) {
  return 4 * (control_words(warps) + state_words(k, d, tt, warps) +
              slab_words(k, tt)) <= kSmemLimit;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// kShared: the state and the slab in shared memory; else the state in
// ``scratch`` ([n_tiles, state_words]) and the slab read from the inputs.
template <bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32) tiles_kernel(
    const float* __restrict__ eb,      // [k, n_tiles * tt]
    const float* __restrict__ cts,     // [n_tiles, tt]
    const int* __restrict__ seg,       // [n_tiles, tt] (pad == d)
    const float* __restrict__ alpha,   // [k]
    const float* __restrict__ gamma0,  // [k, n_tiles * d]
    int n_tiles, int k, int tt, int d, int max_inner, float tol,
    float* __restrict__ gamma_out,     // [k, n_tiles * d]
    float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nthreads = blockDim.x;
  const long long tile = blockIdx.x;
  const long long ld_eb = static_cast<long long>(n_tiles) * tt;
  const long long ld_gamma = static_cast<long long>(n_tiles) * d;
  const float* eb_g = eb + tile * tt;
  const float* cts_g = cts + tile * tt;
  const int* seg_g = seg + tile * tt;
  const float* g0 = gamma0 + tile * d;
  float* out = gamma_out + tile * d;

  if (max_inner <= 0) {
    for (int i = threadIdx.x; i < k * d; i += nthreads) {
      const int j = i / d;
      out[j * ld_gamma + (i - j * d)] = g0[j * ld_gamma + (i - j * d)];
    }
    return;
  }

  float* red = smem;                                   // [nw]
  int* misc = reinterpret_cast<int*>(red + nw);        // n_tok, n_act
  float* state;
  if constexpr (kShared) {
    state = reinterpret_cast<float*>(misc + 2);
  } else {
    state = scratch + tile * state_words(k, d, tt, nw);
  }
  float* gam = state;                                  // [d, k]
  float* et = gam + d * k;                             // [d, k]
  float* part = et + d * k;                            // [d + nw, k]
  float* ratio = part + (d + nw) * k;                  // [tt]
  int* start = reinterpret_cast<int*>(ratio + tt);     // [d + 1]
  const float* eb_t = eb_g;
  long long ld = ld_eb;
  const float* cts_t = cts_g;
  const int* seg_t = seg_g;
  const float* alpha_t = alpha;
  float* eb_c = reinterpret_cast<float*>(start + d + 1);  // [k, slab_ld]
  float* cts_c = eb_c + k * slab_ld(tt);                  // [tt]
  int* seg_c = reinterpret_cast<int*>(cts_c + tt);        // [tt]
  float* alpha_c = reinterpret_cast<float*>(seg_c + tt);  // [k]
  if constexpr (kShared) {
    eb_t = eb_c;
    ld = slab_ld(tt);
    cts_t = cts_c;
    seg_t = seg_c;
    alpha_t = alpha_c;
    for (int j = threadIdx.x; j < k; j += nthreads) alpha_c[j] = alpha[j];
  }

  // Prologue, one pass over the token slots: the live prefix ends at the
  // first pad token; a live token whose slot differs from its left
  // neighbour's starts the runs of that slot and of any empty slots
  // before it.
  for (int t = threadIdx.x; t < tt; t += nthreads) {
    const int s = seg_g[t];
    const int prev = t > 0 ? seg_g[t - 1] : -1;
    if (s < d) {
      for (int q = prev + 1; q <= s; ++q) start[q] = t;
      if (t == tt - 1) {
        misc[0] = tt;
        misc[1] = s + 1;
        start[s + 1] = tt;
      }
      if constexpr (kShared) {
        cts_c[t] = cts_g[t];
        seg_c[t] = s;
        for (int j = 0; j < k; ++j) eb_c[j * slab_ld(tt) + t] = eb_g[j * ld_eb + t];
      }
    } else if (t == 0 || prev < d) {
      misc[0] = t;
      misc[1] = prev + 1;
      start[prev + 1] = t;
    }
  }
  for (int i = threadIdx.x; i < k * d; i += nthreads) {
    const int j = i / d;
    const int s = i - j * d;
    gam[s * k + j] = g0[j * ld_gamma + s];
  }
  __syncthreads();
  const int n_tok = misc[0];
  const int n_act = misc[1];

  // live slots: et from gamma0, a warp each, lanes over topics
  for (int s = warp; s < n_act; s += nw) {
    float tot = 0.0f;
    for (int j = lane; j < k; j += 32) tot += gam[s * k + j];
    const float dg = stc::digamma_approx(warp_sum(tot));
    for (int j = lane; j < k; j += 32) {
      et[s * k + j] = expf(stc::digamma_approx(gam[s * k + j]) - dg);
    }
  }
  // pad slots: to alpha, a thread each; the warp's worst change enters the
  // first iteration's stop test
  float pad_worst = 0.0f;
  for (int s = n_act + threadIdx.x; s < d; s += nthreads) {
    float change = 0.0f;
    for (int j = 0; j < k; ++j) {
      change += fabsf(alpha_t[j] - gam[s * k + j]);
      gam[s * k + j] = alpha_t[j];
    }
    pad_worst = fmaxf(pad_worst, change / k);
  }
  pad_worst = warp_max(pad_worst);
  __syncthreads();

  // the warp's live tokens [t_lo, t_hi) and the slots they belong to
  const int per = (n_tok + nw - 1) / nw;
  const int r = per <= 32 ? 32 : (per + 31) / 32 * 32;
  const int t_lo = min(n_tok, warp * r);
  const int t_hi = min(n_tok, t_lo + r);
  const int s_lo = t_lo < t_hi ? seg_t[t_lo] : 0;
  const int s_hi = t_lo < t_hi ? seg_t[t_hi - 1] : -1;

  int it = 0;
  bool go = true;
  while (go) {
    // phase 1: ratio per token (lanes over tokens), then per piece the k
    // sums of eb * ratio (lanes over topics)
    for (int t = t_lo + lane; t < t_hi; t += 32) {
      const float* e = et + seg_t[t] * k;
      float phin = 0.0f;
#pragma unroll 4
      for (int j = 0; j < k; ++j) phin = fmaf(eb_t[j * ld + t], e[j], phin);
      ratio[t] = cts_t[t] / (phin + kPhiEps);
    }
    __syncwarp();
    for (int s = s_lo; s <= s_hi; ++s) {
      const int a = max(t_lo, start[s]);
      const int b = min(t_hi, start[s + 1]);
      if (a >= b) continue;                    // an empty slot
      for (int j = lane; j < k; j += 32) {
        const float* e = eb_t + j * ld;
        float acc = 0.0f;
#pragma unroll 4
        for (int t = a; t < b; ++t) acc = fmaf(e[t], ratio[t], acc);
        part[(s + warp) * k + j] = acc;
      }
    }
    __syncthreads();

    // phase 2: a warp per live slot, lanes over topics
    float worst_w = it == 0 ? pad_worst : 0.0f;
    for (int s = warp; s < n_act; s += nw) {
      const int a = start[s];
      const int b = start[s + 1];
      const int w0 = a / r;
      const int w1 = a < b ? (b - 1) / r : w0 - 1;
      float tot = 0.0f;
      float change = 0.0f;
      for (int j = lane; j < k; j += 32) {
        float sum = 0.0f;
        for (int w = w0; w <= w1; ++w) sum += part[(s + w) * k + j];
        const float g_new = alpha_t[j] + et[s * k + j] * sum;
        change += fabsf(g_new - gam[s * k + j]);
        tot += g_new;
        gam[s * k + j] = g_new;
      }
      change = warp_sum(change);
      const float dg = stc::digamma_approx(warp_sum(tot));
      for (int j = lane; j < k; j += 32) {
        et[s * k + j] = expf(stc::digamma_approx(gam[s * k + j]) - dg);
      }
      worst_w = fmaxf(worst_w, change / k);
    }
    if (lane == 0) red[warp] = worst_w;
    __syncthreads();
    float worst = red[0];
    for (int u = 1; u < nw; ++u) worst = fmaxf(worst, red[u]);
    ++it;
    go = it < max_inner && worst >= tol;
  }

  // the loop ended on a barrier after the last update
  for (int i = threadIdx.x; i < k * d; i += nthreads) {
    const int j = i / d;
    const int s = i - j * d;
    out[j * ld_gamma + s] = gam[s * k + j];
  }
}

cudaError_t set_attributes() {
  return cudaFuncSetAttribute(tiles_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit);
}

}  // namespace

// The gate: dynamic shared memory a launch at (k, d, tt) with ``warps``
// warps uses (the whole layout where it fits, else the control words), or
// 0 for a geometry the kernel refuses (k, d, tt < 1, warps outside 1..16).
extern "C" int stc_tiles_smem_bytes(int k, int d, int tt, int warps) {
  if (!valid(k, d, tt, warps)) return 0;
  if (fits_shared(k, d, tt, warps)) {
    return static_cast<int>(4 * (control_words(warps) + state_words(k, d, tt, warps) +
                                 slab_words(k, tt)));
  }
  return static_cast<int>(4 * control_words(warps));
}

// Scratch floats a tile needs: 0 where the state fits shared memory.
extern "C" int stc_tiles_scratch_floats(int k, int d, int tt, int warps) {
  if (!valid(k, d, tt, warps) || fits_shared(k, d, tt, warps)) return 0;
  return static_cast<int>(state_words(k, d, tt, warps));
}

extern "C" int stc_gamma_fixed_point_tiles(
    const void* eb, const void* cts, const void* seg, const void* alpha,
    const void* gamma0, int n_tiles, int k, int tt, int d, int max_inner,
    int warps, float tol, void* out, void* scratch, void* stream) {
  const int smem = stc_tiles_smem_bytes(k, d, tt, warps);
  const bool shared = smem > 0 && fits_shared(k, d, tt, warps);
  if (smem == 0 || n_tiles < 1 || (!shared && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once: the most shared memory a launch asks (no attribute call lands
  // inside a graph capture)
  static const cudaError_t attr = set_attributes();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    tiles_kernel<true><<<n_tiles, warps * 32, smem, s>>>(
        static_cast<const float*>(eb), static_cast<const float*>(cts),
        static_cast<const int*>(seg), static_cast<const float*>(alpha),
        static_cast<const float*>(gamma0), n_tiles, k, tt, d, max_inner, tol,
        static_cast<float*>(out), nullptr);
  } else {
    tiles_kernel<false><<<n_tiles, warps * 32, smem, s>>>(
        static_cast<const float*>(eb), static_cast<const float*>(cts),
        static_cast<const int*>(seg), static_cast<const float*>(alpha),
        static_cast<const float*>(gamma0), n_tiles, k, tt, d, max_inner, tol,
        static_cast<float*>(out), static_cast<float*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}
