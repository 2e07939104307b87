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
//   cts == 0) at the end; live doc slots are 0..n_act-1.  A slot no token
//   reaches (a pad slot, or a doc the plan left without tokens) is written
//   as exactly 0 without reading W: that is w * 0 / (den + eps), what the
//   function gives for the finite, non-negative W and H that NMF holds.
//
// What bounds it on the H100: bytes.  Per live token it reads hg's k
// values, cts and seg and writes k vals; per live slot it reads and writes
// a W row: ~90 MB a sweep on the 20NG shape (k=20), ~27 us at 3.35 TB/s.
// The output also holds the pad slots' zero rows and the pad tokens' zero
// vals, and the prologue copies pad tokens' hg: more than the bound
// counts.  The arithmetic (~2k a token, ~2k^2 a slot) is far below that.
//
// Design: one CTA of ops/packed.py tile_warps(tt) warps (16 at tt=512) a
// tile, three barriers a tile whatever k is, no atomics.  The TPU kernel
// built a [d, tt] one-hot and ran both segment sums as MXU matmuls,
// because Mosaic has no gather or scatter; none of that is kept.
// - Prologue: every read of device memory is issued at once, as cp.async
//   copies into shared memory that hold no registers: H H^T, W's first 32
//   rows (live slots are a prefix, and D's tiles hold ~10 docs), and each
//   token slot's hg column and cts into a slab [k, tt] (row stride tt+1
//   rounded to 32, so lanes on 32 topics of one token hit 32 banks).
//   Meanwhile one pass over seg finds the live prefix (n_tok tokens, n_act
//   slots) and each slot's token run, and copies W's row of any later slot
//   that has tokens.  So a tile waits for device memory about once.
// - Barrier.  The numerator: warp w owns live tokens [w R, (w+1) R), R a
//   multiple of 32 that covers n_tok with the CTA's warps (ops/packed.py
//   tile_work).  For each doc run inside the range (a piece), lanes over
//   topics sum hg * cts over the piece's tokens in token order and write
//   the k sums to row slot + w of a piece table: unique, because slots and
//   warps both grow along the tokens.  Rows of w_new past the live slots
//   are zero-filled here.
// - Barrier.  The update: warp s % W owns live slot s, lanes over topics
//   (a lane loops j = lane + 32m past k = 32): the slot's pieces in warp
//   order, den = sum_i w[s, i] hht[i, j] in i order, and w_new's row to
//   the output and to shared memory, over the slab, which is dead by then.
// - Barrier.  vals [tt, k]: consecutive threads write consecutive words
//   (float4s where k % 4 == 0), the (token, topic) of each stepped without
//   a divide; w_new's row, cts and seg come from shared memory, and pad
//   tokens get 0.
// Every sum has a fixed order and nothing is atomic: results repeat bit
// for bit.  Where the layout does not fit shared memory (d = 2048; k =
// 300), the same code keeps the piece table in a scratch buffer the
// wrapper allocates, reads hg, cts, seg and W from the inputs, and reads
// w_new back from the output; H H^T stays in global memory where it does
// not fit either.  No geometry is refused.  The kernel this replaced ran a
// block-wide segmented scan per topic (two barriers each, ~41 a tile at
// k=20) and summed xht in device memory.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W power limit):
// D's shape (1,101 tiles of tt=512, d=128; k=20) 0.0445-0.0453 ms of
// device time by graph replay, 1.65-1.68x the 0.0270 ms byte bound, 3 CTAs
// an SM at 40 registers; the kernel this replaced took 0.113-0.116 ms a
// call.  Word-at-a-time vals stores instead of float4: 0.049-0.050 ms.
// A call timed by CUDA events reads 0.046-0.061 ms: the wrapper's host
// cost (0.033-0.082 ms a call) sets it, not the card.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 16;
// the H100's opt-in shared memory for one block (227 KB)
constexpr int kSmemLimit = 232448;
// n_tok and n_act
constexpr int kControlWords = 2;
// W rows copied before seg is read: live slots are a prefix of the tile's
// slots, and the main path's tiles hold ~10 docs
constexpr int kEarlySlots = 32;

// Row stride of the shared hg slab: tt rounded up to 32, plus one, so the
// lanes of a warp reading one token of 32 topics hit 32 banks.
__host__ __device__ inline int slab_ld(int tt) { return (tt + 31) / 32 * 32 + 1; }

// The tile's state: the slot runs [d + 1] and the piece table [d + warps, k].
__host__ __device__ inline long long state_words(int k, int d, int warps) {
  return (d + 1) + static_cast<long long>(d + warps) * k;
}

// Shared layout: control, H H^T [k, k], the state, then from a multiple of
// four words the copy of W's rows [d, k], the slab room, cts and seg [tt].
__host__ __device__ inline long long wcopy_offset(int k, int d, int warps) {
  return (kControlWords + static_cast<long long>(k) * k +
          state_words(k, d, warps) + 3) / 4 * 4;
}

// The room of the hg slab [k, slab_ld], which w_new [d, k] takes after the
// numerator.
__host__ __device__ inline long long slab_room(int k, int d, int tt) {
  const long long slab = static_cast<long long>(k) * slab_ld(tt);
  const long long wnew = static_cast<long long>(d) * k;
  return slab > wnew ? slab : wnew;
}

long long shared_words(int k, int d, int tt, int warps) {
  return wcopy_offset(k, d, warps) + static_cast<long long>(d) * k +
         slab_room(k, d, tt) + 2LL * tt;
}

bool valid(int k, int d, int tt, int warps) {
  return k >= 1 && d >= 1 && tt >= 1 && warps >= 1 && warps <= kMaxWarps &&
         state_words(k, d, warps) < INT_MAX / 4 &&
         slab_room(k, d, tt) < INT_MAX / 4 &&
         static_cast<long long>(tt) * k < INT_MAX / 4;
}

bool fits_shared(int k, int d, int tt, int warps) {
  return 4 * shared_words(k, d, tt, warps) <= kSmemLimit;
}

// H H^T is cached in shared memory wherever it fits.
bool caches_hht(int k, int d, int tt, int warps) {
  return fits_shared(k, d, tt, warps) ||
         4 * (kControlWords + static_cast<long long>(k) * k) <= kSmemLimit;
}

// A 4-byte copy from device memory to shared memory that does not wait for
// its data (cp.async); wait_copies() waits for all of the thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// kShared: the state, W's live rows, the slab, cts and seg in shared
// memory; else the state in ``scratch`` ([n_tiles, state_words]), hg, cts,
// seg and W read from the inputs and w_new from the output.  vec4: k % 4
// == 0 and 16-byte aligned outputs, so vals and the pad rows of w_new go
// out as float4.  Three CTAs of the shared layout at D's shape share an SM
// (69 KB of shared memory each) if a thread keeps to 40 registers.
template <bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32, kShared ? 3 : 1) mu_kernel(
    const float* __restrict__ hg,    // [k, n_tiles * tt]
    const float* __restrict__ cts,   // [n_tiles, tt]
    const int* __restrict__ seg,     // [n_tiles, tt] (pad == d)
    const float* __restrict__ w,     // [n_tiles * d, k]
    const float* __restrict__ hht,   // [k, k]
    int n_tiles, int k, int tt, int d, float eps, int cache_hht, int vec4,
    float* __restrict__ w_out,       // [n_tiles * d, k]
    float* __restrict__ vals,        // [n_tiles * tt, k]
    float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int nthreads = blockDim.x;
  const long long tile = blockIdx.x;
  const long long ld_hg = static_cast<long long>(n_tiles) * tt;
  const float* hg_g = hg + tile * tt;
  const float* cts_g = cts + tile * tt;
  const int* seg_g = seg + tile * tt;
  const float* w_t = w + tile * d * k;
  float* wo_t = w_out + tile * d * k;
  float* vals_t = vals + tile * tt * k;

  int* misc = reinterpret_cast<int*>(smem);                 // n_tok, n_act
  float* hht_s = smem + kControlWords;                      // [k, k]
  float* state;
  if constexpr (kShared) {
    state = hht_s + k * k;
  } else {
    state = scratch + tile * state_words(k, d, nw);
  }
  int* start = reinterpret_cast<int*>(state);               // [d + 1]
  float* part = state + d + 1;                              // [d + nw, k]
  const float* w_src = w_t;                                 // [d, k]
  const float* hg_t = hg_g;
  long long ld = ld_hg;
  const float* cts_t = cts_g;
  const int* seg_t = seg_g;
  float* wnew = wo_t;                                       // [d, k]
  float* wcopy = nullptr;                                   // [d, k]
  float* slab = nullptr;                                    // [k, slab_ld]
  float* cts_c = nullptr;                                   // [tt]
  int* seg_c = nullptr;                                     // [tt]
  if constexpr (kShared) {
    wcopy = smem + wcopy_offset(k, d, nw);
    slab = wcopy + d * k;
    cts_c = slab + slab_room(k, d, tt);
    seg_c = reinterpret_cast<int*>(cts_c + tt);
    w_src = wcopy;
    hg_t = slab;
    ld = slab_ld(tt);
    cts_t = cts_c;
    seg_t = seg_c;
    wnew = slab;
  }
  const float* hht_p = cache_hht ? hht_s : hht;

  // Prologue.  Every read of device memory the tile needs is issued here,
  // at once, as copies into shared memory: H H^T; W's first kEarlySlots
  // rows and every token slot's hg column and cts (a pad token's or a pad
  // slot's copy costs less than waiting for seg first); and, once seg is
  // in, W's row of each later slot that has tokens.
  if (cache_hht) {
    for (int i = tid; i < k * k; i += nthreads) copy_async(&hht_s[i], &hht[i]);
  }
  if constexpr (kShared) {
    const int early = min(d, kEarlySlots) * k;
    for (int e = tid; e < early; e += nthreads) copy_async(&wcopy[e], &w_t[e]);
    for (int t = tid; t < tt; t += nthreads) {
      for (int j = 0; j < k; ++j) {
        copy_async(&slab[j * ld + t], &hg_g[j * ld_hg + t]);
      }
      copy_async(&cts_c[t], &cts_g[t]);
    }
  }
  // The live prefix ends at the first pad token; a live token whose slot
  // differs from its left neighbour's starts the runs of that slot and of
  // any empty slots before it.
  for (int t = tid; t < tt; t += nthreads) {
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
        seg_c[t] = s;
        if (s != prev && s >= kEarlySlots) {
          for (int i = 0; i < k; ++i) copy_async(&wcopy[s * k + i], &w_t[s * k + i]);
        }
      }
    } else if (t == 0 || prev < d) {
      misc[0] = t;
      misc[1] = prev + 1;
      start[prev + 1] = t;
    }
  }
  wait_copies();
  __syncthreads();
  const int n_tok = misc[0];
  const int n_act = misc[1];

  // rows of w_new past the live slots: pad slots, exactly 0
  if (vec4) {
    float4* wo4 = reinterpret_cast<float4*>(wo_t);
    for (int e = (n_act * k >> 2) + tid; e < (d * k >> 2); e += nthreads) {
      wo4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = n_act * k + tid; e < d * k; e += nthreads) wo_t[e] = 0.0f;
  }

  // The numerator: the warp's live tokens [t_lo, t_hi), a piece per doc
  // run inside them, lanes over topics; piece (s, warp) -> row s + warp.
  const int per = (n_tok + nw - 1) / nw;
  const int r = per <= 32 ? 32 : (per + 31) / 32 * 32;
  const int t_lo = min(n_tok, warp * r);
  const int t_hi = min(n_tok, t_lo + r);
  if (t_lo < t_hi) {
    const int s_lo = seg_t[t_lo];
    const int s_hi = seg_t[t_hi - 1];
    for (int s = s_lo; s <= s_hi; ++s) {
      const int a = max(t_lo, start[s]);
      const int b = min(t_hi, start[s + 1]);
      if (a >= b) continue;                    // an empty slot
      for (int j = lane; j < k; j += 32) {
        const float* h = hg_t + j * ld;
        float acc = 0.0f;
#pragma unroll 4
        for (int t = a; t < b; ++t) acc = fmaf(h[t], cts_t[t], acc);
        part[(s + warp) * k + j] = acc;
      }
    }
  }
  __syncthreads();

  // The update: a warp per live slot, lanes over topics.
  for (int s = warp; s < n_act; s += nw) {
    const int a = start[s];
    const int b = start[s + 1];
    if (a == b) {                              // no token reaches it
      for (int j = lane; j < k; j += 32) wo_t[s * k + j] = 0.0f;
      continue;
    }
    const int w0 = a / r;
    const int w1 = (b - 1) / r;
    const float* ws = w_src + s * k;
    for (int j = lane; j < k; j += 32) {
      float num = 0.0f;
      for (int u = w0; u <= w1; ++u) num += part[(s + u) * k + j];
      float den = 0.0f;
#pragma unroll 4
      for (int i = 0; i < k; ++i) den = fmaf(ws[i], hht_p[i * k + j], den);
      const float wn = ws[j] * num / (den + eps);
      wnew[s * k + j] = wn;
      if constexpr (kShared) wo_t[s * k + j] = wn;
    }
  }
  __syncthreads();

  // vals [tt, k] in token order, pad tokens 0: thread i writes words (or
  // float4s) i, i + nthreads, ...; the (token, topic) of each is stepped
  // without a divide.
  if (vec4) {
    const int k4 = k >> 2;
    const float4* wn4 = reinterpret_cast<const float4*>(wnew);
    float4* v4 = reinterpret_cast<float4*>(vals_t);
    const int step_t = nthreads / k4;
    const int step_q = nthreads - step_t * k4;
    int t = tid / k4;
    int q = tid - t * k4;
    for (int e = tid; e < tt * k4; e += nthreads) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t < n_tok) {
        const float c = cts_t[t];
        const float4 x = wn4[seg_t[t] * k4 + q];
        v = make_float4(c * x.x, c * x.y, c * x.z, c * x.w);
      }
      v4[e] = v;
      t += step_t;
      q += step_q;
      if (q >= k4) {
        q -= k4;
        ++t;
      }
    }
  } else {
    const int step_t = nthreads / k;
    const int step_j = nthreads - step_t * k;
    int t = tid / k;
    int j = tid - t * k;
    for (int e = tid; e < tt * k; e += nthreads) {
      vals_t[e] = t < n_tok ? cts_t[t] * wnew[seg_t[t] * k + j] : 0.0f;
      t += step_t;
      j += step_j;
      if (j >= k) {
        j -= k;
        ++t;
      }
    }
  }
}

cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      mu_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  // the whole of the SM's unified L1 for shared memory, so three tiles of
  // the main path's layout share an SM
  err = cudaFuncSetAttribute(mu_kernel<true>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      mu_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
}

// once: the most shared memory a launch asks (no attribute call lands
// inside a graph capture)
cudaError_t attributes() {
  static const cudaError_t attr = set_attributes();
  return attr;
}

}  // namespace

// Dynamic shared memory a launch at (k, d, tt) with ``warps`` warps uses
// (the whole layout where it fits, else the control words and H H^T where
// that fits), or 0 for a geometry outside the kernel's index range.
extern "C" int stc_nmf_smem_bytes(int k, int d, int tt, int warps) {
  if (!valid(k, d, tt, warps)) return 0;
  if (fits_shared(k, d, tt, warps)) {
    return static_cast<int>(4 * shared_words(k, d, tt, warps));
  }
  long long words = kControlWords;
  if (caches_hht(k, d, tt, warps)) words += static_cast<long long>(k) * k;
  return static_cast<int>(4 * words);
}

// Scratch floats a tile needs: 0 where the state fits shared memory.
extern "C" int stc_nmf_scratch_floats(int k, int d, int tt, int warps) {
  if (!valid(k, d, tt, warps) || fits_shared(k, d, tt, warps)) return 0;
  return static_cast<int>(state_words(k, d, warps));
}

// CTAs of a launch at (k, d, tt) that one SM holds at once (the card's
// occupancy calculator); 0 for a refused geometry, -error on a failure.
extern "C" int stc_nmf_blocks_per_sm(int k, int d, int tt, int warps) {
  const int smem = stc_nmf_smem_bytes(k, d, tt, warps);
  if (smem == 0) return 0;
  cudaError_t err = attributes();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  if (fits_shared(k, d, tt, warps)) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mu_kernel<true>,
                                                        warps * 32, smem);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mu_kernel<false>,
                                                        warps * 32, smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

extern "C" int stc_nmf_mu_update_tiles(
    const void* hg, const void* cts, const void* seg, const void* w,
    const void* hht, int n_tiles, int k, int tt, int d, int warps, float eps,
    void* w_out, void* vals, void* scratch, void* stream) {
  const int smem = stc_nmf_smem_bytes(k, d, tt, warps);
  const bool shared = smem > 0 && fits_shared(k, d, tt, warps);
  if (smem == 0 || n_tiles < 1 || (!shared && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cache_hht = caches_hht(k, d, tt, warps) ? 1 : 0;
  const int vec4 = k % 4 == 0 && reinterpret_cast<std::uintptr_t>(w_out) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(vals) % 16 == 0;
  const cudaError_t attr = attributes();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    mu_kernel<true><<<n_tiles, warps * 32, smem, s>>>(
        static_cast<const float*>(hg), static_cast<const float*>(cts),
        static_cast<const int*>(seg), static_cast<const float*>(w),
        static_cast<const float*>(hht), n_tiles, k, tt, d, eps, cache_hht,
        vec4, static_cast<float*>(w_out), static_cast<float*>(vals), nullptr);
  } else {
    mu_kernel<false><<<n_tiles, warps * 32, smem, s>>>(
        static_cast<const float*>(hg), static_cast<const float*>(cts),
        static_cast<const int*>(seg), static_cast<const float*>(w),
        static_cast<const float*>(hht), n_tiles, k, tt, d, eps, cache_hht,
        vec4, static_cast<float*>(w_out), static_cast<float*>(vals),
        static_cast<float*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}
