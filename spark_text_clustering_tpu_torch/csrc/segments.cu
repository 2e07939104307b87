// Per-document frozen gamma fixed point of LDA scoring, then the
// normalized topic distribution, over a token-packed batch.
//
// Replaces no Pallas kernel: the JAX package computes this function in
// XLA (spark_text_clustering_tpu/ops/lda_math.py:434,
// topic_inference_segments with freeze=True, over
// gamma_fixed_point_segments :252-330).  The port adds it so that a
// document's distribution is a pure function of the document on the
// card, as the JAX package states for its scoring service and
// `score --per-doc-convergence`: the plain PyTorch version sums each
// document's responsibilities with index_add_ (float atomics on the
// card, in an order that changes from run to run) and reduces over k
// with reductions whose split follows the whole tensor's shape, so a
// document scored inside a serve bucket and inside the CLI's whole
// corpus could differ in the last bits.  Per document d, tokens
// [offsets[d], offsets[d+1]) of eb [T, k] and cts [T]:
//     et      = exp(digamma(gamma) - digamma(sum_k gamma))
//     phinorm = sum_k eb[t, k] * et[k] + 1e-30                 per token
//     gamma  <- alpha + et * sum over the doc's tokens of eb * cts / phinorm
// until the doc's own mean|delta gamma| over k drops below tol (the update
// that converged it is kept) or at max_inner; then gamma / sum_k gamma, or
// 1/k for a doc with no positive weight.  max_inner == 0 normalizes gamma0.
//
// What bounds it on the H100: the latency of one document's serial loop of
// up to max_inner dependent iterations, not bytes or operations (a serve
// dispatch's bound is ~3 us, the loop's 100 iterations need ~1 us each at
// the least: a cluster barrier, a remote read, two digammas).  The first
// version ran a document on one CTA of 512 threads: a serve dispatch of 8
// books used 8 of 132 SMs and every iteration re-read each book's rows
// (~350 KB) from L2 through one SM, 1.04 ms a dispatch.
//
// Design: a thread-block cluster of C CTAs a document (C in 1..16, a
// launch parameter: the wrapper takes the largest power of two whose
// clusters for all the batch's doc slots fit on the card at once).
// - A document is cut into pieces of P consecutive tokens counted from its
//   own start (P = 256 in the k <= 8 instance, 128 in the other).  Piece p
//   belongs to CTA p % C; a CTA's warps take its pieces in turn.  A
//   piece's k sums are formed in one fixed way: lane l takes tokens
//   l + 32 i in order of i, then the lanes meet in a fixed shuffle tree
//   that halves the topics a lane carries at each step (lane_topic_sums).
// - Each CTA writes its pieces' sums into its own shared memory (two
//   buffers, so one cluster barrier an iteration suffices) and the cluster
//   synchronizes.  Then warp 0 of every CTA reads all pieces' sums through
//   distributed shared memory in one fixed order (lane l sums pieces
//   l + 32 m in order of m, then the same tree) and updates gamma the same
//   way: every CTA holds the same gamma and stop decision, bit for bit,
//   and no sum is grouped by CTA, so C changes no bit.  Warp 0 keeps gamma
//   in registers; one CTA barrier hands et and the stop flag to the other
//   warps.
// - Before the loop each CTA stages its first pieces in shared memory, eb
//   transposed to [k, P] so that a warp's reads are conflict-free,
//   with cp.async, within the shared memory the wrapper allows a CTA
//   (kSmemBudget: the rest of the SM stays L1).  Pieces past the
//   staging capacity are read from device
//   memory (L2) every iteration; partial sums past their capacity go to a
//   scratch buffer the wrapper allocates, as does the per-token ratio
//   cts / phinorm for k > 32 (the topics run in chunks of 32).  Where a
//   value lives never changes its arithmetic: every multiply-add is an
//   explicit fmaf and the rest explicit _rn operations, so the staged and
//   the streamed code compute the same bits, and the capacity, like C and
//   the block size, changes none.
// - Nothing is atomic and nothing depends on the doc's offset in the batch,
//   its batchmates or T: a document's bits depend on its own tokens,
//   alpha, gamma0, max_inner and tol alone, and a repeat is bit for bit.
//   One launch a batch, no host sync inside.
// - Three instances: Small (k <= 8) and Large (k <= 128) keep the doc's
//   gamma and alpha in warp 0's registers (a lane holds topics lane + 32 h)
//   and et in a fixed shared array; Wide (k > 128) keeps gamma and et in
//   shared memory sized by k, and warp 0 updates the topics in chunks of
//   32 as the doc's sums come (the ratio of a token is formed once, in the
//   first chunk of its piece's sums, and kept in the stage or the scratch
//   for the others, as in Large).  The largest k is where a CTA's fixed
//   words and one piece's partial sums fill the shared budget
//   (stc_segments_max_k).
// digamma is digamma.cuh's, the TPU kernels' series.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "digamma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRegK = 128;  // largest k whose gamma warp 0 keeps in registers
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;           // 227 KB a block on the H100
// The shared bytes the wrapper lets a CTA take: the rest of the SM's
// 256 KB stays L1 (at 8 CTAs a doc, a 227 KB request ran slower on the
// H100 than 80-150 KB, with every piece staged either way).
constexpr int kSmemBudget = 147456;
// At most this many shared words hold partial sums; the staged rows get
// the rest of the capacity.
constexpr int kPartWords = 8192;
constexpr float kPhiEps = 1e-30f;

// Shared words besides the pieces: et [kRegK] (Wide: et and gamma [k]
// each), then 32 words whose first two are the live and stop flags.
__host__ __device__ __forceinline__ int fixed_words(int k) {
  return (k <= kRegK ? kRegK : 2 * k) + 32;
}

// Where a launch keeps what: the same in every CTA of a launch.
struct Plan {
  int local_max;  // most pieces a CTA can own (a doc of all T tokens)
  int part_q;     // pieces a CTA keeps partial sums of in shared memory
  int stage_q;    // pieces a CTA stages in shared memory
  long long smem;  // dynamic shared memory bytes
};

// Tokens a piece: fixed for an instance, as a document's bits follow it
// (8 a lane where a lane keeps 8 topic sums, 4 where it keeps 32).
__host__ __device__ constexpr int piece_tokens(int k) {
  return k <= 8 ? 256 : 128;
}

__host__ __device__ __forceinline__ int stage_words(int k) {
  return piece_tokens(k) * (k + 1 + (k > 32 ? 1 : 0));  // eb [k, P], cts, ratio
}

__host__ __device__ __forceinline__ Plan make_plan(int k, int t, int cs,
                                                  int smem_cap) {
  Plan pl;
  const int pieces = (t + piece_tokens(k) - 1) / piece_tokens(k);
  pl.local_max = (pieces + cs - 1) / cs;
  long long words = smem_cap / 4 - fixed_words(k);
  long long q = (words < kPartWords ? words : kPartWords) / (2 * k);
  pl.part_q = static_cast<int>(q < pl.local_max ? q : pl.local_max);
  words -= 2LL * pl.part_q * k;
  q = words / stage_words(k);
  pl.stage_q = static_cast<int>(q < pl.local_max ? q : pl.local_max);
  pl.smem = 4LL * (fixed_words(k) + 2LL * pl.part_q * k +
                   static_cast<long long>(pl.stage_q) * stage_words(k));
  return pl;
}

// Scratch floats: the ratio of every token for k > 32, then two buffers of
// partial sums past the shared capacity ([slots, k] each; doc d's piece p
// at slot offsets[d] / P + d + p).
__host__ __device__ __forceinline__ long long overflow_slots(int k, int t,
                                                            int n_docs) {
  return t / piece_tokens(k) + n_docs + 1;
}
__host__ __device__ __forceinline__ long long ratio_floats(int k, int t) {
  return k > 32 ? t : 0;
}
__host__ __device__ __forceinline__ long long scratch_floats(const Plan& pl,
                                                            int k, int t,
                                                            int n_docs) {
  return ratio_floats(k, t) +
         (pl.part_q < pl.local_max ? 2 * overflow_slots(k, t, n_docs) * k : 0);
}

struct Args {
  const float* eb;      // [T, k]
  const float* cts;     // [T]
  const int* offsets;   // [n_docs + 1]
  const float* alpha;   // [k]
  const float* gamma0;  // [n_docs, k]
  float* out;           // [n_docs, k]
  float* scratch;       // scratch_floats() floats
  int n_docs, k, t, smem_cap, max_inner;
  float tol;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
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

// v[0..KC) of every lane summed over the warp in one fixed tree: each
// step halves the values a lane carries (it keeps one half and adds its
// partner's sums of that half), then a butterfly adds the lane groups.
// Returns topic (lane % KC)'s sum: KC - 1 + log2(32 / KC) shuffles, not
// 5 KC.  The steps are template instances, so every index is a constant
// and v stays in registers.
template <int W, int KC>
struct Halve {
  static __device__ __forceinline__ void run(float (&v)[KC], int lane) {
    const bool upper = (lane & W) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float send = upper ? v[i] : v[i + W];
      const float keep = upper ? v[i + W] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, W));
    }
    Halve<W / 2, KC>::run(v, lane);
  }
};
template <int KC>
struct Halve<0, KC> {
  static __device__ __forceinline__ void run(float (&)[KC], int) {}
};

template <int KC>
__device__ __forceinline__ float lane_topic_sums(float (&v)[KC], int lane) {
  Halve<KC / 2, KC>::run(v, lane);
  float s = v[0];
#pragma unroll
  for (int w = KC; w < 32; w *= 2) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, w));
  }
  return s;
}

// One piece's k sums of eb * cts / phinorm over its n tokens into dst[k]
// (lane j writes topic c0 + j of each chunk).  kStaged: eb at
// e[j * P + u], cts at c[u], the ratio at r[u] (shared memory); else eb
// at e[u * k + j] (device memory), cts at c[u], the ratio at r[u]
// (scratch).  Both run the same arithmetic.  A lane past the piece's end
// reads its last token and adds it with weight +0, which leaves its sums'
// bits as they were, so the tokens' loads go out together.
template <int KC, bool kStaged>
__device__ __forceinline__ void piece_sums(const float* e, const float* c,
                                           float* r, const float* et_s,
                                           int k, int n, int lane,
                                           float* dst) {
  constexpr int kP = piece_tokens(KC);
  const int js = kStaged ? kP : 1;
  const int us = kStaged ? 1 : k;
  // k <= 8: et in registers and phinorm unrolled, so the tokens' chains
  // interleave
  float etr[KC];
  if constexpr (KC == 8) {
#pragma unroll
    for (int j = 0; j < KC; ++j) etr[j] = j < k ? et_s[j] : 0.0f;
  }
  for (int c0 = 0; c0 < k; c0 += KC) {
    float acc[KC];
#pragma unroll
    for (int jj = 0; jj < KC; ++jj) acc[jj] = 0.0f;
#pragma unroll
    for (int i = 0; i < kP / 32; ++i) {
      const bool in = lane + 32 * i < n;
      const int u = in ? lane + 32 * i : n - 1;
      const float* row = e + u * us;
      float ratio;
      if (c0 == 0) {
        float p = 0.0f;
        if constexpr (KC == 8) {
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            if (j < k) p = __fmaf_rn(row[j * js], etr[j], p);
          }
        } else {
          for (int j = 0; j < k; ++j) p = __fmaf_rn(row[j * js], et_s[j], p);
        }
        ratio = in ? __fdividef(c[u], __fadd_rn(p, kPhiEps)) : 0.0f;
        if (k > KC && in) r[u] = ratio;
      } else {
        ratio = in ? r[u] : 0.0f;
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        if (c0 + jj < k) acc[jj] = __fmaf_rn(row[(c0 + jj) * js], ratio, acc[jj]);
      }
    }
    const float v = lane_topic_sums<KC>(acc, lane);
    if (lane < KC && c0 + lane < k) dst[c0 + lane] = v;
  }
}

// et = exp(digamma(gamma) - digamma(sum_k gamma)) for warp 0's gamma
// [H topics a lane: lane + 32 h] into et_s.  For H = 1 (k <= 8) lane 31
// takes digamma of the sum while lanes 0..k-1 take their topic's, at once.
template <int H>
__device__ __forceinline__ void refresh_et(const float (&g)[H], float* et_s,
                                           int k, int lane) {
  float tot = 0.0f;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (lane + 32 * h < k) tot = __fadd_rn(tot, g[h]);
  }
  tot = warp_sum(tot);
  if constexpr (H == 1) {
    const float d = stc::digamma_approx(lane < k ? g[0] : tot);
    const float dg_tot = __shfl_sync(0xffffffffu, d, 31);
    if (lane < k) et_s[lane] = expf(__fsub_rn(d, dg_tot));
  } else {
    const float dg_tot = stc::digamma_approx(tot);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int j = lane + 32 * h;
      if (j < k) et_s[j] = expf(__fsub_rn(stc::digamma_approx(g[h]), dg_tot));
    }
  }
}

// refresh_et for the Wide instance: gamma and et in shared memory [k],
// lane l taking topics l + 32 h.
__device__ __forceinline__ void refresh_et_wide(const float* g_s, float* et_s,
                                                int k, int lane) {
  float tot = 0.0f;
  for (int j = lane; j < k; j += 32) tot = __fadd_rn(tot, g_s[j]);
  const float dg_tot = stc::digamma_approx(warp_sum(tot));
  for (int j = lane; j < k; j += 32) {
    et_s[j] = expf(__fsub_rn(stc::digamma_approx(g_s[j]), dg_tot));
  }
}

// Warp 0's share of an update: gamma [H topics a lane: lane + 32 h] from
// the sums s, then et; returns the mean |delta gamma|, the same in every
// lane.  g and al are lane registers.
template <int H>
__device__ __forceinline__ float update(float (&g)[H], const float (&s)[H],
                                        const float (&al)[H], float* et_s,
                                        int k, int lane) {
  float chg = 0.0f;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = lane + 32 * h;
    if (j < k) {
      const float old = g[h];
      // et_s[j] is this lane's own write of the previous update
      g[h] = __fmaf_rn(et_s[j], s[h], al[h]);
      chg = __fadd_rn(chg, fabsf(__fsub_rn(g[h], old)));
    }
  }
  refresh_et<H>(g, et_s, k, lane);
  return __fdiv_rn(warp_sum(chg), static_cast<float>(k));
}

// KC: topic sums a lane keeps in registers (8 for k <= 8, else 32 with
// the topics in chunks); NT: threads a CTA; kWide: gamma in shared memory.
template <int KC, int NT, bool kWide>
__global__ void __launch_bounds__(NT, 1) segments_kernel(const Args a) {
  constexpr int H = KC == 8 ? 1 : kRegK / 32;  // topics a lane updates
  constexpr int kP = piece_tokens(KC);
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = a.k;
  const Plan pl = make_plan(k, a.t, cs, a.smem_cap);
  float* et_s = smem;                     // [kRegK] (Wide: [k])
  float* g_s = smem + k;                  // Wide: gamma [k]
  float* flags = smem + fixed_words(k) - 32;  // [0] live, [1] stop
  float* part_s = smem + fixed_words(k);  // [2][part_q, k]
  float* stage_s = part_s + 2 * pl.part_q * k;  // [stage_q][stage_words]
  float* ratio_g = a.scratch;             // [T] for k > 32
  float* over_g = a.scratch + ratio_floats(k, a.t);  // [2][slots, k]
  const long long slots = overflow_slots(k, a.t, a.n_docs);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int doc = blockIdx.x / cs;
  const int lo = a.offsets[doc];
  const int hi = a.offsets[doc + 1];
  const int n_pieces = (hi - lo + kP - 1) / kP;
  const int cs_log = __ffs(cs) - 1;  // cs is a power of two
  const int nq = n_pieces > rank ? (n_pieces - rank + cs - 1) >> cs_log : 0;
  const long long over_base = lo / kP + doc;

  if (threadIdx.x == 0) flags[0] = 0.0f;
  __syncthreads();
  // stage this CTA's first pieces (eb transposed, cts) and look for a
  // positive count in all of its pieces
  bool live = false;
  for (int q = 0; q < nq; ++q) {
    const int p0 = lo + (rank + q * cs) * kP;
    const int n = hi - p0 < kP ? hi - p0 : kP;
    if (q < pl.stage_q) {
      float* st = stage_s + static_cast<long long>(q) * stage_words(k);
      const float* src = a.eb + static_cast<long long>(p0) * k;
      for (int i = threadIdx.x; i < n * k; i += NT) {
        const int u = i / k;
        copy_async(st + (i - u * k) * kP + u, src + i);
      }
      for (int u = threadIdx.x; u < n; u += NT) {
        copy_async(st + k * kP + u, a.cts + p0 + u);
      }
    }
    for (int u = threadIdx.x; u < n; u += NT) live = live || a.cts[p0 + u] > 0.0f;
  }
  if (__ballot_sync(0xffffffffu, live) != 0u && lane == 0) flags[0] = 1.0f;

  // warp 0 holds the doc's gamma (lane + 32 h) and alpha; et to the block
  float g[H], al[H], s[H];
  if (warp == 0) {
    if constexpr (kWide) {
      for (int j = lane; j < k; j += 32) {
        g_s[j] = a.gamma0[static_cast<long long>(doc) * k + j];
      }
      refresh_et_wide(g_s, et_s, k, lane);
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int j = lane + 32 * h;
        g[h] = j < k ? a.gamma0[static_cast<long long>(doc) * k + j] : 0.0f;
        al[h] = j < k ? a.alpha[j] : 0.0f;
      }
      refresh_et<H>(g, et_s, k, lane);
    }
  }
  wait_copies();
  cluster.sync();
  bool nonempty = false;
  for (int q = 0; q < cs; ++q) {
    nonempty = nonempty || cluster.map_shared_rank(flags, q)[0] != 0.0f;
  }

  const int iters = nonempty ? a.max_inner : 0;
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    float* part = part_s + buf * pl.part_q * k;
    float* over = over_g + buf * slots * k;
    for (int q = warp; q < nq; q += NT / 32) {
      const int p = rank + q * cs;
      const int p0 = lo + p * kP;
      const int n = hi - p0 < kP ? hi - p0 : kP;
      float* dst = q < pl.part_q ? part + q * k : over + (over_base + p) * k;
      if (q < pl.stage_q) {
        float* st = stage_s + static_cast<long long>(q) * stage_words(k);
        piece_sums<KC, true>(st, st + k * kP, st + (k + 1) * kP, et_s, k, n,
                             lane, dst);
      } else {
        piece_sums<KC, false>(a.eb + static_cast<long long>(p0) * k,
                              a.cts + p0, ratio_g + p0, et_s, k, n, lane, dst);
      }
    }
    cluster.sync();
    if (warp == 0) {
      // the doc's sums in piece order: lane l over pieces l + 32 m, then
      // the lanes' tree; topics in chunks of KC.  Wide updates each
      // chunk's topics as their sums come (et stays the last update's
      // until all are done), adding |delta gamma| in topic order a lane.
      float chg = 0.0f;
      for (int c0 = 0; c0 < k; c0 += KC) {
        float acc[KC];
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) acc[jj] = 0.0f;
        // pieces p < part_q * cs keep their sums in shared memory, the
        // rest in the scratch: in piece order, the shared ones come first
        const int n_shared = n_pieces < pl.part_q * cs ? n_pieces : pl.part_q * cs;
        int p = lane;
#pragma unroll 4
        for (; p < n_shared; p += 32) {
          const float* src =
              cluster.map_shared_rank(part, p & (cs - 1)) + (p >> cs_log) * k;
#pragma unroll
          for (int jj = 0; jj < KC; ++jj) {
            if (c0 + jj < k) acc[jj] = __fadd_rn(acc[jj], src[c0 + jj]);
          }
        }
        for (; p < n_pieces; p += 32) {
          const float* src = over + (over_base + p) * k;
#pragma unroll
          for (int jj = 0; jj < KC; ++jj) {
            if (c0 + jj < k) acc[jj] = __fadd_rn(acc[jj], __ldcg(src + c0 + jj));
          }
        }
        const float v = lane_topic_sums<KC>(acc, lane);
        if constexpr (kWide) {
          const int j = c0 + lane;  // KC == 32: topic c0 + lane
          if (j < k) {
            const float old = g_s[j];
            g_s[j] = __fmaf_rn(et_s[j], v, a.alpha[j]);
            chg = __fadd_rn(chg, fabsf(__fsub_rn(g_s[j], old)));
          }
        } else {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            if (32 * h == c0) s[h] = v;  // topic c0 + lane
          }
        }
      }
      float mean;
      if constexpr (kWide) {
        refresh_et_wide(g_s, et_s, k, lane);
        mean = __fdiv_rn(warp_sum(chg), static_cast<float>(k));
      } else {
        mean = update<H>(g, s, al, et_s, k, lane);
      }
      if (lane == 0) flags[1] = mean < a.tol ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (flags[1] != 0.0f) break;
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();

  if (rank == 0 && warp == 0) {
    float* out = a.out + static_cast<long long>(doc) * k;
    if constexpr (kWide) {
      float tot = 0.0f;
      for (int j = lane; j < k; j += 32) tot = __fadd_rn(tot, g_s[j]);
      tot = warp_sum(tot);
      for (int j = lane; j < k; j += 32) {
        out[j] = nonempty ? __fdiv_rn(g_s[j], tot) : 1.0f / static_cast<float>(k);
      }
    } else {
      float tot = 0.0f;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (lane + 32 * h < k) tot = __fadd_rn(tot, g[h]);
      }
      tot = warp_sum(tot);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int j = lane + 32 * h;
        if (j < k) {
          out[j] = nonempty ? __fdiv_rn(g[h], tot) : 1.0f / static_cast<float>(k);
        }
      }
    }
  }
}

// The launch configuration: a cluster of cs CTAs a document.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(int n_docs, int cs, int threads, long long smem, cudaStream_t s) {
    cfg.gridDim = dim3(static_cast<unsigned>(n_docs) * cs);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Once per kernel instance: the most shared memory, and clusters of 16.
template <class Kernel>
cudaError_t set_attributes(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The instance for k: {KC, threads, gamma in shared memory}.
template <int KC, int NT, bool W = false>
struct Instance {
  static cudaError_t attributes() {
    static const cudaError_t attr = set_attributes(segments_kernel<KC, NT, W>);
    return attr;
  }
  static cudaError_t launch(const Args& a, int cs, long long smem,
                            cudaStream_t s) {
    const cudaError_t attr = attributes();
    if (attr != cudaSuccess) return attr;
    Launch l(a.n_docs, cs, NT, smem, s);
    const cudaError_t err = cudaLaunchKernelEx(&l.cfg, segments_kernel<KC, NT, W>, a);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  static cudaError_t clusters(int cs, long long smem, int* n) {
    const cudaError_t attr = attributes();
    if (attr != cudaSuccess) return attr;
    Launch l(1, cs, NT, smem, nullptr);
    return cudaOccupancyMaxActiveClusters(n, segments_kernel<KC, NT, W>, &l.cfg);
  }
};
using Small = Instance<8, 512>;   // k <= 8
using Large = Instance<32, 256>;  // 8 < k <= 128
using Wide = Instance<32, 256, true>;  // k > 128

// A launch needs its fixed words and one piece's two partial buffers in
// shared memory; the largest k is where they fill the budget.
bool fits(int k, int smem_cap) {
  return 4LL * (fixed_words(k) + 2LL * k) <= smem_cap;
}

// Past kRegK the fixed words are 2k + 32, so the words a launch needs are
// 4k + 32.
constexpr int kMaxK = (kSmemBudget / 4 - 32) / 4;
static_assert(kMaxK > kRegK, "the budget takes k past the register path");

bool valid(int k, int t, int cluster, int smem_cap) {
  return k >= 1 && k <= kMaxK && t >= 1 && cluster >= 1 &&
         cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0 &&
         fits(k, smem_cap) && smem_cap <= kSmemLimit;
}

template <class Fn>
cudaError_t by_instance(int k, Fn fn) {
  if (k <= 8) return fn(Small{});
  if (k <= kRegK) return fn(Large{});
  return fn(Wide{});
}

}  // namespace

extern "C" int stc_segments_max_k() { return kMaxK; }
extern "C" int stc_segments_max_cluster() { return kMaxCluster; }
extern "C" int stc_segments_piece_tokens(int k) { return piece_tokens(k); }
extern "C" int stc_segments_smem_limit() { return kSmemLimit; }
extern "C" int stc_segments_smem_budget() { return kSmemBudget; }

// The dynamic shared memory of a launch over T = t token slots with
// clusters of ``cluster`` CTAs, within ``smem_cap`` bytes; -1 if invalid.
extern "C" int stc_segments_smem_bytes(int k, int t, int cluster, int smem_cap) {
  if (!valid(k, t, cluster, smem_cap)) return -1;
  return static_cast<int>(make_plan(k, t, cluster, smem_cap).smem);
}

// Pieces of piece_tokens(k) tokens each CTA stages in shared memory.
extern "C" int stc_segments_stage_pieces(int k, int t, int cluster, int smem_cap) {
  if (!valid(k, t, cluster, smem_cap)) return -1;
  return make_plan(k, t, cluster, smem_cap).stage_q;
}

// Floats of the scratch buffer a launch needs (0: none).
extern "C" int stc_segments_scratch_floats(int k, int t, int n_docs, int cluster,
                                           int smem_cap) {
  if (!valid(k, t, cluster, smem_cap) || n_docs < 1) return -1;
  return static_cast<int>(
      scratch_floats(make_plan(k, t, cluster, smem_cap), k, t, n_docs));
}

// Clusters of ``cluster`` CTAs the card can run at once at this launch's
// shared memory (cudaOccupancyMaxActiveClusters); minus a CUDA error code.
extern "C" int stc_segments_active_clusters(int k, int t, int cluster,
                                            int smem_cap) {
  if (!valid(k, t, cluster, smem_cap)) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = make_plan(k, t, cluster, smem_cap).smem;
  int n = 0;
  const cudaError_t err = by_instance(
      k, [&](auto inst) { return decltype(inst)::clusters(cluster, smem, &n); });
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

// t: token slots of eb and cts; cluster: CTAs a document (1, 2, 4, 8 or 16);
// smem_cap: shared bytes a CTA may use.  Returns a CUDA error code.
extern "C" int stc_topic_inference_segments(
    const void* eb, const void* cts, const void* offsets, const void* alpha,
    const void* gamma0, int n_docs, int k, int t, int cluster, int smem_cap,
    int max_inner, float tol, void* out, void* scratch, void* stream) {
  if (!valid(k, t, cluster, smem_cap) || n_docs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = make_plan(k, t, cluster, smem_cap);
  if (scratch_floats(pl, k, t, n_docs) > 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.eb = static_cast<const float*>(eb);
  a.cts = static_cast<const float*>(cts);
  a.offsets = static_cast<const int*>(offsets);
  a.alpha = static_cast<const float*>(alpha);
  a.gamma0 = static_cast<const float*>(gamma0);
  a.out = static_cast<float*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.n_docs = n_docs;
  a.k = k;
  a.t = t;
  a.smem_cap = smem_cap;
  a.max_inner = max_inner;
  a.tol = tol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = by_instance(
      k, [&](auto inst) { return decltype(inst)::launch(a, cluster, pl.smem, s); });
  return static_cast<int>(err);
}
