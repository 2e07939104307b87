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
// up to max_inner iterations, not bytes or operations.  A serve dispatch is
// at most max_batch documents (8 CTAs on 132 SMs on the card's main path),
// and each iteration reads the doc's eb rows again (from L1/L2 after the
// first).
//
// Design: one CTA of kThreads threads a document.
// - Thread t takes the doc's tokens off + t + i * kThreads, counted from the
//   doc's own start, in order of i; it keeps KC topic sums in registers
//   (KC = 8 for k <= 8, else 32; for k > 32 it walks the topics in chunks
//   of KC and keeps each token's ratio cts / phinorm in a scratch buffer
//   the wrapper allocates, written and read by the same thread).  Sums over
//   k run sequentially; a warp's partials meet in a fixed xor-shuffle tree
//   and the warps' sums are added in warp order by the topic's thread.
// - Three barriers an iteration: et written, the warps' partials written,
//   the new gamma and its change written.  Every thread then reads the k
//   changes in order and takes the same stop decision.
// - The block size is a constant and nothing is atomic, so a document's
//   bits depend on its own tokens, alpha, gamma0, max_inner and tol alone:
//   never on its offset in the batch, its batchmates or T.  A repeat is bit
//   for bit.  One launch a batch, no host sync inside.
// digamma is digamma.cuh's, the TPU kernels' series.

#include <cuda_runtime.h>

#include "digamma.cuh"

namespace {

constexpr int kThreads = 512;           // fixed: a document's bits follow it
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr float kPhiEps = 1e-30f;

// Shared words: gamma, et and change [kMaxK] each, the warps' partials
// [kWarps, kMaxK].
constexpr int kSmemWords = (3 + kWarps) * kMaxK;

template <int KC>
__global__ void __launch_bounds__(kThreads) segments_kernel(
    const float* __restrict__ eb,      // [T, k]
    const float* __restrict__ cts,     // [T]
    const int* __restrict__ offsets,   // [n_docs + 1]
    const float* __restrict__ alpha,   // [k]
    const float* __restrict__ gamma0,  // [n_docs, k]
    int k, int max_inner, float tol,
    float* __restrict__ out,           // [n_docs, k]
    float* __restrict__ ratio) {       // [T], read and written for k > KC
  extern __shared__ float smem[];
  float* gam = smem;                   // [kMaxK]
  float* et = gam + kMaxK;             // [kMaxK]
  float* change = et + kMaxK;          // [kMaxK]
  float* part = change + kMaxK;        // [kWarps, k]
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long doc = blockIdx.x;
  const int lo = offsets[doc];
  const int hi = offsets[doc + 1];

  if (t < k) gam[t] = gamma0[doc * k + t];
  bool live = false;
  for (int i = lo + t; i < hi; i += kThreads) live = live || cts[i] > 0.0f;
  const unsigned any = __ballot_sync(0xffffffffu, live);
  if (lane == 0) part[warp] = any != 0u ? 1.0f : 0.0f;
  __syncthreads();
  bool nonempty = false;
  for (int w = 0; w < kWarps; ++w) nonempty = nonempty || part[w] != 0.0f;
  // ``part`` is written next after the first et barrier, which every
  // thread reaches only after reading the flags above

  for (int it = 0; it < max_inner; ++it) {
    if (t < k) {
      float s = 0.0f;
      for (int j = 0; j < k; ++j) s += gam[j];
      et[t] = expf(stc::digamma_approx(gam[t]) - stc::digamma_approx(s));
    }
    __syncthreads();
    for (int c0 = 0; c0 < k; c0 += KC) {
      float acc[KC];
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) acc[jj] = 0.0f;
      for (int i = lo + t; i < hi; i += kThreads) {
        const float* row = eb + static_cast<long long>(i) * k;
        float r;
        if (c0 == 0) {
          float p = 0.0f;
          for (int j = 0; j < k; ++j) p += row[j] * et[j];
          r = cts[i] / (p + kPhiEps);
          if (k > KC) ratio[i] = r;
        } else {
          r = ratio[i];
        }
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          if (c0 + jj < k) acc[jj] += row[c0 + jj] * r;
        }
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        float v = acc[jj];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        if (lane == 0 && c0 + jj < k) part[warp * k + c0 + jj] = v;
      }
    }
    __syncthreads();
    if (t < k) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += part[w * k + t];
      const float g = alpha[t] + et[t] * s;
      change[t] = fabsf(g - gam[t]);
      gam[t] = g;
    }
    __syncthreads();
    float m = 0.0f;
    for (int j = 0; j < k; ++j) m += change[j];
    if (m / static_cast<float>(k) < tol) break;
  }

  if (t < k) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s += gam[j];
    out[doc * k + t] = nonempty ? gam[t] / s : 1.0f / static_cast<float>(k);
  }
}

template <int KC>
cudaError_t launch(const float* eb, const float* cts, const int* offsets,
                   const float* alpha, const float* gamma0, int n_docs, int k,
                   int max_inner, float tol, float* out, float* ratio,
                   cudaStream_t s) {
  segments_kernel<KC><<<n_docs, kThreads, kSmemWords * 4, s>>>(
      eb, cts, offsets, alpha, gamma0, k, max_inner, tol, out, ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stc_segments_max_k() { return kMaxK; }

// Scratch floats a token needs at ``k`` (the ratio buffer of k > 32).
extern "C" int stc_segments_scratch_per_token(int k) { return k > 32 ? 1 : 0; }

extern "C" int stc_topic_inference_segments(
    const void* eb, const void* cts, const void* offsets, const void* alpha,
    const void* gamma0, int n_docs, int k, int max_inner, float tol,
    void* out, void* ratio, void* stream) {
  if (k < 1 || k > kMaxK || n_docs < 1 ||
      (stc_segments_scratch_per_token(k) > 0 && ratio == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const float*>(eb);
  const auto* c = static_cast<const float*>(cts);
  const auto* o = static_cast<const int*>(offsets);
  const auto* a = static_cast<const float*>(alpha);
  const auto* g = static_cast<const float*>(gamma0);
  auto* d = static_cast<float*>(out);
  auto* r = static_cast<float*>(ratio);
  const cudaError_t err =
      k <= 8 ? launch<8>(e, c, o, a, g, n_docs, k, max_inner, tol, d, r, s)
             : launch<32>(e, c, o, a, g, n_docs, k, max_inner, tol, d, r, s);
  return static_cast<int>(err);
}
