// psi(x) for x > 0, as the TPU kernels compute it inline (Mosaic has no
// digamma): the recurrence psi(x) = psi(x+1) - 1/x unrolled six times
// pushes the argument above 6, then the asymptotic series
// ln x - 1/(2x) - 1/(12x^2) + 1/(120x^4) - 1/(252x^6).
//
// Replaces: spark_text_clustering_tpu/ops/pallas_estep.py, digamma_approx.
// Shared by the padded E-step kernel (estep.cu) and the token-packed tile
// kernel (packed.cu).

#pragma once

#include <cuda_runtime.h>

namespace stc {

__device__ __forceinline__ float digamma_approx(float x) {
  float res = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const bool small = x < 6.0f;
    res = res - (small ? 1.0f / x : 0.0f);
    x = small ? x + 1.0f : x;
  }
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  const float series =
      logf(x) - 0.5f * inv -
      inv2 * (1.0f / 12.0f -
              inv2 * (1.0f / 120.0f - inv2 * (1.0f / 252.0f)));
  return res + series;
}

}  // namespace stc
