"""A CPU stand-in for the CUDA runtime, and a function that compiles one
of the port's kernel sources against it with g++.

Enough of the runtime for ``csrc/packed.cu``, ``csrc/nmf.cu`` and
``csrc/emsweep.cu``: every block runs as blockDim.x threads with real
barriers, warp shuffles and ballots, one block after another (over a
grid of x and y), and each ``<<<grid, block, smem, stream>>>`` launch
becomes the stand-in's launcher.  (A kernel's ``cp.async`` copy
compiles, without ``__CUDA_ARCH__``, to a plain copy.)  The kernel tests load the
library with ctypes and the wrappers' C signatures and hold it against
the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

_CUDA_SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
struct Dim3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local Dim3 threadIdx, blockIdx, blockDim;
using std::max;
using std::min;
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return gen != g; });
  }
};
inline Barrier g_block;
inline std::vector<Barrier> g_warps(32);
inline float g_xfer[1024];
inline unsigned g_bits[1024];
inline void __syncthreads() { g_block.wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warps[threadIdx.x >> 5].wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = threadIdx.x;
  g_xfer[t] = v;
  __syncwarp();
  const float r = g_xfer[(t & ~31) | ((t & 31) ^ off)];
  __syncwarp();
  return r;
}
// lane L gets lane L - off's value (its own where L < off); 32-bit types
template <class T> inline T __shfl_up_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int t = threadIdx.x;
  std::memcpy(&g_bits[t], &v, 4);
  __syncwarp();
  T r = v;
  if ((t & 31) >= off) std::memcpy(&r, &g_bits[t - off], 4);
  __syncwarp();
  return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int t = threadIdx.x;
  g_bits[t] = pred != 0;
  __syncwarp();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= g_bits[(t & ~31) | l] << l;
  __syncwarp();
  return m;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline void emu_launch(dim3 grid, int block, std::function<void()> body) {
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned b = 0; b < grid.x; ++b) {
      g_block.n = block;
      for (auto& w : g_warps) w.n = 32;
      std::vector<std::thread> th;
      for (int t = 0; t < block; ++t) {
        th.emplace_back([=] {
          threadIdx = {unsigned(t), 0, 0};
          blockIdx = {b, by, 0};
          blockDim = {unsigned(block), 0, 0};
          body();
        });
      }
      for (auto& x : th) x.join();
    }
  }
}
#define EMU_LAUNCH(fn, grid, block, ...) \
  emu_launch(grid, block, [&]() { fn(__VA_ARGS__); })
"""


def build_on_cpu(name: str, kernel: str, launches: int,
                 out: Path) -> ctypes.CDLL:
    """``csrc/<name>.cu`` compiled by g++ against ``_CUDA_SHIM`` into
    ``out``, with each of its ``launches`` launches of ``kernel`` (a
    kernel's name, a template's with any instance, or an alternation of
    names) swapped for the shim's launcher; loaded with ctypes, with the
    wrapper's C signatures.  Skips the test where there is no g++."""
    from spark_text_clustering_tpu_torch.ops import _build

    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the kernel source for the CPU")
    src = (_build.CSRC / f"{name}.cu").read_text()
    src, n = re.subn(rf"((?:{kernel})(?:<\w+>)?)<<<([^,]+),([^,]+),[^>]*>>>\(",
                     r"EMU_LAUNCH(\1, \2, \3, ", src)
    assert n == launches
    (out / "cuda_runtime.h").write_text(_CUDA_SHIM)
    (out / "unit.cpp").write_text(
        '#include "cuda_runtime.h"\nnamespace { float smem[1 << 16]; }\n'
        + src)
    lib = out / f"lib{name}_cpu.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
         "-w", "-I", str(out), "-I", str(_build.CSRC), "-o", str(lib),
         str(out / "unit.cpp")], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll
