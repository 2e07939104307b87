"""A CPU stand-in for the CUDA runtime, and a function that compiles one
of the port's kernel sources against it with g++.

Enough of the runtime for ``csrc/packed.cu``, ``csrc/nmf.cu``,
``csrc/emsweep.cu`` and ``csrc/segments.cu``: every block runs as
blockDim.x threads with real barriers, warp shuffles and ballots and its
own shared memory, one block after another (over a grid of x and y), and
each ``<<<grid, block, smem, stream>>>`` launch becomes the stand-in's
launcher.  ``cudaLaunchKernelEx`` with a cluster dimension runs the
blocks of one cluster at once, with ``cooperative_groups::this_cluster()``
(``sync``, ``block_rank``, ``num_blocks``, ``map_shared_rank`` into
another block's shared memory), the clusters one after another.  (A
kernel's ``cp.async`` copy compiles, without ``__CUDA_ARCH__``, to a
plain copy.)  The kernel tests load the
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
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout,
  cudaFuncAttributeNonPortableClusterSizeAllowed
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
template <class T> inline T __ldcg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
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
// One block's own state: its barrier, its warps' barriers and shuffle
// buffers, and its shared memory.  The blocks of a cluster run at once.
// A warp's exchanges alternate between two buffers, so one barrier an
// exchange suffices: a lane writes a buffer again only two exchanges
// later, after every lane has passed the barrier between.
struct EmuBlock {
  Barrier block;
  Barrier warps[32];
  float xfer[2][1024];
  unsigned bits[2][1024];
  std::vector<float> smem = std::vector<float>(1 << 16);
};
struct EmuCluster {
  Barrier sync;
  std::vector<std::unique_ptr<EmuBlock>> blocks;
  unsigned first_block = 0;
};
inline thread_local EmuBlock* g_blk;
inline thread_local EmuCluster* g_clu;
inline thread_local int g_phase;
inline float* emu_smem() { return g_blk->smem.data(); }
inline void __syncthreads() { g_blk->block.wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_blk->warps[threadIdx.x >> 5].wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = threadIdx.x;
  float* x = g_blk->xfer[g_phase ^= 1];
  x[t] = v;
  __syncwarp();
  return x[(t & ~31) | ((t & 31) ^ off)];
}
inline float __shfl_sync(unsigned, float v, int src) {
  const int t = threadIdx.x;
  float* x = g_blk->xfer[g_phase ^= 1];
  x[t] = v;
  __syncwarp();
  return x[(t & ~31) | (src & 31)];
}
// lane L gets lane L - off's value (its own where L < off); 32-bit types
template <class T> inline T __shfl_up_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int t = threadIdx.x;
  unsigned* b = g_blk->bits[g_phase ^= 1];
  std::memcpy(&b[t], &v, 4);
  __syncwarp();
  T r = v;
  if ((t & 31) >= off) std::memcpy(&r, &b[t - off], 4);
  return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int t = threadIdx.x;
  unsigned* b = g_blk->bits[g_phase ^= 1];
  b[t] = pred != 0;
  __syncwarp();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= b[(t & ~31) | l] << l;
  return m;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
// Blocks in clusters of cs along x: the clusters one after another, the
// blocks of one cluster at once (cs * block threads).
inline void emu_run(dim3 grid, int block, unsigned cs, std::function<void()> body) {
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned b0 = 0; b0 < grid.x; b0 += cs) {
      EmuCluster clu;
      clu.sync.n = static_cast<int>(cs) * block;
      clu.first_block = b0;
      for (unsigned r = 0; r < cs; ++r) {
        clu.blocks.emplace_back(new EmuBlock);
        clu.blocks.back()->block.n = block;
        for (auto& w : clu.blocks.back()->warps) w.n = 32;
      }
      std::vector<std::thread> th;
      for (unsigned r = 0; r < cs; ++r) {
        for (int t = 0; t < block; ++t) {
          th.emplace_back([=, &clu] {
            threadIdx = {unsigned(t), 0, 0};
            blockIdx = {b0 + r, by, 0};
            blockDim = {unsigned(block), 0, 0};
            g_clu = &clu;
            g_blk = clu.blocks[r].get();
            body();
          });
        }
      }
      for (auto& x : th) x.join();
    }
  }
}
inline void emu_launch(dim3 grid, int block, std::function<void()> body) {
  emu_run(grid, block, 1, std::move(body));
}
#define EMU_LAUNCH(fn, grid, block, ...) \
  emu_launch(grid, block, [&]() { fn(__VA_ARGS__); })
namespace cooperative_groups {
struct cluster_group {
  void sync() const { g_clu->sync.wait(); }
  unsigned block_rank() const { return blockIdx.x - g_clu->first_block; }
  unsigned num_blocks() const { return static_cast<unsigned>(g_clu->blocks.size()); }
  // the same offset in block ``rank``'s shared memory
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    const char* base = reinterpret_cast<const char*>(g_blk->smem.data());
    char* other = reinterpret_cast<char*>(g_clu->blocks[rank]->smem.data());
    return reinterpret_cast<T*>(other + (reinterpret_cast<const char*>(p) - base));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline unsigned emu_cluster_x(const cudaLaunchConfig_t* cfg) {
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      return cfg->attrs[i].val.clusterDim.x;
    }
  }
  return 1;
}
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(E...),
                               A&&... args) {
  const unsigned cs = emu_cluster_x(cfg);
  if (cs < 1 || cfg->gridDim.x % cs != 0 ||
      cfg->dynamicSmemBytes > (1u << 16) * sizeof(float)) {
    return cudaErrorInvalidValue;
  }
  emu_run(cfg->gridDim, static_cast<int>(cfg->blockDim.x), cs,
          [&]() { kernel(args...); });
  return cudaSuccess;
}
// as many clusters as 132 SMs hold, one block an SM
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t* cfg) {
  *n = static_cast<int>(132 / emu_cluster_x(cfg));
  return cudaSuccess;
}
"""


def build_on_cpu(name: str, kernel: str, launches: int,
                 out: Path) -> ctypes.CDLL:
    """``csrc/<name>.cu`` compiled by g++ against ``_CUDA_SHIM`` into
    ``out``, with each of its ``launches`` ``<<<...>>>`` launches of
    ``kernel`` (a kernel's name, a template's with any instance, or an
    alternation of names) swapped for the shim's launcher (a source that
    launches by ``cudaLaunchKernelEx`` has 0) and each block's
    ``extern __shared__`` array pointed at its own shared memory; loaded
    with ctypes, with the wrapper's C signatures.  Skips the test where
    there is no g++."""
    from spark_text_clustering_tpu_torch.ops import _build

    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the kernel source for the CPU")
    src = (_build.CSRC / f"{name}.cu").read_text()
    src, n = re.subn(rf"((?:{kernel})(?:<\w+>)?)<<<([^,]+),([^,]+),[^>]*>>>\(",
                     r"EMU_LAUNCH(\1, \2, \3, ", src)
    assert n == launches
    # each block's own shared memory
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];",
                 r"float* \1 = emu_smem();", src)
    (out / "cuda_runtime.h").write_text(_CUDA_SHIM)
    (out / "cooperative_groups.h").write_text(
        '#pragma once\n#include "cuda_runtime.h"\n')
    (out / "unit.cpp").write_text('#include "cuda_runtime.h"\n' + src)
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
