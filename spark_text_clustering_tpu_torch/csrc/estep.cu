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
// What bounds it on the H100: not device memory, and not arithmetic.
// Every inner iteration reads the eb values of the tile's live slots (2
// flops a value for phinorm, 2 for the update) and the tiles iterate
// 30-70 times: the card's bound for the main path's buckets is 4-7 us.
// The time goes to latency: each iteration is a chain of dependent steps
// (sums over L, a reduction across threads, the gamma update with two
// digammas and an exp a topic, barriers).  The first CUDA version ran a
// tile on one CTA, so the EN books buckets ([5-22, 5, 16384-32768]: 1-3
// tiles) ran 1-3 CTAs on 132 SMs, one warp walking 16,384 slots per doc,
// and one thread per doc computed the k+1 digammas and k exps in turn:
// 23.0-23.3 ms on [22, 5, 16384] and 1.66-1.70 ms on the 20NG bucket
// [4652, 20, 64] (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design:
// * A tile is one thread-block cluster of `cs` CTAs (1-16; the wrapper's
//   cluster_size() picks the size from the tile count and L so that
//   tiles x cs fills the SMs).  Each CTA takes one slice of L.
// * Every iteration each CTA sums its slice into [tile_b, k] partials in
//   its shared memory and the cluster synchronises once.  Then every CTA
//   reads the cs partials through distributed shared memory in rank
//   order and updates the tile the same way, so all CTAs hold the same
//   gamma and stop flag bit for bit with no second barrier to broadcast
//   them; two partial buffers (one when cs = 1) let the next iteration
//   write while a slower CTA still reads.  The update is lane-parallel:
//   warp t is doc t, lane j is topic j (and j+32), and warp shuffles sum
//   gamma and |delta gamma|.
// * Three ways to sum a slice, chosen per launch: where the CTA's share
//   of the slab fits in shared memory it is read from device memory once,
//   then for k <= 8 a doc's threads keep k values and k sums in registers
//   (the EN buckets), for k > 8 two phases over shared memory (slot ratios,
//   then (doc, topic) sums) need few registers, so 4 CTAs share an SM (the
//   20NG buckets); where it does not fit (A's 32768 bucket), the register
//   path reads the slice from L2 every iteration, two slots' loads in
//   flight per thread.  Pad slots (cts == 0) are never read from eb.
//   The slab wins wherever it fits: with the path forced both ways on
//   the H100 above, [22, 5, 16384] took 0.550 ms from the slab and 0.75
//   ms from L2, [4652, 20, 64] 0.378 and 0.875 ms (the k <= 32 L2
//   instance needs 229 registers, one CTA an SM).  Measured with
//   chip_smoke.py on the H100 above: [22, 5, 16384] 0.552-0.566 ms,
//   [4652, 20, 64] 0.385-0.390 ms, [12, 5, 32768] 1.20-1.21 ms from L2.
// * Rank 0 writes the result.  No atomics: the result repeats bit for bit.
// digamma is the same six-step recurrence and asymptotic series as the TPU
// kernel (digamma.cuh).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "digamma.cuh"

namespace cg = cooperative_groups;

namespace {

using stc::digamma_approx;

constexpr int kMaxTileB = 8;
constexpr int kMaxCluster = 16;
constexpr int kMaxK = 64;
constexpr int kSmemLimit = 232448;     // 227 KB a block on the H100
constexpr int kSlotsPerThread = 4;     // fewest slots a thread walks
constexpr int kSlabRegThreads = 1024;  // register path over shared memory

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// exp(E[log theta]) of doc t from its gamma; lane j holds topics j, j+32
__device__ __forceinline__ void refresh_et(const float* gamma, float* et,
                                           int t, int k, int lane) {
  float g[2];
  float tot = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    g[h] = j < k ? gamma[t * k + j] : 0.0f;
    tot += g[h];
  }
  const float dg_tot = digamma_approx(warp_sum(tot));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j < k) et[t * k + j] = expf(digamma_approx(g[h]) - dg_tot);
  }
}

// What every launch passes.
struct Args {
  const float* eb;      // [B, k, L]
  const float* cts;     // [B, L]
  const float* alpha;   // [k]
  const float* gamma0;  // [B, k]
  float* out;           // [B, k]
  int b, k, l, tile_b;
  int ls;               // slots of L one CTA takes
  int par;              // stream: threads per doc; slab: chunks per (doc, topic)
  int max_inner;
  float tol;
};

// The tile state each CTA keeps, in floats: alpha [k], gamma and
// exp(E[log theta]) [tile_b, k], this slice's partial sums [tile_b, k]
// (two buffers when other CTAs read them), each doc's mean |delta gamma|.
__host__ __device__ __forceinline__ int part_buffers(int cs) {
  return cs > 1 ? 2 : 1;
}
__host__ __device__ __forceinline__ int state_floats(int k, int tk, int cs) {
  return k + (2 + part_buffers(cs)) * tk + kMaxTileB;
}

// The iteration loop of one tile, around a Slice that sums this CTA's
// slice of L into `part` ([tile_b, k]).  Every CTA of the cluster runs it
// and ends each iteration with the same gamma and stop flag.
template <class Slice>
__device__ __forceinline__ void run_tile(const Args& a, float* smem,
                                         Slice& slice, int tile) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int k = a.k;
  const int tk = a.tile_b * k;
  float* alpha_s = smem;
  float* gamma_s = alpha_s + k;
  float* et_s = gamma_s + tk;
  float* part_s = et_s + tk;
  float* change_s = part_s + part_buffers(cs) * tk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < tk; i += blockDim.x) {
    const int dd = tile * a.tile_b + i / k;
    gamma_s[i] = dd < a.b ? a.gamma0[static_cast<long long>(dd) * k + i % k] : 1.0f;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) alpha_s[j] = a.alpha[j];
  slice.load();
  __syncthreads();
  if (warp < a.tile_b) refresh_et(gamma_s, et_s, warp, k, lane);
  __syncthreads();

  int it = 0;
  int buf = 0;
  bool go = a.max_inner > 0;
  while (go) {
    float* part = part_s + buf * tk;
    slice.partials(part, et_s);
    cluster.sync();
    // every CTA: the cluster's partials in rank order, then the update
    if (warp < a.tile_b) {
      const int t = warp;
      float dsum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j < k) {
          float s = 0.0f;
          for (int q = 0; q < cs; ++q) {
            s += cluster.map_shared_rank(part, q)[t * k + j];
          }
          const float g = alpha_s[j] + et_s[t * k + j] * s;
          dsum += fabsf(g - gamma_s[t * k + j]);
          gamma_s[t * k + j] = g;
        }
      }
      dsum = warp_sum(dsum);
      refresh_et(gamma_s, et_s, t, k, lane);
      if (lane == 0) change_s[t] = dsum / k;
    }
    __syncthreads();
    ++it;
    float worst = 0.0f;
    for (int u = 0; u < a.tile_b; ++u) worst = fmaxf(worst, change_s[u]);
    go = it < a.max_inner && worst >= a.tol;
    buf = (buf + 1) % part_buffers(cs);
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < tk; i += blockDim.x) {
      const int dd = tile * a.tile_b + i / k;
      if (dd < a.b) a.out[static_cast<long long>(dd) * k + i % k] = gamma_s[i];
    }
  }
}

// Register path: a doc gets `par` threads (a warp multiple); a thread
// keeps U slots' k values and its k partial sums in registers, so U
// slots' loads are in flight at once, and the doc's sums are reduced by
// warp shuffles, then over the doc's warps in order.  With SMEM the CTA's
// slab share (cts and eb of its slice, every doc) sits in shared memory,
// read from device memory once; without, every iteration reads it from L2.
template <int KMAX, int U, bool SMEM>
struct RegSlice {
  const float* eb;
  const float* cts;
  const float* eb_d;   // this doc's [k, L]
  const float* cts_d;  // this doc's [L]
  float* wpart;        // [tile_b, warps a doc, k]
  float* cts_s;        // SMEM: [tile_b, ls]
  float* eb_s;         // SMEM: [tile_b, k, ls]
  int b, k, l, ls, l0, n, tile, tile_b, t, r, group, tk;
  bool real;

  __device__ __forceinline__ float count(int s) const {
    return SMEM ? cts_s[t * ls + s] : cts_d[l0 + s];
  }
  __device__ __forceinline__ float value(int j, int s) const {
    return SMEM ? eb_s[(t * k + j) * ls + s]
                : eb_d[static_cast<long long>(j) * l + l0 + s];
  }

  __device__ __forceinline__ void load() {
    if (!SMEM) return;
    for (int i = threadIdx.x; i < tile_b * ls; i += blockDim.x) {
      const int tt = i / ls;
      const int s = i - tt * ls;
      const int dd = tile * tile_b + tt;
      const float c = (dd < b && s < n) ? cts[static_cast<long long>(dd) * l + l0 + s] : 0.0f;
      cts_s[i] = c;
      if (c != 0.0f) {  // a pad slot's eb is never read
        const float* e = eb + static_cast<long long>(dd) * k * l + l0 + s;
        for (int j = 0; j < k; ++j) {
          eb_s[(tt * k + j) * ls + s] = e[static_cast<long long>(j) * l];
        }
      }
    }
  }

  __device__ __forceinline__ void partials(float* part, const float* et_s) {
    // exp(E[log theta]) of the doc: in registers for small k, else
    // broadcast reads from shared memory (one doc a warp)
    constexpr int KET = KMAX <= 8 ? KMAX : 1;
    float et_r[KET];
    const float* et = et_s + t * k;
#pragma unroll
    for (int j = 0; j < KET; ++j) et_r[j] = j < k ? et[j] : 0.0f;
    float acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[j] = 0.0f;
    if (real) {
      for (int s0 = r; s0 < n; s0 += U * group) {
        float c[U];
        float e[U][KMAX];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = s0 + u * group;
          c[u] = s < n ? count(s) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {  // a pad slot's eb is never read
            e[u][j] = (j < k && c[u] != 0.0f) ? value(j, s0 + u * group) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float phin = 0.0f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < k) phin += e[u][j] * (KMAX <= 8 ? et_r[j % KET] : et[j]);
          }
          const float ratio = c[u] / (phin + 1e-30f);  // 0 for a pad slot
#pragma unroll
          for (int j = 0; j < KMAX; ++j) acc[j] += e[u][j] * ratio;
        }
      }
    }
    const int lane = threadIdx.x & 31;
    const int wpd = group >> 5;
    if (wpd == 1) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) {
          const float v = warp_sum(acc[j]);
          if (lane == 0) part[t * k + j] = v;
        }
      }
      return;
    }
    const int wg = r >> 5;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const float v = warp_sum(acc[j]);
        if (lane == 0) wpart[(t * wpd + wg) * k + j] = v;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tk; i += blockDim.x) {
      const int tt = i / k;
      const int j = i - tt * k;
      float s = 0.0f;
      for (int w = 0; w < wpd; ++w) s += wpart[(tt * wpd + w) * k + j];
      part[i] = s;
    }
  }
};

template <int KMAX, int NT, int U, bool SMEM>
__global__ void __launch_bounds__(NT) estep_reg_kernel(const Args a) {
  extern __shared__ float smem[];
  const int cs = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tk = a.tile_b * a.k;
  RegSlice<KMAX, U, SMEM> slice;
  slice.tile = blockIdx.x / cs;
  slice.t = threadIdx.x / a.par;
  slice.r = threadIdx.x - slice.t * a.par;
  const int d = slice.tile * a.tile_b + slice.t;
  slice.real = d < a.b;
  slice.eb = a.eb;
  slice.cts = a.cts;
  slice.eb_d = a.eb + static_cast<long long>(slice.real ? d : 0) * a.k * a.l;
  slice.cts_d = a.cts + static_cast<long long>(slice.real ? d : 0) * a.l;
  slice.wpart = smem + state_floats(a.k, tk, cs);
  slice.cts_s = slice.wpart + tk * (a.par >> 5);
  slice.eb_s = slice.cts_s + a.tile_b * a.ls;
  slice.b = a.b;
  slice.k = a.k;
  slice.l = a.l;
  slice.ls = a.ls;
  slice.tile_b = a.tile_b;
  slice.l0 = min(a.l, rank * a.ls);
  slice.n = min(a.l, slice.l0 + a.ls) - slice.l0;
  slice.group = a.par;
  slice.tk = tk;
  run_tile(a, smem, slice, slice.tile);
}

// Two-phase path, for k > 8: the CTA's slab share sits in shared memory,
// read from device memory once (pad slots' eb never; their entries are
// zero), and few registers let more CTAs share an SM.  Each iteration: (1) a thread per (doc, slot) computes cts / phinorm into
// `ratio`, (2) a thread per (doc, topic, chunk) sums eb * ratio over
// every `chunks`-th slot with four independent sums, (3) a warp adds a
// (doc, topic)'s chunks.  eb rows are XOR-swizzled by their row index, so
// both phases hit 32 banks.
constexpr int kPhaseThreads = 1024;
constexpr int kMaxPairs = 8;  // (doc, slot) pairs a thread owns

template <int KMAX>
struct PhaseSlice {
  const float* eb;
  const float* cts;
  float* eb_s;     // [tile_b * k, ls], swizzled
  float* ratio_s;  // [tile_b, ls]
  float* red_s;    // [tile_b * k, chunks]
  int b, k, l, tile_b, ls, l0, l1, tile, chunks;
  float c[kMaxPairs];  // this thread's slots' cts, fixed for the launch

  __device__ __forceinline__ int at(int row, int s) const {
    return row * ls + (s ^ (row & 31));
  }

  __device__ __forceinline__ void load() {
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int q = threadIdx.x + i * blockDim.x;
      c[i] = 0.0f;
      if (q < tile_b * ls) {
        const int tt = q / ls;
        const int s = q - tt * ls;
        const int dd = tile * tile_b + tt;
        if (dd < b && l0 + s < l1) c[i] = cts[static_cast<long long>(dd) * l + l0 + s];
        const float* e = eb + (static_cast<long long>(dd) * k) * l + l0 + s;
#pragma unroll 8
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) {
            eb_s[at(tt * k + j, s)] =
                c[i] != 0.0f ? e[static_cast<long long>(j) * l] : 0.0f;
          }
        }
      }
    }
  }

  __device__ __forceinline__ void partials(float* part, const float* et_s) {
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int q = threadIdx.x + i * blockDim.x;
      if (q < tile_b * ls) {
        const int tt = q / ls;
        const int s = q - tt * ls;
        float phin = 0.0f;
#pragma unroll 8
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) phin += eb_s[at(tt * k + j, s)] * et_s[tt * k + j];
        }
        ratio_s[q] = c[i] != 0.0f ? c[i] / (phin + 1e-30f) : 0.0f;
      }
    }
    __syncthreads();
    const int tk = tile_b * k;
    for (int q = threadIdx.x; q < tk * chunks; q += blockDim.x) {
      const int row = q / chunks;
      const int ch = q - row * chunks;
      const float* rr = ratio_s + (row / k) * ls;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int s = ch;
      for (; s + 3 * chunks < ls; s += 4 * chunks) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u] += eb_s[at(row, s + u * chunks)] * rr[s + u * chunks];
        }
      }
      for (; s < ls; s += chunks) acc[0] += eb_s[at(row, s)] * rr[s];
      const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      if (chunks == 1) {
        part[row] = sum;
      } else {
        red_s[q] = sum;
      }
    }
    if (chunks > 1) {
      __syncthreads();
      const int lane = threadIdx.x & 31;
      for (int i = threadIdx.x >> 5; i < tk; i += blockDim.x >> 5) {
        const float v = warp_sum(lane < chunks ? red_s[i * chunks + lane] : 0.0f);
        if (lane == 0) part[i] = v;
      }
    }
  }
};

template <int KMAX>
__global__ void __launch_bounds__(kPhaseThreads) estep_phase_kernel(const Args a) {
  extern __shared__ float smem[];
  const int cs = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tk = a.tile_b * a.k;
  PhaseSlice<KMAX> slice;
  slice.eb = a.eb;
  slice.cts = a.cts;
  slice.eb_s = smem + state_floats(a.k, tk, cs);
  slice.ratio_s = slice.eb_s + tk * a.ls;
  slice.red_s = slice.ratio_s + a.tile_b * a.ls;
  slice.b = a.b;
  slice.k = a.k;
  slice.l = a.l;
  slice.tile_b = a.tile_b;
  slice.ls = a.ls;
  slice.l0 = min(a.l, rank * a.ls);
  slice.l1 = min(a.l, slice.l0 + a.ls);
  slice.tile = blockIdx.x / cs;
  slice.chunks = a.par;
  run_tile(a, smem, slice, slice.tile);
}

struct Geometry {
  int ls, par, threads;
  long long smem;
  bool slab, phase;
};

// Slice length, path, threads and shared memory of one launch.  nt: the
// L2 register instance's thread cap.  The slab goes to shared memory
// wherever it fits, since it wins there on both paths.
Geometry geometry(int k, int l, int tile_b, int cs, int nt) {
  Geometry g;
  g.ls = ((l + cs - 1) / cs + 31) / 32 * 32;
  const int tk = tile_b * k;
  const long long state = 4LL * state_floats(k, tk, cs);
  if (k > 8) {
    // two-phase: threads for kMaxPairs (doc, slot) pairs each, at least
    // 256; chunks so (doc, topic, chunk) fills them
    int threads = (tile_b * g.ls + kMaxPairs - 1) / kMaxPairs;
    threads = (threads + 31) / 32 * 32;
    threads = threads < 256 ? 256 : threads;
    const int chunks = tk >= threads ? 1 : (threads / tk > 32 ? 32 : threads / tk);
    const long long bytes =
        4LL * (tk * g.ls + tile_b * g.ls + (chunks > 1 ? tk * chunks : 0));
    if (threads <= kPhaseThreads && state + bytes <= kSmemLimit) {
      g.phase = g.slab = true;
      g.threads = threads;
      g.par = chunks;
      g.smem = state + bytes;
      return g;
    }
  }
  // register path: each thread walks >= kSlotsPerThread slots of its doc;
  // over shared memory (k <= 8) with kSlabRegThreads threads, from L2 with
  // the L2 instance's cap nt
  g.phase = false;
  auto fit_threads = [&](int cap) {
    const int max_warps = cap / 32 / tile_b;
    const int want = (g.ls + 32 * kSlotsPerThread - 1) / (32 * kSlotsPerThread);
    const int wpd = want > max_warps ? max_warps : want;
    g.par = 32 * wpd;
    g.threads = tile_b * g.par;
    return state + 4LL * tk * wpd;  // the tile state and the warps' sums
  };
  long long base = fit_threads(kSlabRegThreads);
  const long long bytes = 4LL * tile_b * g.ls * (k + 1);
  g.slab = k <= 8 && base + bytes <= kSmemLimit;
  if (!g.slab) base = fit_threads(nt);
  g.smem = base + (g.slab ? bytes : 0);
  return g;
}

// The launch configuration of one geometry: a cluster of cs CTAs a tile.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(int n_tiles, int cs, const Geometry& g, cudaStream_t stream) {
    cfg.gridDim = dim3(static_cast<unsigned>(n_tiles) * cs);
    cfg.blockDim = dim3(g.threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(g.smem);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Once per kernel: the most shared memory any geometry asks, and clusters
// of 16 (so no attribute call lands inside a graph capture).
template <class Kernel>
cudaError_t set_attributes(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Launches `kernel`; returns a CUDA error code.
template <class Kernel>
cudaError_t submit(Kernel kernel, cudaError_t attr, const Args& a, int cs,
                   const Geometry& g, cudaStream_t s) {
  if (attr != cudaSuccess) return attr;
  Launch launch((a.b + a.tile_b - 1) / a.tile_b, cs, g, s);
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// NT, U: the thread cap and unroll of the L2 register instance.
template <int KMAX, int NT, int U>
cudaError_t run(Args a, int cs, cudaStream_t s) {
  const Geometry g = geometry(a.k, a.l, a.tile_b, cs, NT);
  if (g.smem > kSmemLimit) return cudaErrorInvalidValue;
  a.ls = g.ls;
  a.par = g.par;
  if constexpr (KMAX > 8) {
    if (g.phase) {
      static const cudaError_t attr = set_attributes(estep_phase_kernel<KMAX>);
      return submit(estep_phase_kernel<KMAX>, attr, a, cs, g, s);
    }
  } else {
    if (g.slab) {
      static const cudaError_t attr =
          set_attributes(estep_reg_kernel<KMAX, kSlabRegThreads, 1, true>);
      return submit(estep_reg_kernel<KMAX, kSlabRegThreads, 1, true>, attr, a,
                    cs, g, s);
    }
  }
  static const cudaError_t attr = set_attributes(estep_reg_kernel<KMAX, NT, U, false>);
  return submit(estep_reg_kernel<KMAX, NT, U, false>, attr, a, cs, g, s);
}

}  // namespace

// Largest k the kernel takes (a thread keeps k values in registers).
extern "C" int stc_estep_max_k() { return kMaxK; }

// Largest tile_b the kernel takes (a warp per doc in the update).
extern "C" int stc_estep_max_tile_b() { return kMaxTileB; }

// cluster: CTAs per tile (1..16).  Returns a CUDA error code.
extern "C" int stc_gamma_fixed_point_bkl(
    const void* eb, const void* cts, const void* alpha, const void* gamma0,
    int b, int k, int l, int tile_b, int cluster, int max_inner, float tol,
    void* out, void* stream) {
  if (k < 1 || k > kMaxK || tile_b < 1 || tile_b > kMaxTileB || cluster < 1 ||
      cluster > kMaxCluster || l < 1 || b < 1) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.eb = static_cast<const float*>(eb);
  a.cts = static_cast<const float*>(cts);
  a.alpha = static_cast<const float*>(alpha);
  a.gamma0 = static_cast<const float*>(gamma0);
  a.out = static_cast<float*>(out);
  a.b = b;
  a.k = k;
  a.l = l;
  a.tile_b = tile_b;
  a.ls = a.par = 0;
  a.max_inner = max_inner;
  a.tol = tol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return run<8, 512, 2>(a, cluster, s);
  if (k <= 32) return run<32, 256, 2>(a, cluster, s);
  return run<64, 256, 1>(a, cluster, s);
}
