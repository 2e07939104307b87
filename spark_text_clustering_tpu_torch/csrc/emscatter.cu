// Vocab-tiled scatter of EM token posteriors into the term-topic table.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_emscatter.py,
//   scatter_add_vtiles (_scatter_kernel), which computes
//   zeros[k, shard_v].at[:, tile * vt + lid].add(wphi.T) over posteriors
//   already in the plan's vocab-sorted order.
//
// What bounds it on the H100: bytes.  It must read the k posteriors of
// each live token once, every slot's column and the block map once, and
// write the [k, shard_v] table once; there is one add per posterior.  At
// the 20NG shape (~0.53M live tokens in 1,287 blocks of 1,024 slots,
// k=20, V=2^18) that is ~42 MB of posteriors, ~5 MB of columns and
// ~21 MB of table: ~68 MB, about 20 us at 3.35 TB/s.
//
// Design.  The TPU kernel built a [vt, tb] one-hot in VMEM and contracted
// it on the MXU because Mosaic has no scatter, walking a tile's blocks in
// grid order.  The first CUDA version gave a vocab tile to one thread
// block: the 18-block tiles set the pace while most SMs idled, it ran k
// block-wide scans per piece and read one topic at a time with a 320 B
// lane stride.  It took 0.489 ms on the 20NG inputs, 3.4x slower than
// index_add_ of the live slots into a [V, k] table (NVIDIA H100 80GB
// HBM3, 700.00 W).  Now:
//
// * Pass 1 gives every piece of <= 512 slots (a block, or an equal part
//   of one, so a piece never spans two tiles) its own CTA, and grid.y
//   slices of <= 32 topics (k=500 needs 16).  The CTA compacts the
//   piece's live slots (ballot + popc); when they are a prefix, as the
//   planner lays them out, it reads only that prefix, as one contiguous
//   run of posteriors with 16-byte loads, and otherwise gathers the live
//   rows.  An all-pad piece reads no posterior.  The live posteriors are
//   staged topic-major in shared memory, lane-major inside a row (a lane
//   owns <= 16 consecutive live slots; its i-th sits at i * 33 + lane).
// * Run flags and the piece's list of runs are built once.  Then a warp
//   reduces a whole topic: each lane sums its runs in registers, one
//   warp-wide segmented scan (5 shuffle steps) carries runs across lanes,
//   each run's sum goes back into the row at its last slot, and the warp
//   writes the runs in order (coalesced).  A run that starts and ends
//   inside the piece has one writer.  The piece's first and last run may
//   continue into neighbouring pieces: their partial sums go to a
//   scratch table with the piece's metadata.
// * Pass 2 (one thread per piece and topic) lets the piece where such a
//   run starts add the partials of the pieces it covers, in piece order,
//   reading 8 pieces' metadata at a time, and store the total.  A hot
//   column over 11 blocks costs one thread 22 adds and 3 dependent loads.
//
// Every sum is taken in a fixed order, with no float atomics, so the
// result repeats bit for bit.  Columns no token hits keep the zeros the
// wrapper allocates.  Live keys must be nondecreasing inside a tile, as
// plan_em_scatter lays them out (the previous kernel assumed the same).
//
// Measured with chip_smoke.py on the H100 above, B's inputs: 0.0546-0.0551
// ms of device time (0.058-0.063 ms a call from Python) against the
// live-slot index_add_'s 0.135 (0.140-0.143); in B's fit pass 1 takes
// 40.6 us and pass 2 6.5 us a call, the [k, V] zero fill the rest.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPiece = 512;                  // slots one CTA takes
constexpr int kPerLane = kMaxPiece / 32;        // live slots a lane owns
constexpr int kGroupsPerWarp = kMaxPiece / 32 / kWarps;
constexpr int kBatch = 4;                       // staging loads in flight
constexpr int kMaxLd = 33 * kPerLane + 1;       // odd row stride
constexpr int kMaxSmem = (32 * kMaxLd + kMaxLd + kMaxPiece) * 4;
constexpr int kMaxVt = 1024;  // a run's column packs into 10 bits

// Shared-memory index of live slot s when each lane owns `per` consecutive
// live slots: lane-major, so lane L's i-th slot sits at i * 33 + L and a
// warp's reads of its i-th slots hit 32 banks.  inv_per = 1 / per; the
// float quotient is exact for s < 512.
__device__ __forceinline__ int slot_at(int s, int per, float inv_per) {
  const int lane = static_cast<int>((static_cast<float>(s) + 0.5f) * inv_per);
  return (s - lane * per) * 33 + lane;
}

__global__ void __launch_bounds__(kThreads, 4) scatter_pieces_kernel(
    const float* __restrict__ wphi,      // [nb * tb, k]
    const int* __restrict__ lids,        // [nb * tb]  (-1 = pad)
    const int* __restrict__ block_vtile, // [nb]
    int tb, int piece, int k, int kc, int vt, int shard_v, int ld,
    float* __restrict__ out,             // [k, shard_v], zeroed
    int4* __restrict__ meta,             // [n_pieces]: live, head, tail, single
    float* __restrict__ part) {          // [n_pieces, 2, k]: head, tail runs
  extern __shared__ float smem[];
  float* vals = smem;                                     // [kc, ld]
  int* keys = reinterpret_cast<int*>(vals + kc * ld);     // [ld]
  int* live_idx = keys + ld;                              // [piece]
  __shared__ int s_gcount[kMaxPiece / 32];
  __shared__ int s_gbase[kMaxPiece / 32];
  __shared__ int s_nlive;
  __shared__ int s_nruns;

  const int p = blockIdx.x;
  const int j0 = blockIdx.y * kc;
  const int jn = min(kc, k - j0);
  const long long slot0 = static_cast<long long>(p) * piece;
  const int col0 = block_vtile[slot0 / tb] * vt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_groups = (piece + 31) >> 5;

  // 1. the piece's live slots, compacted in slot order
  int my_lid[kGroupsPerWarp];
  unsigned my_mask[kGroupsPerWarp];
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    const int s = g * 32 + lane;
    my_lid[i] = (g < n_groups && s < piece) ? lids[slot0 + s] : -1;
    my_mask[i] = __ballot_sync(0xffffffffu, my_lid[i] >= 0);
    if (lane == 0 && g < n_groups) s_gcount[g] = __popc(my_mask[i]);
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < n_groups ? s_gcount[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane < n_groups) s_gbase[lane] = incl - c;
    if (lane == 31) s_nlive = incl;
  }
  __syncthreads();
  const int n_live = s_nlive;
  const int per = (n_live + 31) >> 5;  // live slots a lane owns below
  const float inv_per = per > 0 ? 1.0f / per : 0.0f;
  int moved = 0;
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    if (g < n_groups && my_lid[i] >= 0) {
      const int pos =
          s_gbase[g] + __popc(my_mask[i] & ((1u << lane) - 1u));
      live_idx[pos] = g * 32 + lane;
      keys[slot_at(pos, per, inv_per)] = my_lid[i];
      moved |= pos != g * 32 + lane;
    }
  }
  const bool prefix = !__syncthreads_or(moved);
  if (n_live == 0) {  // an all-pad piece: no posterior is read
    if (threadIdx.x == 0 && blockIdx.y == 0) meta[p] = make_int4(0, -1, -1, 0);
    return;
  }
  const int first_key = keys[0];
  const int last_key = keys[slot_at(n_live - 1, per, inv_per)];
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    meta[p] = make_int4(n_live, col0 + first_key, col0 + last_key,
                        first_key == last_key ? 1 : 0);
  }

  // 2. the live posteriors of this topic slice, topic-major in vals; a
  //    thread has kBatch loads in flight before it stores any
  const float* src = wphi + slot0 * k;
  if (prefix && jn == k && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int n = n_live * k;
    const int n4 = n >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int base = threadIdx.x; base < n4; base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e4 = base + q * kThreads;
        if (e4 < n4) v[q] = __ldg(src4 + e4);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e4 = base + q * kThreads;
        if (e4 < n4) {
          const float x[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
          int s = (e4 * 4) / k;
          int jj = e4 * 4 - s * k;
          int at = slot_at(s, per, inv_per);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            vals[jj * ld + at] = x[w];
            if (++jj == k) {
              jj = 0;
              at = slot_at(++s, per, inv_per);
            }
          }
        }
      }
    }
    for (int e = n4 * 4 + threadIdx.x; e < n; e += kThreads) {
      const int s = e / k;
      vals[(e - s * k) * ld + slot_at(s, per, inv_per)] = src[e];
    }
  } else {
    for (int base = threadIdx.x; base < n_live * jn; base += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = base + q * kThreads;
        if (e < n_live * jn) {
          const int s = e / jn;
          const long long row = prefix ? s : live_idx[s];
          v[q] = __ldg(src + row * k + j0 + (e - s * jn));
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = base + q * kThreads;
        if (e < n_live * jn) {
          const int s = e / jn;
          vals[(e - s * jn) * ld + slot_at(s, per, inv_per)] = v[q];
        }
      }
    }
  }
  __syncthreads();

  // 3. run flags: a lane owns `per` consecutive live slots; every warp
  //    holds the same flags
  const int s_begin = lane * per;
  // this lane's live slots: i < mine
  const int mine = max(0, min(per, n_live - s_begin));
  unsigned head = 0, tail = 0;
  {
    int key[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) key[i] = i < mine ? keys[i * 33 + lane] : INT_MIN;
    const int prev = s_begin > 0 && s_begin <= n_live ? keys[(per - 1) * 33 + lane - 1] : INT_MIN;
    const int next = s_begin + per < n_live ? keys[lane + 1] : INT_MIN;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int s = s_begin + i;
      if (i < mine) {
        const int before = i > 0 ? key[i - 1] : prev;
        const int after = i + 1 < per ? key[i + 1] : next;
        if (s == 0 || key[i] != before) head |= 1u << i;
        if (s == n_live - 1 || key[i] != after) tail |= 1u << i;
      }
    }
  }
  // the piece's runs in order, each as its last slot's index in a row, its
  // column and where its sum goes (0: out; 1: the head run's partial; 2: the tail
  // run's), packed into live_idx (free after the staging)
  int* runs = live_idx;
  if (warp == 0) {
    const int c = __popc(tail);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s_nruns = incl;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if ((tail >> i) & 1u) {
        const int r = incl - c + __popc(tail & ((1u << i) - 1u));
        const int key = keys[i * 33 + lane];
        const int dest = key == first_key ? 1 : (s_begin + i == n_live - 1 ? 2 : 0);
        runs[r] = ((i * 33 + lane) << 12) | (key << 2) | dest;
      }
    }
  }
  __syncthreads();
  const int n_runs = s_nruns;
  const int first_head = head ? __ffs(head) - 1 : kPerLane;

  // 4. per topic (a warp each): segmented sums inside the lane, one warp
  //    scan carries runs across lanes; each run's sum is stored in place
  //    at its last slot, then the warp writes the runs in order
  for (int jj = warp; jj < jn; jj += kWarps) {
    float* row = vals + jj * ld;
    float v[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = i < mine ? row[i * 33 + lane] : 0.0f;
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) {
      if (!((head >> i) & 1u)) v[i] = v[i - 1] + v[i];
    }
    // warp scan of (lane has a head, sum of the lane's open run)
    int f = head != 0;
    float a = v[kPerLane - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int fo = __shfl_up_sync(0xffffffffu, f, off);
      const float ao = __shfl_up_sync(0xffffffffu, a, off);
      if (lane >= off) {
        if (!f) a = ao + a;
        f |= fo;
      }
    }
    const float al = __shfl_up_sync(0xffffffffu, a, 1);
    const float carry = lane > 0 ? al : 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (i < first_head) v[i] = carry + v[i];
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if ((tail >> i) & 1u) row[i * 33 + lane] = v[i];
    }
    __syncwarp();
    const int j = j0 + jj;
    float* orow = out + static_cast<long long>(j) * shard_v + col0;
    for (int r = lane; r < n_runs; r += 32) {
      const int run = runs[r];
      const float x = row[run >> 12];
      const int dest = run & 3;
      if (dest == 0) {
        if (col0 + ((run >> 2) & 1023) < shard_v) orow[(run >> 2) & 1023] = x;
      } else {
        part[(2LL * p + dest - 1) * k + j] = x;
      }
    }
  }
}

constexpr int kWalk = 8;  // pieces whose metadata a link thread loads at once

// The sum of the run of column `col` whose partial in piece p is
// part[p, which]; with `walk`, the run may go on into later pieces.  The
// pieces are read kWalk at a time, so a run over many pieces costs few
// dependent loads.
__device__ __forceinline__ float finish_run(const int4* __restrict__ meta,
                                            const float* __restrict__ part,
                                            int n_pieces, int k, int p,
                                            int which, int j, int col,
                                            bool walk) {
  float sum = part[(2LL * p + which) * k + j];
  for (int r0 = p + 1; walk && r0 < n_pieces; r0 += kWalk) {
    int live[kWalk], head[kWalk], single[kWalk];
    float h[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      const int r = r0 + u;
      live[u] = -1;  // past the last piece
      head[u] = single[u] = 0;
      h[u] = 0.0f;
      if (r < n_pieces) {
        const int4 m = meta[r];
        live[u] = m.x;
        head[u] = m.y;
        single[u] = m.w;
        h[u] = part[(2LL * r) * k + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      if (walk && live[u] != 0) {  // empty pieces are skipped
        if (live[u] < 0 || head[u] != col) {
          walk = false;
        } else {
          sum = sum + h[u];
          walk = single[u] != 0;
        }
      }
    }
  }
  return sum;
}

// The tail column of the last piece before p that has live slots (-1 if
// none), read kWalk pieces at a time.
__device__ __forceinline__ int tail_before(const int4* __restrict__ meta, int p) {
  for (int r0 = p - 1; r0 >= 0; r0 -= kWalk) {
    int live[kWalk], tail[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      live[u] = 0;
      tail[u] = -1;
      if (r0 - u >= 0) {
        const int4 m = meta[r0 - u];
        live[u] = m.x;
        tail[u] = m.z;
      }
    }
    int found = -2;
#pragma unroll
    for (int u = kWalk - 1; u >= 0; --u) {
      if (live[u] != 0) found = tail[u];  // the nearest one wins
    }
    if (found != -2) return found;
  }
  return -1;
}

__global__ void scatter_link_kernel(const int4* __restrict__ meta,
                                    const float* __restrict__ part,
                                    int n_pieces, int k, int shard_v,
                                    float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_pieces) * k) return;
  const int p = static_cast<int>(i / k);
  const int j = static_cast<int>(i - static_cast<long long>(p) * k);
  const int4 m = meta[p];
  if (m.x == 0) return;
  // the head run is this piece's unless it goes on from the last piece
  // before it that has live slots
  if (tail_before(meta, p) != m.y) {
    const float s = finish_run(meta, part, n_pieces, k, p, 0, j, m.y, m.w != 0);
    if (m.y < shard_v) out[static_cast<long long>(j) * shard_v + m.y] = s;
  }
  if (!m.w) {  // the tail run starts here
    const float s = finish_run(meta, part, n_pieces, k, p, 1, j, m.z, true);
    if (m.z < shard_v) out[static_cast<long long>(j) * shard_v + m.z] = s;
  }
}

}  // namespace

// piece: slots a CTA of pass 1 takes (<= 512, divides tb); kc: topics a
// CTA stages (<= 32); meta and part: scratch of nb * tb / piece pieces.
extern "C" int stc_scatter_add_vtiles(
    const void* wphi, const void* lids, const void* block_vtile,
    int nb, int tb, int piece, int k, int kc, int vt, int shard_v,
    void* out, void* meta, void* part, void* stream) {
  if (piece < 1 || piece > kMaxPiece || tb % piece != 0 || kc < 1 ||
      kc > 32 || k < 1 || vt < 1 || vt > kMaxVt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_pieces = static_cast<long long>(nb) * (tb / piece);
  if (n_pieces == 0) return 0;
  if (n_pieces > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = (33 * ((piece + 31) / 32) + 1) | 1;  // odd row stride
  const int smem = (kc * ld + ld + piece) * 4;
  // once: the most shared memory any launch asks (no attribute call lands
  // inside a graph capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      scatter_pieces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  cudaError_t err = attr;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_pieces), (k + kc - 1) / kc);
  scatter_pieces_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(wphi), static_cast<const int*>(lids),
      static_cast<const int*>(block_vtile), tb, piece, k, kc, vt, shard_v, ld,
      static_cast<float*>(out), static_cast<int4*>(meta),
      static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = n_pieces * k;
  scatter_link_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const int4*>(meta), static_cast<const float*>(part),
      static_cast<int>(n_pieces), k, shard_v, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
