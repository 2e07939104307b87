// One whole EM sweep, fused: the token posteriors are made where they are
// summed and never written to device memory.
//
// Replaces: spark_text_clustering_tpu/ops/pallas_emsweep.py,
//   em_sweep_fused (_sweep_kernel).  Per live token:
//     term = N_wk[:, col] + eta - 1
//     doc  = (N_dk + alpha - 1)[seg, :]
//     phi  = term * doc * inv_denom, normalized over k;  wphi = cts * phi
//   and the sweep returns N_wk'[k, shard_v] (wphi summed by column) and
//   N_dk'[d_pad, k] (wphi summed by doc).  Pad slots add exactly 0;
//   columns and docs that no token hits stay exactly 0.
//
// What bounds it on the H100: bytes.  The sweep must read each token once
// and the [k, shard_v] table once, and write the table and the doc counts
// once; it does ~6k operations a token.  At the EN books shape (~0.57M
// tokens, k=5, V=39,380) that is ~9 MB, 2.6 us: far below the time of a
// launch, so the kernel is bound by latency and by the CTAs in flight.
//
// Design.  The TPU kernel built two one-hots in VMEM (vocab and doc) and
// ran four MXU products, because Mosaic has neither gather nor scatter,
// walking the token blocks in grid order.  The first CUDA version gave a
// vocab tile to one thread block (154 CTAs at EN books, ~9 warps an SM),
// ran a block-wide scan per topic, and kept one [d_pad, k] N_dk copy per
// warp in shared memory, summed over the tiles by a second kernel.  Now
// the sweep reads the tokens twice, in two orders, and sums each output
// over runs of equal keys, in three launches:
//
// * The vocab stream is the plan's vocab-sorted layout: runs of equal
//   column inside a tile give N_wk'.  The doc stream is the same live
//   tokens doc-contiguous (docs in nondecreasing order): runs of equal
//   doc give N_dk'.
// * Launch 1 lays N_wk out as a term table [shard_v, kp]: (N_wk + eta - 1)
//   * inv_denom, a token's topics one contiguous row read with 16-byte
//   loads (gathered topic by topic from [k, shard_v], the doc stream's
//   random columns cost one L1 request a topic and token), and zeroes the
//   two outputs.
// * Launch 2 gives each piece of <= 512 slots of either stream its own
//   CTA (a vocab piece never spans two token blocks, so two tiles), with
//   topic slices of <= 32 in grid.y.  The CTA compacts its live slots
//   (ballot + popc) and makes each live token's phi over all k: the term
//   row through L1/L2, the doc factor from a shared-memory copy in vocab
//   pieces where it is small (d_pad * k <= 4,096), else through L1/L2.
//   Its topic slice of wphi is staged topic-major in shared memory,
//   lane-major in a row (a lane owns <= 16 consecutive live slots; its
//   i-th at i*33+lane).  Each live slot sets its run-head and run-tail
//   bits in its owner lane's masks.  Then a warp reduces a whole topic:
//   each lane sums its runs in registers, one warp segmented scan (5
//   shuffle steps) carries runs across lanes, and a run's last slot's
//   lane writes its sum.  Four block barriers a CTA at any k.  A run
//   inside the piece has one writer; the piece's first and last run may
//   go on into the neighbouring pieces of the same stream, so their sums
//   go to scratch with the piece's metadata.
// * Launch 3, the link (one thread per piece and topic), lets the piece
//   where such a run starts add the partials of the pieces it covers, in
//   piece order, and store the total.
//
// Nothing in shared memory grows with d_pad * k beyond the optional doc
// factor copy, so no geometry the gate lets through is refused.  Every
// float sum is taken in a fixed order, with no float atomics (the run
// masks are integer ORs, whose result has no order): the result repeats
// bit for bit.
//
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, at
// the EN books shape: 0.035 ms of device time a sweep by graph replay;
// over a profiled fit 0.0347 a sweep (pieces 0.0262, link 0.0059, term
// table 0.0026) against the first version's 0.0607 (its sweep 0.0562 and
// N_dk reduce 0.0044), and a 0.0026 ms bound.  Per-phase cuts of the
// pieces launch found it bound by per-CTA latency and instruction issue,
// not by occupancy: 4 or 6 CTAs an SM ran alike.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPiece = 512;                   // slots one CTA takes
constexpr int kPerLane = kMaxPiece / 32;         // live slots a lane owns
constexpr int kGroupsPerWarp = kMaxPiece / 32 / kWarps;
constexpr int kKc = 32;                          // topics a CTA stages
constexpr int kLd = 33 * kPerLane + 1;           // odd row stride
constexpr int kDocfSmemFloats = 4096;            // doc factor copy, at most
// after the [kc, kLd] values: keys, per-group counts and bases, n_live,
// and the lanes' head and tail masks
constexpr int kTailFloats = kLd + 2 * kMaxPiece / 32 + 1 + 64;
constexpr int kMaxSmem = (kKc * kLd + kTailFloats + kDocfSmemFloats) * 4;

struct SweepArgs {
  const float* term;       // [shard_v, kp] (N_wk + eta - 1) * inv_denom, transposed
  const float* docf;       // [k, d_pad] (N_dk + alpha - 1)^T
  const int* lids;         // [nb * tb] vocab stream: column in tile, -1 pad
  const int* seg;          // [nb * tb] its doc slots
  const float* cts;        // [nb * tb] its weights
  const int* block_vtile;  // [nb]
  const int* doc_cols;     // [n_doc] doc stream: global columns
  const int* doc_seg;      // [n_doc] doc slots, nondecreasing
  const float* doc_cts;    // [n_doc] weights
  int tb, vpiece, n_vpieces, n_doc, dpiece;
  int k, kp, kc, vt, d_pad, shard_v, docf_smem;
  float* nwk_out;          // [k, shard_v], zeroed by the term table's launch
  float* ndk_out;          // [d_pad, k], the same
  int4* meta;              // [n_pieces]: live, head key, tail key, single run
  float* part;             // [n_pieces, 2, k]: head run, tail run
};

// Shared-memory index of live slot s when each lane owns `per` consecutive
// live slots: lane-major, so lane L's i-th slot sits at i * 33 + L and a
// warp's reads of its i-th slots hit 32 banks.  inv_per = 1 / per; the
// float quotient is exact for s < 512.
__device__ __forceinline__ int slot_at(int s, int per, float inv_per) {
  const int lane = static_cast<int>((static_cast<float>(s) + 0.5f) * inv_per);
  return (s - lane * per) * 33 + lane;
}

// The term table: term[v, j] = (N_wk[j, v] + eta - 1) * inv_denom[j],
// rows padded with zeros to kp (a multiple of kChunk), so a token's
// topics are one contiguous row read with 16-byte loads.  One thread a
// column: its reads of N_wk are coalesced across the warp.  It also zeroes
// both outputs (the columns and docs no token hits stay 0), so the sweep
// needs no separate fill.
__global__ void term_table_kernel(const float* __restrict__ nwk,
                                  const float* __restrict__ inv_denom, int k,
                                  int kp, int shard_v, int ndk_size,
                                  float eta_m1, float* __restrict__ term,
                                  float* __restrict__ nwk_out,
                                  float* __restrict__ ndk_out) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < ndk_size) ndk_out[v] = 0.0f;
  if (v >= shard_v) return;
  float4* row = reinterpret_cast<float4*>(term + static_cast<long long>(v) * kp);
  for (int j = 0; j < kp; j += 4) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + u < k) {
        const long long at = static_cast<long long>(j + u) * shard_v + v;
        x[u] = (nwk[at] + eta_m1) * inv_denom[j + u];
        nwk_out[at] = 0.0f;
      } else {
        x[u] = 0.0f;
      }
    }
    row[j >> 2] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

constexpr int kChunk = 8;  // topics of a token read at once (two float4)

// phi_j, j in [jb, jb + kChunk) and < j_end, of this thread's slots before
// normalization (0 for dead slots and past j_end); every load of the
// chunk is issued before the first is used.
__device__ __forceinline__ void phi_chunk(const SweepArgs& a, const float* docf,
                                          int jb, int j_end,
                                          const int (&key)[kGroupsPerWarp],
                                          const int (&col)[kGroupsPerWarp],
                                          const int (&doc)[kGroupsPerWarp],
                                          float (&out)[kGroupsPerWarp][kChunk]) {
  float4 t[kGroupsPerWarp][kChunk / 4];
  float dv[kGroupsPerWarp][kChunk];
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const float4* row = reinterpret_cast<const float4*>(
        a.term + static_cast<long long>(col[i]) * a.kp + jb);
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      t[i][q] = key[i] >= 0 ? __ldg(row + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      dv[i][u] = key[i] >= 0 && jb + u < j_end ? docf[(jb + u) * a.d_pad + doc[i]] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      out[i][4 * q] = t[i][q].x * dv[i][4 * q];
      out[i][4 * q + 1] = t[i][q].y * dv[i][4 * q + 1];
      out[i][4 * q + 2] = t[i][q].z * dv[i][4 * q + 2];
      out[i][4 * q + 3] = t[i][q].w * dv[i][4 * q + 3];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4) sweep_pieces_kernel(
    const SweepArgs a) {
  extern __shared__ float smem[];
  float* vals = smem;                                  // [kc, kLd]
  int* keys = reinterpret_cast<int*>(vals + a.kc * kLd);  // [kLd]
  int* s_gcount = keys + kLd;                          // [kMaxPiece / 32]
  int* s_gbase = s_gcount + kMaxPiece / 32;            // [kMaxPiece / 32]
  int* s_count = s_gbase + kMaxPiece / 32;             // n_live
  unsigned* s_head = reinterpret_cast<unsigned*>(s_count + 1);  // [32]
  unsigned* s_tail = s_head + 32;                      // [32]
  float* docf_s = reinterpret_cast<float*>(s_tail + 32);  // [k, d_pad]

  const int p = blockIdx.x;
  const bool vocab = p < a.n_vpieces;
  const int j0 = blockIdx.y * a.kc;
  const int jn = min(a.kc, a.k - j0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long slot0;
  int len, col0 = 0;
  if (vocab) {
    slot0 = static_cast<long long>(p) * a.vpiece;
    len = a.vpiece;
    col0 = a.block_vtile[slot0 / a.tb] * a.vt;
  } else {
    slot0 = static_cast<long long>(p - a.n_vpieces) * a.dpiece;
    len = static_cast<int>(min(static_cast<long long>(a.dpiece),
                               a.n_doc - slot0));
  }
  if (threadIdx.x < 32) s_head[threadIdx.x] = s_tail[threadIdx.x] = 0u;
  const bool docf_smem = vocab && a.docf_smem;
  const float* docf = docf_smem ? docf_s : a.docf;
  if (docf_smem) {
    for (int i = threadIdx.x; i < a.k * a.d_pad; i += kThreads) {
      docf_s[i] = __ldg(a.docf + i);
    }
  }

  // 1. the piece's slots: every load issued before any is used
  int my_key[kGroupsPerWarp], my_col[kGroupsPerWarp], my_doc[kGroupsPerWarp];
  float my_cts[kGroupsPerWarp];
  unsigned my_mask[kGroupsPerWarp];
  const int n_groups = (len + 31) >> 5;
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const int s = (warp + i * kWarps) * 32 + lane;
    my_key[i] = -1;
    my_col[i] = my_doc[i] = 0;
    my_cts[i] = 0.0f;
    if (s < len) {
      const long long g = slot0 + s;
      if (vocab) {
        const int lid = a.lids[g];
        my_doc[i] = a.seg[g];
        my_cts[i] = a.cts[g];
        my_key[i] = lid;
        my_col[i] = min(col0 + max(lid, 0), a.shard_v - 1);  // as the plain version
      } else {
        my_doc[i] = my_key[i] = a.doc_seg[g];
        my_col[i] = a.doc_cols[g];
        my_cts[i] = a.doc_cts[g];
      }
    }
    my_mask[i] = __ballot_sync(0xffffffffu, my_key[i] >= 0);
    const int grp = warp + i * kWarps;
    if (lane == 0 && grp < n_groups) s_gcount[grp] = __popc(my_mask[i]);
  }
  __syncthreads();

  // 2. where each group's live slots go; meanwhile each live token's
  //    normalizer, over all k
  if (warp == 0) {
    const int c = lane < n_groups ? s_gcount[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane < n_groups) s_gbase[lane] = incl - c;
    if (lane == 31) s_count[0] = incl;
  }
  float den[kGroupsPerWarp] = {};
  float ph0[kGroupsPerWarp][kChunk];  // topics [0, kChunk), kept for slice 0
  for (int jb = 0; jb < a.k; jb += kChunk) {
    float ph[kGroupsPerWarp][kChunk];
    phi_chunk(a, docf, jb, a.k, my_key, my_col, my_doc, ph);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
#pragma unroll
      for (int i = 0; i < kGroupsPerWarp; ++i) {
        den[i] += ph[i][u];
        if (jb == 0) ph0[i][u] = ph[i][u];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) den[i] += 1e-30f;
  __syncthreads();
  const int n_live = s_count[0];
  if (n_live == 0) {  // an all-pad piece
    if (threadIdx.x == 0 && blockIdx.y == 0) {
      a.meta[p] = make_int4(0, -1, -1, 0);
    }
    return;
  }

  // 3. the live keys, and this slice's wphi, compacted in slot order
  const int per = (n_live + 31) >> 5;  // live slots a lane owns below
  const float inv_per = 1.0f / per;
  int pos[kGroupsPerWarp], at[kGroupsPerWarp];
  float scale[kGroupsPerWarp];  // cts / sum_j phi_j
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    pos[i] = at[i] = -1;
    scale[i] = my_cts[i] / den[i];
    if (my_key[i] >= 0) {
      const int grp = warp + i * kWarps;
      pos[i] = s_gbase[grp] + __popc(my_mask[i] & ((1u << lane) - 1u));
      at[i] = slot_at(pos[i], per, inv_per);
      keys[at[i]] = my_key[i];
    }
  }
  for (int jb = j0; jb < j0 + jn; jb += kChunk) {
    float ph[kGroupsPerWarp][kChunk];
    if (jb == 0) {
#pragma unroll
      for (int i = 0; i < kGroupsPerWarp; ++i) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) ph[i][u] = ph0[i][u];
      }
    } else {
      phi_chunk(a, docf, jb, j0 + jn, my_key, my_col, my_doc, ph);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
#pragma unroll
      for (int i = 0; i < kGroupsPerWarp; ++i) {
        if (at[i] >= 0 && jb + u < j0 + jn) {
          vals[(jb + u - j0) * kLd + at[i]] = ph[i][u] * scale[i];
        }
      }
    }
  }
  __syncthreads();
  const int first_key = keys[0];
  const int last_key = keys[slot_at(n_live - 1, per, inv_per)];
  const int key0 = vocab ? col0 : 0;  // a run's key in the link: column or doc
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    a.meta[p] = make_int4(n_live, key0 + first_key, key0 + last_key,
                          first_key == last_key ? 1 : 0);
  }

  // 4. run flags: each live slot sets its bit in its owner lane's head and
  //    tail masks (an OR of bits, in any order, gives one result)
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    if (at[i] >= 0) {
      const int before = pos[i] > 0 ? keys[slot_at(pos[i] - 1, per, inv_per)] : INT_MIN;
      const int after =
          pos[i] + 1 < n_live ? keys[slot_at(pos[i] + 1, per, inv_per)] : INT_MIN;
      const int item = at[i] / 33;
      const int owner = at[i] - item * 33;
      if (my_key[i] != before) atomicOr(s_head + owner, 1u << item);
      if (my_key[i] != after) atomicOr(s_tail + owner, 1u << item);
    }
  }
  __syncthreads();
  const unsigned head = s_head[lane], tail = s_tail[lane];
  const int mine = max(0, min(per, n_live - lane * per));  // live slots i < mine
  const int first_head = head ? __ffs(head) - 1 : kPerLane;

  // 5. per topic (a warp each): segmented sums inside the lane, one warp
  //    scan carries runs across lanes; each run's last slot's lane writes
  //    the run's sum (the piece's first and last run to scratch)
  for (int jj = warp; jj < jn; jj += kWarps) {
    const float* row = vals + jj * kLd;
    float v[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = i < mine ? row[i * 33 + lane] : 0.0f;
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) {
      if (!((head >> i) & 1u)) v[i] = v[i - 1] + v[i];
    }
    // warp scan of (lane has a head, sum of the lane's open run)
    int f = head != 0;
    float acc = v[kPerLane - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int fo = __shfl_up_sync(0xffffffffu, f, off);
      const float ao = __shfl_up_sync(0xffffffffu, acc, off);
      if (lane >= off) {
        if (!f) acc = ao + acc;
        f |= fo;
      }
    }
    const float al = __shfl_up_sync(0xffffffffu, acc, 1);
    const float carry = lane > 0 ? al : 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (i < first_head) v[i] = carry + v[i];
    }
    const int j = j0 + jj;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if ((tail >> i) & 1u) {
        const int key = keys[i * 33 + lane];
        if (key == first_key) {
          a.part[2LL * p * a.k + j] = v[i];
        } else if (lane * per + i == n_live - 1) {
          a.part[(2LL * p + 1) * a.k + j] = v[i];
        } else if (!vocab) {
          a.ndk_out[static_cast<long long>(key) * a.k + j] = v[i];
        } else if (col0 + key < a.shard_v) {
          a.nwk_out[static_cast<long long>(j) * a.shard_v + col0 + key] = v[i];
        }
      }
    }
  }
}

constexpr int kWalk = 8;  // pieces whose metadata a link thread loads at once

// The sum of the run of key `key` whose partial in piece p is
// part[p, which]; with `walk`, the run may go on into later pieces before
// `end`.  The pieces are read kWalk at a time, so a run over many pieces
// costs few dependent loads.
__device__ __forceinline__ float finish_run(const int4* __restrict__ meta,
                                            const float* __restrict__ part,
                                            int end, int k, int p, int which,
                                            int j, int key, bool walk) {
  float sum = part[(2LL * p + which) * k + j];
  for (int r0 = p + 1; walk && r0 < end; r0 += kWalk) {
    int live[kWalk], head[kWalk], single[kWalk];
    float h[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      const int r = r0 + u;
      live[u] = -1;  // past the stream's last piece
      head[u] = single[u] = 0;
      h[u] = 0.0f;
      if (r < end) {
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
        if (live[u] < 0 || head[u] != key) {
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

// The tail key of the last piece in [begin, p) that has live slots (-1 if
// none), read kWalk pieces at a time.
__device__ __forceinline__ int tail_before(const int4* __restrict__ meta,
                                           int begin, int p) {
  for (int r0 = p - 1; r0 >= begin; r0 -= kWalk) {
    int live[kWalk], tail[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      live[u] = 0;
      tail[u] = -1;
      if (r0 - u >= begin) {
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

// Runs that cross pieces, joined in piece order inside each stream: vocab
// pieces [0, n_vpieces) into N_wk', doc pieces [n_vpieces, n_pieces) into
// N_dk'.
__global__ void sweep_link_kernel(const int4* __restrict__ meta,
                                  const float* __restrict__ part,
                                  int n_vpieces, int n_pieces, int k,
                                  int shard_v, float* __restrict__ nwk_out,
                                  float* __restrict__ ndk_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_pieces) * k) return;
  const int p = static_cast<int>(i / k);
  const int j = static_cast<int>(i - static_cast<long long>(p) * k);
  const int4 m = meta[p];
  if (m.x == 0) return;
  const bool vocab = p < n_vpieces;
  const int begin = vocab ? 0 : n_vpieces;
  const int end = vocab ? n_vpieces : n_pieces;
  float s[2];
  int key[2];
  int n = 0;
  // the head run is this piece's unless it goes on from the last piece
  // before it that has live slots
  if (tail_before(meta, begin, p) != m.y) {
    s[n] = finish_run(meta, part, end, k, p, 0, j, m.y, m.w != 0);
    key[n++] = m.y;
  }
  if (!m.w) {  // the tail run starts here
    s[n] = finish_run(meta, part, end, k, p, 1, j, m.z, true);
    key[n++] = m.z;
  }
  for (int u = 0; u < n; ++u) {
    if (!vocab) {
      ndk_out[static_cast<long long>(key[u]) * k + j] = s[u];
    } else if (key[u] < shard_v) {
      nwk_out[static_cast<long long>(j) * shard_v + key[u]] = s[u];
    }
  }
}

}  // namespace

// vpiece: slots a vocab CTA takes (<= 512, divides tb); dpiece: slots a
// doc CTA takes (<= 512); term: scratch of
// shard_v * kp floats, 16-byte aligned (kp = k rounded up to kChunk); meta
// and part: scratch of nb * tb / vpiece + ceil(n_doc / dpiece) pieces.
extern "C" int stc_em_sweep_fused(
    const void* nwk, const void* docf, const void* inv_denom,
    const void* lids, const void* seg, const void* cts,
    const void* block_vtile, const void* doc_cols, const void* doc_cts,
    const void* doc_seg, int nb, int tb, int vpiece, int n_doc, int dpiece,
    int k, int vt, int d_pad, int shard_v, float eta_m1, void* nwk_out,
    void* ndk_out, void* term, void* meta, void* part, void* stream) {
  if (vpiece < 1 || vpiece > kMaxPiece || tb % vpiece != 0 || dpiece < 1 ||
      dpiece > kMaxPiece || k < 1 || vt < 1 || d_pad < 1 || n_doc < 0 ||
      shard_v < 1 ||
      (reinterpret_cast<unsigned long long>(term) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_vpieces = static_cast<long long>(nb) * (tb / vpiece);
  const long long n_pieces = n_vpieces + (n_doc + dpiece - 1) / dpiece;
  const int kp = (k + kChunk - 1) / kChunk * kChunk;
  if (n_pieces * k > INT_MAX || static_cast<long long>(shard_v) * kp > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pieces == 0) return 0;
  SweepArgs a;
  a.term = static_cast<const float*>(term);
  a.docf = static_cast<const float*>(docf);
  a.lids = static_cast<const int*>(lids);
  a.seg = static_cast<const int*>(seg);
  a.cts = static_cast<const float*>(cts);
  a.block_vtile = static_cast<const int*>(block_vtile);
  a.doc_cols = static_cast<const int*>(doc_cols);
  a.doc_seg = static_cast<const int*>(doc_seg);
  a.doc_cts = static_cast<const float*>(doc_cts);
  a.tb = tb;
  a.vpiece = vpiece;
  a.n_vpieces = static_cast<int>(n_vpieces);
  a.n_doc = n_doc;
  a.dpiece = dpiece;
  a.k = k;
  a.kp = kp;
  a.kc = k < kKc ? k : kKc;
  a.vt = vt;
  a.d_pad = d_pad;
  a.shard_v = shard_v;
  a.docf_smem = k * d_pad <= kDocfSmemFloats ? 1 : 0;
  a.nwk_out = static_cast<float*>(nwk_out);
  a.ndk_out = static_cast<float*>(ndk_out);
  a.meta = static_cast<int4*>(meta);
  a.part = static_cast<float*>(part);
  const int smem = (a.kc * kLd + kTailFloats + (a.docf_smem ? k * d_pad : 0)) * 4;
  // once: the most shared memory any launch asks (no attribute call lands
  // inside a graph capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_pieces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  cudaError_t err = attr;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_cols = shard_v > d_pad * k ? shard_v : d_pad * k;
  term_table_kernel<<<(n_cols + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(nwk), static_cast<const float*>(inv_denom), k,
      kp, shard_v, d_pad * k, eta_m1, static_cast<float*>(term), a.nwk_out,
      a.ndk_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_pieces), (k + a.kc - 1) / a.kc);
  sweep_pieces_kernel<<<grid, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = n_pieces * k;
  sweep_link_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      a.meta, a.part, a.n_vpieces, static_cast<int>(n_pieces), k, shard_v,
      a.nwk_out, a.ndk_out);
  return static_cast<int>(cudaGetLastError());
}
