// One whole AFM training step after sampling, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` / `fused_step_pallas` in
// src/repro/kernels/fused/fused.py. In one launch: the best-matching-unit
// search (optional; exact f32 or bf16 cross term with an exact-f32 polish of
// the winner's q2), the Eq. 3 merge of the batch into its GMUs, the 8-draw
// counter drive, and up to `budget` cascade waves, each
//   w <- w + l_c * (((up + dn) + lf) + rt - n_recv * w)
// over the fired 4-neighbours, with the counter stencil of cascade.cu. The
// wave loop stops at an empty front; a cascade that outlives `budget` is
// finished by the wrapper (ops.fused_step_parts).
//
// Bound on an H100: at 30x30x784, B = 16 the step reads W, s, c and the
// draws once and writes W and the lattices once, ~5.8 MB (~1.7 us at
// 3.35 TB/s); its arithmetic (search 2*B*N*D, merge, 6*N*D a wave) is tiny
// beside that. So it is bound by bytes, and in practice by latency: the
// launch, one grid barrier, the block barriers, and the chains of
// dependent shared-memory accesses between them, with 16 warps an SM to
// hide them.
//
// Design. A cooperative grid of one block of 512 threads an SM (the plan
// comes from the host, `ops.plan`, and `repro_fused_plan` checks it against
// the kernel as built). After the GMUs are known the step splits over
// features: the counter dynamics read only c, the fired front and the
// draws, and the weight update of feature k reads only feature k. So each
// block owns a slice of `ds` features of all N units in shared memory and
// runs the N-site integer cascade itself, redundantly and bitwise the same
// as every other block; all blocks stop at the same wave and need no
// synchronisation between blocks inside the loop. Blocks 0-2 write the
// lattice outputs.
// 0. Thread 0 starts the TMA (one instruction a copy, completing on an
//    mbarrier) on what is needed before the grid barrier: a bulk copy of
//    the samples (on the exact tier at B <= 16) and 2-D boxes of the W
//    slice (8 features from a multiple of 4, 256 units, unit-major). Once
//    the slice has landed, the first staging thread starts bulk copies of
//    c, the drive draws and the first `staged` waves' draws, which land
//    during the grid barrier instead of slowing the first two. Where
//    16-byte alignment does not allow these, the staging warps copy with
//    `cp.async`.
// 1. Search and staging, side by side. Warps 0-7 search: the units split
//    over all blocks, one split a block, run by `repro::rows_split`
//    (runtime/search.cuh: a warp a unit, 16 samples at a time in shared
//    memory, 16-byte row loads, a named barrier of their own), the
//    arithmetic of bmu.cu's `rows_kernel`; per-split (min, argmin) partials
//    go to scratch. Meanwhile warps 8-15 put the W slice feature-major
//    (`f * n + u`: a wave's neighbours at unit strides, free of bank
//    conflicts) into both weight buffers, from the boxes or by 4-byte
//    `cp.async` copies transposed as they land (a slice of 6 features is
//    24 bytes a row, not a 16-byte multiple), checking that every weight
//    is "steady" (finite, not -0).
// 2. One grid barrier; then every block merges the partials of each sample
//    (`repro::merge_splits`: a warp a sample, lanes over the splits, a
//    butterfly under `wins`; the partials are stored sample-major, so the
//    132 blocks' reads of them are coalesced), so on the exact tier the
//    GMUs and q2 = max(v + |s|^2, 0) are bitwise those of `bmu.cu` on the
//    same inputs, and ties go to the lowest index for any split count.
// 3. The Eq. 3 merge touches only the hit units, a thread a (first sample
//    of a GMU, feature): it sums that GMU's samples in sample order, then
//    w + l_s (mean - w). The edge mask of each site is stored once, so the
//    waves do no integer division.
// 4. The drive, the waves in work proportional to the front and the
//    outputs: runtime/wave_loop.cuh, the code cascade.cu's drive_cascade
//    (the staged step's drive and cascade) runs too, so the two give the
//    same bits for the same merged W, counters and draws. While every
//    weight is steady (finite, not -0), a site that receives nothing keeps
//    its weights bit for bit and only the receivers' pairs are updated; a
//    weight that is not steady sends every later wave back to updating
//    every pair. Waves past the staged ones read their draws from device
//    memory.
// W is written out of place, so the bf16 polish reads the winners' input
// rows after the barrier while other blocks write their slices. The merge
// and wave updates use _rn intrinsics in the plain version's op order (no
// FMA contraction), so for the same GMUs the weights are those of the plain
// PyTorch version. No atomics on floats: two calls give the same bits.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../runtime/search.cuh"
#include "../runtime/waves.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::ROW_KC;
using repro::ROW_SAMPLES;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::smem_addr;
using repro::stage_bytes;
using repro::steady;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SEARCH_WARPS = 8;   // warps 0-7 search, on named barrier 1
constexpr int SEARCH_BAR = 1;
constexpr int STAGE_THREADS = THREADS - SEARCH_WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
// the W slice by the TMA: boxes of W_BOX_COLS features x W_BOX_ROWS units,
// starting at a multiple of 4 features (a box's row must start on a 16-byte
// boundary)
constexpr int W_BOX_COLS = 8;
constexpr int W_BOX_ROWS = 256;

struct Params {
  CUtensorMap w_map;      // W as a 2-D tensor for the TMA, when tma_w
  const float* w;         // (n, d) input weights
  const int32_t* c;       // (n,) counters
  const float* s;         // (b, d) samples
  const uint8_t* drive;   // (8, n) drive draws (bool)
  const uint8_t* bern;    // (w_cap, 4, n) wave draws (bool)
  const int32_t* gmu_in;  // (b,) given GMUs, or NULL: search here
  int n, side, d, b, theta, budget, bf16, vec, ds;
  int staged;             // waves of draws in shared memory
  int bulk_s;             // the samples come in by one bulk copy
  int bulk_in;            // c, the drive and the staged draws too
  int w_boxes;            // room for this many columns of TMA boxes (0: none)
  int tma_w;              // the W slice comes in by the TMA
  int out2;               // and goes out two features a store
  float l_s, l_c;
  float* w_out;
  int32_t* c_out;
  uint8_t* fired_out;
  int32_t* stats_out;     // (2,) [size, waves]
  int32_t* recv_out;
  int32_t* gmu_out;
  float* q2_out;
  float* part_v;          // (b, blocks) per-split minimum
  int32_t* part_i;        // (b, blocks) per-split argmin
};

struct Layout {
  size_t wbox, s_tile, wa, wb, s_q, c, recv, cnt, first, fgen, acc, drive,
      draws, fronts, receivers, gmu, s_slice, nbr, flags, bars, bytes;
};

__host__ __device__ inline size_t up16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += up16(bytes);
  return here;
}

// rows of W a TMA box covers, whole boxes
__host__ __device__ inline int w_rows(int n) {
  return (n + W_BOX_ROWS - 1) / W_BOX_ROWS * W_BOX_ROWS;
}

// shared memory of one block, each region rounded up to 16 bytes (ops.plan
// adds up the same regions): w_boxes columns of TMA boxes of the W slice
// (first, 128-byte aligned), the search's samples (16 rows of max(512, d)
// floats) and per-warp values, two weight slices (feature-major), the
// counters, the receive counts, the GMU counts, each GMU's first sample,
// the wave each site last fired in, two arrays of packed receipts, the
// drive draws, `staged` waves of draws, two front lists, two receiver
// lists, the GMUs, the samples' slice, the edge masks, the flags (`dirty`,
// two front lengths, three receiver counts) and three mbarriers
__host__ __device__ inline Layout layout(int n, int b, int d, int ds,
                                         int staged, int w_boxes) {
  Layout l;
  size_t at = 0;
  l.wbox = take(at, sizeof(float) * W_BOX_COLS * w_rows(n) * w_boxes);
  l.s_tile = take(at, sizeof(float) * ROW_SAMPLES * (d > ROW_KC ? d : ROW_KC));
  l.wa = take(at, sizeof(float) * ds * n);
  l.wb = take(at, sizeof(float) * ds * n);
  l.s_q = take(at, sizeof(float) * SEARCH_WARPS * ROW_SAMPLES);
  l.c = take(at, sizeof(int32_t) * n);
  l.recv = take(at, sizeof(int32_t) * n);
  l.cnt = take(at, sizeof(int32_t) * n);
  l.first = take(at, sizeof(int32_t) * n);
  l.fgen = take(at, sizeof(int32_t) * n);
  l.acc = take(at, 2 * sizeof(int32_t) * n);
  l.drive = take(at, static_cast<size_t>(8) * n);
  l.draws = take(at, static_cast<size_t>(4) * n * staged);
  l.fronts = take(at, 2 * sizeof(uint16_t) * n);
  l.receivers = take(at, 2 * sizeof(uint16_t) * n);
  l.gmu = take(at, sizeof(int32_t) * b);   // read 4 at a time
  l.s_slice = take(at, sizeof(float) * b * ds);
  l.nbr = take(at, n);
  l.flags = take(at, 6 * sizeof(int32_t));
  l.bars = take(at, 3 * sizeof(uint64_t));
  l.bytes = at;
  return l;
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one TMA box of the 2-D tensor `map` at (column x, row y), completing on
// the mbarrier `bar`; rows and columns past the tensor are zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// an mbarrier of one arrival (visible to the other threads after the next
// barrier)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the arrival at `bar`, which then expects `bytes` of bulk copies: its
// first phase completes when they have all landed
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// this block's split of the units against every 16-sample tile, on the
// chosen tier, into the partials (sample-major); by warps
// 0 .. SEARCH_WARPS - 1. With PRESTAGED (B <= 16) the samples are the bulk
// copy that completes `tile_ready`
template <bool BF16, bool VEC, bool PRESTAGED>
__device__ void search_split(const Params& p, float* s_tile,
                             const uint64_t* tile_ready,
                             float (*s_q)[ROW_SAMPLES]) {
  const int g = blockIdx.x, splits = gridDim.x;
  const int lo = repro::split_lo(g, p.n, splits);
  const int hi = repro::split_lo(g + 1, p.n, splits);
  for (int b0 = 0; b0 < p.b; b0 += ROW_SAMPLES) {
    float best;
    int best_i;
    repro::rows_split<BF16, VEC, SEARCH_WARPS, SEARCH_BAR, PRESTAGED>(
        p.w, p.s, p.n, p.b, p.d, lo, hi, b0, s_tile,
        PRESTAGED ? p.d : ROW_KC, tile_ready, s_q, best, best_i);
    const int bi = b0 + threadIdx.x;
    if (threadIdx.x < ROW_SAMPLES && bi < p.b) {
      p.part_v[static_cast<size_t>(bi) * splits + g] = best;
      p.part_i[static_cast<size_t>(bi) * splits + g] = best_i;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(p.n, p.b, p.d, p.ds, p.staged, p.w_boxes);
  const float* wbox = reinterpret_cast<const float*>(smem + lay.wbox);
  float* s_tile = reinterpret_cast<float*>(smem + lay.s_tile);
  float (*s_q)[ROW_SAMPLES] =
      reinterpret_cast<float (*)[ROW_SAMPLES]>(smem + lay.s_q);
  float* wa = reinterpret_cast<float*>(smem + lay.wa);
  float* wb = reinterpret_cast<float*>(smem + lay.wb);
  int32_t* c = reinterpret_cast<int32_t*>(smem + lay.c);
  int32_t* recv = reinterpret_cast<int32_t*>(smem + lay.recv);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + lay.cnt);
  int32_t* first = reinterpret_cast<int32_t*>(smem + lay.first);
  int32_t* fgen = reinterpret_cast<int32_t*>(smem + lay.fgen);
  int32_t* acc = reinterpret_cast<int32_t*>(smem + lay.acc);
  const uint8_t* drive = smem + lay.drive;
  const uint8_t* draws = smem + lay.draws;
  uint16_t* fronts = reinterpret_cast<uint16_t*>(smem + lay.fronts);
  uint16_t* receivers = reinterpret_cast<uint16_t*>(smem + lay.receivers);
  int32_t* gmu = reinterpret_cast<int32_t*>(smem + lay.gmu);
  float* s_slice = reinterpret_cast<float*>(smem + lay.s_slice);
  uint8_t* nbr = smem + lay.nbr;
  int32_t* flags = reinterpret_cast<int32_t*>(smem + lay.flags);
  int32_t* dirty = flags;
  int32_t* n_front = flags + 1;   // the front of wave k: n_front[k % 2]
  int32_t* n_recv = flags + 3;    // the receivers of wave k: n_recv[k % 3]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* tile_ready = bars;    // the samples landed
  uint64_t* inputs_ready = bars + 1;   // c, the drive, the staged draws
  uint64_t* w_ready = bars + 2;        // the boxes of the W slice

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, last = gridDim.x - 1;
  const int n = p.n, side = p.side, d = p.d, b = p.b, ds = p.ds;
  const int f0 = min(d, g * ds);
  const int nf = min(ds, d - f0);   // features of this block; 0 past d
  const bool searched = p.gmu_in == nullptr;
  const int staged = min(p.staged, p.budget);   // waves of draws staged
  const int draw_bytes = 4 * n * staged;
  const int box_x = f0 & ~3, shift = f0 - box_x;   // the boxes' first column
  const int col_boxes = (shift + nf + W_BOX_COLS - 1) / W_BOX_COLS;

  // ---- 0. the TMA copies of what is needed before the grid barrier (the
  // samples and the W slice), and the flags; the first staging thread
  // starts the others once the W slice has landed
  if (tid == 0) {
    mbar_init(tile_ready);
    mbar_init(inputs_ready);
    mbar_init(w_ready);
    if (p.bulk_s) {
      mbar_expect(tile_ready, 4 * b * d);
      bulk_copy(s_tile, p.s, 4 * b * d, tile_ready);
    }
    if (p.tma_w && nf > 0) {
      const int rows = w_rows(n);
      mbar_expect(w_ready, sizeof(float) * W_BOX_COLS * rows * col_boxes);
      for (int cb = 0; cb < col_boxes; ++cb)
        for (int r0 = 0; r0 < rows; r0 += W_BOX_ROWS)
          tma_box(smem + lay.wbox + sizeof(float) * W_BOX_COLS *
                                        (static_cast<size_t>(cb) * rows + r0),
                  &p.w_map, box_x + W_BOX_COLS * cb, r0, w_ready);
    }
  }
  if (tid < 6) flags[tid] = 0;   // dirty and the lengths
  __syncthreads();

  // ---- 1. search (Eq. 1) by warps 0-7 while the others copy this block's
  // inputs in; with the GMUs given, every warp copies
  const int t0 = searched ? SEARCH_WARPS * 32 : 0;
  const int nth = searched ? STAGE_THREADS : THREADS;
  bool clean = true;   // every weight of the slice steady
  if (searched && warp < SEARCH_WARPS) {
    if (p.bulk_s)
      search_split<false, true, true>(p, s_tile, tile_ready, s_q);
    else if (p.bf16)
      p.vec ? search_split<true, true, false>(p, s_tile, nullptr, s_q)
            : search_split<true, false, false>(p, s_tile, nullptr, s_q);
    else
      p.vec ? search_split<false, true, false>(p, s_tile, nullptr, s_q)
            : search_split<false, false, false>(p, s_tile, nullptr, s_q);
  } else if (nf > 0) {
    const int t = tid - t0;
    if (!p.tma_w)
      REPRO_FOR_PAIRS(n, nf, t, nth, cp_async4(wa + f * n + u,
                                         p.w + static_cast<size_t>(u) * d + f0 + f));
    for (int e = t; e < b * nf; e += nth) {
      const int bi = e / nf, f = e - bi * nf;
      cp_async4(s_slice + bi * ds + f,
                p.s + static_cast<size_t>(bi) * d + f0 + f);
    }
    if (!p.bulk_in) {
      stage_bytes(c, p.c, 4 * n, t, nth);
      stage_bytes(smem + lay.drive, p.drive, 8 * n, t, nth);
      stage_bytes(smem + lay.draws, p.bern, draw_bytes, t, nth);
    }
    cp_async_commit();
    // the sites' state, and their edge masks
    for (int u = t; u < n; u += nth) {
      cnt[u] = 0;
      recv[u] = 0;
      first[u] = b;   // above every sample index
      fgen[u] = -1;   // fired in no wave
      acc[u] = 0;
      acc[n + u] = 0;
      nbr[u] = repro::edge_mask(u, side);
    }
    // the copies landed: this thread's pairs of the slice (from the TMA's
    // unit-major boxes, or already in place) into both weight buffers, and
    // checked
    cp_async_wait_all();
    if (p.tma_w) repro::mbar_wait(w_ready, 0);
    if (p.bulk_in && t == 0) {
      mbar_expect(inputs_ready, 12 * n + draw_bytes);
      bulk_copy(c, p.c, 4 * n, inputs_ready);
      bulk_copy(smem + lay.drive, p.drive, 8 * n, inputs_ready);
      if (draw_bytes > 0)
        bulk_copy(smem + lay.draws, p.bern, draw_bytes, inputs_ready);
    }
    if (p.tma_w) {
      const int rows = w_rows(n);
      REPRO_FOR_PAIRS(n, nf, t, nth, {
        const int x = shift + f;
        const float v = wbox[(static_cast<size_t>(x / W_BOX_COLS) * rows + u) *
                                 W_BOX_COLS + x % W_BOX_COLS];
        wa[f * n + u] = v;
        wb[f * n + u] = v;
        clean &= steady(v);
      });
    } else {
      REPRO_FOR_PAIRS(n, nf, t, nth, {
        const float v = wa[f * n + u];
        wb[f * n + u] = v;
        clean &= steady(v);
      });
    }
  }

  // ---- 2. the merge of the splits, or the given GMUs; then each GMU's
  // count and first sample (integers: any order). GMUs outside [0, n) are
  // dropped, as JAX's scatter drops them. The search's outputs come from
  // the last block, which owns no features at the main shape, so they stay
  // off the critical path
  if (searched) {
    cg::this_grid().sync();
    if (p.bulk_s) repro::mbar_wait(tile_ready, 0);   // landed before leaving
    if (nf == 0 && g != last) return;   // nothing staged, nothing to do
    for (int bi = warp; bi < b; bi += WARPS) {
      float v;
      int idx;
      repro::merge_splits(p.part_v, p.part_i, gridDim.x, 1, gridDim.x, bi,
                          lane, n, v, idx);
      idx = idx < n ? idx : 0;   // every distance NaN: unit 0, as bmu.cu
      if (g == last && !p.bf16) {
        const float s2 =
            repro::row_norm(p.s + static_cast<size_t>(bi) * d, d, lane);
        if (lane == 0) p.q2_out[bi] = fmaxf(v + s2, 0.f);
      }
      if (lane == 0) {
        gmu[bi] = idx;
        if (g == last) p.gmu_out[bi] = idx;
        if (nf > 0) {
          atomicAdd(&cnt[idx], 1);
          atomicMin(&first[idx], bi);
        }
      }
    }
    if (g == last && p.bf16) {   // exact-f32 polish of each winner
      __syncwarp();
      for (int bi = warp; bi < b; bi += WARPS) {
        const float* wu = p.w + static_cast<size_t>(gmu[bi]) * d;
        const float* sb = p.s + static_cast<size_t>(bi) * d;
        float acc2 = 0.f;
        for (int k = lane; k < d; k += 32) {
          const float dv = __fsub_rn(wu[k], sb[k]);
          acc2 = fmaf(dv, dv, acc2);
        }
        acc2 = warp_sum(acc2);
        if (lane == 0) p.q2_out[bi] = fmaxf(acc2, 0.f);
      }
    }
    if (nf == 0) return;
  } else {
    if (nf == 0) return;
    __syncthreads();   // the counts are zeroed
    for (int bi = tid; bi < b; bi += THREADS) {
      const int u = p.gmu_in[bi];
      gmu[bi] = u;
      if (u >= 0 && u < n) {
        atomicAdd(&cnt[u], 1);
        atomicMin(&first[u], bi);
      }
    }
  }
  if (p.bulk_in) repro::mbar_wait(inputs_ready, 0);
  __syncthreads();

  // ---- 3. the Eq. 3 merge of the hit units, a thread a (sample, feature):
  // the first sample of each GMU sums that GMU's samples in sample order,
  // then w + l_s * (mean - w). And a thread a site: the counter drive (each
  // of a unit's adaptations, at most 8, adds its draw; the units at
  // threshold form the first front)
  for (int e = tid; e < b * nf; e += THREADS) {
    const int bi = e / nf, f = e - bi * nf;
    const int u = gmu[bi];
    if (u < 0 || u >= n || first[u] != bi) continue;
    // GMU u's samples, 32 at a time as a bit mask (their GMUs read 4 at a
    // time; none before bi has u), summed in sample order, and counted
    float tsum = 0.f;
    int k = 0;
    for (int c0 = bi & ~3; c0 < b; c0 += 32) {
      unsigned mask = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (c0 + 4 * q < b) {
          const int4 g4 = *reinterpret_cast<const int4*>(gmu + c0 + 4 * q);
          mask |= ((g4.x == u) | (g4.y == u) << 1 | (g4.z == u) << 2 |
                   (g4.w == u) << 3) << (4 * q);
        }
      }
      if (b - c0 < 32) mask &= (1u << (b - c0)) - 1;   // the padding
      k += __popc(mask);
      for (; mask != 0; mask &= mask - 1)
        tsum = __fadd_rn(tsum, s_slice[(c0 + __ffs(mask) - 1) * ds + f]);
    }
    const float mean = __fdiv_rn(tsum, static_cast<float>(k));
    const float wv = wa[f * n + u];
    const float out = __fadd_rn(wv, __fmul_rn(p.l_s, __fsub_rn(mean, wv)));
    wa[f * n + u] = out;
    wb[f * n + u] = out;
    clean &= steady(out);
  }
  // the drive, the waves and the outputs, as drive_cascade runs them
#include "../runtime/wave_loop.cuh"
}

// the plan as ops.plan passes it (int32[8]): blocks, features a block,
// threads, shared bytes, waves of draws staged, samples a search tile,
// features a staged search chunk, columns of TMA boxes of the W slice
// (0: the slice comes in by 4-byte copies)
struct Plan {
  int blocks, ds, threads, smem, staged, sample_tile, chunk, w_boxes;
};

// the columns of boxes the block with the most needs (its features from a
// multiple of 4 on)
int boxes_needed(int d, int ds, int blocks) {
  int most = 0;
  for (int g = 0; g < blocks && g * ds < d; ++g) {
    const int f0 = g * ds, nf = d - f0 < ds ? d - f0 : ds;
    const int need = (f0 % 4 + nf + W_BOX_COLS - 1) / W_BOX_COLS;
    most = need > most ? need : most;
  }
  return most;
}

// cudaErrorInvalidValue unless the plan is one this kernel, as built, can
// run: its threads, tile and chunk, the shared bytes of its layout, TMA
// boxes only where rows are whole 16-byte units and enough for every block,
// every feature in a block, and sites that fit the 16-bit lists
cudaError_t check_plan(int n, int d, int b, const void* plan_in, Plan& pl) {
  const int32_t* v = static_cast<const int32_t*>(plan_in);
  pl = Plan{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  if (n < 1 || n > 65535 || d < 1 || b < 1 || pl.blocks < 1 || pl.ds < 1 ||
      pl.threads != THREADS || pl.staged < 0 ||
      (pl.w_boxes != 0 &&
       (d % 4 != 0 || pl.w_boxes < boxes_needed(d, pl.ds, pl.blocks))) ||
      pl.sample_tile != ROW_SAMPLES || pl.chunk != ROW_KC ||
      static_cast<int64_t>(pl.blocks) * pl.ds < d ||
      static_cast<size_t>(pl.smem) !=
          layout(n, b, d, pl.ds, pl.staged, pl.w_boxes).bytes) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, looked up by the CUDA runtime's entry-point query
// (the library links no libcuda), or NULL
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace

// Checks a plan from ops.plan against the kernel as built and the card.
// out (int32[3]): SMs, shared bytes a block may opt into, blocks of this
// plan that fit on the card at once (0 when its shared memory does not fit
// at all). Returns cudaErrorInvalidValue where the plan disagrees with the
// kernel.
extern "C" int repro_fused_plan(int n, int d, int b, const void* plan,
                                void* out) {
  Plan pl;
  cudaError_t err = check_plan(n, d, b, plan, pl);
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pl.smem <= max_smem) {
    err = cudaFuncSetAttribute(fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pl.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel,
                                                          THREADS, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int32_t* o = static_cast<int32_t*>(out);
  o[0] = sms;
  o[1] = max_smem;
  o[2] = per_sm * sms;
  return 0;
}

// scratch: (b, blocks) f32 then (b, blocks) int32 when the kernel searches
extern "C" int repro_fused_step(
    const void* w, const void* c, const void* s, const void* drive,
    const void* bern, const void* gmu_in, int side, int d, int b, int theta,
    int budget, int bf16, float l_s, float l_c, void* w_out, void* c_out,
    void* fired_out, void* stats_out, void* recv_out, void* gmu_out,
    void* q2_out, void* scratch, const void* plan, void* stream) {
  Plan pl;
  cudaError_t err = check_plan(side * side, d, b, plan, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.n = side * side;
  p.side = side;
  p.d = d;
  p.b = b;
  p.theta = theta;
  p.budget = budget;
  p.bf16 = bf16;
  p.vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(s) % 16 == 0;
  p.ds = pl.ds;
  p.staged = pl.staged;
  const auto a16 = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  // the samples by one bulk copy on the exact tier's 16-byte search at
  // B <= 16 (the main path); c, the drive and the draws where every piece
  // is 16-byte aligned
  p.bulk_s = gmu_in == nullptr && !bf16 && b <= ROW_SAMPLES && d % 4 == 0 &&
             a16(w) && a16(s);
  p.bulk_in = p.n % 4 == 0 && a16(c) && a16(drive) && a16(bern);
  // the W slice by TMA boxes where the plan keeps room for them and W is
  // 16-byte aligned (rows of d % 4 == 0 floats, as the plan requires)
  p.w_boxes = pl.w_boxes;
  p.out2 = pl.ds % 2 == 0 && d % 2 == 0 &&
           reinterpret_cast<uintptr_t>(w_out) % 8 == 0;
  p.tma_w = pl.w_boxes > 0 && a16(w);
  if (p.tma_w) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(p.n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(float)};
    const cuuint32_t box[2] = {W_BOX_COLS, W_BOX_ROWS};
    const cuuint32_t steps[2] = {1, 1};
    if (encode(&p.w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<void*>(w), dims, strides, box, steps,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.l_s = l_s;
  p.l_c = l_c;
  p.w = static_cast<const float*>(w);
  p.c = static_cast<const int32_t*>(c);
  p.s = static_cast<const float*>(s);
  p.drive = static_cast<const uint8_t*>(drive);
  p.bern = static_cast<const uint8_t*>(bern);
  p.gmu_in = static_cast<const int32_t*>(gmu_in);
  p.w_out = static_cast<float*>(w_out);
  p.c_out = static_cast<int32_t*>(c_out);
  p.fired_out = static_cast<uint8_t*>(fired_out);
  p.stats_out = static_cast<int32_t*>(stats_out);
  p.recv_out = static_cast<int32_t*>(recv_out);
  p.gmu_out = static_cast<int32_t*>(gmu_out);
  p.q2_out = static_cast<float*>(q2_out);
  p.part_v = static_cast<float*>(scratch);
  p.part_i = static_cast<int32_t*>(scratch) + static_cast<size_t>(pl.blocks) * b;
  // set at every launch: an earlier, smaller shape may have set it lower
  err = cudaFuncSetAttribute(fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel),
                                    dim3(pl.blocks), dim3(THREADS), args,
                                    pl.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
