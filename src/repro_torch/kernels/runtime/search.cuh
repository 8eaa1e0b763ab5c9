// Device helpers shared by the kernels that search for a best-matching
// unit (bmu.cu, fused.cu).
//
// Both kernels rank the units with the same arithmetic, from the functions
// below: `rows_split` sums one unit's |w|^2 - 2 w.s for 16 samples at a
// time in one fixed order, whatever split, block size or kernel holds the
// unit, and `merge_splits` reduces the per-split (min, argmin) partials
// under `wins`, a total order. So for the same W and samples the two
// kernels pick bitwise-equal units and values on the exact tier, and
// `row_norm` gives both the same |s|^2 to add back.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace repro {

constexpr unsigned FULL_MASK = 0xffffffffu;

// a search operand on the chosen tier: f32 as it is, or rounded to bf16
// (round to nearest even, as torch's .to(torch.bfloat16)) and widened back
template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// (v, i) beats (bv, bi) when smaller, or equal with a lower index
__device__ __forceinline__ bool wins(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// the first unit of split `split` of `splits` over n units (floor-balanced)
__host__ __device__ __forceinline__ int split_lo(int split, int n,
                                                 int splits) {
  return static_cast<int>(static_cast<int64_t>(split) * n / splits);
}

// ---------------------------------------------------------------- rows

constexpr int ROW_SAMPLES = 16;          // samples a warp sums at once
constexpr int ROW_KC = 512;              // features a staged chunk
constexpr int ROW_LOADS = ROW_KC / 128;  // float4 loads a lane takes a chunk

// a lane's float4s of features k0 + 4 lane + 128 l of one row (zeros past d)
__device__ __forceinline__ void load_row(float4 (&out)[ROW_LOADS],
                                         const float* __restrict__ row,
                                         bool has, int lane, int k0, int d) {
#pragma unroll
  for (int l = 0; l < ROW_LOADS; ++l) {
    const int k = k0 + 4 * lane + 128 * l;
    out[l] = (has && k < d) ? *reinterpret_cast<const float4*>(row + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <bool BF16>
__device__ __forceinline__ void fma4(float4 sv, float4 wv, float& acc) {
  acc = fmaf(operand<BF16>(sv.x), operand<BF16>(wv.x), acc);
  acc = fmaf(operand<BF16>(sv.y), operand<BF16>(wv.y), acc);
  acc = fmaf(operand<BF16>(sv.z), operand<BF16>(wv.z), acc);
  acc = fmaf(operand<BF16>(sv.w), operand<BF16>(wv.w), acc);
}

// the barrier of the warps that search: the whole block (BAR 0), or warps
// 0 .. WARPS - 1 of a larger block on named barrier BAR, while the other
// warps do other work
template <int BAR, int WARPS>
__device__ __forceinline__ void search_sync() {
  if (BAR == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(WARPS * 32) : "memory");
  }
}

// a shared-memory address, as the PTX of barriers and copies takes it
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wait until the mbarrier at `bar` completes the phase of this parity
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One split of the search for one tile of ROW_SAMPLES samples, run by
// warps 0 .. WARPS - 1 of the block (each of their threads calls it; it
// holds barriers, `search_sync<BAR, WARPS>`): the units [lo, hi) against
// samples b0 .. b0 + 15 of s (zeros past b).
// A warp takes one unit at a time. With VEC (d % 4 == 0, 16-byte aligned
// rows) its lanes hold the row's float4s at features 4 lane + 128 m and,
// for m in rising order, sum |w|^2 and the 16 cross terms with FMAs; the
// next 512 features are in flight while these are used. Otherwise lane l
// takes features l + 32 j in rising order. The samples are read from
// shared memory, s_tile[i * s_ld + k] for sample b0 + i: staged here in
// chunks of ROW_KC features (s_ld = ROW_KC), or, with PRESTAGED, the whole
// tile copied in by the caller (s_ld = d), landed once the mbarrier
// `tile_ready` completes its first phase. The xor butterfly then gives
// every lane the full sums, and q = |w|^2 - 2 w.s: a unit's q is the same
// bits in any split, block size or kernel. Threads 0..ROW_SAMPLES-1 end
// with the (min, argmin) of their sample over the split, units rising,
// ties to the lowest index; (+inf, n) for an empty split.
template <bool BF16, bool VEC, int WARPS, int BAR = 0, bool PRESTAGED = false>
__device__ __forceinline__ void rows_split(
    const float* __restrict__ w, const float* __restrict__ s, int n, int b,
    int d, int lo, int hi, int b0, float* s_tile, int s_ld,
    const uint64_t* tile_ready, float (*s_q)[ROW_SAMPLES], float& best,
    int& best_i) {
  constexpr int THREADS = WARPS * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  best = INFINITY;
  best_i = n;
  for (int u0 = lo; u0 < hi; u0 += WARPS) {
    const int u = u0 + warp;
    const bool has = u < hi;
    const float* wrow = w + static_cast<size_t>(has ? u : lo) * d;
    float acc[ROW_SAMPLES];
#pragma unroll
    for (int i = 0; i < ROW_SAMPLES; ++i) acc[i] = 0.f;
    float w2 = 0.f;
    float4 wv[ROW_LOADS];
    if (VEC) load_row(wv, wrow, has, lane, 0, d);
    for (int k0 = 0; k0 < d; k0 += ROW_KC) {
      const int kc = min(ROW_KC, d - k0);
      const float* tile = s_tile + (PRESTAGED ? k0 : 0);
      if (PRESTAGED) {
        if (u0 == lo && k0 == 0) mbar_wait(tile_ready, 0);
      } else {
        search_sync<BAR, WARPS>();   // the previous chunk and s_q are consumed
        if (VEC) {         // kc % 4 == 0 here
          const int kc4 = kc / 4;
          for (int e = threadIdx.x; e < ROW_SAMPLES * kc4; e += THREADS) {
            const int r = e / kc4, k = (e % kc4) * 4;
            *reinterpret_cast<float4*>(s_tile + r * s_ld + k) =
                b0 + r < b ? *reinterpret_cast<const float4*>(
                                 s + static_cast<size_t>(b0 + r) * d + k0 + k)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
          for (int e = threadIdx.x; e < ROW_SAMPLES * kc; e += THREADS) {
            const int r = e / kc, k = e % kc;
            s_tile[r * s_ld + k] =
                b0 + r < b ? s[static_cast<size_t>(b0 + r) * d + k0 + k] : 0.f;
          }
        }
        search_sync<BAR, WARPS>();
      }
      if (VEC) {
        // the next chunk of the row is in flight while this one is used
        float4 nxt[ROW_LOADS];
        load_row(nxt, wrow, has, lane, k0 + ROW_KC, d);
        if (has) {
#pragma unroll
          for (int l = 0; l < ROW_LOADS; ++l) {
            const int k = 4 * lane + 128 * l;
            if (k < kc) {
              w2 = fmaf(wv[l].x, wv[l].x, w2);
              w2 = fmaf(wv[l].y, wv[l].y, w2);
              w2 = fmaf(wv[l].z, wv[l].z, w2);
              w2 = fmaf(wv[l].w, wv[l].w, w2);
#pragma unroll
              for (int i = 0; i < ROW_SAMPLES; ++i) {
                fma4<BF16>(*reinterpret_cast<const float4*>(tile + i * s_ld + k),
                           wv[l], acc[i]);
              }
            }
          }
        }
#pragma unroll
        for (int l = 0; l < ROW_LOADS; ++l) wv[l] = nxt[l];
      } else if (has) {
        for (int k = lane; k < kc; k += 32) {
          const float x = wrow[k0 + k];
          w2 = fmaf(x, x, w2);
          const float xo = operand<BF16>(x);
#pragma unroll
          for (int i = 0; i < ROW_SAMPLES; ++i) {
            acc[i] = fmaf(operand<BF16>(tile[i * s_ld + k]), xo, acc[i]);
          }
        }
      }
    }
    // every lane ends with the full sums (butterfly, one fixed order)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      w2 += __shfl_xor_sync(FULL_MASK, w2, off);
#pragma unroll
      for (int i = 0; i < ROW_SAMPLES; ++i) {
        acc[i] += __shfl_xor_sync(FULL_MASK, acc[i], off);
      }
    }
    float q = INFINITY;
#pragma unroll
    for (int i = 0; i < ROW_SAMPLES; ++i) {
      if (lane == i) q = w2 - 2.f * acc[i];
    }
    if (lane < ROW_SAMPLES) s_q[warp][lane] = has ? q : INFINITY;
    search_sync<BAR, WARPS>();
    if (threadIdx.x < ROW_SAMPLES) {
      // warps hold rising units, so a strict order keeps the lowest index
#pragma unroll
      for (int ww = 0; ww < WARPS; ++ww) {
        if (u0 + ww < hi && wins(s_q[ww][threadIdx.x], u0 + ww, best, best_i)) {
          best = s_q[ww][threadIdx.x];
          best_i = u0 + ww;
        }
      }
    }
    // s_q is rewritten by the next units (staging opens with a barrier)
    if (PRESTAGED) search_sync<BAR, WARPS>();
  }
}

// ---------------------------------------------------------------- merge

// |s|^2 of one row, by one warp: lane l sums features l + 32 j with FMAs,
// then the xor butterfly gives every lane the same bits
__device__ __forceinline__ float row_norm(const float* __restrict__ row,
                                          int d, int lane) {
  float s2 = 0.f;
  for (int k = lane; k < d; k += 32) s2 = fmaf(row[k], row[k], s2);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s2 += __shfl_xor_sync(FULL_MASK, s2, off);
  }
  return s2;
}

constexpr int MERGE_LOADS = 8;   // partials a lane has in flight at once

// The (min, argmin) of sample `row` over the splits' partials, by one warp:
// the partial of split sp is at sp * split_stride + row * row_stride (bmu:
// split-major, one launch merges; fused: sample-major, so that the lanes of
// every block read a sample's partials from consecutive addresses). Lanes
// stride over the splits (MERGE_LOADS of them loaded at once), then an xor
// butterfly under `wins`. A total order, so the result does not depend on
// the split count or the order of the reduction; every lane ends with it.
// The partials are read from L2 (`__ldcg`), so they may have been written
// by other blocks of the same launch before a grid barrier.
__device__ __forceinline__ void merge_splits(const float* part_v,
                                             const int* part_i, int splits,
                                             size_t split_stride,
                                             size_t row_stride, int row,
                                             int lane, int n, float& v,
                                             int& bi) {
  v = INFINITY;
  bi = n;
  const size_t base = static_cast<size_t>(row) * row_stride;
  for (int sp0 = lane; sp0 < splits; sp0 += 32 * MERGE_LOADS) {
    float ov[MERGE_LOADS];
    int oi[MERGE_LOADS];
#pragma unroll
    for (int j = 0; j < MERGE_LOADS; ++j) {
      const int sp = sp0 + 32 * j;
      const bool in = sp < splits;
      const size_t at = base + static_cast<size_t>(sp) * split_stride;
      ov[j] = in ? __ldcg(part_v + at) : INFINITY;
      oi[j] = in ? __ldcg(part_i + at) : n;
    }
#pragma unroll
    for (int j = 0; j < MERGE_LOADS; ++j) {
      if (wins(ov[j], oi[j], v, bi)) {
        v = ov[j];
        bi = oi[j];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, v, off);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
    if (wins(ov, oi, v, bi)) {
      v = ov;
      bi = oi;
    }
  }
}

}  // namespace repro
