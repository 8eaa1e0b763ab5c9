// Exact best-matching-unit search on Hopper (sm_90a).
//
// Replaces the TPU kernel `_bmu_kernel` / `bmu_pallas` in
// src/repro/kernels/bmu/bmu.py. For each sample s_i it finds
// argmin_j |w_j|^2 - 2 w_j . s_i with a running (min, argmin), ties to the
// lowest index, then adds |s_i|^2 back and clamps at >= 0.
//
// What bounds it on an H100 (132 SMs):
// - the training search (B = 16, N = 900, D = 784): bytes. The cross term
//   is 22.6 MFLOP, the 2.8 MB of W take ~0.84 us at 3.35 TB/s, so the
//   kernel must read W once, with every SM streaming a slice of it;
// - the queries (B = 10000): f32 operations. 2*B*N*D = 14.1 GFLOP of
//   exact f32 is ~0.21 ms at 67 TFLOP/s of non-tensor f32.
//
// Design: the units are split across blocks, and each block reduces its
// slice to a per-sample (min, argmin) partial; a second launch merges the
// partials with `repro::wins` (a strict total order on (value, index), so
// the merge is deterministic and the lowest index wins a tie even across
// splits), adds |s|^2 and clamps. No atomics anywhere: two calls on the
// same inputs give bitwise equal results. The split and tile plan comes
// from the host (`ops.plan`), which sizes the grid to the SM count:
// - `rows_kernel` (where 128-sample tiles would leave most SMs idle; 16
//   samples a block, 132 splits of 6-7 units at B = 16): a warp takes one
//   unit, its lanes read the unit's row with 16-byte loads straight from
//   device memory (the next 512 features in flight while these are used),
//   and the 16 samples are staged in shared memory in chunks of 512
//   features. The body is `repro::rows_split` (runtime/search.cuh), which
//   the fused kernel's search calls too, and the merge's is
//   `repro::merge_splits`, so both kernels pick the same units bitwise;
// - `tile_kernel` (where its tiles give at least a third of the SMs a
//   block, as at B = 10000): an SGEMM-style register-blocked tile of 128
//   samples x 128 units a block, 8 x 8 accumulators a thread (its samples
//   and its units each two runs of 4), 16-feature chunks staged K-major
//   (transposed as they land by 4-byte `cp.async` copies, so any D and any
//   alignment) and double-buffered, read as float4s without bank
//   conflicts, and an epilogue that adds |w|^2 and keeps the running
//   (min, argmin) across the block's unit tiles; a split is a whole number
//   of unit tiles (8 splits of one tile at N = 900, 632 blocks at B =
//   10000). 157 registers a thread: one block of 8 warps an SM.
// Every (unit, sample) distance is summed in the same order wherever the
// unit sits, so equal rows give bitwise equal distances. Ragged N, B and D
// are masked in the loads; rows_kernel's 16-byte loads need D % 4 == 0 and
// aligned pointers, and scalar loads take over otherwise. An empty split
// writes (+inf, n), which never wins.
//
// The exact tier uses f32 FMAs only: no tensor cores, so no TF32. The bf16
// tier rounds s and w to bf16 (__float2bfloat16) as they are read from
// shared memory and accumulates in f32; the norms stay f32, and the wrapper
// polishes the winner's q2 in exact f32. 3xTF32 or `wgmma` tiers are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../runtime/search.cuh"

namespace {

using repro::operand;
using repro::wins;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- rows

constexpr int R_WARPS = 8;
constexpr int R_THREADS = R_WARPS * 32;
constexpr int R_SAMPLES = repro::ROW_SAMPLES;   // samples a block

// a block a (split, 16-sample tile): `repro::rows_split`, whose arithmetic
// the fused kernel shares
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(R_THREADS)
rows_kernel(const float* __restrict__ w, const float* __restrict__ s, int n,
            int b, int d, int splits, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  __shared__ __align__(16) float s_tile[R_SAMPLES][repro::ROW_KC];
  __shared__ float s_q[R_WARPS][R_SAMPLES];
  const int split = blockIdx.x;
  const int b0 = blockIdx.y * R_SAMPLES;
  float best;
  int best_i;
  repro::rows_split<BF16, VEC, R_WARPS>(
      w, s, n, b, d, repro::split_lo(split, n, splits),
      repro::split_lo(split + 1, n, splits), b0, &s_tile[0][0],
      repro::ROW_KC, nullptr, s_q, best, best_i);
  const int gb = b0 + threadIdx.x;
  if (threadIdx.x < R_SAMPLES && gb < b) {
    part_v[static_cast<size_t>(split) * b + gb] = best;
    part_i[static_cast<size_t>(split) * b + gb] = best_i;
  }
}

// ---------------------------------------------------------------- tiles

constexpr int T_B = 128;               // samples a block
constexpr int T_N = 128;               // units a tile
constexpr int T_K = 16;                // features a staged chunk
constexpr int T_LD = T_B + 4;          // a K-major row of 128 samples or units
constexpr int T_THREADS = 256;         // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows r0.. of a (rows x d) matrix, features k0..k0+T_K, transposed as they
// land into dst[T_K][T_LD] (zeros past the ragged edges): 16 neighbouring
// threads read one row's 16 features, each copy 4 bytes, asynchronous
__device__ __forceinline__ void stage(float (*dst)[T_LD],
                                      const float* __restrict__ src, int r0,
                                      int rows, int d, int k0) {
#pragma unroll
  for (int h = 0; h < T_B * T_K / T_THREADS; ++h) {
    const int e = threadIdx.x + T_THREADS * h;
    const int r = e / T_K, k = e % T_K;
    const int gr = r0 + r, gk = k0 + k;
    const bool ok = gr < rows && gk < d;
    cp_async4(&dst[k][r], ok ? src + static_cast<size_t>(gr) * d + gk : src,
              ok ? 4 : 0);
  }
}

// the 8 values a thread takes of one K-major row: x[4c .. 4c+3] and
// x[64 + 4c .. 64 + 4c + 3], rounded to the tier's operands
template <bool BF16>
__device__ __forceinline__ void fragment(const float* row, int c,
                                         float (&out)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + 4 * c);
  const float4 hi = *reinterpret_cast<const float4*>(row + 64 + 4 * c);
  out[0] = operand<BF16>(lo.x);
  out[1] = operand<BF16>(lo.y);
  out[2] = operand<BF16>(lo.z);
  out[3] = operand<BF16>(lo.w);
  out[4] = operand<BF16>(hi.x);
  out[5] = operand<BF16>(hi.y);
  out[6] = operand<BF16>(hi.z);
  out[7] = operand<BF16>(hi.w);
}

// slot i of a thread's 8 samples (or units): 4c + i, then 64 + 4c + i - 4
__device__ __forceinline__ int owned(int c, int i) {
  return i < 4 ? 4 * c + i : 64 + 4 * c + i - 4;
}

template <bool BF16>
__global__ void __launch_bounds__(T_THREADS)
tile_kernel(const float* __restrict__ w, const float* __restrict__ s, int n,
            int b, int d, int splits, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  __shared__ __align__(16) float a_tile[2][T_K][T_LD];
  __shared__ __align__(16) float w_tile[2][T_K][T_LD];
  __shared__ float w2_tile[T_N];

  const int tx = threadIdx.x % 16;       // units owned(tx, j)
  const int ty = threadIdx.x / 16;       // samples owned(ty, i)
  const int split = blockIdx.x;
  const int b0 = blockIdx.y * T_B;
  const int tiles = (n + T_N - 1) / T_N;
  const int t_lo = static_cast<int>(static_cast<int64_t>(split) * tiles / splits);
  const int t_hi = static_cast<int>(static_cast<int64_t>(split + 1) * tiles / splits);
  const int chunks = (d + T_K - 1) / T_K;
  // |w|^2: thread t sums half of unit t / 2's features of each chunk
  const int w2_unit = threadIdx.x / 2;
  const int w2_half = (threadIdx.x % 2) * (T_K / 2);

  float best[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    best_i[i] = n;
  }

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int n0 = tile * T_N;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float w2 = 0.f;

    stage(a_tile[0], s, b0, b, d, 0);
    stage(w_tile[0], w, n0, n, d, 0);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < chunks) {   // the next chunk is in flight while this one is used
        stage(a_tile[buf ^ 1], s, b0, b, d, (c + 1) * T_K);
        stage(w_tile[buf ^ 1], w, n0, n, d, (c + 1) * T_K);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < T_K / 2; ++kk) {
        const float x = w_tile[buf][w2_half + kk][w2_unit];
        w2 = fmaf(x, x, w2);
      }
#pragma unroll
      for (int kk = 0; kk < T_K; ++kk) {
        float a[8], x[8];
        fragment<BF16>(a_tile[buf][kk], ty, a);
        fragment<BF16>(w_tile[buf][kk], tx, x);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
      }
      __syncthreads();   // this buffer is staged again two chunks on
    }
    // the two halves of a unit's |w|^2 sit in neighbouring lanes
    w2 += __shfl_xor_sync(FULL, w2, 1);
    if (threadIdx.x % 2 == 0) w2_tile[w2_unit] = w2;
    __syncthreads();
    // units of this thread rise with j, so a strict < keeps the lowest index
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = n0 + owned(tx, j);
      if (u < n) {
        const float wj = w2_tile[owned(tx, j)];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float q = wj - 2.f * acc[i][j];
          if (q < best[i]) {
            best[i] = q;
            best_i[i] = u;
          }
        }
      }
    }
    __syncthreads();   // w2_tile is rewritten by the next tile
  }

  // the 16 threads of a sample row are 16 consecutive lanes of a warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = best[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off, 16);
      const int oi = __shfl_xor_sync(FULL, bi, off, 16);
      if (wins(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int gb = b0 + owned(ty, i);
    if (tx == 0 && gb < b) {
      part_v[static_cast<size_t>(split) * b + gb] = v;
      part_i[static_cast<size_t>(split) * b + gb] = bi;
    }
  }
}

// ---------------------------------------------------------------- merge

constexpr int M_WARPS = 8;

// one warp a sample: |s|^2, then the splits' partials under `wins` (a total
// order, so the result does not depend on the order of the reduction)
__global__ void __launch_bounds__(M_WARPS * 32)
merge_kernel(const float* __restrict__ s, int n, int b, int d, int splits,
             const float* __restrict__ part_v, const int* __restrict__ part_i,
             int* __restrict__ idx_out, float* __restrict__ q2_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * M_WARPS + (threadIdx.x >> 5);
  if (row >= b) return;
  const float s2 = repro::row_norm(s + static_cast<size_t>(row) * d, d, lane);
  float v;
  int bi;
  repro::merge_splits(part_v, part_i, splits, b, 1, row, lane, n, v, bi);
  if (lane == 0) {
    idx_out[row] = bi < n ? bi : 0;   // every distance NaN: unit 0
    q2_out[row] = fmaxf(v + s2, 0.f);
  }
}

template <bool BF16, bool VEC>
cudaError_t launch_search(const float* w, const float* s, int n, int b, int d,
                   int sample_tile, int splits, float* pv, int* pi,
                   cudaStream_t st) {
  const dim3 grid(splits, (b + sample_tile - 1) / sample_tile);
  if (sample_tile == R_SAMPLES) {
    rows_kernel<BF16, VEC><<<grid, R_THREADS, 0, st>>>(w, s, n, b, d, splits,
                                                       pv, pi);
  } else {
    tile_kernel<BF16><<<grid, T_THREADS, 0, st>>>(w, s, n, b, d, splits, pv,
                                                  pi);
  }
  return cudaGetLastError();
}

}  // namespace

// w (n, d) and s (b, d) f32; sample_tile 16 (rows_kernel) or 128
// (tile_kernel) and splits as `ops.plan` gives them; part_v / part_i
// scratch of (splits, b) f32 / int32; idx_out (b,) int32, q2_out (b,) f32
extern "C" int repro_bmu(const void* w, const void* s, int n, int b, int d,
                         int bf16, int sample_tile, int splits, void* part_v,
                         void* part_i, void* idx_out, void* q2_out,
                         void* stream) {
  if (n < 1 || b < 1 || d < 1 || splits < 1 || splits > 65535 ||
      (sample_tile != R_SAMPLES && sample_tile != T_B) ||
      (b + sample_tile - 1) / sample_tile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* sp = static_cast<const float*>(s);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const cudaError_t err =
      bf16 ? (vec ? launch_search<true, true>(wp, sp, n, b, d, sample_tile, splits, pv, pi, st)
                  : launch_search<true, false>(wp, sp, n, b, d, sample_tile, splits, pv, pi, st))
           : (vec ? launch_search<false, true>(wp, sp, n, b, d, sample_tile, splits, pv, pi, st)
                  : launch_search<false, false>(wp, sp, n, b, d, sample_tile, splits, pv, pi, st));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(b + M_WARPS - 1) / M_WARPS, M_WARPS * 32, 0, st>>>(
      sp, n, b, d, splits, pv, pi, static_cast<int*>(idx_out),
      static_cast<float*>(q2_out));
  return static_cast<int>(cudaGetLastError());
}
