// Exact best-matching-unit search on Hopper (sm_90a).
//
// Replaces the TPU kernel `_bmu_kernel` / `bmu_pallas` in
// src/repro/kernels/bmu/bmu.py. For each sample s_i it finds
// argmin_j |w_j|^2 - 2 w_j . s_i with a running (min, argmin), ties to the
// lowest index, then adds |s_i|^2 back and clamps at >= 0.
//
// Bound on an H100: at the query shape (B = 10000, N = 900, D = 784) the
// cross term is 2*B*N*D = 14.1 GFLOP of exact f32, which is compute-bound
// (~0.21 ms at 67 TFLOP/s of non-tensor f32). At the training shape
// (B = 16) the 2.8 MB of W dominate (~0.84 us at 3.35 TB/s) and one launch
// costs more than either.
//
// Design: a block owns BS samples and loops over all units in tiles of BN,
// staging BK-feature chunks of both through shared memory; the loop over
// unit tiles takes the place of the TPU's sequential grid axis. Each thread
// holds SPT x UPT f32 accumulators and does plain FMAs (no tensor cores, so
// no TF32 anywhere). Ragged N, B and D are masked in the loads, so no
// sentinel rows are needed. |w|^2 and |s|^2 are accumulated from the same
// staged f32 tiles. The bf16 tier rounds s and w to bf16 (__float2bfloat16)
// as they are read from shared memory and accumulates in f32; the norms stay
// f32, and the wrapper polishes the winner's q2 in exact f32.
// Simple first: no wgmma, TMA or split-N yet; at B = 16 a single block
// walks all 900 units.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "../runtime/search.cuh"

namespace {

using repro::operand;
using repro::wins;

constexpr int BS = 32;                 // samples per block
constexpr int BN = 64;                 // units per tile
constexpr int BK = 32;                 // features per staged chunk
constexpr int TX = 16;                 // threads along units
constexpr int TY = 16;                 // threads along samples
constexpr int THREADS = TX * TY;
constexpr int SPT = BS / TY;           // samples per thread
constexpr int UPT = BN / TX;           // units per thread

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
bmu_kernel(const float* __restrict__ w, const float* __restrict__ s, int n,
           int b, int d, int* __restrict__ idx_out,
           float* __restrict__ q2_out) {
  __shared__ float s_tile[BS][BK + 1];
  __shared__ float w_tile[BN][BK + 1];
  __shared__ float w2_tile[BN];
  __shared__ float s2_tile[BS];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b0 = blockIdx.x * BS;

  float best[SPT];
  int best_i[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    best[i] = INFINITY;
    best_i[i] = 0;
  }
  float s2_acc = 0.f;   // threads BN .. BN+BS-1: |s|^2 of one sample

  for (int n0 = 0; n0 < n; n0 += BN) {
    float acc[SPT][UPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i)
#pragma unroll
      for (int j = 0; j < UPT; ++j) acc[i][j] = 0.f;
    float w2_acc = 0.f;   // threads 0 .. BN-1: |w|^2 of one unit

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BS * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int gb = b0 + r, gk = k0 + k;
        s_tile[r][k] = (gb < b && gk < d) ? s[(size_t)gb * d + gk] : 0.f;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int gn = n0 + r, gk = k0 + k;
        w_tile[r][k] = (gn < n && gk < d) ? w[(size_t)gn * d + gk] : 0.f;
      }
      __syncthreads();
      if (tid < BN) {
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk)
          w2_acc = fmaf(w_tile[tid][kk], w_tile[tid][kk], w2_acc);
      } else if (n0 == 0 && tid < BN + BS) {
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk)
          s2_acc = fmaf(s_tile[tid - BN][kk], s_tile[tid - BN][kk], s2_acc);
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float sv[SPT], wv[UPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) sv[i] = operand<BF16>(s_tile[ty * SPT + i][kk]);
#pragma unroll
        for (int j = 0; j < UPT; ++j) wv[j] = operand<BF16>(w_tile[tx + TX * j][kk]);
#pragma unroll
        for (int i = 0; i < SPT; ++i)
#pragma unroll
          for (int j = 0; j < UPT; ++j) acc[i][j] = fmaf(sv[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < BN) w2_tile[tid] = w2_acc;
    if (n0 == 0 && tid >= BN && tid < BN + BS) s2_tile[tid - BN] = s2_acc;
    __syncthreads();
    // units of this thread rise with j, so a strict < keeps the lowest index
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const int u = n0 + tx + TX * j;
      if (u < n) {
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const float q = w2_tile[tx + TX * j] - 2.f * acc[i][j];
          if (q < best[i]) {
            best[i] = q;
            best_i[i] = u;
          }
        }
      }
    }
    __syncthreads();   // w2_tile is rewritten by the next tile
  }

  // the TX threads of one sample row are 16 consecutive lanes of a warp
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    float v = best[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off, TX);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off, TX);
      if (wins(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int gb = b0 + ty * SPT + i;
    if (tx == 0 && gb < b) {
      idx_out[gb] = bi;
      q2_out[gb] = fmaxf(v + s2_tile[ty * SPT + i], 0.f);
    }
  }
}

}  // namespace

extern "C" int repro_bmu(const void* w, const void* s, int n, int b, int d,
                         int bf16, void* idx_out, void* q2_out, void* stream) {
  const dim3 grid((b + BS - 1) / BS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* sp = static_cast<const float*>(s);
  int* ip = static_cast<int*>(idx_out);
  float* qp = static_cast<float*>(q2_out);
  if (bf16)
    bmu_kernel<true><<<grid, THREADS, 0, st>>>(wp, sp, n, b, d, ip, qp);
  else
    bmu_kernel<false><<<grid, THREADS, 0, st>>>(wp, sp, n, b, d, ip, qp);
  return static_cast<int>(cudaGetLastError());
}
