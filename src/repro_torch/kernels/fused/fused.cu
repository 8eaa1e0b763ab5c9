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
// beside that. So it is bound by bytes, and in practice by the latency of
// its barriers, one launch in place of ~140.
//
// Design. The TPU kernel holds all of W (2.8 MB) in one core's VMEM; a CTA
// has at most 227 KB of shared memory. But after the GMUs are known the
// step splits over features: the counter dynamics read only c, the fired
// front and the draws, and the weight update of feature k reads only
// feature k. So each CTA owns a slice of `ds` features of all N units in
// shared memory (two buffers: a wave reads one, writes the other) and runs
// the N-site integer cascade itself, redundantly and bitwise the same as
// every other CTA; all CTAs stop at the same wave and need no
// synchronisation inside the loop. CTA 0 writes the lattice outputs.
// The search is the only step that reduces over all of D: each CTA first
// takes a tile of units over full D and writes a per-tile (min, argmin)
// for every sample; one grid-wide barrier (cooperative launch, so the grid
// must be co-resident: the wrapper checks `repro_fused_plan`); then every
// CTA reduces the tiles with ties to the lowest index. W is written out of
// place, so the bf16 polish can read the winners' input rows after the
// barrier while other CTAs write their slices.
// The merge and wave updates use _rn intrinsics in the plain version's op
// order (no FMA contraction), so for the same GMUs the weights are those of
// the plain PyTorch version. Simple first: no wgmma, TMA or cluster.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../runtime/search.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::operand;
using repro::wins;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Params {
  const float* w;         // (n, d) input weights
  const int32_t* c;       // (n,) counters
  const float* s;         // (b, d) samples
  const uint8_t* drive;   // (8, n) drive draws (bool)
  const uint8_t* bern;    // (w_cap, 4, n) wave draws (bool)
  const int32_t* gmu_in;  // (b,) given GMUs, or NULL: search here
  int n, side, d, b, theta, budget, bf16, ds;
  float l_s, l_c;
  float* w_out;
  int32_t* c_out;
  uint8_t* fired_out;
  int32_t* stats_out;     // (2,) [size, waves]
  int32_t* recv_out;
  int32_t* gmu_out;
  float* q2_out;
  float* part_val;        // (grid, b) per-tile minimum
  int32_t* part_idx;      // (grid, b) per-tile argmin
};

struct Layout {
  size_t wa, wb, ca, cb, recv, cnt, gmu, fa, fb, bytes;
};

// shared memory of one CTA: two weight slices (n * ds floats), two counter
// lattices, the receive counts, the GMU counts, the GMUs, two fired fronts
__host__ __device__ inline Layout layout(int n, int b, int ds) {
  Layout l;
  l.wa = 0;
  l.wb = l.wa + sizeof(float) * n * ds;
  l.ca = l.wb + sizeof(float) * n * ds;
  l.cb = l.ca + sizeof(int32_t) * n;
  l.recv = l.cb + sizeof(int32_t) * n;
  l.cnt = l.recv + sizeof(int32_t) * n;
  l.gmu = l.cnt + sizeof(int32_t) * n;
  l.fa = l.gmu + sizeof(int32_t) * b;
  l.fb = l.fa + n;
  l.bytes = (l.fb + n + 15) / 16 * 16;
  return l;
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Phase 1: this CTA's tile of units over full D; per sample the tile's
// (min, argmin) of q = (|s|^2 - 2 s.w) + |w|^2, units in rising order.
template <bool BF16>
__device__ void search_tile(const Params& p, float* w2s) {
  const int g = blockIdx.x, grid = gridDim.x;
  const int tn = (p.n + grid - 1) / grid;
  const int u0 = min(p.n, g * tn), u1 = min(p.n, u0 + tn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int u = u0 + warp; u < u1; u += WARPS) {
    const float* wu = p.w + (size_t)u * p.d;
    float acc = 0.f;
    for (int k = lane; k < p.d; k += 32) acc = fmaf(wu[k], wu[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) w2s[u - u0] = acc;
  }
  __syncthreads();
  for (int bi = warp; bi < p.b; bi += WARPS) {
    const float* sb = p.s + (size_t)bi * p.d;
    float s2 = 0.f;
    for (int k = lane; k < p.d; k += 32) s2 = fmaf(sb[k], sb[k], s2);
    s2 = warp_sum(s2);
    float best = INFINITY;
    int best_i = p.n;
    for (int u = u0; u < u1; ++u) {
      const float* wu = p.w + (size_t)u * p.d;
      float acc = 0.f;
      for (int k = lane; k < p.d; k += 32)
        acc = fmaf(operand<BF16>(sb[k]), operand<BF16>(wu[k]), acc);
      acc = warp_sum(acc);
      const float q = __fadd_rn(__fsub_rn(s2, 2.f * acc), w2s[u - u0]);
      if (q < best) {   // rising u: a strict < keeps the lowest index
        best = q;
        best_i = u;
      }
    }
    if (lane == 0) {
      p.part_val[(size_t)g * p.b + bi] = best;
      p.part_idx[(size_t)g * p.b + bi] = best_i;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) fused_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.n, p.b, p.ds);
  float* wa = reinterpret_cast<float*>(smem + lay.wa);
  float* wb = reinterpret_cast<float*>(smem + lay.wb);
  int32_t* ca = reinterpret_cast<int32_t*>(smem + lay.ca);
  int32_t* cb = reinterpret_cast<int32_t*>(smem + lay.cb);
  int32_t* recv = reinterpret_cast<int32_t*>(smem + lay.recv);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + lay.cnt);
  int32_t* gmu = reinterpret_cast<int32_t*>(smem + lay.gmu);
  uint8_t* fa = smem + lay.fa;
  uint8_t* fb = smem + lay.fb;

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int n = p.n, side = p.side, d = p.d, b = p.b;

  // ---- search (Eq. 1), or the given GMUs
  if (p.gmu_in == nullptr) {
    if (p.bf16)
      search_tile<true>(p, wa);
    else
      search_tile<false>(p, wa);
    cg::this_grid().sync();
    for (int bi = tid; bi < b; bi += THREADS) {
      float bv = INFINITY;
      int bidx = n;
      for (int t = 0; t < (int)gridDim.x; ++t) {
        const float v = __ldcg(p.part_val + (size_t)t * b + bi);
        const int i = __ldcg(p.part_idx + (size_t)t * b + bi);
        if (wins(v, i, bv, bidx)) {
          bv = v;
          bidx = i;
        }
      }
      gmu[bi] = bidx;
      if (g == 0) {
        p.gmu_out[bi] = bidx;
        if (!p.bf16) p.q2_out[bi] = fmaxf(bv, 0.f);
      }
    }
    __syncthreads();
    if (g == 0 && p.bf16) {   // exact-f32 polish of each winner's distance
      const int warp = tid / 32, lane = tid % 32;
      for (int bi = warp; bi < b; bi += WARPS) {
        const float* wu = p.w + (size_t)gmu[bi] * d;
        const float* sb = p.s + (size_t)bi * d;
        float acc = 0.f;
        for (int k = lane; k < d; k += 32) {
          const float dv = __fsub_rn(wu[k], sb[k]);
          acc = fmaf(dv, dv, acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) p.q2_out[bi] = fmaxf(acc, 0.f);
      }
    }
  } else {
    for (int bi = tid; bi < b; bi += THREADS) gmu[bi] = p.gmu_in[bi];
  }

  // ---- per-unit GMU counts (integers: any order); GMUs outside [0, n)
  // are dropped, as JAX's scatter drops them
  for (int u = tid; u < n; u += THREADS) {
    cnt[u] = 0;
    recv[u] = 0;
  }
  __syncthreads();
  for (int bi = tid; bi < b; bi += THREADS) {
    const int u = gmu[bi];
    if (u >= 0 && u < n) atomicAdd(&cnt[u], 1);
  }
  __syncthreads();

  // ---- this CTA's feature slice, with the Eq. 3 merge: the target sum in
  // sample order, then w + l_s * (mean - w) for hit units
  const int ds = p.ds;
  const int f0 = g * ds;
  const int nf = min(ds, d - f0);
  for (int e = tid; e < n * nf; e += THREADS) {
    const int u = e / nf, f = e % nf;
    float wv = p.w[(size_t)u * d + f0 + f];
    const int k = cnt[u];
    if (k > 0) {
      float tsum = 0.f;
      for (int bi = 0; bi < b; ++bi)
        if (gmu[bi] == u) tsum = __fadd_rn(tsum, p.s[(size_t)bi * d + f0 + f]);
      const float mean = __fdiv_rn(tsum, (float)k);
      wv = __fadd_rn(wv, __fmul_rn(p.l_s, __fsub_rn(mean, wv)));
    }
    wa[u * ds + f] = wv;
  }

  // ---- counter drive: each of a unit's adaptations (at most 8) adds its
  // draw; the units at threshold form the first front
  for (int u = tid; u < n; u += THREADS) {
    const int k = min(cnt[u], 8);
    int inc = 0;
    for (int j = 0; j < k; ++j) inc += p.drive[(size_t)j * n + u] != 0;
    const int cv = p.c[u] + inc;
    ca[u] = cv;
    fa[u] = cv >= p.theta;
  }
  __syncthreads();

  // ---- waves, until the front is empty or the budget is spent
  int size = 0, waves = 0;
  while (waves < p.budget) {
    int fired = 0;
    for (int base = 0; base < n; base += THREADS) {
      const int u = base + tid;
      fired += __syncthreads_count(u < n && fa[u]);
    }
    if (fired == 0) break;
    size += fired;
    const uint8_t* bw = p.bern + (size_t)waves * 4 * n;
    // counters: the stencil of cascade.cu (slots below, above, right, left)
    for (int u = tid; u < n; u += THREADS) {
      const int r = u / side, col = u % side;
      const int below = (r + 1 < side) ? (fa[u + side] != 0) : 0;
      const int above = (r > 0) ? (fa[u - side] != 0) : 0;
      const int right = (col + 1 < side) ? (fa[u + 1] != 0) : 0;
      const int left = (col > 0) ? (fa[u - 1] != 0) : 0;
      const int nr = below + above + right + left;
      const int inc = (bw[u] != 0) * below + (bw[n + u] != 0) * above +
                      (bw[2 * n + u] != 0) * right +
                      (bw[3 * n + u] != 0) * left;
      const int cv = (fa[u] ? 0 : ca[u]) + inc;
      cb[u] = cv;
      fb[u] = (cv >= p.theta) && (nr > 0);
      recv[u] += nr;
    }
    // weights: every site of the slice, from the old buffer into the new
    for (int e = tid; e < n * nf; e += THREADS) {
      const int u = e / nf, f = e % nf;
      const int r = u / side, col = u % side;
      const int i = u * ds + f;
      float up = 0.f, dn = 0.f, lf = 0.f, rt = 0.f;
      int nr = 0;
      if (r + 1 < side) {
        up = __fmul_rn(wa[i + side * ds], fa[u + side] ? 1.f : 0.f);
        nr += fa[u + side] != 0;
      }
      if (r > 0) {
        dn = __fmul_rn(wa[i - side * ds], fa[u - side] ? 1.f : 0.f);
        nr += fa[u - side] != 0;
      }
      if (col + 1 < side) {
        lf = __fmul_rn(wa[i + ds], fa[u + 1] ? 1.f : 0.f);
        nr += fa[u + 1] != 0;
      }
      if (col > 0) {
        rt = __fmul_rn(wa[i - ds], fa[u - 1] ? 1.f : 0.f);
        nr += fa[u - 1] != 0;
      }
      const float sum = __fadd_rn(__fadd_rn(__fadd_rn(up, dn), lf), rt);
      const float wv = wa[i];
      wb[i] = __fadd_rn(
          wv, __fmul_rn(p.l_c, __fsub_rn(sum, __fmul_rn((float)nr, wv))));
    }
    __syncthreads();
    float* tw = wa; wa = wb; wb = tw;
    int32_t* tc = ca; ca = cb; cb = tc;
    uint8_t* tf = fa; fa = fb; fb = tf;
    ++waves;
  }

  // ---- outputs: the slice, and the lattices from CTA 0
  for (int e = tid; e < n * nf; e += THREADS) {
    const int u = e / nf, f = e % nf;
    p.w_out[(size_t)u * d + f0 + f] = wa[u * ds + f];
  }
  if (g == 0) {
    for (int u = tid; u < n; u += THREADS) {
      p.c_out[u] = ca[u];
      p.fired_out[u] = fa[u];
      p.recv_out[u] = recv[u];
    }
    if (tid == 0) {
      p.stats_out[0] = size;
      p.stats_out[1] = waves;
    }
  }
}

// features per CTA: the fewest that keep one CTA per SM enough
int plan_ds(int d, int sms) { return (d + sms - 1) / sms; }

}  // namespace

// plan_out (int32[5]): features per CTA, CTAs, shared bytes per CTA, the
// shared bytes a CTA may opt into, and the CTAs that fit on the card at once
// (0 when the shared memory does not fit at all)
extern "C" int repro_fused_plan(int n, int d, int b, void* plan_out) {
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ds = plan_ds(d, sms);
  const int grid = (d + ds - 1) / ds;
  const size_t smem = layout(n, b, ds).bytes;
  if (smem <= (size_t)max_smem) {
    err = cudaFuncSetAttribute(fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel,
                                                          THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int32_t* out = static_cast<int32_t*>(plan_out);
  out[0] = ds;
  out[1] = grid;
  out[2] = (int32_t)smem;
  out[3] = max_smem;
  out[4] = per_sm * sms;
  return 0;
}

extern "C" int repro_fused_step(
    const void* w, const void* c, const void* s, const void* drive,
    const void* bern, const void* gmu_in, int side, int d, int b, int theta,
    int budget, int bf16, float l_s, float l_c, void* w_out, void* c_out,
    void* fired_out, void* stats_out, void* recv_out, void* gmu_out,
    void* q2_out, void* scratch, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.n = side * side;
  p.side = side;
  p.d = d;
  p.b = b;
  p.theta = theta;
  p.budget = budget;
  p.bf16 = bf16;
  p.ds = plan_ds(d, sms);
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
  const int grid = (d + p.ds - 1) / p.ds;
  p.part_val = static_cast<float*>(scratch);
  p.part_idx = static_cast<int32_t*>(scratch) + (size_t)grid * b;
  const size_t smem = layout(p.n, b, p.ds).bytes;
  // set at every launch: an earlier, smaller shape may have set it lower
  err = cudaFuncSetAttribute(fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel),
                                    dim3(grid), dim3(THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
