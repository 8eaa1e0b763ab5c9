// The cascade of the AFM on Hopper (sm_90a): one counter wave, and a
// staged step's whole drive and cascade.
//
// Replaces the TPU kernel `_wave_kernel` / `cascade_wave_pallas` in
// src/repro/kernels/cascade/cascade.py, which runs one counter wave, and
// the loop JAX wraps around it: `drive_and_cascade` in
// src/repro/core/cascade.py, a `lax.while_loop` with `_wave_kernel` as its
// `wave_fn`, which never returns to the host between waves.
//
// cascade_wave_kernel: one wave. Per lattice site: reset the counter if the
// site fired, count the fired 4-neighbours in slot order below, above,
// right, left, add the receipts whose Bernoulli draw succeeded, and fire
// anew when c >= theta and at least one broadcast arrived. Outputs (new_c,
// new_fired, recv). At side 30 it moves ~16 KB, ~5 ns at 3.35 TB/s, so a
// launch costs far more than its work: one thread a site, coalesced loads.
// It is the `wave_fn` seam's kernel and the tail loop's.
//
// drive_cascade_kernel: what a staged step does after its Eq. 3 merge, in
// one launch: the 8-draw counter drive of each unit's adaptations, then up
// to `budget` waves, each
//   w <- w + l_c * (((up + dn) + lf) + rt - n_recv * w)
// over the fired 4-neighbours, stopping at an empty front. The front is
// counted in shared memory, so nothing comes back to the host inside the
// loop; a cascade that outlives `budget` is finished by the wrapper's tail
// loop (ops.drive_cascade_stage).
//
// Bound on an H100: at 30x30x784 the step reads W once and writes it once
// (5.6 MB), plus c, the counts, the drive, the staged draws and the
// lattices (~0.08 MB): ~1.7 us at 3.35 TB/s; the arithmetic, 6 N D a wave,
// is smaller. A step whose drive fires nothing (many do) costs the launch
// and that one pass over W.
//
// Design. An ordinary launch (no grid barrier: blocks never wait for each
// other) of ceil(d / ds) blocks of 512 threads, the plan from the host
// (`ops.plan_cascade`, checked by `repro_cascade_plan`): at D = 784 on 132
// SMs, 6 features a block and 131 blocks. Each block copies its slice of W
// into shared memory feature-major by 4-byte `cp.async` copies transposed
// as they land (a slice of 6 features is 24 bytes a row, not a 16-byte
// multiple), and c, the counts, the drive and the first `staged` waves'
// draws by 16-byte `cp.async` copies where the source is 16-byte aligned
// (4-byte or plain copies otherwise); it checks that every weight is
// steady. Then it runs the drive, the waves and the outputs of
// runtime/wave_loop.cuh, the code of fused.cu's cascade, included in both
// kernels' bodies (runtime/waves.cuh describes it): every block runs the
// whole integer cascade, redundantly and bitwise the same, and updates its
// own features. W is written out of place, into a new tensor: the op is a
// pure function, as its plain version and the fused step are, and a step
// that fires nothing still costs only the one pass over W (its copy). The
// updates use _rn intrinsics in the plain version's op order (no FMA
// contraction) and no float atomics, so the weights are the plain
// PyTorch version's bit for bit, and two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../runtime/waves.cuh"

namespace {

using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::stage_bytes;
using repro::steady;

constexpr int WAVE_THREADS = 256;   // cascade_wave_kernel
constexpr int THREADS = 512;        // drive_cascade_kernel

__global__ void __launch_bounds__(WAVE_THREADS)
cascade_wave_kernel(const int32_t* __restrict__ c,
                    const uint8_t* __restrict__ fired,
                    const uint8_t* __restrict__ bern, int side, int theta,
                    int32_t* __restrict__ c_out, uint8_t* __restrict__ fired_out,
                    int32_t* __restrict__ recv_out) {
  const int nn = side * side;
  const int site = blockIdx.x * WAVE_THREADS + threadIdx.x;
  if (site >= nn) return;
  const int r = site / side, col = site % side;
  const int below = (r + 1 < side) ? (fired[site + side] != 0) : 0;
  const int above = (r > 0) ? (fired[site - side] != 0) : 0;
  const int right = (col + 1 < side) ? (fired[site + 1] != 0) : 0;
  const int left = (col > 0) ? (fired[site - 1] != 0) : 0;
  const int recv = below + above + right + left;
  const int inc = (bern[site] != 0) * below + (bern[nn + site] != 0) * above +
                  (bern[2 * nn + site] != 0) * right +
                  (bern[3 * nn + site] != 0) * left;
  const int new_c = (fired[site] ? 0 : c[site]) + inc;
  c_out[site] = new_c;
  fired_out[site] = (new_c >= theta) && (recv > 0);
  recv_out[site] = recv;
}

struct Params {
  const float* w;          // (n, d) merged weights
  const int32_t* c;        // (n,) counters
  const int32_t* counts;   // (n,) adaptations of each unit this step
  const uint8_t* drive;    // (8, n) drive draws (bool)
  const uint8_t* bern;     // (w_cap, 4, n) wave draws (bool)
  int n, side, d, ds, theta, budget;
  int staged;              // waves of draws in shared memory
  int out2;                // the slice goes out two features a store
  float l_c;
  float* w_out;
  int32_t* c_out;
  uint8_t* fired_out;
  int32_t* stats_out;      // (2,) [size, waves]
  int32_t* recv_out;
};

struct Layout {
  size_t wa, wb, c, recv, cnt, fgen, acc, drive, draws, fronts, receivers,
      nbr, flags, bytes;
};

__host__ __device__ inline size_t up16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += up16(bytes);
  return here;
}

// shared memory of one block, each region rounded up to 16 bytes
// (ops.cascade_shared_bytes adds up the same regions): two weight slices
// (feature-major), the counters, the receive counts, the adaptation counts,
// the wave each site last fired in, two arrays of packed receipts, the
// drive draws, `staged` waves of draws, two front lists, two receiver
// lists, the edge masks and the flags (`dirty`, two front lengths, three
// receiver counts)
__host__ __device__ inline Layout layout(int n, int ds, int staged) {
  Layout l;
  size_t at = 0;
  l.wa = take(at, sizeof(float) * ds * n);
  l.wb = take(at, sizeof(float) * ds * n);
  l.c = take(at, sizeof(int32_t) * n);
  l.recv = take(at, sizeof(int32_t) * n);
  l.cnt = take(at, sizeof(int32_t) * n);
  l.fgen = take(at, sizeof(int32_t) * n);
  l.acc = take(at, 2 * sizeof(int32_t) * n);
  l.drive = take(at, static_cast<size_t>(8) * n);
  l.draws = take(at, static_cast<size_t>(4) * n * staged);
  l.fronts = take(at, 2 * sizeof(uint16_t) * n);
  l.receivers = take(at, 2 * sizeof(uint16_t) * n);
  l.nbr = take(at, n);
  l.flags = take(at, 6 * sizeof(int32_t));
  l.bytes = at;
  return l;
}

__global__ void __launch_bounds__(THREADS, 1)
drive_cascade_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.n, p.ds, p.staged);
  float* wa = reinterpret_cast<float*>(smem + lay.wa);
  float* wb = reinterpret_cast<float*>(smem + lay.wb);
  int32_t* c = reinterpret_cast<int32_t*>(smem + lay.c);
  int32_t* recv = reinterpret_cast<int32_t*>(smem + lay.recv);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + lay.cnt);
  int32_t* fgen = reinterpret_cast<int32_t*>(smem + lay.fgen);
  int32_t* acc = reinterpret_cast<int32_t*>(smem + lay.acc);
  uint8_t* drive = smem + lay.drive;
  uint8_t* draws = smem + lay.draws;
  uint16_t* fronts = reinterpret_cast<uint16_t*>(smem + lay.fronts);
  uint16_t* receivers = reinterpret_cast<uint16_t*>(smem + lay.receivers);
  uint8_t* nbr = smem + lay.nbr;
  int32_t* flags = reinterpret_cast<int32_t*>(smem + lay.flags);
  int32_t* dirty = flags;
  int32_t* n_front = flags + 1;   // the front of wave k: n_front[k % 2]
  int32_t* n_recv = flags + 3;    // the receivers of wave k: n_recv[k % 3]

  const int tid = threadIdx.x, g = blockIdx.x;
  const int n = p.n, side = p.side, d = p.d, ds = p.ds;
  const int f0 = g * ds;
  const int nf = min(ds, d - f0);   // every block owns >= 1 feature
  const int staged = min(p.staged, p.budget);   // waves of draws staged

  // ---- copies in: the W slice transposed to feature-major, then c, the
  // counts, the drive and the staged draws; the sites' state meanwhile
  REPRO_FOR_PAIRS(n, nf, tid, THREADS,
                  cp_async4(wa + f * n + u,
                            p.w + static_cast<size_t>(u) * d + f0 + f));
  stage_bytes(c, p.c, 4 * n, tid, THREADS);
  stage_bytes(cnt, p.counts, 4 * n, tid, THREADS);
  stage_bytes(drive, p.drive, 8 * n, tid, THREADS);
  stage_bytes(draws, p.bern, 4 * n * staged, tid, THREADS);
  cp_async_commit();
  if (tid < 6) flags[tid] = 0;   // dirty and the lengths
  for (int u = tid; u < n; u += THREADS) {
    recv[u] = 0;
    fgen[u] = -1;   // fired in no wave
    acc[u] = 0;
    acc[n + u] = 0;
    nbr[u] = repro::edge_mask(u, side);
  }
  // the copies landed: this thread's pairs of the slice into the second
  // buffer, and checked
  cp_async_wait_all();
  bool clean = true;   // every weight of this thread's pairs steady
  REPRO_FOR_PAIRS(n, nf, tid, THREADS, {
    const float v = wa[f * n + u];
    wb[f * n + u] = v;
    clean &= steady(v);
  });
  __syncthreads();

  // the drive, the waves and the outputs, as fused.cu runs them
#include "../runtime/wave_loop.cuh"
}

// the plan as ops.plan_cascade passes it (int32[5]): blocks, features a
// block, threads, shared bytes, waves of draws staged
struct Plan {
  int blocks, ds, threads, smem, staged;
};

// cudaErrorInvalidValue unless the plan is one this kernel, as built, can
// run: its threads, the shared bytes of its layout, every block owning a
// feature and every feature in a block, and sites that fit the 16-bit lists
cudaError_t check_plan(int n, int d, const void* plan_in, Plan& pl) {
  const int32_t* v = static_cast<const int32_t*>(plan_in);
  pl = Plan{v[0], v[1], v[2], v[3], v[4]};
  if (n < 1 || n > 65535 || d < 1 || pl.ds < 1 || pl.threads != THREADS ||
      pl.staged < 0 || pl.blocks != (d + pl.ds - 1) / pl.ds ||
      static_cast<size_t>(pl.smem) != layout(n, pl.ds, pl.staged).bytes) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_cascade_wave(const void* c, const void* fired,
                                  const void* bern, int side, int theta,
                                  void* c_out, void* fired_out, void* recv_out,
                                  void* stream) {
  const int nn = side * side;
  const dim3 grid((nn + WAVE_THREADS - 1) / WAVE_THREADS);
  cascade_wave_kernel<<<grid, WAVE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c), static_cast<const uint8_t*>(fired),
      static_cast<const uint8_t*>(bern), side, theta,
      static_cast<int32_t*>(c_out), static_cast<uint8_t*>(fired_out),
      static_cast<int32_t*>(recv_out));
  return static_cast<int>(cudaGetLastError());
}

// Checks a plan from ops.plan_cascade against the kernel as built and the
// card. out (int32[2]): SMs, shared bytes a block may opt into. Returns
// cudaErrorInvalidValue where the plan disagrees with the kernel or its
// shared memory does not fit.
extern "C" int repro_cascade_plan(int n, int d, const void* plan, void* out) {
  Plan pl;
  cudaError_t err = check_plan(n, d, plan, pl);
  int dev = 0, sms = 0, max_smem = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && pl.smem > max_smem) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_t* o = static_cast<int32_t*>(out);
  o[0] = sms;
  o[1] = max_smem;
  return 0;
}

extern "C" int repro_drive_cascade(
    const void* w, const void* c, const void* counts, const void* drive,
    const void* bern, int side, int d, int theta, int budget, float l_c,
    void* w_out, void* c_out, void* fired_out, void* stats_out,
    void* recv_out, const void* plan, void* stream) {
  Plan pl;
  cudaError_t err = check_plan(side * side, d, plan, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.w = static_cast<const float*>(w);
  p.c = static_cast<const int32_t*>(c);
  p.counts = static_cast<const int32_t*>(counts);
  p.drive = static_cast<const uint8_t*>(drive);
  p.bern = static_cast<const uint8_t*>(bern);
  p.n = side * side;
  p.side = side;
  p.d = d;
  p.ds = pl.ds;
  p.theta = theta;
  p.budget = budget;
  p.staged = pl.staged;
  p.out2 = pl.ds % 2 == 0 && d % 2 == 0 &&
           reinterpret_cast<uintptr_t>(w_out) % 8 == 0;
  p.l_c = l_c;
  p.w_out = static_cast<float*>(w_out);
  p.c_out = static_cast<int32_t*>(c_out);
  p.fired_out = static_cast<uint8_t*>(fired_out);
  p.stats_out = static_cast<int32_t*>(stats_out);
  p.recv_out = static_cast<int32_t*>(recv_out);
  // set at every launch: an earlier, smaller shape may have set it lower
  err = cudaFuncSetAttribute(drive_cascade_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  drive_cascade_kernel<<<pl.blocks, THREADS, pl.smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
