// One cascade toppling wave on the unit lattice, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_wave_kernel` / `cascade_wave_pallas` in
// src/repro/kernels/cascade/cascade.py. Per lattice site: reset the counter
// if the site fired, count the fired 4-neighbours in slot order below,
// above, right, left, add the receipts whose Bernoulli draw succeeded, and
// fire anew when c >= theta and at least one broadcast arrived. Outputs
// (new_c, new_fired, recv).
//
// Bound on an H100: at side 30 the wave reads c (3.6 KB), fired (0.9 KB)
// and bern (3.6 KB) and writes 8.1 KB, ~16 KB in all, ~5 ns at 3.35 TB/s;
// a launch costs microseconds, so the kernel is launch-bound and the design
// does nothing beyond one thread per site with coalesced loads. The
// integers are exact, so the result is bitwise the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cascade_wave_kernel(const int32_t* __restrict__ c,
                    const uint8_t* __restrict__ fired,
                    const uint8_t* __restrict__ bern, int side, int theta,
                    int32_t* __restrict__ c_out, uint8_t* __restrict__ fired_out,
                    int32_t* __restrict__ recv_out) {
  const int nn = side * side;
  const int site = blockIdx.x * THREADS + threadIdx.x;
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

}  // namespace

extern "C" int repro_cascade_wave(const void* c, const void* fired,
                                  const void* bern, int side, int theta,
                                  void* c_out, void* fired_out, void* recv_out,
                                  void* stream) {
  const int nn = side * side;
  const dim3 grid((nn + THREADS - 1) / THREADS);
  cascade_wave_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c), static_cast<const uint8_t*>(fired),
      static_cast<const uint8_t*>(bern), side, theta,
      static_cast<int32_t*>(c_out), static_cast<uint8_t*>(fired_out),
      static_cast<int32_t*>(recv_out));
  return static_cast<int>(cudaGetLastError());
}
