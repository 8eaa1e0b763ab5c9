// Device code shared by the kernels that run the AFM cascade on the
// weights: fused.cu (after its search and Eq. 3 merge) and cascade.cu's
// drive_cascade (after the staged step's merge).
//
// Both split the step over features: the counter dynamics read only c, the
// fired front and the draws, and the weight update of feature k reads only
// feature k. So a block holds a slice of `nf` features of all n units in
// shared memory, feature-major (`f * n + u`: a wave's neighbours at unit
// strides, free of bank conflicts), and runs the n-site integer cascade
// itself, redundantly and bitwise the same as every other block; all blocks
// stop at the same wave and never synchronise with each other. Both run the
// same drive, waves and outputs (runtime/wave_loop.cuh, included in each
// kernel's body), so for the same merged W, counters and draws the two
// kernels give the same bits:
// - the drive: each of a unit's adaptations (at most 8) adds its drive
//   draw; the units at threshold form the first front;
// - the waves, in work proportional to the front, two barriers each. Push:
//   a thread a (fired site, direction) adds one receipt, and its draw, to
//   the neighbour's packed count (shared-memory integer atomics: any order
//   gives the same sums) and lists the sites that receive. Update: a
//   thread a receiver sets its counter (in place: no site reads another's
//   counter) and lists the next front; a thread a (site, feature) pair
//   updates the weights with `update` below,
//     w + l_c * (((up + dn) + lf) + rt - n_recv * w),
//   with _rn intrinsics in the plain version's op order (no FMA
//   contraction). While every weight is `steady`, a site that receives
//   nothing keeps its weights bit for bit (w + l_c (±0 - 0 w) is w), so
//   only the receivers' pairs are updated, and last wave's receivers copied
//   into the new buffer; a weight that is not steady sets the `dirty` flag,
//   which sends every later wave back to updating every pair. Waves past
//   the staged ones read their draws from device memory;
// - the outputs: the slice, and the lattices from three blocks.
// No atomics on floats: two calls give the same bits. Here: the copies
// that stage a block's inputs, the pair loop, `steady`, `update` and the
// edge masks.
#pragma once

#include <math.h>
#include <stdint.h>

namespace repro {

// ---------------------------------------------------------------- staging

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src));
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `bytes` bytes from global memory into a 16-byte aligned shared region of
// at least the next multiple of 16, by threads t (0 <= t < nth):
// asynchronous 16-byte copies where the source is 16-byte aligned, 4-byte
// ones where it and the size are 4-byte aligned, plain copies otherwise
// (visible after the next barrier either way)
__device__ __forceinline__ void stage_bytes(void* dst, const void* src,
                                            int bytes, int t, int nth) {
  unsigned char* d8 = static_cast<unsigned char*>(dst);
  const unsigned char* s8 = static_cast<const unsigned char*>(src);
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if ((at & 15) == 0) {
    for (int i = 16 * t; i < bytes; i += 16 * nth)
      cp_async16(d8 + i, s8 + i, min(16, bytes - i));
  } else if ((at & 3) == 0 && (bytes & 3) == 0) {
    for (int i = 4 * t; i < bytes; i += 4 * nth) cp_async4(d8 + i, s8 + i);
  } else {
    for (int i = t; i < bytes; i += nth) d8[i] = s8[i];
  }
}

// pairs (u, f) of a slice of nf features, f fastest (a warp reads or writes
// a few 24-byte runs of rows), for thread t of nth, without a division a
// pair
#define REPRO_FOR_PAIRS(n, nf, t, nth, BODY)               \
  {                                                        \
    const int du_ = (nth) / (nf), df_ = (nth) - du_ * (nf); \
    for (int u = (t) / (nf), f = (t) % (nf); u < (n);) {   \
      BODY;                                                \
      u += du_;                                            \
      f += df_;                                            \
      if (f >= (nf)) {                                     \
        f -= (nf);                                         \
        ++u;                                               \
      }                                                    \
    }                                                      \
  }

// ---------------------------------------------------------------- waves

// a weight the sparse waves can leave as it is: finite, and not -0 (for
// such a w, w + l_c * (±0 - 0 * w) is w bit for bit, with l_c finite, and
// a non-finite l_c makes the first wave's weights non-finite; -0 turns
// into +0)
__device__ __forceinline__ bool steady(float w) {
  return isfinite(w) && __float_as_uint(w) != 0x80000000u;
}

// The weight update of feature f of site u in wave k, in the plain
// version's op order, from `wa` into `wb`: a neighbour broadcasts when it
// fired in wave k (fgen == k); m is u's edge mask. Returns whether the new
// value is steady.
__device__ __forceinline__ bool update(const float* wa, float* wb,
                                       const int32_t* fgen, int k, int n,
                                       int side, int u, int f, int m,
                                       float l_c) {
  const int below = (m & 1) ? (fgen[u + side] == k) : 0;
  const int above = (m & 2) ? (fgen[u - side] == k) : 0;
  const int right = (m & 4) ? (fgen[u + 1] == k) : 0;
  const int left = (m & 8) ? (fgen[u - 1] == k) : 0;
  const int nr = below + above + right + left;
  const float* col = wa + f * n;
  const float up = (m & 1) ? __fmul_rn(col[u + side], below ? 1.f : 0.f) : 0.f;
  const float dn = (m & 2) ? __fmul_rn(col[u - side], above ? 1.f : 0.f) : 0.f;
  const float lf = (m & 4) ? __fmul_rn(col[u + 1], right ? 1.f : 0.f) : 0.f;
  const float rt = (m & 8) ? __fmul_rn(col[u - 1], left ? 1.f : 0.f) : 0.f;
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(up, dn), lf), rt);
  const float wv = col[u];
  const float out = __fadd_rn(
      wv, __fmul_rn(l_c, __fsub_rn(sum, __fmul_rn((float)nr, wv))));
  wb[f * n + u] = out;
  return steady(out);
}

// the edge mask of site u of a side x side lattice: 1 a row below, 2 a row
// above, 4 a column right, 8 a column left (stored once a site, so the waves
// do no integer division)
__device__ __forceinline__ uint8_t edge_mask(int u, int side) {
  const int r = u / side, col = u - r * side;
  return (r + 1 < side) | ((r > 0) << 1) | ((col + 1 < side) << 2) |
         ((col > 0) << 3);
}

}  // namespace repro
