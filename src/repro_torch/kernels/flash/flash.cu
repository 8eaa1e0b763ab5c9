// Causal flash attention, forward and backward, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's attention is plain jnp
// (`_attend` in src/repro/models/attention.py), and the port's copy of it
// (`repro_torch.models.attention._attend`) forms the (B, H, S, S) logits in
// f32 with an additive mask, a softmax and f32 products, each pass its own
// launch. This kernel computes the same function for the causal
// self-attention of training and prefill without ever writing the S x S
// scores to device memory.
//
// Inputs, all bf16 and in the layout `self_attention` makes them: q (B, S,
// H, hd), k and v (B, S, Hkv, hd) before the GQA repeat; query head h reads
// kv head h / rep, rep = H / Hkv. hd is 64 or 128. Query row i sees keys
// j <= i. The logits are (q . k) / sqrt(hd): bf16 products on the tensor
// cores (`mma.sync` m16n8k16) with f32 accumulation give exactly the f32
// products `_attend` forms, summed in another order. The softmax runs in
// f32 in base 2 (logits scaled by log2(e) / sqrt(hd)).
//
// Bound on an H100: the causal products, 4 B H hd S (S + 1) / 2 FLOPs
// forward (QK^T and PV) and 10 B H hd S (S + 1) / 2 backward (QK^T again,
// dV, dP, dK, dQ), on the 989 TFLOP/s of the bf16 tensor cores; the bytes
// (q, k, v, out once each) are far below that line at S >= 512. So the
// kernel is bound by the tensor cores, and its design keeps them fed from
// shared memory and skips every tile wholly above the diagonal, which adds
// exact zeros (exp(-inf)) and nothing else.
//
// Forward (`flash_fwd_kernel`, FlashAttention-2): a block takes `rows`
// (64 or 128, from `ops.plan`) query rows of one (batch row, head), 16 a
// warp; the grid's y index runs the longest rows first. Its Q tile and a
// ring of two 64-key K and V tiles land in shared memory by 16-byte
// `cp.async` (rows padded to hd + 8, so the `ldmatrix` reads are free of
// bank conflicts); Q's fragments stay in registers. Per key tile a warp
// forms S = Q K^T for its 16 rows, masks the keys past each row (only on
// the tiles that cross its diagonal; pairs of 8-key tiles wholly past its
// last row are not computed), runs the online softmax (m, l in f32) on the
// accumulator fragments, rounds P to bf16 once (as `_attend` rounds its
// probabilities before PV) and adds P V. The output acc / max(l, 1e-30)
// goes out as bf16 through shared memory in 16-byte stores, and the f32
// log-sum-exp (natural log, (B, H, S)) for the backward.
//
// Backward (`flash_bwd_kernel`, FlashAttention-2 with dQ by atomics): a
// block of 4 warps owns 64 keys of one (batch row, kv head), 16 a warp,
// and walks the query tiles from the diagonal down, for each of the kv
// head's rep query heads in turn, with Q, dO, the log-sum-exp and D of the
// next tile prefetched into the other half of a two-stage ring. Per tile a
// warp recomputes P^T = exp2(K Q^T scale - lse) (f32), adds P^T dO to dV
// with P rounded to bf16 as in the forward, forms dP^T = V dO^T, dS^T =
// P^T (dP^T - D) / sqrt(hd) in f32, and adds dS^T Q to dK with dS split
// into a bf16 high and low part (two products), so dS keeps ~16 bits where
// autograd through `_attend` keeps it in f32. dK and dV of the rep heads
// sum in f32 registers and are written once, as bf16. dS^T (high and low)
// goes through shared memory to the dQ = dS K product, which every block
// adds into an f32 (B, S, H, hd) buffer by 8-byte atomics. D = rowsum(dO o
// O) in f32 comes from `flash_bwd_pre_kernel`, which also zeroes that
// buffer; `flash_dq_cast_kernel` casts it to bf16 once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BC = 64;                     // keys a tile (forward), a block (backward)
constexpr int BWD_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// query rows a backward step takes: 64, or 32 at hd 128, where dK and dV
// alone hold 128 f32 accumulators a lane
template <int HD>
constexpr int BWD_ROWS = HD > 64 ? 32 : 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a b on the tensor cores: m16n8k16, bf16 operands, f32 accumulators;
// A's rows 0-7 in a[0] (k 0-7) and a[2] (k 8-15), rows 8-15 in a[1], a[3]
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A lane's row address in a 16 x 16 tile of a [row][ld] array, for the
// four 8 x 8 matrices of one ldmatrix.x4:
// - off_a: an A fragment of [m][k] memory (`ldsm`), or the B fragments of
//   two 8-wide n tiles of [k][n] memory (`ldsm_t`): r = {n0 b0, n0 b1,
//   n1 b0, n1 b1};
// - off_b: the B fragments of two n tiles of [n][k] memory (`ldsm`), or an
//   A fragment of [k][m] memory (`ldsm_t`).
__device__ __forceinline__ int off_a(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}

__device__ __forceinline__ int off_b(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// two values as a bf16 pair, the first in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// what the low bf16 pair of (lo, hi) leaves over its high pair `high`
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi,
                                              uint32_t high) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&high);
  return pack_bf16(lo - __low2float(h), hi - __high2float(h));
}

__device__ __forceinline__ void store32(bf16* p, uint32_t x) {
  *reinterpret_cast<uint32_t*>(p) = x;
}

// ------------------------------------------------------------- forward

template <int HD>
__host__ __device__ constexpr int fwd_smem_bytes(int rows) {
  return (rows + 4 * BC) * (HD + 8) * 2;   // Q, and two K and two V tiles
}

// grid (B * H, query tiles), blockDim 32 * rows / 16; see the file's note
template <int HD>
__global__ void __launch_bounds__(256, HD > 64 ? 1 : 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int s_len, int h_q, int rep,
                 int rows) {
  constexpr int LD = HD + 8;               // padded shared row, elements
  constexpr int PIECES = HD / 8;           // 16-byte pieces of a row
  constexpr int KT = HD / 16;              // k steps of Q K^T
  constexpr int NT = HD / 8;               // 8-wide column tiles of O
  constexpr int ST = BC / 8;               // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);            // [rows][LD]
  bf16* sk = sq + rows * LD;                           // [2][BC][LD]
  bf16* sv = sk + 2 * BC * LD;                         // [2][BC][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;                // fragment row
  const int gc = lane & 3;                 // fragment column pair
  const int h_kv = h_q / rep;
  const int b = blockIdx.x / h_q;
  const int h = blockIdx.x - b * h_q;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * rows;
  const int r0 = q0 + 16 * warp;           // this warp's first row
  const int n_kt = (min(s_len, q0 + rows) + BC - 1) / BC;
  const float scale2 = LOG2E * rsqrtf(static_cast<float>(HD));

  const size_t q_pos = static_cast<size_t>(h_q) * HD;    // a position's stride
  const size_t kv_pos = static_cast<size_t>(h_kv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s_len * q_pos + h * HD;
  const bf16* kb = k + static_cast<size_t>(b) * s_len * kv_pos + (h / rep) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s_len * kv_pos + (h / rep) * HD;

  for (int e = threadIdx.x; e < rows * PIECES; e += blockDim.x) {
    const int r = e / PIECES, part = (e % PIECES) * 8;
    const bool ok = q0 + r < s_len;
    cp_async16(sq + r * LD + part, ok ? qb + (q0 + r) * q_pos + part : qb,
               ok ? 16 : 0);
  }
  // key tile kt into ring stage kt & 1, zeros past the last key
  auto prefetch = [&](int kt) {
    bf16* ks = sk + (kt & 1) * BC * LD;
    bf16* vs = sv + (kt & 1) * BC * LD;
    for (int e = threadIdx.x; e < BC * PIECES; e += blockDim.x) {
      const int r = e / PIECES, part = (e % PIECES) * 8;
      const int j = kt * BC + r;
      const bool ok = j < s_len;
      const size_t off = ok ? j * kv_pos + part : 0;
      cp_async16(ks + r * LD + part, kb + off, ok ? 16 : 0);
      cp_async16(vs + r * LD + part, vb + off, ok ? 16 : 0);
    }
  };
  prefetch(0);
  cp_async_commit();

  uint32_t qa[KT][4];
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m = NEG_INF, m8 = NEG_INF, l = 0.f, l8 = 0.f;   // rows gr, gr + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) prefetch(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                       // Q and key tile kt have landed
    if (kt == 0) {
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        ldsm(qa[t], sq + 16 * warp * LD + 16 * t + off_a(lane, LD));
      }
    }
    const int kbase = kt * BC;
    // the tile holds a key at or before one of this warp's rows
    if (r0 < s_len && kbase <= r0 + 15) {
      const bf16* ks = sk + (kt & 1) * BC * LD;
      const bf16* vs = sv + (kt & 1) * BC * LD;
      float sc[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int j2 = 0; j2 < ST / 2; ++j2) {
        if (kbase + 16 * j2 <= r0 + 15) {  // else every key is masked
#pragma unroll
          for (int t = 0; t < KT; ++t) {
            uint32_t kf[4];
            ldsm(kf, ks + 16 * j2 * LD + 16 * t + off_b(lane, LD));
            mma(sc[2 * j2], qa[t], kf[0], kf[1]);
            mma(sc[2 * j2 + 1], qa[t], kf[2], kf[3]);
          }
        }
      }
      // scale; keys past a row to -inf where the tile crosses the diagonal
      const bool diag = kbase + BC - 1 > r0;
      float mt = NEG_INF, mt8 = NEG_INF;
#pragma unroll
      for (int j = 0; j < ST; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kbase + 8 * j + 2 * gc + e;
          float x = sc[j][e] * scale2, x8 = sc[j][2 + e] * scale2;
          if (diag && key > r0 + gr) x = -INFINITY;
          if (diag && key > r0 + gr + 8) x8 = -INFINITY;
          sc[j][e] = x;
          sc[j][2 + e] = x8;
          mt = fmaxf(mt, x);
          mt8 = fmaxf(mt8, x8);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
      mt8 = fmaxf(mt8, __shfl_xor_sync(FULL, mt8, 1));
      mt8 = fmaxf(mt8, __shfl_xor_sync(FULL, mt8, 2));
      const float mn = fmaxf(m, mt), mn8 = fmaxf(m8, mt8);
      const float al = exp2f(m - mn), al8 = exp2f(m8 - mn8);
      m = mn;
      m8 = mn8;
      l *= al;
      l8 *= al8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= al;
        o[nt][1] *= al;
        o[nt][2] *= al8;
        o[nt][3] *= al8;
      }
      // P in f32 into l, rounded to bf16 once for the PV product
      uint32_t pa[ST][2];
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        const float p0 = exp2f(sc[j][0] - mn), p1 = exp2f(sc[j][1] - mn);
        const float p2 = exp2f(sc[j][2] - mn8), p3 = exp2f(sc[j][3] - mn8);
        l += p0 + p1;
        l8 += p2 + p3;
        pa[j][0] = pack_bf16(p0, p1);
        pa[j][1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int t = 0; t < BC / 16; ++t) {
        if (kbase + 16 * t <= r0 + 15) {
          const uint32_t a[4] = {pa[2 * t][0], pa[2 * t][1], pa[2 * t + 1][0],
                                 pa[2 * t + 1][1]};
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t vf[4];
            ldsm_t(vf, vs + 16 * t * LD + 16 * n2 + off_a(lane, LD));
            mma(o[2 * n2], a, vf[0], vf[1]);
            mma(o[2 * n2 + 1], a, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();                       // stage kt & 1 is refilled next
  }
  cp_async_wait<0>();
  if (r0 >= s_len) return;
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  l8 += __shfl_xor_sync(FULL, l8, 1);
  l8 += __shfl_xor_sync(FULL, l8, 2);
  const float d = fmaxf(l, 1e-30f), d8 = fmaxf(l8, 1e-30f);

  // this warp's 16 rows of O, as bf16, over its own (read) rows of Q
  bf16* so = sq + 16 * warp * LD;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    store32(so + gr * LD + 8 * nt + 2 * gc, pack_bf16(o[nt][0] / d, o[nt][1] / d));
    store32(so + (gr + 8) * LD + 8 * nt + 2 * gc,
            pack_bf16(o[nt][2] / d8, o[nt][3] / d8));
  }
  __syncwarp();
  bf16* ob = out + static_cast<size_t>(b) * s_len * q_pos + h * HD;
  for (int e = lane; e < 16 * PIECES; e += 32) {
    const int r = e / PIECES, part = (e % PIECES) * 8;
    if (r0 + r < s_len) {
      *reinterpret_cast<uint4*>(ob + (r0 + r) * q_pos + part) =
          *reinterpret_cast<const uint4*>(so + r * LD + part);
    }
  }
  if (gc == 0) {
    float* lb = lse + (static_cast<size_t>(b) * h_q + h) * s_len;
    if (r0 + gr < s_len) lb[r0 + gr] = (m + log2f(l)) * LN2;
    if (r0 + gr + 8 < s_len) lb[r0 + gr + 8] = (m8 + log2f(l8)) * LN2;
  }
}

// ------------------------------------------------------------ backward

// D = rowsum(dO o O) in f32 into delta (B, H, S), and zeros into the f32 dQ
// buffer (B, S, H, hd): hd / 8 lanes a (position, head) row, 8 values each
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_pre_kernel(const bf16* __restrict__ d_out,
                     const bf16* __restrict__ out, float* __restrict__ delta,
                     float* __restrict__ dq_acc, int s_len, int h_q,
                     long long n_rows) {
  constexpr int LPR = HD / 8;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = e / LPR;
  const int part = static_cast<int>(e % LPR) * 8;
  float acc = 0.f;
  if (row < n_rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(d_out + row * HD + part);
    const uint4 c = *reinterpret_cast<const uint4*>(out + row * HD + part);
    const bf16* pa = reinterpret_cast<const bf16*>(&a);
    const bf16* pc = reinterpret_cast<const bf16*>(&c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc = fmaf(__bfloat162float(pa[i]), __bfloat162float(pc[i]), acc);
    }
    float4* z = reinterpret_cast<float4*>(dq_acc + row * HD + part);
    z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(FULL, acc, off);
  }
  if (row < n_rows && part == 0) {
    const int h = static_cast<int>(row % h_q);
    const long long pos = row / h_q;                 // b * s_len + s
    const long long b = pos / s_len;
    const int s = static_cast<int>(pos - b * s_len);
    delta[(b * h_q + h) * s_len + s] = acc;
  }
}

// dQ in bf16 from the f32 buffer, 8 values a thread
__global__ void __launch_bounds__(256)
flash_dq_cast_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                     long long n8) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n8) return;
  const float4 x = reinterpret_cast<const float4*>(dq_acc)[2 * e];
  const float4 y = reinterpret_cast<const float4*>(dq_acc)[2 * e + 1];
  reinterpret_cast<uint4*>(dq)[e] =
      make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                 pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
}

__device__ __forceinline__ void atomic_add2(float* p, float x, float y) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

template <int HD>
__host__ __device__ constexpr int bwd_smem_bytes() {
  constexpr int br = BWD_ROWS<HD>;
  // K, V; two stages of Q and dO; dS^T high and low; two stages of the
  // rows' log-sum-exp and D
  return (2 * BC + 4 * br) * (HD + 8) * 2 + 2 * BC * (br + 8) * 2 +
         4 * br * 4;
}

// grid (B * Hkv, key tiles), 4 warps; see the file's note
template <int HD>
__global__ void __launch_bounds__(BWD_WARPS * 32, 2)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ d_out,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int s_len,
                 int h_q, int rep) {
  constexpr int BR = BWD_ROWS<HD>;         // query rows a step
  constexpr int LD = HD + 8;
  constexpr int LDS = BR + 8;              // dS^T rows: [BC keys][LDS]
  constexpr int PIECES = HD / 8;
  constexpr int KT = HD / 16;
  constexpr int NT = HD / 8;
  constexpr int RT = BR / 8;               // 8-row tiles of S^T
  constexpr int QRG = BR / 16;             // dQ: row groups of 16 ..
  constexpr int QCG = BWD_WARPS / QRG;     // .. times column groups
  constexpr int QNT = NT / QCG;            // 8-wide column tiles a warp
  static_assert(QRG * QCG == BWD_WARPS && QNT % 2 == 0, "dQ's warp split");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);            // [BC][LD]
  bf16* sv = sk + BC * LD;                             // [BC][LD]
  bf16* sq = sv + BC * LD;                             // [2][BR][LD]
  bf16* sdo = sq + 2 * BR * LD;                        // [2][BR][LD]
  bf16* sds_hi = sdo + 2 * BR * LD;                    // [BC][LDS]
  bf16* sds_lo = sds_hi + BC * LDS;                    // [BC][LDS]
  float* slse = reinterpret_cast<float*>(sds_lo + BC * LDS);   // [2][BR]
  float* sdel = slse + 2 * BR;                         // [2][BR]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int gc = lane & 3;
  const int h_kv = h_q / rep;
  const int b = blockIdx.x / h_kv;
  const int hk = blockIdx.x - b * h_kv;
  const int kbase = blockIdx.y * BC;
  const int kw = kbase + 16 * warp;        // this warp's first key
  const int n_qt = (s_len + BR - 1) / BR;
  const int qt0 = kbase / BR;              // the first tile with a row >= kbase
  const int nq = n_qt - qt0;
  const int n_it = rep * nq;
  const float scale = rsqrtf(static_cast<float>(HD));
  const float scale2 = scale * LOG2E;

  const size_t q_pos = static_cast<size_t>(h_q) * HD;
  const size_t kv_pos = static_cast<size_t>(h_kv) * HD;
  const size_t kv0 = static_cast<size_t>(b) * s_len * kv_pos + hk * HD;
  for (int e = threadIdx.x; e < BC * PIECES; e += blockDim.x) {
    const int r = e / PIECES, part = (e % PIECES) * 8;
    const bool ok = kbase + r < s_len;
    const size_t off = ok ? kv0 + (kbase + r) * kv_pos + part : 0;
    cp_async16(sk + r * LD + part, k + off, ok ? 16 : 0);
    cp_async16(sv + r * LD + part, v + off, ok ? 16 : 0);
  }
  // step `it` (query head hk * rep + it / nq, rows of tile qt0 + it % nq)
  // into stage it & 1: Q and dO by cp.async (zeros past the last row), the
  // log-sum-exp (times log2 e) and D by plain loads (+inf and 0 past it)
  auto prefetch = [&](int it) {
    const int h = hk * rep + it / nq;
    const int q0 = (qt0 + it % nq) * BR;
    const int st = it & 1;
    const size_t row0 = static_cast<size_t>(b) * s_len * q_pos + h * HD;
    for (int e = threadIdx.x; e < BR * PIECES; e += blockDim.x) {
      const int r = e / PIECES, part = (e % PIECES) * 8;
      const bool ok = q0 + r < s_len;
      const size_t off = ok ? row0 + (q0 + r) * q_pos + part : 0;
      cp_async16(sq + (st * BR + r) * LD + part, q + off, ok ? 16 : 0);
      cp_async16(sdo + (st * BR + r) * LD + part, d_out + off, ok ? 16 : 0);
    }
    const size_t l0 = (static_cast<size_t>(b) * h_q + h) * s_len;
    for (int r = threadIdx.x; r < BR; r += blockDim.x) {
      const bool ok = q0 + r < s_len;
      slse[st * BR + r] = ok ? lse[l0 + q0 + r] * LOG2E : INFINITY;
      sdel[st * BR + r] = ok ? delta[l0 + q0 + r] : 0.f;
    }
  };
  prefetch(0);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) prefetch(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                       // step it's stage has landed
    const int h = hk * rep + it / nq;
    const int q0 = (qt0 + it % nq) * BR;
    const int st = it & 1;
    const bf16* qs = sq + st * BR * LD;
    const bf16* dos = sdo + st * BR * LD;
    const float* ls = slse + st * BR;
    const float* ds = sdel + st * BR;

    // S^T = K Q^T: this warp's 16 keys x BR rows
    float s[RT][4];
#pragma unroll
    for (int j = 0; j < RT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      uint32_t ka[4];
      ldsm(ka, sk + 16 * warp * LD + 16 * t + off_a(lane, LD));
#pragma unroll
      for (int j2 = 0; j2 < RT / 2; ++j2) {
        uint32_t f[4];
        ldsm(f, qs + 16 * j2 * LD + 16 * t + off_b(lane, LD));
        mma(s[2 * j2], ka, f[0], f[1]);
        mma(s[2 * j2 + 1], ka, f[2], f[3]);
      }
    }
    // P^T in f32: keys kw + gr (c0, c1) and kw + gr + 8 (c2, c3), rows
    // q0 + 8 j + 2 gc (+1); zero for a key past its row
#pragma unroll
    for (int j = 0; j < RT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rl = 8 * j + 2 * gc + e;
        const float lz = ls[rl];
        s[j][e] = kw + gr > q0 + rl ? 0.f : exp2f(s[j][e] * scale2 - lz);
        s[j][2 + e] =
            kw + gr + 8 > q0 + rl ? 0.f : exp2f(s[j][2 + e] * scale2 - lz);
      }
    }
    // dV += P^T dO, P rounded to bf16
#pragma unroll
    for (int u = 0; u < RT / 2; ++u) {
      const uint32_t a[4] = {pack_bf16(s[2 * u][0], s[2 * u][1]),
                             pack_bf16(s[2 * u][2], s[2 * u][3]),
                             pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]),
                             pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t f[4];
        ldsm_t(f, dos + 16 * u * LD + 16 * n2 + off_a(lane, LD));
        mma(dv_acc[2 * n2], a, f[0], f[1]);
        mma(dv_acc[2 * n2 + 1], a, f[2], f[3]);
      }
    }
    // dP^T = V dO^T
    float dp[RT][4];
#pragma unroll
    for (int j = 0; j < RT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      uint32_t va[4];
      ldsm(va, sv + 16 * warp * LD + 16 * t + off_a(lane, LD));
#pragma unroll
      for (int j2 = 0; j2 < RT / 2; ++j2) {
        uint32_t f[4];
        ldsm(f, dos + 16 * j2 * LD + 16 * t + off_b(lane, LD));
        mma(dp[2 * j2], va, f[0], f[1]);
        mma(dp[2 * j2 + 1], va, f[2], f[3]);
      }
    }
    // dS^T = P^T (dP^T - D) / sqrt(hd), f32, in s
#pragma unroll
    for (int j = 0; j < RT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dd = ds[8 * j + 2 * gc + e];
        s[j][e] = s[j][e] * (dp[j][e] - dd) * scale;
        s[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - dd) * scale;
      }
    }
    // dK += dS^T Q with dS^T as a bf16 high and low part; both parts to
    // shared memory as [key][row] for the dQ product
    bf16* hrow = sds_hi + (16 * warp + gr) * LDS + 2 * gc;
    bf16* lrow = sds_lo + (16 * warp + gr) * LDS + 2 * gc;
#pragma unroll
    for (int u = 0; u < RT / 2; ++u) {
      uint32_t hi[4], lo[4];
      hi[0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
      hi[1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
      hi[2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
      hi[3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
      lo[0] = pack_rest(s[2 * u][0], s[2 * u][1], hi[0]);
      lo[1] = pack_rest(s[2 * u][2], s[2 * u][3], hi[1]);
      lo[2] = pack_rest(s[2 * u + 1][0], s[2 * u + 1][1], hi[2]);
      lo[3] = pack_rest(s[2 * u + 1][2], s[2 * u + 1][3], hi[3]);
      store32(hrow + 16 * u, hi[0]);
      store32(hrow + 8 * LDS + 16 * u, hi[1]);
      store32(hrow + 16 * u + 8, hi[2]);
      store32(hrow + 8 * LDS + 16 * u + 8, hi[3]);
      store32(lrow + 16 * u, lo[0]);
      store32(lrow + 8 * LDS + 16 * u, lo[1]);
      store32(lrow + 16 * u + 8, lo[2]);
      store32(lrow + 8 * LDS + 16 * u + 8, lo[3]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t f[4];
        ldsm_t(f, qs + 16 * u * LD + 16 * n2 + off_a(lane, LD));
        mma(dk_acc[2 * n2], hi, f[0], f[1]);
        mma(dk_acc[2 * n2], lo, f[0], f[1]);
        mma(dk_acc[2 * n2 + 1], hi, f[2], f[3]);
        mma(dk_acc[2 * n2 + 1], lo, f[2], f[3]);
      }
    }
    __syncthreads();                       // dS^T of every warp is in place

    // dQ = dS K: rows qr .. qr + 15 of the step, columns qc .. qc + 8 QNT
    const int qr = 16 * (warp % QRG);
    const int qc = (warp / QRG) * QNT * 8;
    float dq[QNT][4];
#pragma unroll
    for (int nt = 0; nt < QNT; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
#pragma unroll
    for (int u = 0; u < BC / 16; ++u) {
      uint32_t ah[4], al[4];
      ldsm_t(ah, sds_hi + 16 * u * LDS + qr + off_b(lane, LDS));
      ldsm_t(al, sds_lo + 16 * u * LDS + qr + off_b(lane, LDS));
#pragma unroll
      for (int n2 = 0; n2 < QNT / 2; ++n2) {
        uint32_t f[4];
        ldsm_t(f, sk + 16 * u * LD + qc + 16 * n2 + off_a(lane, LD));
        mma(dq[2 * n2], ah, f[0], f[1]);
        mma(dq[2 * n2], al, f[0], f[1]);
        mma(dq[2 * n2 + 1], ah, f[2], f[3]);
        mma(dq[2 * n2 + 1], al, f[2], f[3]);
      }
    }
    const int row = q0 + qr + gr;
    float* dqb = dq_acc + static_cast<size_t>(b) * s_len * q_pos + h * HD + qc +
                 2 * gc;
#pragma unroll
    for (int nt = 0; nt < QNT; ++nt) {
      if (row < s_len) {
        atomic_add2(dqb + row * q_pos + 8 * nt, dq[nt][0], dq[nt][1]);
      }
      if (row + 8 < s_len) {
        atomic_add2(dqb + (row + 8) * q_pos + 8 * nt, dq[nt][2], dq[nt][3]);
      }
    }
  }
  cp_async_wait<0>();

  // dK and dV of this warp's keys, bf16, in k's layout
  const size_t kv_b = static_cast<size_t>(b) * s_len * kv_pos + hk * HD + 2 * gc;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (kw + gr < s_len) {
      const size_t off = kv_b + (kw + gr) * kv_pos + 8 * nt;
      store32(dk + off, pack_bf16(dk_acc[nt][0], dk_acc[nt][1]));
      store32(dv + off, pack_bf16(dv_acc[nt][0], dv_acc[nt][1]));
    }
    if (kw + gr + 8 < s_len) {
      const size_t off = kv_b + (kw + gr + 8) * kv_pos + 8 * nt;
      store32(dk + off, pack_bf16(dk_acc[nt][2], dk_acc[nt][3]));
      store32(dv + off, pack_bf16(dv_acc[nt][2], dv_acc[nt][3]));
    }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  // above 48 KB a block's shared memory must be asked for (per card)
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, int b, int s,
               int h, int rep, int rows, void* out, void* lse,
               cudaStream_t st) {
  const int bytes = fwd_smem_bytes<HD>(rows);
  const cudaError_t err = opt_in(flash_fwd_kernel<HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<HD><<<dim3(b * h, (s + rows - 1) / rows), 2 * rows, bytes,
                         st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), s, h, rep, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* d_out, const void* lse, int b, int s, int h,
               int rep, void* delta, void* dq_acc, void* dq, void* dk,
               void* dv, cudaStream_t st) {
  const long long n_rows = static_cast<long long>(b) * s * h;
  const long long pre_threads = n_rows * (HD / 8);
  flash_bwd_pre_kernel<HD><<<static_cast<unsigned>((pre_threads + 255) / 256),
                             256, 0, st>>>(
      static_cast<const bf16*>(d_out), static_cast<const bf16*>(out),
      static_cast<float*>(delta), static_cast<float*>(dq_acc), s, h, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bytes = bwd_smem_bytes<HD>();
  err = opt_in(flash_bwd_kernel<HD>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_kernel<HD><<<dim3(b * (h / rep), (s + BC - 1) / BC),
                         BWD_WARPS * 32, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_out),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, h, rep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n8 = n_rows * HD / 8;
  flash_dq_cast_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0,
                         st>>>(static_cast<const float*>(dq_acc),
                               static_cast<bf16*>(dq), n8);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int b, int s, int h, int hkv, int hd) {
  return b >= 1 && s >= 1 && hkv >= 1 && h >= hkv && h % hkv == 0 &&
         (hd == 64 || hd == 128) &&
         static_cast<long long>(b) * h <= 2147483647LL &&
         (s + 31) / 32 <= 65535;
}

}  // namespace

// q (b, s, h, hd), k and v (b, s, hkv, hd), all bf16 and contiguous; hd 64
// or 128; rows (64 or 128) query rows a block, as `ops.plan` gives them;
// out like q (bf16), lse (b, h, s) f32, the natural log-sum-exp of each
// row's scaled logits
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               int b, int s, int h, int hkv, int hd, int rows,
                               void* out, void* lse, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(b, s, h, hkv, hd) || (rows != 64 && rows != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 64) return launch_fwd<64>(q, k, v, b, s, h, h / hkv, rows, out, lse, st);
  return launch_fwd<128>(q, k, v, b, s, h, h / hkv, rows, out, lse, st);
}

// the forward's q, k, v, out and lse, and d_out like out (bf16,
// contiguous); delta (b, h, s) and dq_acc (b, s, h, hd) f32 scratch; dq
// like q, dk and dv like k (bf16)
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* d_out,
                               const void* lse, int b, int s, int h, int hkv,
                               int hd, void* delta, void* dq_acc, void* dq,
                               void* dk, void* dv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(b, s, h, hkv, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 64) {
    return launch_bwd<64>(q, k, v, out, d_out, lse, b, s, h, h / hkv, delta,
                          dq_acc, dq, dk, dv, st);
  }
  return launch_bwd<128>(q, k, v, out, d_out, lse, b, s, h, h / hkv, delta,
                         dq_acc, dq, dk, dv, st);
}
