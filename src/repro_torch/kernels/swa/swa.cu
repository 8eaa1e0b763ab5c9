// Flash-decode attention over a ring-buffer KV cache on Hopper (sm_90a).
//
// Replaces the TPU kernel `_swa_kernel` / `swa_decode_pallas` in
// src/repro/kernels/swa/swa.py. One query token per head attends to a
// cache of W slots: q (B, H, hd), k and v (B, W, Hkv, hd) in their cache
// layout, pos (B,) int32 read from device memory (no host sync per step).
// Head h uses kv head h / rep, rep = H / Hkv (GQA). Slot j is valid iff
// age(j) = (pos - j) mod W < min(pos + 1, W); for pos >= 0 that is exactly
// j < min(pos + 1, W) (for pos >= W every age is < W; for pos < W the
// slots j <= pos have age pos - j <= pos and the others pos - j + W > pos),
// so the kernel visits the valid slots only and never meets a masked one.
// Logits are (q . k) / sqrt(hd) in f32; an online softmax keeps m, l and
// acc in f32; the output is acc / max(l, 1e-30), cast to q's dtype.
//
// Bound on an H100: the work is one read of each valid K and V row, about
// 2 * valid * Hkv * hd * bytes per batch row (16.8 MB at the long_500k
// shape: B 1, W 8192, Hkv 8, hd 64, bf16), i.e. ~5 us at 3.35 TB/s; the
// arithmetic (4 * rep flops per element read) is far below the tensor-core
// or f32 rate, so the kernel is bound by bytes.
//
// Design, simple first: one block of 8 warps per (batch row, kv head). A
// warp splits into groups of hd / VEC lanes, each lane loading 16 bytes of
// a slot's row (a 128-byte row is one group of 8 lanes at bf16 / hd 64), so
// a warp reads whole rows with 16-byte loads straight from the cache layout,
// never transposing or copying it. Each group streams its own slots, U at a
// time, and keeps its own online softmax for the rep query rows (q and acc
// in registers, rep bounded by the MAX_REP template). The groups of a warp
// merge by shuffles, the warps through shared memory. One block per
// (b, kv head) fills only B * Hkv SMs (8 of 132 at B 1), so at long
// contexts the kernel is far from its bound; splitting the slots across
// blocks with a combine pass is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

// 16 bytes of T, widened to f32
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&out)[N]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&out)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD, int MAX_REP>
__global__ void __launch_bounds__(THREADS)
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int32_t* __restrict__ pos,
                  int w, int hkv, int rep, T* __restrict__ out) {
  constexpr int VEC = Pack<T>::N;          // elements a lane loads at once
  constexpr int LPS = HD / VEC;            // lanes per slot row (a group)
  constexpr int GPW = 32 / LPS;            // groups per warp
  constexpr int GROUPS = WARPS * GPW;
  constexpr int U = MAX_REP >= 8 ? 2 : 4;  // slots a group takes per step
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "hd / VEC lanes");

  __shared__ float s_m[WARPS][MAX_REP];
  __shared__ float s_l[WARPS][MAX_REP];
  __shared__ float s_acc[WARPS][MAX_REP][HD];

  const int h = blockIdx.x;                // kv head
  const int b = blockIdx.y;                // batch row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % LPS;               // lane within its group
  const int g = warp * GPW + lane / LPS;   // group within the block
  const int heads = hkv * rep;
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  const int nv = min(pos[b] + 1, w);       // valid slots: j < nv

  float qf[MAX_REP][VEC];
  float m[MAX_REP], l[MAX_REP], acc[MAX_REP][VEC];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[r][e] = 0.f;
      acc[r][e] = 0.f;
    }
    if (r < rep) {
      Pack<T>::load(q + (static_cast<size_t>(b) * heads + h * rep + r) * HD +
                        li * VEC,
                    qf[r]);
    }
  }

  const size_t slot_stride = static_cast<size_t>(hkv) * HD;
  const size_t row0 = (static_cast<size_t>(b) * w * hkv + h) * HD + li * VEC;
  for (int base = 0; base < nv; base += GROUPS * U) {
    float kf[U][VEC], vf[U][VEC];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * GROUPS + g;
      ok[u] = j < nv;
      if (ok[u]) {
        Pack<T>::load(k + row0 + j * slot_stride, kf[u]);
        Pack<T>::load(v + row0 + j * slot_stride, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;                 // uniform across the block
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qf[r][e], kf[u][e], part);
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1) {
          part += __shfl_xor_sync(FULL, part, off);
        }
        s[u] = part / sqrt_hd;
      }
      float mt = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) mt = fmaxf(mt, s[u]);
      }
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        const float p = expf(s[u] - mn);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[u][e], acc[r][e]);
      }
      m[r] = mn;
    }
  }

  // merge the groups of each warp (shuffles), then the warps (shared memory)
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= rep) break;
    float mw = m[r];
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) {
      mw = fmaxf(mw, __shfl_xor_sync(FULL, mw, off));
    }
    const float sc = expf(m[r] - mw);      // 0 for a group that saw no slot
    float lw = l[r] * sc;
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) {
      lw += __shfl_xor_sync(FULL, lw, off);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float a = acc[r][e] * sc;
#pragma unroll
      for (int off = LPS; off < 32; off <<= 1) {
        a += __shfl_xor_sync(FULL, a, off);
      }
      if (lane < LPS) s_acc[warp][r][li * VEC + e] = a;
    }
    if (lane == 0) {
      s_m[warp][r] = mw;
      s_l[warp][r] = lw;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) mx = fmaxf(mx, s_m[ww][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float sc = expf(s_m[ww][r] - mx);
      lsum = fmaf(s_l[ww][r], sc, lsum);
      a = fmaf(s_acc[ww][r][d], sc, a);
    }
    store(out + (static_cast<size_t>(b) * heads + h * rep + r) * HD + d,
          a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int MAX_REP>
int launch(const void* q, const void* k, const void* v, const void* pos,
           int b, int hkv, int w, int rep, void* out, cudaStream_t stream) {
  const dim3 grid(hkv, b);
  swa_decode_kernel<T, HD, MAX_REP><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pos), w, hkv, rep,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_rep(const void* q, const void* k, const void* v, const void* pos,
               int b, int hkv, int w, int rep, void* out,
               cudaStream_t stream) {
  if (rep <= 1) return launch<T, HD, 1>(q, k, v, pos, b, hkv, w, rep, out, stream);
  if (rep <= 2) return launch<T, HD, 2>(q, k, v, pos, b, hkv, w, rep, out, stream);
  if (rep <= 4) return launch<T, HD, 4>(q, k, v, pos, b, hkv, w, rep, out, stream);
  return launch<T, HD, 8>(q, k, v, pos, b, hkv, w, rep, out, stream);
}

}  // namespace

// q (b, hkv * rep, hd), k and v (b, w, hkv, hd), all of one type (bf16 when
// `bf16`, else f32), pos (b,) int32, out like q; hd 64 or 128, rep 1..8.
extern "C" int repro_swa_decode(const void* q, const void* k, const void* v,
                                const void* pos, int b, int hkv, int w,
                                int rep, int hd, int bf16, void* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || hkv < 1 || w < 1 || rep < 1 || rep > 8 ||
      (hd != 64 && hd != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    return hd == 64
               ? launch_rep<__nv_bfloat16, 64>(q, k, v, pos, b, hkv, w, rep, out, s)
               : launch_rep<__nv_bfloat16, 128>(q, k, v, pos, b, hkv, w, rep, out, s);
  }
  return hd == 64 ? launch_rep<float, 64>(q, k, v, pos, b, hkv, w, rep, out, s)
                  : launch_rep<float, 128>(q, k, v, pos, b, hkv, w, rep, out, s);
}
