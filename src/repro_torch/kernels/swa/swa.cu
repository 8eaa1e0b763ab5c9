// Flash-decode attention over a ring-buffer KV cache on Hopper (sm_90a).
//
// Replaces the TPU kernel `_swa_kernel` / `swa_decode_pallas` in
// src/repro/kernels/swa/swa.py. One query token per head attends to a
// cache of W slots: q (B, H, hd), k and v (B, W, Hkv, hd) in their cache
// layout, pos (B,) int32 read from device memory (no host sync per step).
// Head h uses kv head h / rep, rep = H / Hkv (GQA, MQA: rep 1 to 16);
// hd is 32, 64, 128 or 256 (recurrentgemma-2b's local attention: hd 256,
// H 10 over one kv head). Slot j is valid iff
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
// or f32 rate, so the kernel is bound by bytes, and the card's 132 SMs
// must all stream.
//
// Design (flash decoding): the grid is (splits, Hkv, B); a block of 8 warps
// takes `slots` consecutive slots of one (batch row, kv head), as many
// splits as `ops.plan` picks from B, Hkv, W and the SM count (never from
// pos: 32 splits of 256 slots, 256 blocks, at long_500k; one split at the
// serve shape, W 192). The block streams its slots' K and V rows, straight
// from the cache layout, through a ring of chunks in shared memory with
// 16-byte `cp.async` copies, so the loads in flight cost no registers and
// two blocks fit an SM: at long_500k all 256 blocks are resident with
// their whole 64 KB in flight. Logits are kept in base 2 (scaled by
// log2(e) / sqrt(hd) in f32), so p = exp2f(logit - m), with no division in
// the loop.
// - bf16 (`swa_bf16_kernel`, the serving path): the math is on the tensor
//   cores (`mma.sync` m16n8k16, f32 accumulate), 16 slots a warp a
//   128-slot chunk: S = Q K^T with the rep query rows in the A operand
//   (rows 0-7 for rep <= 8; rows 8-15 too, each lane keeping two rows'
//   softmax, for rep 9-16),
//   the online softmax on the accumulator fragments, then O += P V with P
//   split into a bf16 high and low part, so the PV product keeps ~16 bits
//   of the f32 probabilities. (On the SIMT cores, one slot row a group of
//   8 lanes, this math takes ~110 instructions a slot a lane, which bound
//   the kernel.)
// - f32 (`swa_f32_kernel`): SIMT, a group of min(hd / 4, 32) lanes a slot
//   row, each group with its own online softmax for the rep rows.
// At hd 256 (bf16), and where they would take more than 32 registers a
// lane (f32), the query rows are read from shared memory at each use: the
// f32 accumulators of 16 rows already take 128 registers a lane at hd 256.
// The warps' merge tables (up to 8 warps x 16 rows x (hd + 2) f32, 132 KB
// at hd 256) are laid over the K/V ring once the loop is done.
// The warps merge through shared memory. With one split the block writes
// the output; otherwise it writes its (m, l, acc) in f32 to scratch, a
// block with no valid slot (m = -1e30, l = 0, acc = 0) included, and takes
// an integer ticket; the last block of the (batch row, kv head) to finish
// combines the splits in split order (deterministic: no float atomics, and
// the order never depends on which block is last), giving an empty split
// weight 0, and resets the ticket.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SPLITS = 64;             // splits the combine takes

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// The combine, run by the last block of a (batch row, kv head) to finish:
// the splits' partials, read from L2 (__ldcg: other blocks wrote them), in
// split order; a split with l = 0 adds nothing. Warp w takes rows w and
// w + 8: its lanes walk the splits (lane, lane + 32, ..) for M = max m and
// L = sum l 2^(m - M), joined by butterfly shuffles (one fixed order); the
// weights 2^(m - M) pass through shared memory, and each thread sums its
// acc columns over the splits in split order, the loads batched.
template <typename T, int HD>
__device__ void combine_splits(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc, int b,
                               int h, int hkv, int rep, int splits,
                               T* __restrict__ out) {
  __shared__ float s_wt[2 * WARPS][MAX_SPLITS];   // [r][split]: 2^(m - M)
  __shared__ float s_lt[2 * WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t part0 = (static_cast<size_t>(b) * hkv + h) * splits;
  for (int r = warp; r < rep; r += WARPS) {
    float mx = NEG_INF;
    for (int sp = lane; sp < splits; sp += 32) {
      mx = fmaxf(mx, __ldcg(&part_ml[((part0 + sp) * rep + r) * 2]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    }
    float lsum = 0.f;
    for (int sp = lane; sp < splits; sp += 32) {
      const float* ml = &part_ml[((part0 + sp) * rep + r) * 2];
      const float wt = exp2f(__ldcg(ml) - mx);
      s_wt[r][sp] = wt;
      lsum = fmaf(__ldcg(ml + 1), wt, lsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lsum += __shfl_xor_sync(FULL, lsum, off);
    }
    if (lane == 0) s_lt[r] = lsum;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const float* acc = part_acc + (part0 * rep + r) * HD + d;
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      a = fmaf(__ldcg(&acc[static_cast<size_t>(sp) * rep * HD]), s_wt[r][sp],
               a);
    }
    store(out + ((static_cast<size_t>(b) * hkv + h) * rep + r) * HD + d,
          a / fmaxf(s_lt[r], 1e-30f));
  }
}

// The end of both kernels: each warp has left its (m, l) a row in
// s_ml[warp][row][2] and its acc in s_acc[warp][row][HD] (rows in ROWS
// slots, m in base 2). The warps merge in warp order; with one split the
// block writes out, otherwise its (m, l) to part_ml (b, hkv, splits, rep,
// 2) and its acc to part_acc (b, hkv, splits, rep, HD) in f32, and takes a
// ticket from tickets[b * hkv + h] (zero on entry, zero again on exit):
// the last block of the (batch row, kv head) combines the splits into out.
template <typename T, int HD, int ROWS>
__device__ void finish(const float* s_ml, const float* s_acc, int b, int h,
                       int hkv, int rep, T* __restrict__ out,
                       float* __restrict__ part_ml,
                       float* __restrict__ part_acc,
                       int* __restrict__ tickets) {
  const int splits = gridDim.x;
  const size_t part = (static_cast<size_t>(b) * hkv + h) * splits + blockIdx.x;
  for (int idx = threadIdx.x; idx < rep * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) mx = fmaxf(mx, s_ml[(ww * ROWS + r) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float sc = exp2f(s_ml[(ww * ROWS + r) * 2] - mx);   // 0: no slot
      lsum = fmaf(s_ml[(ww * ROWS + r) * 2 + 1], sc, lsum);
      a = fmaf(s_acc[(ww * ROWS + r) * HD + d], sc, a);
    }
    if (splits == 1) {
      store(out + ((static_cast<size_t>(b) * hkv + h) * rep + r) * HD + d,
            a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[(part * rep + r) * HD + d] = a;
      if (d == 0) {
        part_ml[(part * rep + r) * 2] = mx;
        part_ml[(part * rep + r) * 2 + 1] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // the last split of this (batch row, kv head) to finish combines them all
  __shared__ bool s_last;
  __threadfence();         // this block's partials are visible to the card
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&tickets[b * hkv + h], 1) == splits - 1;
  }
  __syncthreads();
  if (!s_last) return;
  combine_splits<T, HD>(part_ml, part_acc, b, h, hkv, rep, splits, out);
  if (threadIdx.x == 0) tickets[b * hkv + h] = 0;   // ready for the next call
}

// ------------------------------------------------------- f32: SIMT math

constexpr int CHUNK_BYTES = 16384;         // of K (and as much of V) a chunk
constexpr int STAGES = 3;                  // chunks in shared memory at once
constexpr int RING_BYTES = STAGES * 2 * CHUNK_BYTES;   // K and V: 96 KB

// floats a lane takes of a row: 4 (one 16-byte piece), or hd / 32 so that
// a row's group stays within one warp
template <int HD>
__host__ __device__ constexpr int f32_vec() {
  return HD > 128 ? HD / 32 : 4;
}

// the query rows live in shared memory when they would take more than 32
// registers a lane (rep 9-16, and hd 256 at rep 5-8), beside as many of
// accumulators
template <int HD, int MAX_REP>
__host__ __device__ constexpr bool f32_q_shared() {
  return f32_vec<HD>() * MAX_REP > 32;
}

// the dynamic shared memory of swa_f32_kernel: the K/V ring (and the
// query rows when they live there), or the warps' merge tables laid over
// them after the loop, whichever is larger
template <int HD, int MAX_REP>
__host__ __device__ constexpr int f32_smem_bytes() {
  constexpr int loop = RING_BYTES + (f32_q_shared<HD, MAX_REP>()
                                         ? MAX_REP * HD * 4 : 0);
  constexpr int tables = WARPS * MAX_REP * (HD + 2) * 4;
  return loop > tables ? loop : tables;
}

// grid (splits, hkv, b): split blockIdx.x of (batch row, kv head) takes the
// slots [split * slots, split * slots + slots) below nv. The slots' K and V
// rows stream through a ring of STAGES chunks in shared memory by cp.async
// (16-byte copies straight from the cache layout). A warp splits into
// groups of LPS = hd / VEC lanes; lane li of a group takes the VEC / 4
// 16-byte pieces li, li + LPS, .. of a slot's row (so a group's loads of a
// piece are contiguous); each group takes U slots of a chunk and keeps its
// own online softmax for the rep query rows in base 2 (q scaled by
// log2(e) / sqrt(hd) once).
template <int HD, int MAX_REP>
__global__ void __launch_bounds__(THREADS, MAX_REP >= 8 || HD > 128 ? 1 : 2)
swa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int32_t* __restrict__ pos,
               int w, int hkv, int rep, int slots, float* __restrict__ out,
               float* __restrict__ part_ml, float* __restrict__ part_acc,
               int* __restrict__ tickets) {
  constexpr int VEC = f32_vec<HD>();       // floats a lane takes of a row
  constexpr int NP = VEC / 4;              // its 16-byte pieces
  constexpr int LPS = HD / VEC;            // lanes per slot row (a group)
  constexpr int GPW = 32 / LPS;            // groups per warp
  constexpr int GROUPS = WARPS * GPW;
  constexpr int PIECES = HD / 4;           // 16-byte pieces of a row
  constexpr int CS = CHUNK_BYTES / (HD * static_cast<int>(sizeof(float)));
  constexpr int U = CS / GROUPS;           // slots a group takes a chunk
  constexpr bool QS = f32_q_shared<HD, MAX_REP>();
  static_assert(U * GROUPS == CS, "a chunk is whole slots of every group");
  static_assert(LPS <= 32 && LPS * VEC == HD, "a row's group is in a warp");

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_ring = reinterpret_cast<float*>(smem);   // [STAGES][CS][HD]
  float* v_ring = k_ring + STAGES * CS * HD;
  float* q_s = v_ring + STAGES * CS * HD;           // [MAX_REP][HD] if QS

  const int split = blockIdx.x;
  const int h = blockIdx.y;                // kv head
  const int b = blockIdx.z;                // batch row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % LPS;               // lane within its group
  const int g = warp * GPW + lane / LPS;   // group within the block
  const int heads = hkv * rep;
  const int nv = min(pos[b] + 1, w);       // valid slots: j < nv
  const int j0 = split * slots;
  const int jend = min(j0 + slots, nv);
  const int chunks = jend > j0 ? (jend - j0 + CS - 1) / CS : 0;
  const float scale = LOG2E * rsqrtf(static_cast<float>(HD));

  const size_t slot_stride = static_cast<size_t>(hkv) * HD;
  const size_t row0 = (static_cast<size_t>(b) * w * hkv + h) * HD;
  // chunk c (slots j0 + c CS ..) into ring stage c % STAGES, zeros past jend
  auto issue = [&](int c) {
    float* ks = k_ring + (c % STAGES) * CS * HD;
    float* vs = v_ring + (c % STAGES) * CS * HD;
    for (int e = threadIdx.x; e < CS * PIECES; e += THREADS) {
      const int sl = e / PIECES, part = (e % PIECES) * 4;
      const int j = j0 + c * CS + sl;
      const bool ok = j < jend;
      const size_t off = ok ? row0 + j * slot_stride + part : 0;
      cp_async16(ks + sl * HD + part, k + off, ok ? 16 : 0);
      cp_async16(vs + sl * HD + part, v + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }

  // the query rows, scaled (rows past rep zero): in registers, or in
  // shared memory (seen by every thread after the loop's first barrier)
  const float* qrow = q + (static_cast<size_t>(b) * heads + h * rep) * HD;
  float qf[QS ? 1 : MAX_REP][QS ? 1 : VEC];
  if constexpr (QS) {
    for (int e = threadIdx.x; e < MAX_REP * HD; e += THREADS) {
      q_s[e] = e / HD < rep ? qrow[e] * scale : 0.f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        const float4 x = r < rep ? *reinterpret_cast<const float4*>(
                                       qrow + r * HD + (pc * LPS + li) * 4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        qf[r][4 * pc] = x.x * scale;
        qf[r][4 * pc + 1] = x.y * scale;
        qf[r][4 * pc + 2] = x.z * scale;
        qf[r][4 * pc + 3] = x.w * scale;
      }
    }
  }
  float m[MAX_REP], l[MAX_REP], acc[MAX_REP][VEC];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c has landed; chunk c - 1's stage is free
    if (c + STAGES - 1 < chunks) issue(c + STAGES - 1);
    cp_async_commit();
    const float* ks = k_ring + (c % STAGES) * CS * HD + li * 4;
    const float* vs = v_ring + (c % STAGES) * CS * HD + li * 4;
    bool ok[U];
    float s[MAX_REP][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sl = u * GROUPS + g;
      ok[u] = j0 + c * CS + sl < jend;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) s[r][u] = 0.f;
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        const float4 kf =
            *reinterpret_cast<const float4*>(ks + sl * HD + pc * LPS * 4);
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          float4 qv;
          if constexpr (QS) {
            qv = *reinterpret_cast<const float4*>(
                q_s + r * HD + (pc * LPS + li) * 4);
          } else {
            qv = make_float4(qf[r][4 * pc], qf[r][4 * pc + 1],
                             qf[r][4 * pc + 2], qf[r][4 * pc + 3]);
          }
          s[r][u] = fmaf(qv.w, kf.w, fmaf(qv.z, kf.z,
                    fmaf(qv.y, kf.y, fmaf(qv.x, kf.x, s[r][u]))));
        }
      }
    }
    // every row up to MAX_REP, so the rows' dependent chains interleave;
    // rows past rep have q = 0 and are never written
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1) {
          s[r][u] += __shfl_xor_sync(FULL, s[r][u], off);
        }
      }
      float mt = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) mt = fmaxf(mt, s[r][u]);
      }
      const float mn = fmaxf(m[r], mt);
      const float alpha = exp2f(m[r] - mn);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[r][u] = ok[u] ? exp2f(s[r][u] - mn) : 0.f;   // now p
        l[r] += s[r][u];
      }
      m[r] = mn;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        const float4 vf = *reinterpret_cast<const float4*>(
            vs + (u * GROUPS + g) * HD + pc * LPS * 4);
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          acc[r][4 * pc] = fmaf(s[r][u], vf.x, acc[r][4 * pc]);
          acc[r][4 * pc + 1] = fmaf(s[r][u], vf.y, acc[r][4 * pc + 1]);
          acc[r][4 * pc + 2] = fmaf(s[r][u], vf.z, acc[r][4 * pc + 2]);
          acc[r][4 * pc + 3] = fmaf(s[r][u], vf.w, acc[r][4 * pc + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // merge the groups of each warp (shuffles) into the merge tables, laid
  // over the ring (and query rows) once every warp is done with them; the
  // warps merge in finish
  __syncthreads();
  float* s_ml = reinterpret_cast<float*>(smem);     // [WARPS][MAX_REP][2]
  float* s_acc = s_ml + WARPS * MAX_REP * 2;        // [WARPS][MAX_REP][HD]
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    float mw = m[r];
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) {
      mw = fmaxf(mw, __shfl_xor_sync(FULL, mw, off));
    }
    const float sc = exp2f(m[r] - mw);     // 0 for a group that saw no slot
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
      if (lane < LPS) {
        s_acc[(warp * MAX_REP + r) * HD + ((e / 4) * LPS + li) * 4 + e % 4] =
            a;
      }
    }
    if (lane == 0) {
      s_ml[(warp * MAX_REP + r) * 2] = mw;
      s_ml[(warp * MAX_REP + r) * 2 + 1] = lw;
    }
  }
  __syncthreads();
  finish<float, HD, MAX_REP>(s_ml, s_acc, b, h, hkv, rep, out, part_ml,
                             part_acc, tickets);
}

// ------------------------------------------------ bf16: tensor-core math

// d += a b on the tensor cores: m16n8k16, bf16 operands, f32 accumulators;
// A's rows 0-7 in a0 (k 0-7) and a2 (k 8-15), rows 8-15 in a1 and a3
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two values as a bf16 pair, the first in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// what the low bf16 pair of (lo, hi) leaves over its high pair `high`
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi,
                                              uint32_t high) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&high);
  return pack_bf16(lo - __low2float(h), hi - __high2float(h));
}

// 128-slot chunks in flight: two, or one at hd 256, whose two K and V
// chunks (264 KB) would not fit in a block's 227 KB
template <int HD>
constexpr int MMA_STAGES_OF = HD > 128 ? 1 : 2;

template <int HD>   // K and V rings of bf16 rows padded to HD + 8
constexpr int MMA_RING_BYTES =
    MMA_STAGES_OF<HD> * 2 * WARPS * 16 * (HD + 8) * 2;

// the dynamic shared memory of swa_bf16_kernel: the ring, and at hd 256
// the MR query rows (padded as the ring's) after it
template <int HD, int MR>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return MMA_RING_BYTES<HD> + (HD > 128 ? MR * (HD + 8) * 2 : 0);
}

// grid (splits, hkv, b), as swa_f32_kernel. A chunk is 128 slots, 16 a
// warp; its K and V rows land by cp.async in shared memory rows padded to
// HD + 8 elements (so the fragment reads below are free of bank
// conflicts). Per chunk a warp takes its 16 slots on the tensor cores
// (m16n8k16, bf16 in, f32 accumulate): S = Q K^T with query rows 0-7 in
// rows 0-7 of the A operand and, for MR = 16 (rep 9-16), rows 8-15 in
// rows 8-15 (else zero), and K read as B fragments straight from its
// rows; the logits are scaled in f32 and an online softmax in base 2 runs
// on the accumulator fragments (a lane holds rows lane / 4 and lane / 4 +
// 8, so a row's max and sum take two quad shuffles); then O += P V with P
// split in a bf16 high and low part (two MMAs, so the product keeps ~16
// bits of the f32 probabilities) and V read by ldmatrix.trans. At hd 256
// one chunk is in shared memory at a time (its loads wait for the math of
// the chunk before). The Q
// fragments stay in registers, or at hd 256 (where O alone takes 128
// registers a lane at MR 16) are read from shared memory at each use.
template <int HD, int MR>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
swa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int32_t* __restrict__ pos, int w, int hkv, int rep,
                int slots, __nv_bfloat16* __restrict__ out,
                float* __restrict__ part_ml, float* __restrict__ part_acc,
                int* __restrict__ tickets) {
  constexpr int MMA_STAGES = MMA_STAGES_OF<HD>;
  constexpr int RS = HD + 8;               // padded shared row, elements
  constexpr int CS = WARPS * 16;           // slots a chunk
  constexpr int PIECES = HD / 8;           // 16-byte pieces of a row
  constexpr int KT = HD / 16;              // k-steps of Q K^T
  constexpr int NT = HD / 8;               // 8-wide column tiles of O
  constexpr bool TWO = MR > 8;             // query rows 8-15 in the A tile
  constexpr bool QS = HD > 128;            // Q fragments in shared memory
  static_assert(MR == 8 || MR == 16, "8 or 16 rows of the A tile");
  static_assert(WARPS * MR * (HD + 2) * 4 <= MMA_RING_BYTES<HD>,
                "the merge tables fit in the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_ring = k_ring + MMA_STAGES * CS * RS;
  __nv_bfloat16* q_s = v_ring + MMA_STAGES * CS * RS;   // [MR][RS] if QS

  const int split = blockIdx.x;
  const int h = blockIdx.y;                // kv head
  const int b = blockIdx.z;                // batch row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;                // fragment row: the query row
  const int gc = lane & 3;                 // fragment column pair
  const int nv = min(pos[b] + 1, w);       // valid slots: j < nv
  const int j0 = split * slots;
  const int jend = min(j0 + slots, nv);
  const int chunks = jend > j0 ? (jend - j0 + CS - 1) / CS : 0;
  const float scale = LOG2E * rsqrtf(static_cast<float>(HD));

  const size_t slot_stride = static_cast<size_t>(hkv) * HD;
  const size_t row0 = (static_cast<size_t>(b) * w * hkv + h) * HD;
  auto issue = [&](int c) {
    __nv_bfloat16* ks = k_ring + (c % MMA_STAGES) * CS * RS;
    __nv_bfloat16* vs = v_ring + (c % MMA_STAGES) * CS * RS;
    for (int e = threadIdx.x; e < CS * PIECES; e += THREADS) {
      const int sl = e / PIECES, part = (e % PIECES) * 8;
      const int j = j0 + c * CS + sl;
      const bool ok = j < jend;
      const size_t off = ok ? row0 + j * slot_stride + part : 0;
      cp_async16(ks + sl * RS + part, k + off, ok ? 16 : 0);
      cp_async16(vs + sl * RS + part, v + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int c = 0; c < MMA_STAGES; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }

  // Q as A fragments: rows gr and gr + 8 (zero past rep), columns
  // 16 t + 2 gc (+1) and 16 t + 8 + 2 gc (+1); at hd 256 the rows go to
  // shared memory (seen by every thread after the loop's first barrier)
  const __nv_bfloat16* qrows =
      q + (static_cast<size_t>(b) * hkv + h) * rep * HD;
  uint32_t qa[QS ? 1 : KT][4];
  if constexpr (QS) {
    for (int e = threadIdx.x; e < MR * PIECES; e += THREADS) {
      const int r = e / PIECES, part = (e % PIECES) * 8;
      *reinterpret_cast<uint4*>(q_s + r * RS + part) =
          r < rep ? *reinterpret_cast<const uint4*>(qrows + r * HD + part)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const __nv_bfloat16* qa0 = qrows + gr * HD + 16 * t + 2 * gc;
      const __nv_bfloat16* qa1 = qa0 + 8 * HD;
      qa[t][0] = gr < rep ? load32(qa0) : 0u;
      qa[t][2] = gr < rep ? load32(qa0 + 8) : 0u;
      qa[t][1] = TWO && gr + 8 < rep ? load32(qa1) : 0u;
      qa[t][3] = TWO && gr + 8 < rep ? load32(qa1 + 8) : 0u;
    }
  }
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  // rows gr and gr + 8; l over this lane's slots
  float m = NEG_INF, l = 0.f, m8 = NEG_INF, l8 = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<MMA_STAGES - 1>();
    __syncthreads();                       // chunk c has landed
    const __nv_bfloat16* ks = k_ring + (c % MMA_STAGES) * CS * RS + warp * 16 * RS;
    const __nv_bfloat16* vs = v_ring + (c % MMA_STAGES) * CS * RS + warp * 16 * RS;
    // S for slots 8 nt + 2 gc (+1) of this warp's 16
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* krow = ks + (8 * nt + gr) * RS + 2 * gc;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        uint32_t a0, a1, a2, a3;
        if constexpr (QS) {
          const __nv_bfloat16* qp = q_s + gr * RS + 16 * t + 2 * gc;
          a0 = load32(qp);
          a2 = load32(qp + 8);
          a1 = TWO ? load32(qp + 8 * RS) : 0u;
          a3 = TWO ? load32(qp + 8 * RS + 8) : 0u;
        } else {
          a0 = qa[t][0];
          a1 = qa[t][1];
          a2 = qa[t][2];
          a3 = qa[t][3];
        }
        mma_bf16(sc[nt], a0, a1, a2, a3, load32(krow + 16 * t),
                 load32(krow + 16 * t + 8));
      }
    }
    // p[e] of row gr and p8[e] of row gr + 8, for slot jw + 8 (e >> 1) +
    // (e & 1)
    const int jw = j0 + c * CS + warp * 16 + 2 * gc;
    float p[4], p8[4];
    float mt = NEG_INF, mt8 = NEG_INF;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = sc[e >> 1][e & 1] * scale;
      p8[e] = sc[e >> 1][2 + (e & 1)] * scale;
      if (jw + 8 * (e >> 1) + (e & 1) < jend) {
        mt = fmaxf(mt, p[e]);
        mt8 = fmaxf(mt8, p8[e]);
      }
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float mn = fmaxf(m, mt);
    const float alpha = exp2f(m - mn);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = jw + 8 * (e >> 1) + (e & 1) < jend ? exp2f(p[e] - mn) : 0.f;
      l += p[e];
    }
    m = mn;
    float alpha8 = 1.f;
    if constexpr (TWO) {
      mt8 = fmaxf(mt8, __shfl_xor_sync(FULL, mt8, 1));
      mt8 = fmaxf(mt8, __shfl_xor_sync(FULL, mt8, 2));
      const float mn8 = fmaxf(m8, mt8);
      alpha8 = exp2f(m8 - mn8);
      l8 *= alpha8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p8[e] = jw + 8 * (e >> 1) + (e & 1) < jend ? exp2f(p8[e] - mn8) : 0.f;
        l8 += p8[e];
      }
      m8 = mn8;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= alpha;
      o[nt][1] *= alpha;
      if constexpr (TWO) {
        o[nt][2] *= alpha8;
        o[nt][3] *= alpha8;
      }
    }
    // P as A fragments, a high and a low bf16 part
    const uint32_t ph0 = pack_bf16(p[0], p[1]), ph2 = pack_bf16(p[2], p[3]);
    const uint32_t pl0 = pack_rest(p[0], p[1], ph0);
    const uint32_t pl2 = pack_rest(p[2], p[3], ph2);
    uint32_t ph1 = 0u, ph3 = 0u, pl1 = 0u, pl3 = 0u;
    if constexpr (TWO) {
      ph1 = pack_bf16(p8[0], p8[1]);
      ph3 = pack_bf16(p8[2], p8[3]);
      pl1 = pack_rest(p8[0], p8[1], ph1);
      pl3 = pack_rest(p8[2], p8[3], ph3);
    }
    // V as B fragments: 16 slots x 16 columns a ldmatrix.x4.trans
    const __nv_bfloat16* vrow =
        vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + (lane >> 4) * 8;
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + 16 * n2);
      mma_bf16(o[2 * n2], ph0, ph1, ph2, ph3, vb[0], vb[1]);
      mma_bf16(o[2 * n2], pl0, pl1, pl2, pl3, vb[0], vb[1]);
      mma_bf16(o[2 * n2 + 1], ph0, ph1, ph2, ph3, vb[2], vb[3]);
      mma_bf16(o[2 * n2 + 1], pl0, pl1, pl2, pl3, vb[2], vb[3]);
    }
    __syncthreads();                       // this stage is refilled next
    if (c + MMA_STAGES < chunks) issue(c + MMA_STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  if constexpr (TWO) {
    l8 += __shfl_xor_sync(FULL, l8, 1);
    l8 += __shfl_xor_sync(FULL, l8, 2);
  }

  // this warp's rows into the merge tables, over the (now idle) ring
  __syncthreads();
  float* s_ml = reinterpret_cast<float*>(smem);     // [WARPS][MR][2]
  float* s_acc = s_ml + WARPS * MR * 2;             // [WARPS][MR][HD]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s_acc[(warp * MR + gr) * HD + 8 * nt + 2 * gc] = o[nt][0];
    s_acc[(warp * MR + gr) * HD + 8 * nt + 2 * gc + 1] = o[nt][1];
    if constexpr (TWO) {
      s_acc[(warp * MR + gr + 8) * HD + 8 * nt + 2 * gc] = o[nt][2];
      s_acc[(warp * MR + gr + 8) * HD + 8 * nt + 2 * gc + 1] = o[nt][3];
    }
  }
  if (gc == 0) {
    s_ml[(warp * MR + gr) * 2] = m;
    s_ml[(warp * MR + gr) * 2 + 1] = l;
    if constexpr (TWO) {
      s_ml[(warp * MR + gr + 8) * 2] = m8;
      s_ml[(warp * MR + gr + 8) * 2 + 1] = l8;
    }
  }
  __syncthreads();
  finish<__nv_bfloat16, HD, MR>(s_ml, s_acc, b, h, hkv, rep, out, part_ml,
                                part_acc, tickets);
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  // above 48 KB a block's shared memory must be asked for (per card)
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HD, int MAX_REP>
int launch_f32(const void* q, const void* k, const void* v, const void* pos,
               int b, int hkv, int w, int rep, int splits, int slots,
               void* out, void* ml, void* acc, void* tk, cudaStream_t st) {
  constexpr int bytes = f32_smem_bytes<HD, MAX_REP>();
  const cudaError_t err = opt_in(swa_f32_kernel<HD, MAX_REP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_f32_kernel<HD, MAX_REP><<<dim3(splits, hkv, b), THREADS, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(pos), w, hkv,
      rep, slots, static_cast<float*>(out), static_cast<float*>(ml),
      static_cast<float*>(acc), static_cast<int*>(tk));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32_rep(const void* q, const void* k, const void* v,
                   const void* pos, int b, int hkv, int w, int rep,
                   int splits, int slots, void* out, void* ml, void* acc,
                   void* tk, cudaStream_t s) {
  if (rep <= 1) return launch_f32<HD, 1>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, ml, acc, tk, s);
  if (rep <= 2) return launch_f32<HD, 2>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, ml, acc, tk, s);
  if (rep <= 4) return launch_f32<HD, 4>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, ml, acc, tk, s);
  if (rep <= 8) return launch_f32<HD, 8>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, ml, acc, tk, s);
  return launch_f32<HD, 16>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, ml, acc, tk, s);
}

template <int HD, int MR>
int launch_bf16(const void* q, const void* k, const void* v, const void* pos,
                int b, int hkv, int w, int rep, int splits, int slots,
                void* out, void* ml, void* acc, void* tk, cudaStream_t st) {
  constexpr int bytes = bf16_smem_bytes<HD, MR>();
  const cudaError_t err = opt_in(swa_bf16_kernel<HD, MR>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bf16_kernel<HD, MR><<<dim3(splits, hkv, b), THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(pos),
      w, hkv, rep, slots, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ml), static_cast<float*>(acc), static_cast<int*>(tk));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16_rep(const void* q, const void* k, const void* v,
                    const void* pos, int b, int hkv, int w, int rep,
                    int splits, int slots, void* out, void* ml, void* acc,
                    void* tk, cudaStream_t s) {
  if (rep <= 8) return launch_bf16<HD, 8>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, ml, acc, tk, s);
  return launch_bf16<HD, 16>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, ml, acc, tk, s);
}

}  // namespace

// q (b, hkv * rep, hd), k and v (b, w, hkv, hd), all of one type (bf16 when
// `bf16`, else f32), pos (b,) int32, out like q; hd 32, 64, 128 or 256
// (32: the MoE configs' smoke widths; 256: recurrentgemma-2b), rep 1..16;
// splits x slots >= w as `ops.plan` gives them; with splits > 1, part_ml
// (b, hkv, splits, rep, 2) and part_acc (b, hkv, splits, rep, hd) f32
// scratch, and tickets (b * hkv,) int32, zero before the call and left so
// (all three unused, may be NULL, with one split)
extern "C" int repro_swa_decode(const void* q, const void* k, const void* v,
                                const void* pos, int b, int hkv, int w,
                                int rep, int hd, int bf16, int splits,
                                int slots, void* part_ml, void* part_acc,
                                void* tickets, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || hkv < 1 || hkv > 65535 || w < 1 || rep < 1 ||
      rep > 16 || (hd != 32 && hd != 64 && hd != 128 && hd != 256) ||
      splits < 1 || slots < 1 ||
      static_cast<int64_t>(splits) * slots < w || splits > MAX_SPLITS ||
      (splits > 1 && (part_ml == nullptr || part_acc == nullptr ||
                      tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    if (hd == 32) return launch_bf16_rep<32>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
    if (hd == 64) return launch_bf16_rep<64>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
    if (hd == 128) return launch_bf16_rep<128>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
    return launch_bf16_rep<256>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
  }
  if (hd == 32) return launch_f32_rep<32>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
  if (hd == 64) return launch_f32_rep<64>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
  if (hd == 128) return launch_f32_rep<128>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
  return launch_f32_rep<256>(q, k, v, pos, b, hkv, w, rep, splits, slots, out, part_ml, part_acc, tickets, s);
}
