// Device helpers shared by the kernels that search for a best-matching
// unit (bmu.cu, fused.cu).
#pragma once

#include <cuda_bf16.h>

namespace repro {

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

}  // namespace repro
