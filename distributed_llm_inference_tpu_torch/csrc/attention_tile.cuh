// Small building blocks shared by the prefill attention kernels: packing
// two floats into a bf16 pair, and staging a 16-byte chunk of an f32 row
// into shared memory (the f32 instances). Used by ragged_attention.cu (the
// ragged paged kernels) and flash_attention.cu (flash attention over
// contiguous K/V).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

// log2 of G query heads a kv head rounded up to a power of two: the bf16
// kernels give a query 1 << group_shift(G) score rows
// (ops/attention.py:rows_per_query).
inline int group_shift(int G) {
  int s = 0;
  while ((1 << s) < G) ++s;
  return s;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy one 16-byte chunk of a row from global to shared memory (the shared
// row stride is odd, so the store is four single floats); a null source
// stores zeros.
__device__ __forceinline__ void stage_chunk(float* dst_row,
                                            const float* src_row, int chunk) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (src_row != nullptr)
    v = *reinterpret_cast<const float4*>(src_row + chunk * 4);
  float* d = dst_row + chunk * 4;
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

}  // namespace tile
