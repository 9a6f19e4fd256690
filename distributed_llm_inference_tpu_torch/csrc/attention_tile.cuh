// Tile building blocks shared by the prefill attention kernels for Hopper
// (sm_90a): the bf16 tensor-core product (mma.sync m16n8k16 with f32
// accumulation), its operand loads, and 16-byte row staging into shared
// memory. Used by ragged_attention.cu (the ragged paged kernels) and
// flash_attention.cu (flash attention over contiguous K/V).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

// D = A (16x16, row) * B (16x8, col) + D, bf16 inputs, f32 accumulation.
// Lane (g = lane / 4, t = lane % 4) holds: a[0] = A[g][2t..2t+1],
// a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..];
// b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; c[0..1] = C[g][2t..2t+1],
// c[2..3] = C[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices from shared memory, transposed on the way: lanes
// 0-7 name the rows of the first, lanes 8-15 of the second (16 bytes each).
// Lane (g, t) receives M[2t..2t+1][g] of each: the B operand of mma_bf16
// for a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One row of D bf16 from global to shared memory in 16-byte chunks; a null
// source stores zeros.
__device__ __forceinline__ void stage_chunk16(__nv_bfloat16* dst_row,
                                              const __nv_bfloat16* src_row,
                                              int chunk) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src_row != nullptr)
    v = *reinterpret_cast<const uint4*>(src_row + chunk * 8);
  *reinterpret_cast<uint4*>(dst_row + chunk * 8) = v;
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
