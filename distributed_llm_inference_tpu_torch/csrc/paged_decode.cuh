// Decode attention over bf16 or int8 K/V for Hopper (sm_90a), bf16 queries:
// the device code of `paged_attention`'s bf16 instance and of the bf16-query
// instances of `quantized_paged_attention` (both csrc/paged_attention.cu)
// and `quantized_decode_attention` (csrc/quant_attention.cu).
//
// Replaces three TPU kernels for bf16 queries: `_paged_kernel` and
// `_qpaged_kernel` (distributed_llm_inference_tpu/ops/paged_attention.py)
// and `_qdense_kernel` (distributed_llm_inference_tpu/ops/quant_attention.py).
// One query token a row attends over the row's live positions [lo, hi)
// (hi = min(kv_len, cap), lo from the sliding window, anchored at
// q_positions); the kernel writes the output and, where asked, the softmax
// stats m (the max of the scaled scores) and l (the sum of exp(s - m)).
// Where the rows come from is a row map, a template parameter: PageRows
// reads a page pool [P, Hkv, PS, D] in place through the page table (#2 in
// bf16, #5 in int8), DenseRows the int8 dense cache's head-major buffer
// [B, Hkv, T, D] (#8). Over int8 the f32 scales of each (position, kv head)
// sit in planes indexed like the rows; the K scale multiplies the score,
// s = (q . k) * ks * scale, and the V scale the probability before P V,
// acc += (p * vs) v, while l sums p, as the TPU kernels do. They keep
// p * vs in f32; here it goes into P V as two bf16 terms, hi = bf16(p * vs)
// and lo = bf16(p * vs - hi), two products on the same V fragment, which
// hold it to about 2^-17 (hi alone rounds a term by up to 2^-9, which put
// most outputs a bf16 step from the plain version's, a step that at
// |out| >= 4 is past the 2e-2 tolerance). The f32 instances stay on
// decode_attention.cuh's walk (the engine's exact-parity runs are the only
// f32 callers).
//
// What bounds it on this card: bytes. Every live K and V byte is read once
// for 4 * G flops a value, far below the ~295 flop/byte where the tensor
// cores would matter. What each choice does about it:
//
// * One launch, no scratch. A thread-block cluster of C blocks serves one
//   (row, kv head). The row's live positions, in steps of kStep = 64
//   aligned on 64, are dealt to the C blocks in turn at run time, so the
//   split follows the live length, not the table width; C (1..8) is
//   chosen by the caller from the batch (ops/paged_attention.py:
//   cluster_size). The blocks merge their (m, l, acc) through distributed
//   shared memory behind cluster barriers, as the fused step does
//   (fused_decode.cuh): no partials in device memory, no second kernel.
// * Copies in flight. A producer warp brings each step's K and V by TMA
//   (cp.async.bulk.tensor.2d over the rows [rows, D], the 128-byte swizzle:
//   D / 64 boxes of 64 columns a bf16 row, one box of D an int8 row; an
//   int8 row of D = 64 is staged unswizzled, 64 bytes) into a ring of
//   stages against full / empty mbarriers, about 96 KB a block in flight
//   while the consumers work (at D = 128, 3 stages of 32 KB in bf16, 6 of
//   16 KB in int8; twice as many of half the size at D = 64). A box has
//   gcd(PS, 64) rows over pages, so it never crosses a
//   page and any page size works, and 64 rows over the dense buffer, where
//   a box may run into the next (row, head)'s rows (masked) or past the
//   buffer's end (the map's extent: zeros). A box with no live position is
//   asked for at a negative row, which the TMA fills with zeros and still
//   counts. The producer's lanes resolve 32 boxes' rows at once, so the
//   table's reads do not stand one after another in front of the copies.
//   Over int8 the same lanes bring each box's scales by cp.async, 4 bytes a
//   row, onto the stage's full barrier (a TMA box of scales would need 4
//   rows at least; a page of fewer has nothing to give it).
// * Softmax by tile, products on the tensor cores. Each of 4 consumer warps
//   takes 16 positions of a step and keeps its own running (m, l, acc). The
//   scores are one mma.sync m16n8k16 product, S^T = Q K^T, with the G <= 8
//   query heads as the rows (padded to 16: rows g >= G are zeros, computed
//   and never stored, so G is a run-time argument) and the positions as the
//   columns; its
//   accumulator fragment is, lane for lane, the B operand of P V (acc^T =
//   V^T P^T), so p never leaves the registers. A warp takes one max a head
//   over its 16 positions (two shuffles), rescales its accumulators once
//   for them, and only when a max moved; l sums p in f32.
// * bf16 K and V come from the swizzled stage by ldmatrix (V^T by
//   ldmatrix.trans). int8 has no ldmatrix.trans, so each lane reads the
//   bytes of its own fragments (16-byte loads, no bank conflicts under the
//   swizzle) and converts them in registers, exactly and with no conversion
//   instruction (the byte in the mantissa of 2^23, the bias subtracted:
//   hopper::i8x4_to_bf16x2), 2.75 instructions a value. K: a lane's 32-bit
//   word holds 4 values of D of its position, its (b0, b1) pair; which word
//   feeds which k-step is a permutation of D, and q's fragment is loaded
//   under the same one (a dot product does not care about the order of D).
//   V^T: a lane's A fragment pairs two positions of one column of D; the
//   lane reads its 4 positions' D / 8 bytes of D and pairs bytes of two
//   positions by prmt, so the columns of acc^T are a permutation of D,
//   undone when the accumulators are written out.
// * The warps' and the block's states are merged in shared memory over the
//   drained ring, so a block's shared memory does not grow with G.
//
// Built for head_dim 64 and 128 (a template argument) with 1 to 8 query
// heads per kv head (a run-time argument).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace pdec {

constexpr int kMaxG = 8;                        // query heads an m-tile holds
constexpr int kWarps = 4;                       // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;     // and the producer warp
constexpr int kStep = 64;                       // positions a ring stage
constexpr int kWarpRows = kStep / kWarps;       // positions a warp a stage
constexpr int kHalf = kStep * 128;              // 64 rows of 128 bytes
constexpr int kMaxCluster = 8;
constexpr int kBlocksPerSM = 2;
// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// Stages of the int8 ring at D = 128 (twice as many at D = 64). 6 (96 KB)
// is the most that keeps 2 blocks an SM; tools/torch_cluster_sweep.py
// rebuilds with other counts to time them.
#ifndef PDEC_INT8_STAGES
#define PDEC_INT8_STAGES 6
#endif

// The ring for K/V of type KV (bf16 or int8) and head_dim D: a stage holds
// a step's K, then its V. A bf16 plane is D / 64 swizzled halves of 64 rows
// x 128 bytes, an int8 one of D = 128 one such half; an int8 plane of
// D = 64 is 64 rows of 64 bytes, unswizzled. int8 adds the step's K and V
// scales, f32, in a region of their own.
template <class KV, int D>
struct Ring {
  static constexpr bool kInt8 = sizeof(KV) == 1;
  static constexpr bool kSwizzled = !kInt8 || D == 128;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kBoxes = kInt8 ? 1 : D / 64;  // TMA boxes a row
  static constexpr int kBoxCols = kInt8 ? D : 64;
  static constexpr int kPlane = kStep * kRowBytes;
  static constexpr int kStageBytes = 2 * kPlane;
  static constexpr int kStages =
      (kInt8 ? PDEC_INT8_STAGES : 3) * 128 / D;
  static constexpr int kScaleBytes = kInt8 ? kStages * 2 * kStep * 4 : 0;
  // Address of the 16-byte chunk `chunk` of row `row` of a staged plane.
  static __device__ __forceinline__ uint32_t at(uint32_t base, int row,
                                                int chunk) {
    if constexpr (kSwizzled)
      return base + (chunk >> 3) * kHalf + row * 128 +
             (((chunk & 7) ^ (row & 7)) << 4);
    else
      return base + row * kRowBytes + chunk * 16;
  }
};

// Shared memory of a block, from a 1024-aligned base (the swizzle repeats
// every 1024 bytes): the ring, the scales (int8), the barriers (full,
// empty). Once the ring is drained, its first bytes take each warp's
// (acc [G][D], m [G], l [G]) and the block's, for G <= kMaxG.
template <class KV, int D>
struct Smem {
  using R = Ring<KV, D>;
  static constexpr int kScales = R::kStages * R::kStageBytes;
  static constexpr int kBars = kScales + R::kScaleBytes;
  static constexpr int kBytes = kBars + 2 * R::kStages * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static constexpr int kWarpAcc = 0;
  static constexpr int kWarpML = kWarpAcc + kWarps * kMaxG * D * 4;
  static constexpr int kBlockAcc = kWarpML + kWarps * 2 * kMaxG * 4;
  static constexpr int kBlockML = kBlockAcc + kMaxG * D * 4;
  static_assert(kBlockML + 2 * kMaxG * 4 <= kScales, "merge over the ring");
};

// Row of the tensor map (and of the scale planes) that holds position `pos`
// of (row b, kv head h): the page pool [P, Hkv, PS, D] as rows, through the
// row's page table. The wrapper checks that every row a table can name lies
// below 2^31, which stands in for the map's extent.
struct PageRows {
  const int* table;  // [B, Tw]
  int Tw, PS, Hkv;
  __device__ __forceinline__ int row(int b, int h, int pos) const {
    return (table[(size_t)b * Tw + pos / PS] * Hkv + h) * PS + pos % PS;
  }
  __host__ __device__ long long extent() const { return 1ll << 31; }
};

// The same over the dense cache's contiguous [B, Hkv, T, D] buffer: one run
// of B * Hkv * T rows (below 2^31, the wrapper checks), the map's extent.
struct DenseRows {
  int T, Hkv, total;
  __device__ __forceinline__ int row(int b, int h, int pos) const {
    return (b * Hkv + h) * T + pos;
  }
  __host__ __device__ long long extent() const { return total; }
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes of shared memory at `addr` as four words.
__device__ __forceinline__ void lds_128(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 8 bytes of shared memory at `addr` as two words (the other two zero).
__device__ __forceinline__ void lds_64(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
  r[2] = r[3] = 0u;
}

// c += A B, m16n8k16, bf16 in, f32 accumulators (the mma.sync fragments:
// a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 =
// A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g]; c0, c1 = C[g][2t..],
// c2, c3 = C[g+8][2t..], g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte j of `u` (an int8 word biased by 0x80808080) as an exact f32, and
// the bf16 pair (lo, hi) of two such values, low half first (their top 16
// bits: the values are integers of at most 8 significant bits).
__device__ __forceinline__ float biased_byte(uint32_t u, int j) {
  return __uint_as_float(hopper::prmt(u, 0x4B000000u, 0x7650 + j)) -
         8388736.f;
}

__device__ __forceinline__ uint32_t pair_bf16(float lo, float hi) {
  return hopper::prmt(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <int D, class KV, class Rows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) paged_decode_kernel(
    const __grid_constant__ CUtensorMap k_map,  // rows [extent, D] of KV
    const __grid_constant__ CUtensorMap v_map,
    const __nv_bfloat16* __restrict__ q,        // [B, Hkv*G, D]
    Rows rows,
    const float* __restrict__ ks,               // int8: scales at the rows
    const float* __restrict__ vs,
    const int* __restrict__ kv_lens,            // [B]
    const int* __restrict__ q_pos,              // [B]
    __nv_bfloat16* __restrict__ out,            // [B, Hkv*G, D]
    float* __restrict__ m_out,                  // [B, Hkv, G], or null
    float* __restrict__ l_out,                  // [B, Hkv, G], or null
    int G, int cap, int box_rows, float scale, int window) {
  static_assert(D == 64 || D == 128, "the instances this kernel is built for");
  using R = Ring<KV, D>;
  using S = Smem<KV, D>;
  constexpr bool kInt8 = R::kInt8;
  constexpr int kStages = R::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  // [kStages][2][kStep]: a stage's K scales, then its V scales.
  float* scl = reinterpret_cast<float*>(smem + S::kScales);
  const int C = gridDim.x;
  const int r = hopper::cluster_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hkv = gridDim.y;
  const int tid = threadIdx.x;
  // Broadcast so that the compiler sees it warp-uniform.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;

  // The row's live positions [lo, hi), in steps of kStep from `first`;
  // block r takes steps r, r + C, ...
  const int hi = min(kv_lens[b], cap);
  const int lo = window > 0 ? max(0, q_pos[b] - window + 1) : 0;
  const int first = (lo / kStep) * kStep;
  const int nsteps = hi > lo ? (hi - first + kStep - 1) / kStep : 0;
  const int mine = nsteps > r ? (nsteps - r + C - 1) / C : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // int8: the TMA's bytes, and each producer lane's scale copies.
      hopper::mbar_init(&full[s], kInt8 ? 1 + 32 : 1);
      hopper::mbar_init(&empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  float* wacc = reinterpret_cast<float*>(smem + S::kWarpAcc);  // [kWarps][G][D]
  float* wml = reinterpret_cast<float*>(smem + S::kWarpML);    // [kWarps][2][G]
  // This consumer warp's running state, out of its loop: m and l of head g
  // (the same on the 4 lanes of a quad; l a partial sum a lane), acc^T
  // [D x 8 heads] as D / 16 m-tiles of 16 rows of D.
  const int g = lane >> 2, t = lane & 3;
  float m_run = kNegInf, l_run = 0.f;
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mt][c] = 0.f;
  if (warp == kWarps) {
    // The producer. The lanes resolve the rows of the block's next 32
    // boxes together (one table read each, in flight at once), then lane 0
    // issues them in order, each step's boxes into its stage; over int8
    // every lane then copies a share of the box's scales.
    const int per_step = kStep / box_rows;
    const int boxes = mine * per_step;
    for (int base = 0; base < boxes; base += 32) {
      int my_row = -box_rows;  // no live position: zeros
      if (base + lane < boxes) {
        const int i = (base + lane) / per_step;
        const int pos =
            first + (r + i * C) * kStep + (base + lane) % per_step * box_rows;
        if (pos < hi && pos + box_rows > lo) my_row = rows.row(b, h, pos);
      }
      const int n = min(32, boxes - base);
      for (int j = 0; j < n; ++j) {
        const int row = __shfl_sync(0xffffffffu, my_row, j);
        const int i = (base + j) / per_step;
        const int r0 = (base + j) % per_step * box_rows;
        const int s = i % kStages;
        if (r0 == 0) {
          if (kInt8 || lane == 0)
            hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
          if (lane == 0) hopper::mbar_arrive_expect_tx(&full[s], R::kStageBytes);
        }
        if (lane == 0) {
          uint8_t* st = smem + s * R::kStageBytes +
                        r0 * (R::kSwizzled ? 128 : R::kRowBytes);
#pragma unroll
          for (int c = 0; c < R::kBoxes; ++c) {
            hopper::tma_load_2d(st + c * kHalf, &k_map, &full[s],
                                c * R::kBoxCols, row);
            hopper::tma_load_2d(st + R::kPlane + c * kHalf, &v_map, &full[s],
                                c * R::kBoxCols, row);
          }
        }
        if constexpr (kInt8) {
          float* sc = scl + s * 2 * kStep + r0;
          for (int e = lane; e < box_rows; e += 32) {
            const long long at = (long long)row + e;
            const bool live = row >= 0 && at < rows.extent();
            const size_t src = live ? static_cast<size_t>(at) : 0;
            hopper::cp_async_4(sc + e, ks + src, live);
            hopper::cp_async_4(sc + kStep + e, vs + src, live);
          }
          if (r0 + box_rows == kStep) hopper::cp_async_arrive_noinc(&full[s]);
        }
      }
      __syncwarp();
    }
  } else {
    // Q as the A operand: the G heads are rows 0..G-1 of 16, so a1 = a3 =
    // 0; qa[k] = (a0, a2) of k-step k. Over int8, k-step k takes the D
    // pairs (D/4 t + 4k, +1) and (D/4 t + 4k + 2, +3), K's word D/16 t + k.
    uint32_t qa[D / 16][2];
    {
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(
          q + (((size_t)b * Hkv + h) * G + (g < G ? g : 0)) * D);
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int w0 = kInt8 ? (D / 8) * t + 2 * k : 8 * k + t;
        const int w1 = kInt8 ? w0 + 1 : w0 + 4;
        qa[k][0] = g < G ? qp[w0] : 0u;
        qa[k][1] = g < G ? qp[w1] : 0u;
      }
    }
    const int wr0 = warp * kWarpRows;
    for (int i = 0; i < mine; ++i) {
      const int s = i % kStages;
      const int pos0 = first + (r + i * C) * kStep + wr0;
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
      if (pos0 < hi && pos0 + kWarpRows > lo) {
        const uint32_t kb = hopper::smem_u32(smem + s * R::kStageBytes);
        const uint32_t vb = kb + R::kPlane;
        // S^T = Q K^T: two n-tiles of 8 positions, 8 k-steps over D.
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (kInt8) {
          // Lane (g, t): positions g and 8 + g, bytes D/4 t.. of D (chunks
          // D/64 t ..), word k of them for k-step k.
          constexpr int kCh = D / 64;  // 16-byte chunks a lane a position
          uint32_t kw[2][kCh][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < kCh; ++c)
              lds_128(R::at(kb, wr0 + 8 * nt + g, kCh * t + c), kw[nt][c]);
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              uint32_t b0, b1;
              hopper::i8x4_to_bf16x2(kw[nt][k >> 2][k & 3], b0, b1);
              mma_bf16(sc[nt], qa[k][0], 0u, qa[k][1], 0u, b0, b1);
            }
        } else {
          const int krow = wr0 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
          for (int k = 0; k < D / 16; ++k) {
            uint32_t kf[4];
            ldsm_x4(R::at(kb, krow, 2 * k + ((lane >> 3) & 1)), kf);
            mma_bf16(sc[0], qa[k][0], 0u, qa[k][1], 0u, kf[0], kf[1]);
            mma_bf16(sc[1], qa[k][0], 0u, qa[k][1], 0u, kf[2], kf[3]);
          }
        }
        // Lane (g, t) holds head g at positions 2t, 2t + 1, 8 + 2t,
        // 9 + 2t of the warp's 16 (element e: 2t + (e & 1) + 8 (e >> 1)).
        float sv[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
        float kscl[4] = {1.f, 1.f, 1.f, 1.f}, vscl[4] = {1.f, 1.f, 1.f, 1.f};
        if constexpr (kInt8) {
          const float* sp = scl + s * 2 * kStep + wr0 + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kscl[e] = sp[(e & 1) + ((e >> 1) << 3)];
            vscl[e] = sp[kStep + (e & 1) + ((e >> 1) << 3)];
          }
        }
        const float minus_inf = __uint_as_float(0xff800000u);
        float mx = minus_inf;
        bool valid[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = pos0 + 2 * t + (e & 1) + ((e >> 1) << 3);
          valid[e] = pos >= lo && pos < hi;
          // The TPU kernel's order: (q . k) * ks, then * scale.
          const float dot = kInt8 ? sv[e] * kscl[e] : sv[e];
          sv[e] = valid[e] ? dot * scale : minus_inf;
          mx = fmaxf(mx, sv[e]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run, mx);
        const float alpha = __expf(m_run - m_new);
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = __expf(sv[e] - m_new);
        l_run = l_run * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
        m_run = m_new;
        // acc^T's columns are heads 2t and 2t + 1: their alphas live on
        // quads 2t and 2t + 1.
        const float a_lo = __shfl_sync(0xffffffffu, alpha, 8 * t);
        const float a_hi = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
        if (__any_sync(0xffffffffu, a_lo != 1.f || a_hi != 1.f)) {
#pragma unroll
          for (int mt = 0; mt < D / 16; ++mt) {
            acc[mt][0] *= a_lo;
            acc[mt][1] *= a_hi;
            acc[mt][2] *= a_lo;
            acc[mt][3] *= a_hi;
          }
        }
        // acc^T += V^T P^T: P^T's B fragment is the score fragment's
        // (b0 = positions 2t, 2t + 1 of head g, b1 = 8 + 2t, 9 + 2t): bf16
        // p; over int8 p * vs (a masked position's 0, whatever its scale
        // holds) as two bf16 terms, hi and the rest, lo.
        if constexpr (kInt8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = valid[e] ? p[e] * vscl[e] : 0.f;
        }
        const uint32_t pb0 = pack_bf16(p[0], p[1]);
        const uint32_t pb1 = pack_bf16(p[2], p[3]);
        uint32_t pl0 = 0u, pl1 = 0u;
        if constexpr (kInt8) {
          pl0 = pack_bf16(p[0] - __uint_as_float(pb0 << 16),
                          p[1] - __uint_as_float(pb0 & 0xffff0000u));
          pl1 = pack_bf16(p[2] - __uint_as_float(pb1 << 16),
                          p[3] - __uint_as_float(pb1 & 0xffff0000u));
        }
        if constexpr (kInt8) {
          // Lane (g, t): bytes D/8 g.. of D of positions 2t, 2t + 1,
          // 8 + 2t, 9 + 2t (16 bytes, chunk g, at D = 128; 8 at D = 64).
          // Row g of m-tile mt is D = D/8 g + 2mt, row g + 8 is
          // D/8 g + 2mt + 1.
          uint32_t vw[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = wr0 + 8 * (j >> 1) + 2 * t + (j & 1);
            if constexpr (D == 128)
              lds_128(R::at(vb, row, g), vw[j]);
            else
              lds_64(R::at(vb, row, 0) + 8 * g, vw[j]);
#pragma unroll
            for (int c = 0; c < 4; ++c) vw[j][c] ^= 0x80808080u;
          }
#pragma unroll
          for (int mt = 0; mt < D / 16; ++mt) {
            const int w = mt >> 1, y = 2 * (mt & 1);
            uint32_t a[4];
#pragma unroll
            for (int pp = 0; pp < 2; ++pp)  // positions 2t.. / 8 + 2t..
#pragma unroll
              for (int d = 0; d < 2; ++d)     // D rows g / g + 8
                a[2 * pp + d] = pair_bf16(biased_byte(vw[2 * pp][w], y + d),
                                          biased_byte(vw[2 * pp + 1][w], y + d));
            mma_bf16(acc[mt], a[0], a[1], a[2], a[3], pb0, pb1);
            mma_bf16(acc[mt], a[0], a[1], a[2], a[3], pl0, pl1);
          }
        } else {
          const int vrow = wr0 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
          for (int mt = 0; mt < D / 16; ++mt) {
            uint32_t vf[4];
            ldsm_x4_t(R::at(vb, vrow, 2 * mt + ((lane >> 3) & 1)), vf);
            mma_bf16(acc[mt], vf[0], vf[1], vf[2], vf[3], pb0, pb1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
  }
  // The ring is drained (every stage a consumer waited for has landed and
  // been read): its bytes take the merges.
  __syncthreads();
  if (warp < kWarps) {
    // The warp's state into shared memory.
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
    float* my_acc = wacc + warp * G * D;
    float* my_ml = wml + warp * 2 * G;
    if (t == 0 && g < G) {
      my_ml[g] = m_run;
      my_ml[G + g] = l_run;
    }
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      // The D of accumulator rows g and g + 8 of m-tile mt.
      const int d0 = kInt8 ? (D / 8) * g + 2 * mt : 16 * mt + g;
      const int d1 = kInt8 ? d0 + 1 : d0 + 8;
      if (2 * t < G) {
        my_acc[2 * t * D + d0] = acc[mt][0];
        my_acc[2 * t * D + d1] = acc[mt][2];
      }
      if (2 * t + 1 < G) {
        my_acc[(2 * t + 1) * D + d0] = acc[mt][1];
        my_acc[(2 * t + 1) * D + d1] = acc[mt][3];
      }
    }
  }
  __syncthreads();

  // The block's state: its warps' merged.
  float* bacc = reinterpret_cast<float*>(smem + S::kBlockAcc);  // [G][D]
  float* bml = reinterpret_cast<float*>(smem + S::kBlockML);    // [2][G]
  for (int e = tid; e < G * D; e += kThreads) {
    const int gh = e / D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wml[w * 2 * G + gh]);
    float num = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(wml[w * 2 * G + gh] - m);
      num += wacc[(w * G) * D + e] * f;
      l += wml[w * 2 * G + G + gh] * f;
    }
    bacc[e] = num;
    if (e % D == 0) {
      bml[gh] = m;
      bml[G + gh] = l;
    }
  }

  // The cluster's blocks merged: block r writes its share of the outputs.
  hopper::cluster_sync();
  const int share = (G * D + C - 1) / C;
  const int end = min((r + 1) * share, G * D);
  for (int e = r * share + tid; e < end; e += kThreads) {
    const int g = e / D;
    float m = kNegInf;
    for (int k = 0; k < C; ++k)
      m = fmaxf(m, hopper::cluster_load(bml + g, k));
    float num = 0.f, l = 0.f;
    for (int k = 0; k < C; ++k) {
      const float f = __expf(hopper::cluster_load(bml + g, k) - m);
      num += hopper::cluster_load(bacc + e, k) * f;
      l += hopper::cluster_load(bml + G + g, k) * f;
    }
    const size_t o = ((size_t)b * Hkv + h) * G + g;
    // A row with nothing to attend: l = 0 gives zeros.
    out[o * D + e % D] = __float2bfloat16_rn(num / fmaxf(l, 1e-20f));
    if (e % D == 0 && m_out != nullptr) {
      m_out[o] = m;
      l_out[o] = l;
    }
  }
  hopper::cluster_sync();
}

inline int box_rows_for(int PS) {  // gcd(PS, 64)
  int a = PS, b = kStep;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The launch of a grid of (C, Hkv, B) blocks in clusters of C, `smem`
// bytes of shared memory a block; `attr` holds the cluster's dimension.
inline cudaLaunchConfig_t launch_config(cudaLaunchAttribute (&attr)[1],
                                        int smem, int C, int Hkv, int B,
                                        cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch over bf16 q [B, Hkv*G, D] and K/V rows of type KV named by
// `rows`: a cluster of C blocks a (row, kv head), positions below `cap`,
// boxes of `box_rows` rows (a divisor of 64); ks / vs the int8 scale
// planes, null for bf16; m_out / l_out may be null. Returns
// cudaGetLastError() after the launch, -2 if the driver refused a tensor
// map.
template <int D, class KV, class Rows>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const Rows& rows, const int* kv_lens,
           const int* q_pos, void* out, float* m_out, float* l_out, int B,
           int Hkv, int G, int cap, int box_rows, int C, float scale,
           int window, cudaStream_t stream) {
  using R = Ring<KV, D>;
  using S = Smem<KV, D>;
  CUtensorMap k_map, v_map;
  const uint64_t dims[2] = {(uint64_t)D, (uint64_t)rows.extent()};
  const uint64_t strides[1] = {(uint64_t)R::kRowBytes};
  const uint32_t box[2] = {(uint32_t)R::kBoxCols, (uint32_t)box_rows};
  const CUtensorMapDataType type = sizeof(KV) == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swizzle = R::kSwizzled
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_NONE;
  int err = hopper::encode_map(&k_map, type, 2, k, dims, strides, box,
                               swizzle);
  if (err != 0) return err;
  err = hopper::encode_map(&v_map, type, 2, v, dims, strides, box, swizzle);
  if (err != 0) return err;
  auto* kernel = paged_decode_kernel<D, KV, Rows>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(attr, S::kAlloc, C, Hkv, B, stream);
  cerr = cudaLaunchKernelEx(
      &cfg, kernel, k_map, v_map, static_cast<const __nv_bfloat16*>(q), rows,
      ks, vs, kv_lens, q_pos, static_cast<__nv_bfloat16*>(out), m_out, l_out,
      G, cap, box_rows, scale, window);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy of paged_decode_kernel<D, KV, PageRows> (the dense row
// map's instances take the same resources, and so does every G): out[0]
// its shared memory a block, out[1] blocks an SM, out[2] clusters of C
// blocks the card holds at once. Returns 0 or the CUDA error of a query.
template <int D, class KV>
int occupancy(int C, long long* out) {
  using S = Smem<KV, D>;
  auto* kernel = paged_decode_kernel<D, KV, PageRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, S::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(attr, S::kAlloc, C, 1, 1, 0);
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = S::kAlloc;
  out[1] = blocks;
  out[2] = clusters;
  return 0;
}

// As launch, G and D checked at run time. Returns -1 for a shape outside
// D in {64, 128}, G in 1..8, C in 1..8, box rows that do not divide 64, or
// (int8 rows of D = 64, 64 bytes) an odd number of box rows, whose boxes
// would land off the 128-byte alignment a TMA destination needs.
template <class KV, class Rows>
int dispatch(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const Rows& rows, const int* kv_lens,
             const int* q_pos, void* out, float* m_out, float* l_out, int B,
             int Hkv, int G, int D, int cap, int box_rows, int C,
             float scale, int window, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > kMaxG || C < 1 || C > kMaxCluster || cap < 1 ||
      box_rows < 1 || kStep % box_rows != 0)
    return -1;
  if (D == 128)
    return launch<128, KV>(q, k, v, ks, vs, rows, kv_lens, q_pos, out, m_out,
                           l_out, B, Hkv, G, cap, box_rows, C, scale, window,
                           stream);
  if (D == 64 && (sizeof(KV) == 2 || box_rows % 2 == 0))
    return launch<64, KV>(q, k, v, ks, vs, rows, kv_lens, q_pos, out, m_out,
                          l_out, B, Hkv, G, cap, box_rows, C, scale, window,
                          stream);
  return -1;
}

}  // namespace pdec
