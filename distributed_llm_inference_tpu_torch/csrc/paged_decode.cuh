// Decode attention over bf16 pages for Hopper (sm_90a): the device code of
// `paged_attention`'s bf16 instance (csrc/paged_attention.cu).
//
// Replaces the TPU kernel `_paged_kernel` behind `paged_attention`
// (distributed_llm_inference_tpu/ops/paged_attention.py) for bf16 queries
// and pages. One query token a row attends over the row's live positions
// [lo, kv_len) (lo from the sliding window, anchored at q_positions), read
// in place from the page pool through the page table; the kernel writes the
// output and the softmax stats m (the max of the scaled scores) and l (the
// sum of exp(s - m)). The f32 instance stays on decode_attention.cuh's walk
// (the engine's exact-parity runs are the only f32 callers).
//
// What bounds it on this card: bytes. Every live K and V byte is read once
// for 4 * G flops a bf16 pair, far below the ~295 flop/byte where the
// tensor cores would matter. What each choice does about it:
//
// * One launch, no scratch. A thread-block cluster of C blocks serves one
//   (row, kv head). The row's live positions, in steps of kStep = 64
//   aligned on 64, are dealt to the C blocks in turn at run time, so the
//   split follows the live length, not the table width; C (1..8) is
//   chosen by the caller from the batch, about one block an SM (C = 2 at 8
//   rows x 8 kv heads, 8 at one row): on an H100 more blocks only added
//   merges, and fewer left the memory system short of requests. The
//   blocks merge their (m, l, acc) through distributed shared memory
//   behind cluster barriers, as the fused step does (fused_decode.cuh): no
//   partials in device memory, no second kernel.
// * Copies in flight. A producer warp brings each step's K and V by TMA
//   (cp.async.bulk.tensor.2d over the pool viewed as rows [P * Hkv * PS, D],
//   two boxes of 64 columns a row, the 128-byte swizzle) into a ring of
//   kStages stages against full / empty mbarriers, so up to 96 KB a block
//   is in flight while the consumers work. A box has gcd(PS, 64) rows, so it
//   never crosses a page and any page size works; a box with no live
//   position is asked for at a negative row, which the TMA fills with
//   zeros and still counts. The producer's lanes resolve 32 boxes' table
//   entries at once, so the table's reads do not stand one after another
//   in front of the copies.
// * Softmax by tile, products on the tensor cores. Each of 4 consumer warps
//   takes 16 positions of a step and keeps its own running (m, l, acc). The
//   scores are one mma.sync m16n8k16 product, S^T = Q K^T, with the G query
//   heads as the rows (padded to 16) and the positions as the columns
//   (ldmatrix from the swizzled stage: no bank conflicts); its accumulator
//   fragment is, lane for lane, the B operand of P V (acc^T = V^T P^T, V^T
//   by ldmatrix.trans), so p never leaves the registers. A warp takes one
//   max a head over its 16 positions (two shuffles), rescales its
//   accumulators once for them, and only when a max moved. p is rounded to
//   bf16 for P V, as the TPU kernel rounds it for G > 1; l sums p in f32.
//
// The load stage is written against a row map (PageRows below: position ->
// row of the tensor map): a contiguous [B, Hkv, T, D] buffer (#8's) is
// another row map, and int8 pages (#5's) another tensor map type with their
// scales brought beside the rows, for the next kernels onto this one.
//
// Built for head_dim 128 with 1 or 4 query heads per kv head.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace pdec {

constexpr int kD = 128;
constexpr int kWarps = 4;                       // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;     // and the producer warp
constexpr int kStep = 64;                       // positions a ring stage
constexpr int kWarpRows = kStep / kWarps;       // positions a warp a stage
constexpr int kHalf = kStep * 128;              // 64 rows of 64 bf16
constexpr int kStageBytes = 4 * kHalf;          // K's halves, then V's
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;
constexpr int kBlocksPerSM = 2;
// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// Shared memory of a block, from a 1024-aligned base (the swizzle repeats
// every 1024 bytes): the ring, each warp's (acc [G][D], m [G], l [G]), the
// block's, the barriers (full, empty).
template <int G>
struct Smem {
  static constexpr int kWarpAcc = kStages * kStageBytes;
  static constexpr int kWarpML = kWarpAcc + kWarps * G * kD * 4;
  static constexpr int kBlockAcc = kWarpML + kWarps * 2 * G * 4;
  static constexpr int kBlockML = kBlockAcc + G * kD * 4;
  static constexpr int kBars = (kBlockML + 2 * G * 4 + 7) & ~7;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// Row of the tensor map that holds position `pos` of (row b, kv head h):
// the page pool [P, Hkv, PS, D] as rows, through the row's page table.
struct PageRows {
  const int* table;  // [B, Tw]
  int Tw, PS, Hkv;
  __device__ __forceinline__ int row(int b, int h, int pos) const {
    return (table[(size_t)b * Tw + pos / PS] * Hkv + h) * PS + pos % PS;
  }
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

// Address of the 16-byte chunk `chunk` (0..15 over D) of row `row` of a
// staged tile: two 64-column halves, chunk c of a row at c ^ (row % 8).
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  return base + (chunk >> 3) * kHalf + row * 128 +
         (((chunk & 7) ^ (row & 7)) << 4);
}

template <int G, class Rows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) paged_decode_kernel(
    const __grid_constant__ CUtensorMap k_map,  // pool rows [P*Hkv*PS, D]
    const __grid_constant__ CUtensorMap v_map,
    const __nv_bfloat16* __restrict__ q,        // [B, Hkv*G, D]
    Rows rows,
    const int* __restrict__ kv_lens,            // [B]
    const int* __restrict__ q_pos,              // [B]
    __nv_bfloat16* __restrict__ out,            // [B, Hkv*G, D]
    float* __restrict__ m_out,                  // [B, Hkv, G]
    float* __restrict__ l_out,                  // [B, Hkv, G]
    int cap, int box_rows, float scale, int window) {
  static_assert(G == 1 || G == 4, "the instances this kernel is built for");
  using S = Smem<G>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
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
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  float* wacc = reinterpret_cast<float*>(smem + S::kWarpAcc);  // [kWarps][G][D]
  float* wml = reinterpret_cast<float*>(smem + S::kWarpML);    // [kWarps][2][G]
  if (warp == kWarps) {
    // The producer. The lanes resolve the rows of the block's next 32
    // boxes together (one table read each, in flight at once), then lane 0
    // issues them in order, each step's boxes into its stage.
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
        if (lane != 0) continue;
        const int i = (base + j) / per_step;
        const int r0 = (base + j) % per_step * box_rows;
        const int s = i % kStages;
        if (r0 == 0) {
          hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
        }
        uint8_t* st = smem + s * kStageBytes + r0 * 128;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          hopper::tma_load_2d(st + c * kHalf, &k_map, &full[s], c * 64, row);
          hopper::tma_load_2d(st + (2 + c) * kHalf, &v_map, &full[s], c * 64,
                              row);
        }
      }
      __syncwarp();
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    // Q as the A operand: the G heads are rows 0..G-1 of 16, so a1 = a3 =
    // 0; qa[k] = (a0, a2) of k-step k.
    uint32_t qa[kD / 16][2];
    {
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(
          q + (((size_t)b * Hkv + h) * G + (g < G ? g : 0)) * kD);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k) {
        qa[k][0] = g < G ? qp[8 * k + t] : 0u;
        qa[k][1] = g < G ? qp[8 * k + 4 + t] : 0u;
      }
    }
    // This warp's running state: m and l of head g (the same on the 4
    // lanes of a quad; l a partial sum a lane), acc^T [D x 8 heads] as 8
    // m-tiles of 16 rows of D.
    float m_run = kNegInf, l_run = 0.f;
    float acc[kD / 16][4];
#pragma unroll
    for (int mt = 0; mt < kD / 16; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][c] = 0.f;
    const int wr0 = warp * kWarpRows;
    for (int i = 0; i < mine; ++i) {
      const int s = i % kStages;
      const int pos0 = first + (r + i * C) * kStep + wr0;
      hopper::mbar_wait(&full[s], (i / kStages) & 1);
      if (pos0 < hi && pos0 + kWarpRows > lo) {
        const uint32_t kb = hopper::smem_u32(smem + s * kStageBytes);
        const uint32_t vb = kb + 2 * kHalf;
        // S^T = Q K^T: two n-tiles of 8 positions, 8 k-steps over D.
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const int krow = wr0 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
        for (int k = 0; k < kD / 16; ++k) {
          uint32_t kf[4];
          ldsm_x4(swz(kb, krow, 2 * k + ((lane >> 3) & 1)), kf);
          mma_bf16(sc[0], qa[k][0], 0u, qa[k][1], 0u, kf[0], kf[1]);
          mma_bf16(sc[1], qa[k][0], 0u, qa[k][1], 0u, kf[2], kf[3]);
        }
        // Lane (g, t) holds head g at positions 2t, 2t + 1, 8 + 2t,
        // 9 + 2t of the warp's 16.
        float sv[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
        const float minus_inf = __uint_as_float(0xff800000u);
        float mx = minus_inf;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = pos0 + 2 * t + (e & 1) + ((e >> 1) << 3);
          sv[e] = pos >= lo && pos < hi ? sv[e] * scale : minus_inf;
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
          for (int mt = 0; mt < kD / 16; ++mt) {
            acc[mt][0] *= a_lo;
            acc[mt][1] *= a_hi;
            acc[mt][2] *= a_lo;
            acc[mt][3] *= a_hi;
          }
        }
        // acc^T += V^T P^T: P^T's B fragment is the score fragment's
        // (b0 = positions 2t, 2t + 1 of head g, b1 = 8 + 2t, 9 + 2t).
        const uint32_t pb0 = pack_bf16(p[0], p[1]);
        const uint32_t pb1 = pack_bf16(p[2], p[3]);
        const int vrow = wr0 + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
        for (int mt = 0; mt < kD / 16; ++mt) {
          uint32_t vf[4];
          ldsm_x4_t(swz(vb, vrow, 2 * mt + ((lane >> 3) & 1)), vf);
          mma_bf16(acc[mt], vf[0], vf[1], vf[2], vf[3], pb0, pb1);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    // The warp's state into shared memory.
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
    float* my_acc = wacc + warp * G * kD;
    float* my_ml = wml + warp * 2 * G;
    if (t == 0 && g < G) {
      my_ml[g] = m_run;
      my_ml[G + g] = l_run;
    }
#pragma unroll
    for (int mt = 0; mt < kD / 16; ++mt) {
      const int d = 16 * mt + g;
      if (2 * t < G) {
        my_acc[2 * t * kD + d] = acc[mt][0];
        my_acc[2 * t * kD + d + 8] = acc[mt][2];
      }
      if (2 * t + 1 < G) {
        my_acc[(2 * t + 1) * kD + d] = acc[mt][1];
        my_acc[(2 * t + 1) * kD + d + 8] = acc[mt][3];
      }
    }
  }
  __syncthreads();

  // The block's state: its warps' merged.
  float* bacc = reinterpret_cast<float*>(smem + S::kBlockAcc);  // [G][D]
  float* bml = reinterpret_cast<float*>(smem + S::kBlockML);    // [2][G]
  for (int e = tid; e < G * kD; e += kThreads) {
    const int g = e / kD;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wml[w * 2 * G + g]);
    float num = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(wml[w * 2 * G + g] - m);
      num += wacc[(w * G) * kD + e] * f;
      l += wml[w * 2 * G + G + g] * f;
    }
    bacc[e] = num;
    if (e % kD == 0) {
      bml[g] = m;
      bml[G + g] = l;
    }
  }

  // The cluster's blocks merged: block r writes its share of the outputs.
  hopper::cluster_sync();
  const int share = (G * kD + C - 1) / C;
  const int end = min((r + 1) * share, G * kD);
  for (int e = r * share + tid; e < end; e += kThreads) {
    const int g = e / kD;
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
    out[o * kD + e % kD] = __float2bfloat16_rn(num / fmaxf(l, 1e-20f));
    if (e % kD == 0) {
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

// One launch over bf16 q [B, Hkv*G, D], pools [P, Hkv, PS, D], table
// [B, Tw]: a cluster of C blocks a (row, kv head). Returns
// cudaGetLastError() after the launch, -1 for a shape outside G in {1, 4}
// and C in 1..8, -2 if the driver refused a tensor map.
template <int G>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* kv_lens, const int* q_pos, void* out, float* m_out,
           float* l_out, int B, int Hkv, int PS, int Tw, int C, float scale,
           int window, cudaStream_t stream) {
  using S = Smem<G>;
  CUtensorMap k_map, v_map;
  // The pool as rows of D; the wrapper checks that every row a table can
  // name lies below 2^31, which stands in for the extent.
  const int box_rows = box_rows_for(PS);
  const uint64_t dims[2] = {(uint64_t)kD, 1ull << 31};
  const uint64_t strides[1] = {kD * 2};
  const uint32_t box[2] = {64u, (uint32_t)box_rows};
  int err = hopper::encode_map(&k_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k,
                               dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = hopper::encode_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v,
                           dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  auto* kernel = paged_decode_kernel<G, PageRows>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kAlloc;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const PageRows rows{table, Tw, PS, Hkv};
  cerr = cudaLaunchKernelEx(
      &cfg, kernel, k_map, v_map, static_cast<const __nv_bfloat16*>(q), rows,
      kv_lens, q_pos, static_cast<__nv_bfloat16*>(out), m_out, l_out,
      Tw * PS, box_rows, scale, window);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

inline int dispatch(const void* q, const void* k, const void* v,
                    const int* table, const int* kv_lens, const int* q_pos,
                    void* out, float* m_out, float* l_out, int B, int Hkv,
                    int G, int D, int PS, int Tw, int C, float scale,
                    int window, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (D != kD || C < 1 || C > kMaxCluster || PS < 1 || Tw < 1) return -1;
  if (G == 1)
    return launch<1>(q, k, v, table, kv_lens, q_pos, out, m_out, l_out, B,
                     Hkv, PS, Tw, C, scale, window, stream);
  if (G == 4)
    return launch<4>(q, k, v, table, kv_lens, q_pos, out, m_out, l_out, B,
                     Hkv, PS, Tw, C, scale, window, stream);
  return -1;
}

}  // namespace pdec
