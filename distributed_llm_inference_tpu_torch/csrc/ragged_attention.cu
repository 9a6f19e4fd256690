// Ragged mixed-phase paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of
// distributed_llm_inference_tpu/ops/ragged_attention.py: `_ragged_kernel`
// behind `ragged_paged_attention` and `_qragged_kernel` behind
// `quantized_ragged_paged_attention` (the same over int8 pages). Row b carries
// num_new[b] real query tokens starting at absolute position q_start[b] and
// attends causally (optionally inside a sliding window) over the first
// kv_lengths[b] slots of its pages, read in place through the page table. A
// full prompt, a prefill chunk with q_start > 0, a single decode token and an
// empty row are all cells of one launch. Pad queries and empty rows give
// zeros.
//
// What bounds it on this card: operations, the two products Q K^T and P V
// (4 * D flops per (query, head, visible slot)); K and V are re-read per
// query tile but from L2.
//
// Design: one block per (query tile, kv head, row). A tile is 64 / G queries,
// so with the G query heads of the group it is always 64 score rows. The
// block walks the row's positions 64 at a time, from the first position the
// sliding window admits up to the tile's causal frontier
// min(kv_len, q_start + last query of the tile + 1), and no further: dead
// table slots are never fetched, and a tile of pad queries exits at once.
// Per step the K and V slots are staged in shared memory, the 64 x 64 score
// tile is computed, the online softmax runs on registers, and P V is added to
// an f32 accumulator in registers. The element type picks the products:
//
// * bfloat16 (`ragged_kernel_mma`): tensor cores, mma.sync m16n8k16 with f32
//   accumulation. 4 warps, each owning 16 score rows. Q fragments stay in
//   registers for the whole walk; K rows in shared memory are the "col"
//   operand of Q K^T as they lie; the score fragments, rounded to bf16 as the
//   TPU kernel rounds them, are already laid out as the A operand of P V, so
//   P never leaves registers; V fragments come through ldmatrix.trans. Rows
//   are padded by 16 bytes so that fragment loads hit distinct banks.
// * float32 (`ragged_kernel_f32`): register-tiled f32 FMAs, 256 threads, each a
//   4 x 4 patch of the score tile and 4 rows x D/16 columns of P V, with P
//   going through shared memory. Full float32 products: the exact-parity
//   checks of the engine run in this type, and TF32 would not pass them.
//
// int8 pages (Q8 below): the pages hold int8 values and two f32 planes an
// f32 scale per (slot, kv head). Staging converts the int8 K and V rows to
// the working type in shared memory (int8 -> bf16 is exact for |v| <= 127,
// so Q K^T on the tensor cores loses nothing) and stages the step's 64 K and
// V scales beside them. The K scale multiplies each score, s = (q . k) * ks
// * scale; the V scale multiplies each probability before P V, while l sums
// the probabilities themselves, as `_qragged_kernel` does. The TPU kernel
// keeps p * vs and V in f32 for P V; the bf16 kernel here rounds p * vs to
// bf16 for the tensor cores, as it rounds P in the bf16 pool's case (the
// error stays inside the smoke's bf16 tolerance). The f32 kernel keeps
// p * vs in f32. Reading int8 halves the page bytes of a bf16 pool.
//
// Built for head_dim 128 with 1 or 4 query heads per kv head (MHA, and the
// Llama-3 grouping this package serves); a model with other widths adds its
// instance to dispatch_g / dispatch_d below.
//
// Left to later changes: a cp.async / TMA ring so that staging overlaps the
// products, wgmma, and larger query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using tile::ldmatrix_x2_trans;
using tile::mma_bf16;
using tile::pack_bf16;
using tile::stage_chunk;
using tile::stage_chunk16;

constexpr int kRows = 64;   // score rows per block = (64 / G) queries x G
constexpr int kTile = 64;   // kv positions per step
// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// ---------------------------------------------------------------------------
// bfloat16: tensor-core products
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kRowPad = 8;  // bf16 elements (16 bytes) of padding per row

// 16 int8 of a row (16-byte chunk `chunk`) as bf16 into shared memory; a
// null source stores zeros.
__device__ __forceinline__ void stage_i8_bf16(__nv_bfloat16* dst_row,
                                              const int8_t* src_row,
                                              int chunk) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src_row != nullptr)
    v = *reinterpret_cast<const uint4*>(src_row + chunk * 16);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float b0 = (float)((int32_t)(w[i] << 24) >> 24);
    const float b1 = (float)((int32_t)(w[i] << 16) >> 24);
    const float b2 = (float)((int32_t)(w[i] << 8) >> 24);
    const float b3 = (float)((int32_t)w[i] >> 24);
    o[2 * i] = pack_bf16(b0, b1);
    o[2 * i + 1] = pack_bf16(b2, b3);
  }
  uint4* d = reinterpret_cast<uint4*>(dst_row + chunk * 16);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// The two scales of positions kv0 .. kv0 + kTile - 1 (0 past `end`).
__device__ __forceinline__ void stage_scales(float* ks_s, float* vs_s,
                                             const float* ks, const float* vs,
                                             const int* trow, int kv0, int end,
                                             int Hkv, int h, int PS, int tid,
                                             int nthreads) {
  for (int r = tid; r < kTile; r += nthreads) {
    const int pos = kv0 + r;
    float a = 0.f, b = 0.f;
    if (pos < end) {
      const size_t slot = ((size_t)trow[pos / PS] * Hkv + h) * PS + pos % PS;
      a = ks[slot];
      b = vs[slot];
    }
    ks_s[r] = a;
    vs_s[r] = b;
  }
}

// KV is __nv_bfloat16, or int8_t with the scale planes ks / vs.
template <int D, int G, typename KV>
__global__ void __launch_bounds__(kMmaThreads) ragged_kernel_mma(
    const __nv_bfloat16* __restrict__ q,          // [B, S, Hkv*G, D]
    const KV* __restrict__ k_pages,               // [P, Hkv, PS, D]
    const KV* __restrict__ v_pages,               // [P, Hkv, PS, D]
    const float* __restrict__ ks,                 // [P, Hkv, PS] (int8)
    const float* __restrict__ vs,                 // [P, Hkv, PS] (int8)
    const int* __restrict__ table,                // [B, Tw]
    const int* __restrict__ kv_lens,              // [B]
    const int* __restrict__ q_starts,             // [B]
    const int* __restrict__ num_news,             // [B]
    __nv_bfloat16* __restrict__ out,              // [B, S, Hkv*G, D]
    int S, int Hkv, int PS, int Tw, float scale, int window) {
  using bf16 = __nv_bfloat16;
  constexpr bool Q8 = sizeof(KV) == 1;
  constexpr int SE = D + kRowPad;     // shared row stride in elements
  constexpr int KS = D / 16;          // k-steps of Q K^T
  constexpr int NT = kTile / 8;       // score n-tiles per step
  constexpr int ND = D / 8;           // output n-tiles
  constexpr int CPR = D / 8;          // 16-byte chunks per row
  constexpr int BQ = kRows / G;

  extern __shared__ uint4 smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);   // [kRows][SE]
  bf16* k_s = q_s + kRows * SE;                    // [kTile][SE]
  bf16* v_s = k_s + kTile * SE;                    // [kTile][SE]
  float* ks_s = reinterpret_cast<float*>(v_s + kTile * SE);  // [kTile] (Q8)
  float* vs_s = ks_s + kTile;                                // [kTile] (Q8)

  const int tile_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g4 = lane >> 2;  // 0..7
  const int t4 = lane & 3;   // 0..3
  const int Hq = Hkv * G;

  const int num_new = num_news[b];
  const int q_start = q_starts[b];
  const int kv_len = min(kv_lens[b], Tw * PS);

  if (tile_start >= num_new) {
    // Tile of pad queries only (or an empty row): zeros, no page touched.
    for (int c = tid; c < kRows * CPR; c += kMmaThreads) {
      const int r = c / CPR;
      const int q_rel = tile_start + r / G;
      if (q_rel < S)
        *reinterpret_cast<uint4*>(
            out + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D +
            (c % CPR) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  for (int c = tid; c < kRows * CPR; c += kMmaThreads) {
    const int r = c / CPR;
    const int q_rel = tile_start + r / G;
    const bf16* src = nullptr;
    if (q_rel < S)
      src = q + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
    stage_chunk16(q_s + r * SE, src, c % CPR);
  }
  __syncthreads();

  // This thread's two score rows, and their Q fragments for every k-step.
  const int row0 = warp * 16 + g4;
  const int row1 = row0 + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = ks * 16 + 2 * t4;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(q_s + row0 * SE + col);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(q_s + row1 * SE + col);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(q_s + row0 * SE + col + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(q_s + row1 * SE + col + 8);
  }
  const int q_rel0 = tile_start + row0 / G;
  const int q_rel1 = tile_start + row1 / G;
  const int q_pos0 = q_start + q_rel0;
  const int q_pos1 = q_start + q_rel1;
  const bool ok0 = q_rel0 < num_new;
  const bool ok1 = q_rel1 < num_new;

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  const int last_q = min(tile_start + BQ, num_new) - 1;
  const int end = min(kv_len, q_start + last_q + 1);
  int first = 0;
  if (window > 0) first = max(0, q_start + tile_start - window + 1);
  first = (first / kTile) * kTile;

  const int* trow = table + (size_t)b * Tw;
  for (int kv0 = first; kv0 < end; kv0 += kTile) {
    __syncthreads();  // every warp is done with the previous k_s and v_s
    constexpr int CPS = Q8 ? D / 16 : CPR;  // 16-byte source chunks per row
    for (int c = tid; c < kTile * CPS; c += kMmaThreads) {
      const int r = c / CPS;
      const int pos = kv0 + r;
      const KV* ksrc = nullptr;
      const KV* vsrc = nullptr;
      if (pos < end) {
        const int page = trow[pos / PS];
        const size_t base = (((size_t)page * Hkv + h) * PS + pos % PS) * D;
        ksrc = k_pages + base;
        vsrc = v_pages + base;
      }
      if constexpr (Q8) {
        stage_i8_bf16(k_s + r * SE, ksrc, c % CPS);
        stage_i8_bf16(v_s + r * SE, vsrc, c % CPS);
      } else {
        stage_chunk16(k_s + r * SE, ksrc, c % CPS);
        stage_chunk16(v_s + r * SE, vsrc, c % CPS);
      }
    }
    if constexpr (Q8)
      stage_scales(ks_s, vs_s, ks, vs, trow, kv0, end, Hkv, h, PS, tid,
                   kMmaThreads);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: s[nt] covers slots nt*8 .. nt*8+7.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* krow = k_s + (nt * 8 + g4) * SE + ks * 16 + 2 * t4;
        mma_bf16(s[nt], qa[ks],
                 *reinterpret_cast<const uint32_t*>(krow),
                 *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }

    // Mask, scale, online softmax. s[nt][0..1] belong to row0 at slots
    // nt*8 + 2*t4 (+1), s[nt][2..3] to row1; a row's 64 scores sit in the 4
    // lanes that share g4.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = kv0 + nt * 8 + 2 * t4 + e;
        const bool live = pos < kv_len;
        const bool v0 = ok0 && live && pos <= q_pos0 &&
                        (window <= 0 || pos > q_pos0 - window);
        const bool v1 = ok1 && live && pos <= q_pos1 &&
                        (window <= 0 || pos > q_pos1 - window);
        if constexpr (Q8) {
          const float kq = ks_s[nt * 8 + 2 * t4 + e];
          s[nt][e] = v0 ? s[nt][e] * kq * scale : kNegInf;
          s[nt][2 + e] = v1 ? s[nt][2 + e] * kq * scale : kNegInf;
        } else {
          s[nt][e] = v0 ? s[nt][e] * scale : kNegInf;
          s[nt][2 + e] = v1 ? s[nt][2 + e] * scale : kNegInf;
        }
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // Masked entries are exactly 0: exp(kNegInf - kNegInf) would be 1.
        const float p0 = s[nt][e] > kNegInf ? expf(s[nt][e] - mn0) : 0.f;
        const float p1 = s[nt][2 + e] > kNegInf ? expf(s[nt][2 + e] - mn1) : 0.f;
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha0;
      o[nd][1] *= alpha0;
      o[nd][2] *= alpha1;
      o[nd][3] *= alpha1;
    }

    // int8 pages: p * vs is what multiplies V (l above summed p itself).
    if constexpr (Q8) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vq = vs_s[nt * 8 + 2 * t4 + e];
          s[nt][e] *= vq;
          s[nt][2 + e] *= vq;
        }
    }

    // O += P V, 16 slots per k-step: the score fragments of n-tiles 2j and
    // 2j+1 are the A operand as they lie.
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const bf16* vrow = v_s + (j * 16 + (lane & 15)) * SE;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + nd * 8);
        mma_bf16(o[nd], pa, b0, b1);
      }
    }
  }

  // Pad queries (q_rel >= num_new) never accumulated: l == 0 -> zeros.
  const float inv0 = 1.f / fmaxf(l0, 1e-20f);
  const float inv1 = 1.f / fmaxf(l1, 1e-20f);
  if (q_rel0 < S) {
    bf16* orow = out + (((size_t)b * S + q_rel0) * Hq + h * G + row0 % G) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[nd][0] * inv0, o[nd][1] * inv0);
  }
  if (q_rel1 < S) {
    bf16* orow = out + (((size_t)b * S + q_rel1) * Hq + h * G + row1 % G) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

template <int D, int G, typename KV>
int launch_mma(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* table, const int* kv_lens,
               const int* q_starts, const int* num_news, void* out, int B,
               int S, int Hkv, int PS, int Tw, float scale, int window,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = kRows / G;
  const size_t smem_bytes =
      (size_t)(kRows + 2 * kTile) * (D + kRowPad) * sizeof(bf16) +
      (sizeof(KV) == 1 ? 2 * kTile * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel_mma<D, G, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  ragged_kernel_mma<D, G, KV><<<grid, kMmaThreads, smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, table, kv_lens, q_starts, num_news,
      static_cast<bf16*>(out), S, Hkv, PS, Tw, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: register-tiled FMA products
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPStride = kTile + 1;

// 16 int8 of a row (16-byte chunk `chunk`) as f32 into shared memory; a
// null source stores zeros.
__device__ __forceinline__ void stage_chunk_i8(float* dst_row,
                                               const int8_t* src_row,
                                               int chunk) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src_row != nullptr)
    v = *reinterpret_cast<const uint4*>(src_row + chunk * 16);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float* d = dst_row + chunk * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
}

// KV is float, or int8_t with the scale planes ks / vs.
template <int D, int G, typename KV>
__global__ void __launch_bounds__(kThreads) ragged_kernel_f32(
    const float* __restrict__ q,          // [B, S, Hkv*G, D]
    const KV* __restrict__ k_pages,       // [P, Hkv, PS, D]
    const KV* __restrict__ v_pages,       // [P, Hkv, PS, D]
    const float* __restrict__ ks,         // [P, Hkv, PS] (int8)
    const float* __restrict__ vs,         // [P, Hkv, PS] (int8)
    const int* __restrict__ table,        // [B, Tw]
    const int* __restrict__ kv_lens,      // [B] live slots incl. this call's
    const int* __restrict__ q_starts,     // [B]
    const int* __restrict__ num_news,     // [B]
    float* __restrict__ out,              // [B, S, Hkv*G, D]
    int S, int Hkv, int PS, int Tw, float scale, int window) {
  // Rows padded to an odd stride: the strided reads below (row tx + 16*j of
  // k_s, column tx + 16*jj of v_s) then hit distinct banks.
  constexpr bool Q8 = sizeof(KV) == 1;
  constexpr int SW = D + 1;
  constexpr int CPR = D / 4;          // 16-byte chunks per row of q
  constexpr int BQ = kRows / G;       // queries per tile
  constexpr int NW = D / 16;          // output columns per thread

  extern __shared__ float smem_f32[];
  float* q_s = smem_f32;                     // [kRows][SW]
  float* k_s = q_s + kRows * SW;             // [kTile][SW]
  float* v_s = k_s + kTile * SW;             // [kTile][SW]
  float* p_s = v_s + kTile * SW;             // [kRows][kPStride]
  float* ks_s = p_s + kRows * kPStride;      // [kTile] (Q8)
  float* vs_s = ks_s + kTile;                // [kTile] (Q8)

  const int tile_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // 0..15: owns score rows ty*4 .. ty*4+3
  const int tx = tid & 15;   // 0..15: owns slots tx + 16*j, columns tx + 16*jj
  const int Hq = Hkv * G;

  const int num_new = num_news[b];
  const int q_start = q_starts[b];
  const int kv_len = min(kv_lens[b], Tw * PS);

  if (tile_start >= num_new) {
    // Tile of pad queries only (or an empty row): zeros, no page touched.
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int r = idx / D;
      const int q_rel = tile_start + r / G;
      if (q_rel < S)
        out[(((size_t)b * S + q_rel) * Hq + h * G + r % G) * D + idx % D] = 0.f;
    }
    return;
  }

  // Stage the query tile once.
  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR;
    const int q_rel = tile_start + r / G;
    const float* src = nullptr;
    if (q_rel < S)
      src = q + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
    stage_chunk(q_s + r * SW, src, c % CPR);
  }

  float m[4], l[4], acc[4][NW];
  int q_rel_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    q_rel_r[i] = tile_start + (ty * 4 + i) / G;
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) acc[i][jj] = 0.f;
  }

  // Positions this tile can see: [first, end).
  const int last_q = min(tile_start + BQ, num_new) - 1;
  const int end = min(kv_len, q_start + last_q + 1);
  int first = 0;
  if (window > 0) first = max(0, q_start + tile_start - window + 1);
  first = (first / kTile) * kTile;

  const int* trow = table + (size_t)b * Tw;
  for (int kv0 = first; kv0 < end; kv0 += kTile) {
    __syncthreads();  // the previous step is done with k_s, v_s and p_s
    constexpr int CPS = Q8 ? D / 16 : CPR;  // 16-byte source chunks per row
    for (int c = tid; c < kTile * CPS; c += kThreads) {
      const int r = c / CPS;
      const int pos = kv0 + r;
      const KV* ksrc = nullptr;
      const KV* vsrc = nullptr;
      if (pos < end) {
        const int page = trow[pos / PS];
        const size_t base = (((size_t)page * Hkv + h) * PS + pos % PS) * D;
        ksrc = k_pages + base;
        vsrc = v_pages + base;
      }
      if constexpr (Q8) {
        stage_chunk_i8(k_s + r * SW, ksrc, c % CPS);
        stage_chunk_i8(v_s + r * SW, vsrc, c % CPS);
      } else {
        stage_chunk(k_s + r * SW, ksrc, c % CPS);
        stage_chunk(v_s + r * SW, vsrc, c % CPS);
      }
    }
    if constexpr (Q8)
      stage_scales(ks_s, vs_s, ks, vs, trow, kv0, end, Hkv, h, PS, tid,
                   kThreads);
    __syncthreads();

    // Scores: rows ty*4+i, slots tx+16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[i] = q_s[(ty * 4 + i) * SW + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = k_s[(tx + 16 * j) * SW + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qf[i] * kf[j];
    }

    // Online softmax on the registers; a row is spread over the 16 threads
    // that share ty (a half warp), reduced with shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_start + q_rel_r[i];
      const bool row_ok = q_rel_r[i] < num_new;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = kv0 + tx + 16 * j;
        valid[j] = row_ok && pos < kv_len && pos <= q_pos &&
                   (window <= 0 || pos > q_pos - window);
        if constexpr (Q8)
          s[i][j] = valid[j] ? s[i][j] * ks_s[tx + 16 * j] * scale : kNegInf;
        else
          s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Masked entries are exactly 0: exp(kNegInf - kNegInf) would be 1.
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        // int8 pages: V is weighted by p * vs; l sums p.
        p_s[(ty * 4 + i) * kPStride + tx + 16 * j] =
            Q8 ? p * vs_s[tx + 16 * j] : p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NW; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty*4+i, columns tx+16*jj of each V slot.
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      float pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[i] = p_s[(ty * 4 + i) * kPStride + t];
#pragma unroll
      for (int jj = 0; jj < NW; ++jj) {
        const float vf = v_s[t * SW + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] += pf[i] * vf;
      }
    }
  }

  // Pad queries (q_rel >= num_new) never accumulated: l == 0 -> zeros.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (q_rel_r[i] >= S) continue;
    const int r = ty * 4 + i;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* orow = out + (((size_t)b * S + q_rel_r[i]) * Hq + h * G + r % G) * D;
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) orow[tx + 16 * jj] = acc[i][jj] * inv;
  }
}

template <int D, int G, typename KV>
int launch_f32(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* table, const int* kv_lens,
               const int* q_starts, const int* num_news, void* out, int B,
               int S, int Hkv, int PS, int Tw, float scale, int window,
               cudaStream_t stream) {
  constexpr int BQ = kRows / G;
  const size_t smem_bytes =
      ((size_t)(kRows + 2 * kTile) * (D + 1) + (size_t)kRows * kPStride +
       (sizeof(KV) == 1 ? 2 * kTile : 0)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel_f32<D, G, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  ragged_kernel_f32<D, G, KV><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, table, kv_lens, q_starts, num_news,
      static_cast<float*>(out), S, Hkv, PS, Tw, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *table, *kv_lens, *q_starts, *num_news;
  void* out;
  int B, S, Hkv, PS, Tw, window;
  float scale;
  cudaStream_t stream;
};

// BF16 picks the tensor-core kernel; Q8 the int8 pages.
template <bool BF16, bool Q8, int D, int G>
int launch(const Args& a) {
  if constexpr (BF16) {
    using KV = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
    return launch_mma<D, G, KV>(a.q, a.k, a.v, a.ks, a.vs, a.table,
                                a.kv_lens, a.q_starts, a.num_news, a.out, a.B,
                                a.S, a.Hkv, a.PS, a.Tw, a.scale, a.window,
                                a.stream);
  } else {
    using KV = typename std::conditional<Q8, int8_t, float>::type;
    return launch_f32<D, G, KV>(a.q, a.k, a.v, a.ks, a.vs, a.table,
                                a.kv_lens, a.q_starts, a.num_news, a.out, a.B,
                                a.S, a.Hkv, a.PS, a.Tw, a.scale, a.window,
                                a.stream);
  }
}

template <bool BF16, bool Q8>
int dispatch(int D, int G, const Args& a) {
  if (D != 128) return -1;
  switch (G) {
    case 1: return launch<BF16, Q8, 128, 1>(a);
    case 4: return launch<BF16, Q8, 128, 4>(a);
  }
  return -1;
}

int run(const void* q, const void* k_pages, const void* ks_pages,
        const void* v_pages, const void* vs_pages, const void* table,
        const void* kv_lens, const void* q_starts, const void* num_news,
        void* out, int B, int S, int Hkv, int G, int D, int PS, int Tw,
        float scale, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  Args a;
  a.q = q; a.k = k_pages; a.v = v_pages;
  a.ks = static_cast<const float*>(ks_pages);
  a.vs = static_cast<const float*>(vs_pages);
  a.table = static_cast<const int*>(table);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.q_starts = static_cast<const int*>(q_starts);
  a.num_news = static_cast<const int*>(num_news);
  a.out = out;
  a.B = B; a.S = S; a.Hkv = Hkv; a.PS = PS; a.Tw = Tw; a.window = window;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool q8 = ks_pages != nullptr;
  if (dtype == 0) return q8 ? dispatch<true, true>(D, G, a)
                            : dispatch<true, false>(D, G, a);
  if (dtype == 1) return q8 ? dispatch<false, true>(D, G, a)
                            : dispatch<false, false>(D, G, a);
  return -1;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. window: 0 = no sliding window.
// Returns cudaGetLastError() after the launch, or -1 for a shape outside
// D = 128, G in {1, 4}.
extern "C" int dli_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* kv_lens, const void* q_starts,
    const void* num_news, void* out, int B, int S, int Hkv, int G, int D,
    int PS, int Tw, float scale, int window, int dtype, void* stream) {
  return run(q, k_pages, nullptr, v_pages, nullptr, table, kv_lens, q_starts,
             num_news, out, B, S, Hkv, G, D, PS, Tw, scale, window, dtype,
             stream);
}

// As dli_ragged_paged_attention over int8 pages: k_pages / v_pages int8
// [P, Hkv, PS, D], ks_pages / vs_pages f32 [P, Hkv, PS] (both non-null);
// dtype is q's and out's.
extern "C" int dli_quantized_ragged_paged_attention(
    const void* q, const void* k_pages, const void* ks_pages,
    const void* v_pages, const void* vs_pages, const void* table,
    const void* kv_lens, const void* q_starts, const void* num_news,
    void* out, int B, int S, int Hkv, int G, int D, int PS, int Tw,
    float scale, int window, int dtype, void* stream) {
  if (ks_pages == nullptr || vs_pages == nullptr) return -1;
  return run(q, k_pages, ks_pages, v_pages, vs_pages, table, kv_lens,
             q_starts, num_news, out, B, S, Hkv, G, D, PS, Tw, scale, window,
             dtype, stream);
}
