// Flash attention over contiguous K/V under a boolean mask, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` behind `flash_attention` in
// distributed_llm_inference_tpu/ops/flash_attention.py: the prefill attention
// of the dense caches. q [B, S, Hkv*G, D], K and V [B, T, Hkv, D] (any
// strides over B, T and the head; rows of D contiguous), mask [B, S, T] one
// byte per (query, position), nonzero = attend. The mask alone says what a
// query sees: causality, cache validity, a sliding window and sink
// structure are all in it, and nothing is assumed in its place. Scores are
// f32, (q . k) * scale; a fully masked row gives zeros.
//
// What bounds it on this card: operations, the two products Q K^T and P V
// (4 * D flops per (query, head, visible position)). A mask tile with no
// visible position contributes nothing: in the TPU kernel such a tile is an
// exact no-op (its max is -0.7 * f32 max, alpha = 1, p = 0), so it is
// skipped here without reading K or V. Under a causal mask that skips the
// upper half.
//
// Design, the ragged kernel's (ragged_attention.cu) over a contiguous buffer:
// one block per (query tile, kv head, row). The G query heads of the kv head
// fold into the rows: a tile is 64 / G queries, 64 score rows. The block
// walks the positions 64 at a time: it stages the step's mask tile in shared
// memory, skips the step when the tile is empty, else stages K and V and
// runs one online-softmax step. The element type picks the products:
//
// * bfloat16: tensor cores, mma.sync m16n8k16 with f32 accumulation
//   (attention_tile.cuh); P is rounded to bf16 for P V, as the TPU kernel
//   rounds p to V's type.
// * float32: register-tiled f32 FMAs, as the ragged f32 kernel.
//
// The TPU kernel walks 128-wide tiles; this one 64-wide ones. In f32 that
// changes only the order of the sums; in bf16 also where p is rounded
// (relative to the running max at each tile), within one bf16 step.
//
// Built for head_dim 128 with 1 or 4 query heads per kv head; a model with
// other widths adds its instance to dispatch below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

struct Args {
  const void *q, *k, *v;
  const uint8_t* mask;
  void* out;
  int B, S, T, Hkv;
  long long ksb, kst, ksh, vsb, vst, vsh;  // element strides of K and V
  float scale;
  cudaStream_t stream;
};

// The step's mask tile [BQ][kTile] into shared memory (0 past S or T);
// returns, in every thread, whether any position of it is visible.
template <int BQ, int NTHREADS>
__device__ __forceinline__ bool stage_mask(uint8_t* mask_s,
                                           const uint8_t* mask, int b, int S,
                                           int T, int tile_start, int kv0) {
  int any = 0;
  for (int idx = threadIdx.x; idx < BQ * kTile; idx += NTHREADS) {
    const int qi = tile_start + idx / kTile;
    const int pos = kv0 + idx % kTile;
    uint8_t m = 0;
    if (qi < S && pos < T) m = mask[((size_t)b * S + qi) * T + pos] != 0;
    mask_s[idx] = m;
    any |= m;
  }
  return __syncthreads_or(any) != 0;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core products
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kRowPad = 8;  // bf16 elements (16 bytes) of padding per row

template <int D, int G>
__global__ void __launch_bounds__(kMmaThreads) flash_kernel_mma(Args a) {
  using bf16 = __nv_bfloat16;
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
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(v_s + kTile * SE);  // [BQ][kTile]

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const int S = a.S, T = a.T;
  const int tile_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g4 = lane >> 2;  // 0..7
  const int t4 = lane & 3;   // 0..3
  const int Hq = a.Hkv * G;

  for (int c = tid; c < kRows * CPR; c += kMmaThreads) {
    const int r = c / CPR;
    const int q_rel = tile_start + r / G;
    const bf16* src = nullptr;
    if (q_rel < S) src = q + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
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
  const uint8_t* mrow0 = mask_s + (row0 / G) * kTile;
  const uint8_t* mrow1 = mask_s + (row1 / G) * kTile;

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  const bf16* kb = k + (size_t)b * a.ksb + (size_t)h * a.ksh;
  const bf16* vb = v + (size_t)b * a.vsb + (size_t)h * a.vsh;
  for (int kv0 = 0; kv0 < T; kv0 += kTile) {
    __syncthreads();  // every warp is done with the previous tiles
    if (!stage_mask<BQ, kMmaThreads>(mask_s, a.mask, b, S, T, tile_start, kv0))
      continue;
    for (int c = tid; c < kTile * CPR; c += kMmaThreads) {
      const int r = c / CPR;
      const int pos = kv0 + r;
      const bf16* ksrc = nullptr;
      const bf16* vsrc = nullptr;
      if (pos < T) {
        ksrc = kb + (size_t)pos * a.kst;
        vsrc = vb + (size_t)pos * a.vst;
      }
      stage_chunk16(k_s + r * SE, ksrc, c % CPR);
      stage_chunk16(v_s + r * SE, vsrc, c % CPR);
    }
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
        const int col = nt * 8 + 2 * t4 + e;
        s[nt][e] = mrow0[col] ? s[nt][e] * a.scale : kNegInf;
        s[nt][2 + e] = mrow1[col] ? s[nt][2 + e] * a.scale : kNegInf;
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
        const int col = nt * 8 + 2 * t4 + e;
        // Masked entries are exactly 0: exp(kNegInf - kNegInf) would be 1.
        const float p0 = mrow0[col] ? expf(s[nt][e] - mn0) : 0.f;
        const float p1 = mrow1[col] ? expf(s[nt][2 + e] - mn1) : 0.f;
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

  // A row that saw nothing (fully masked, or past S) has l == 0: zeros.
  bf16* out = static_cast<bf16*>(a.out);
  const int q_rel0 = tile_start + row0 / G;
  const int q_rel1 = tile_start + row1 / G;
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

template <int D, int G>
int launch_mma(const Args& a) {
  constexpr int BQ = kRows / G;
  const size_t smem_bytes =
      (size_t)(kRows + 2 * kTile) * (D + kRowPad) * sizeof(__nv_bfloat16) +
      (size_t)BQ * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_mma<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + BQ - 1) / BQ, a.Hkv, a.B);
  flash_kernel_mma<D, G><<<grid, kMmaThreads, smem_bytes, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: register-tiled FMA products
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPStride = kTile + 1;

template <int D, int G>
__global__ void __launch_bounds__(kThreads) flash_kernel_f32(Args a) {
  // Rows padded to an odd stride: the strided reads below (row tx + 16*j of
  // k_s, column tx + 16*jj of v_s) then hit distinct banks.
  constexpr int SW = D + 1;
  constexpr int CPR = D / 4;          // 16-byte chunks per row
  constexpr int BQ = kRows / G;       // queries per tile
  constexpr int NW = D / 16;          // output columns per thread

  extern __shared__ float smem_f32[];
  float* q_s = smem_f32;                     // [kRows][SW]
  float* k_s = q_s + kRows * SW;             // [kTile][SW]
  float* v_s = k_s + kTile * SW;             // [kTile][SW]
  float* p_s = v_s + kTile * SW;             // [kRows][kPStride]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(p_s + kRows * kPStride);

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int S = a.S, T = a.T;
  const int tile_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // 0..15: owns score rows ty*4 .. ty*4+3
  const int tx = tid & 15;   // 0..15: owns slots tx + 16*j, columns tx + 16*jj
  const int Hq = a.Hkv * G;

  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR;
    const int q_rel = tile_start + r / G;
    const float* src = nullptr;
    if (q_rel < S) src = q + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
    stage_chunk(q_s + r * SW, src, c % CPR);
  }

  float m[4], l[4], acc[4][NW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) acc[i][jj] = 0.f;
  }

  const float* kb = k + (size_t)b * a.ksb + (size_t)h * a.ksh;
  const float* vb = v + (size_t)b * a.vsb + (size_t)h * a.vsh;
  for (int kv0 = 0; kv0 < T; kv0 += kTile) {
    __syncthreads();  // the previous step is done with its tiles
    if (!stage_mask<BQ, kThreads>(mask_s, a.mask, b, S, T, tile_start, kv0))
      continue;
    for (int c = tid; c < kTile * CPR; c += kThreads) {
      const int r = c / CPR;
      const int pos = kv0 + r;
      const float* ksrc = nullptr;
      const float* vsrc = nullptr;
      if (pos < T) {
        ksrc = kb + (size_t)pos * a.kst;
        vsrc = vb + (size_t)pos * a.vst;
      }
      stage_chunk(k_s + r * SW, ksrc, c % CPR);
      stage_chunk(v_s + r * SW, vsrc, c % CPR);
    }
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
      const uint8_t* mrow = mask_s + ((ty * 4 + i) / G) * kTile;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        valid[j] = mrow[tx + 16 * j] != 0;
        s[i][j] = valid[j] ? s[i][j] * a.scale : kNegInf;
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
        p_s[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
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

  // A row that saw nothing (fully masked, or past S) has l == 0: zeros.
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int q_rel = tile_start + r / G;
    if (q_rel >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* orow = out + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) orow[tx + 16 * jj] = acc[i][jj] * inv;
  }
}

template <int D, int G>
int launch_f32(const Args& a) {
  constexpr int BQ = kRows / G;
  const size_t smem_bytes =
      ((size_t)(kRows + 2 * kTile) * (D + 1) + (size_t)kRows * kPStride) *
          sizeof(float) +
      (size_t)BQ * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + BQ - 1) / BQ, a.Hkv, a.B);
  flash_kernel_f32<D, G><<<grid, kThreads, smem_bytes, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int D>
int dispatch_g(int G, const Args& a) {
  switch (G) {
    case 1: return BF16 ? launch_mma<D, 1>(a) : launch_f32<D, 1>(a);
    case 4: return BF16 ? launch_mma<D, 4>(a) : launch_f32<D, 4>(a);
  }
  return -1;
}

}  // namespace

// q [B, S, Hkv*G, D] contiguous; k / v [B, T, Hkv, D] with element strides
// (k_sb, k_st, k_sh) / (v_sb, v_st, v_sh) over B, T and the head, rows of D
// contiguous and 16-byte aligned; mask [B, S, T] bytes (nonzero = attend);
// out [B, S, Hkv*G, D]. dtype: 0 = bfloat16, 1 = float32 (q, k, v, out).
// Returns cudaGetLastError() after the launch, -1 for a shape outside
// D = 128, G in {1, 4}.
extern "C" int dli_flash_attention(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    int B, int S, int T, int Hkv, int G, int D, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D != 128) return -1;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.B = B; a.S = S; a.T = T; a.Hkv = Hkv;
  a.ksb = k_sb; a.kst = k_st; a.ksh = k_sh;
  a.vsb = v_sb; a.vst = v_st; a.vsh = v_sh;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_g<true, 128>(G, a);
  if (dtype == 1) return dispatch_g<false, 128>(G, a);
  return -1;
}
