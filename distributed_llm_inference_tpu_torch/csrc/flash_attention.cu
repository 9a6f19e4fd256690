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
// f32, (q . k) * scale; p is rounded to V's type before P V; a fully masked
// row gives zeros.
//
// What bounds it on this card: operations, the two products Q K^T and P V
// (4 * D flops per (query, head, visible position)). A mask tile with no
// visible position contributes nothing: in the TPU kernel such a tile is an
// exact no-op (its max is -0.7 * f32 max, alpha = 1, p = 0), so it is
// skipped here without reading K or V. Under a causal mask that skips the
// upper half.
//
// bfloat16 (`flash_kernel_wgmma`), the ragged kernel's Hopper design
// (ragged_attention.cu, hopper_tile.cuh) over a contiguous buffer:
//
// * The mask first: `mask_tiles_kernel` reads the byte mask once a call
//   (it is shared by every kv head) and writes it bit-packed, [B, S, 4 nKT]
//   32-bit words (bit i of word w of a row: position 32 w + i), and the
//   class of every (row, query tile, kv step) tile: empty (no visible
//   position), full (every position below T visible to every query below
//   S) or partial. A step is kStep = 128 positions wide, the TPU kernel's
//   block_k, so p is rounded at the running maxima the TPU kernel and the
//   plain version hold.
// * Work tile: 128 score rows a block, 128 / Gp queries x Gp rows a query,
//   Gp the group of G query heads a kv head rounded up to a power of two:
//   the rows of heads past G are padding, read as zeros and never written
//   (Q and the output go through 5-D tensor maps {D, G, Hkv, S, B} whose
//   boxes of Gp heads run past the group). The block first lists its
//   non-empty steps from the classes, then walks only those. Two consumer warpgroups own 64 rows
//   each and share every staged K/V tile; a producer warpgroup feeds them
//   and gives up registers to them (setmaxnreg).
// * Staging: a ring of 3 stages of K and V in shared memory with full /
//   empty mbarriers. One producer thread brings Q once and each listed
//   step's K and V by TMA through 4-D tensor maps over the strided views
//   (dimensions ordered by stride, 128-byte swizzle, D / 64 64-column
//   boxes of 128 rows a tile); rows past T (and queries past S) arrive as
//   zeros.
// * Products on wgmma (m64n128k16 for S, m64nDk16 for P V), bf16 in, f32
//   accumulators: S = Q K^T with
//   Q and K K-major in shared memory; P V with P from registers, rounded to
//   bf16 (the score accumulator's fragment is already the A operand), V
//   MN-major. The two warpgroups take turns at the tensor cores (named
//   barriers): one issues its next Q K^T and its P V while the other runs
//   its softmax, and a warpgroup's softmax runs while its own P V is in
//   flight.
// * Softmax in the log2 domain (log2(e) folded into the scale, ex2.approx).
//   A full step applies no mask; a partial one takes each thread's two rows'
//   128 bits of the step from the packed mask (loaded while Q K^T runs). A
//   masked score is -inf, so its probability is exactly 0; the running max
//   starts at the finite kNegInf, so m_old - m_new is never inf - inf, and
//   a row that sees nothing keeps l = 0 and writes zeros.
// * Output: each warpgroup writes its 64 rows, normalised and in bf16, into
//   its rows of the Q tile (free after its last Q K^T) and stores them by
//   TMA, which leaves rows past S unwritten.
// * Schedule: the grid is (Hkv, B, query tiles) with the tile index
//   reversed, so that under a causal mask the longest walks start first.
// * The tensor maps are encoded per launch on the host and passed as
//   __grid_constant__ parameters; prefill runs eagerly.
//
// float32 (`flash_kernel_f32`): register-tiled f32 FMAs, 256 threads, 64
// score rows (64 / G queries of G rows; the rows past the last whole query
// idle) and 64 positions a step, staging the step's byte mask and
// skipping an empty one. Full float32 products: the exact-parity checks of
// the engine run in this type. Its 64-wide steps change only the order of
// the sums against the TPU kernel's 128-wide ones.
//
// Built for head_dim 64 and 128 (template instances) with 1 to 8 query
// heads per kv head (a run-time argument of both kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "hopper_tile.cuh"

namespace {

using tile::group_shift;
using tile::pack_bf16;
using tile::stage_chunk;

// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

struct Args {
  const void *q, *k, *v;
  const uint8_t* mask;
  void* out;
  uint32_t* bits;       // bf16: [B, S, 4 nKT] packed mask
  uint8_t* classes;     // bf16: [B, nQT, nKT] tile classes
  int B, S, T, Hkv, G;
  long long ksb, kst, ksh, vsb, vst, vsh;  // element strides of K and V
  float scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// bfloat16: the mask's tiles, then TMA ring and wgmma
// ---------------------------------------------------------------------------

constexpr int kBlockRows = 128;  // score rows a block: two warpgroups of 64
constexpr int kStep = 128;       // kv positions a step (the TPU's block_k)
constexpr int kWords = kStep / 32;  // packed mask words of a row's step
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreadsWg = kConsumers + 128;
constexpr int kRowBytes = 128;   // a staged row of a half: 64 bf16
constexpr int kHalfBytes = kStep * kRowBytes;  // 128 rows of one half, 16 KB
constexpr int kStages = 3;
constexpr int kMaxSteps = 1024;  // kv steps a block can list: T <= 131072
constexpr float kLog2e = 1.4426950408889634f;
// Tile classes as mask_tiles_kernel writes them.
constexpr uint8_t kEmpty = 0, kFull = 1, kPartial = 2;
constexpr uint16_t kPartialBit = 0x8000;  // in a listed step: kt | bit

// Shared memory, from a 1024-aligned base (the TMA's and wgmma's 128-byte
// swizzle repeats every 1024 bytes): Q (D / 64 64-column halves of 128
// rows) | a ring of 3 stages, each K's halves then V's | the block's list
// of non-empty steps and its length | barriers (q_full, full[3], empty[3]).
// 226 KB of the 227 a block can have at D = 128.
template <int D>
struct WgLayout {
  static constexpr int kHalves = D / 64;
  static constexpr int kQBytes = kHalves * kHalfBytes;
  static constexpr int kTile = kQBytes;
  static constexpr int kTileBytes = 2 * kHalves * kHalfBytes;
  static constexpr int kList = kTile + kStages * kTileBytes;
  static constexpr int kCount = kList + kMaxSteps * 2;
  static constexpr int kBars = kCount + 16;
  static constexpr int kNumBars = 1 + 2 * kStages;
  static constexpr int kBytes = kBars + kNumBars * 8;
};
static_assert(WgLayout<128>::kBytes <= 232448, "shared memory of one block");

// 16 mask bytes as 16 bits, byte i -> bit i.
__device__ __forceinline__ uint32_t pack_bytes(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r |= ((w[i] >> (8 * j)) & 0xffu) != 0 ? 1u << (4 * i + j) : 0u;
  return r;
}

// One block per (kv step, query tile of BQ rows, row), BQ * 4 threads: the
// thread of (query r, word w) packs the 32 mask bytes of its word; then the
// block classes its tile. Queries past S and positions past T are not
// visible.
__global__ void mask_tiles_kernel(const uint8_t* __restrict__ mask,
                                  uint32_t* __restrict__ bits,
                                  uint8_t* __restrict__ classes, int S, int T,
                                  int BQ) {
  const int kt = blockIdx.x;
  const int qt = blockIdx.y;
  const int b = blockIdx.z;
  const int nkt = gridDim.x;
  const int q = qt * BQ + (threadIdx.x >> 2);
  const int w = threadIdx.x & 3;
  const int kv0 = kt * kStep + w * 32;
  uint32_t word = 0;
  if (q < S) {
    const uint8_t* row = mask + ((size_t)b * S + q) * T;
    if (kv0 + 32 <= T && ((reinterpret_cast<uintptr_t>(row) + kv0) & 15) == 0) {
      const uint4* p = reinterpret_cast<const uint4*>(row + kv0);
      word = pack_bytes(p[0]) | (pack_bytes(p[1]) << 16);
    } else {
      for (int i = 0; i < 32 && kv0 + i < T; ++i)
        word |= row[kv0 + i] != 0 ? 1u << i : 0u;
    }
    bits[((size_t)b * S + q) * (nkt * kWords) + kt * kWords + w] = word;
  }
  const int any = __syncthreads_or(q < S && word != 0u);
  const int all = __syncthreads_and(q >= S || word == 0xffffffffu);
  if (threadIdx.x == 0)
    classes[((size_t)b * gridDim.y + qt) * nkt + kt] =
        !any ? kEmpty : all ? kFull : kPartial;
}

// The consumers' loop over the block's listed steps: warpgroup wg (0 or 1)
// owns block rows 64 wg .. 64 wg + 63, row r the query r >> gshift. Every
// listed step is walked by both warpgroups; the products stay outside any
// branch, which keeps them pipelined.
template <int D>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint64_t* q_full, uint64_t* full, uint64_t* empty,
    const uint16_t* list, int steps, const CUtensorMap* o_map,
    const uint32_t* __restrict__ bits, int b, int h, int gshift,
    int tile_start, int S, int row_words, float scale_log2, int wg,
    int tid) {
  using L = WgLayout<D>;
  constexpr int kHalves = L::kHalves;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g4;  // this thread's two rows
  const int row1 = row0 + 8;
  const int q_rel0 = tile_start + (row0 >> gshift);
  const int q_rel1 = tile_start + (row1 >> gshift);
  // The packed mask rows of the two queries (none past S: not visible).
  const uint32_t* bits0 =
      q_rel0 < S ? bits + ((size_t)b * S + q_rel0) * row_words : nullptr;
  const uint32_t* bits1 =
      q_rel1 < S ? bits + ((size_t)b * S + q_rel1) * row_words : nullptr;
  const uint8_t* q_wg = smem + wg * 64 * kRowBytes;
  auto k_tile = [&](int i) {
    return smem + L::kTile + (i % kStages) * L::kTileBytes;
  };

  float o[D / 2], s[64];
  uint32_t pa[kStep / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  uint32_t mw0[kWords], mw1[kWords];  // a partial step's mask bits

  // S = Q K^T over the warpgroup's 64 rows and step i's 128 positions.
  auto issue_s = [&](int i) {
    const uint8_t* k_t = k_tile(i);
    hopper::wgmma_fence();
    hopper::wgmma_m64n128k16_ss_first(
        s, hopper::desc_sw128(q_wg, 16, 1024),
        hopper::desc_sw128(k_t, 16, 1024));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
      hopper::wgmma_m64n128k16_ss(s, hopper::desc_sw128(q_wg + off, 16, 1024),
                                  hopper::desc_sw128(k_t + off, 16, 1024));
    }
    hopper::wgmma_commit();
  };
  // O = alpha O + P V over step i's 128 positions.
  float alpha0 = 1.f, alpha1 = 1.f;
  auto issue_pv = [&](int i) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    const uint8_t* v_t = k_tile(i) + kHalves * kHalfBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      const uint64_t desc =
          hopper::desc_sw128(v_t + kk * 16 * kRowBytes, kHalfBytes, 1024);
      if constexpr (D == 128)
        hopper::wgmma_m64n128k16_rs_tb(o, pa[kk], desc);
      else
        hopper::wgmma_m64n64k16_rs_tb(o, pa[kk], desc);
    }
    hopper::wgmma_commit();
  };
  // P in bf16, as the TPU kernel rounds it: the score fragments of n-tiles
  // 2kk and 2kk + 1 are the A operand of k-step kk as they lie.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // A partial step's mask bits of the two rows, loaded before the step's
  // Q K^T so that the load overlaps it.
  auto load_mask = [&](int i) {
    const uint16_t e = list[i];
    if (!(e & kPartialBit)) return;
    const int kt = e & ~kPartialBit;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), c = a;
    if (bits0 != nullptr)
      a = *reinterpret_cast<const uint4*>(bits0 + kt * kWords);
    if (bits1 != nullptr)
      c = *reinterpret_cast<const uint4*>(bits1 + kt * kWords);
    mw0[0] = a.x; mw0[1] = a.y; mw0[2] = a.z; mw0[3] = a.w;
    mw1[0] = c.x; mw1[1] = c.y; mw1[2] = c.z; mw1[3] = c.w;
  };
  // Online softmax of step i: the probabilities into s, l and m updated,
  // alpha the factor o takes before this step's P V. s[4 nt + e] is row0 at
  // position nt * 8 + 2 t4 + e of the step, s[4 nt + 2 + e] row1; a row's
  // 128 scores sit in the 4 lanes that share g4. Only a partial step is
  // masked: position c of a row is bit c % 32 of its word c / 32.
  auto softmax = [&](int i) {
    const bool partial = (list[i] & kPartialBit) != 0;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * nt + e];
        float x1 = s[4 * nt + 2 + e];
        if (partial) {
          const int bit = (nt % 4) * 8 + 2 * t4 + e;
          if (!((mw0[nt / 4] >> bit) & 1u)) x0 = -INFINITY;
          if (!((mw1[nt / 4] >> bit) & 1u)) x1 = -INFINITY;
        }
        s[4 * nt + e] = x0;
        s[4 * nt + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    alpha0 = hopper::exp2_approx(m0 - mn0);
    alpha1 = hopper::exp2_approx(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 =
            hopper::exp2_approx(fmaf(s[4 * nt + e], scale_log2, -mn0));
        const float p1 =
            hopper::exp2_approx(fmaf(s[4 * nt + 2 + e], scale_log2, -mn1));
        sum0 += p0;
        sum1 += p1;
        s[4 * nt + e] = p0;
        s[4 * nt + 2 + e] = p1;
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
  };
  auto wait_full = [&](int i) {
    hopper::mbar_wait(&full[i % kStages], (i / kStages) & 1);
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i % kStages]);
  };

  hopper::mbar_wait(q_full, 0);
  if (steps > 0) {
    // Ping-pong, as in ragged_attention.cu: a warpgroup issues its products
    // (Q K^T of this step, then P V of the previous one) only after the
    // other has issued its own. Warpgroup 0 starts; the arrivals on each
    // barrier match its waits.
    if (wg == 1) hopper::named_arrive(2, kConsumers);
    load_mask(0);
    wait_full(0);
    hopper::named_sync(2 + wg, kConsumers);
    issue_s(0);
    if (wg == 0 || steps > 1) hopper::named_arrive(2 + (wg ^ 1), kConsumers);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    softmax(0);
    pack_p();
    for (int i = 1; i < steps; ++i) {
      load_mask(i);
      wait_full(i);
      hopper::named_sync(2 + wg, kConsumers);
      issue_s(i);
      issue_pv(i - 1);
      if (wg == 0 || i + 1 < steps)
        hopper::named_arrive(2 + (wg ^ 1), kConsumers);
      hopper::wgmma_wait<1>();  // Q K^T of step i
      hopper::fence_regs(s);
      softmax(i);
      hopper::wgmma_wait<0>();  // P V of step i - 1
      hopper::fence_regs(o);
      release(i - 1);
      pack_p();
    }
    issue_pv(steps - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    release(steps - 1);
  }

  // The output goes through the warpgroup's Q rows, free since its last
  // Q K^T, in the layout of Q's tile, and out by TMA (rows past S are not
  // written). A row that saw nothing has o = 0 and l = 0: zeros.
  const float inv0 = 1.f / fmaxf(l0, 1e-20f);
  const float inv1 = 1.f / fmaxf(l1, 1e-20f);
  uint8_t* o_s = const_cast<uint8_t*>(q_wg);
  const int r0 = warp * 16 + g4;  // row0 and row1 in the warpgroup's rows
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* half = o_s + (j / 8) * kHalfBytes + 4 * t4;
    *reinterpret_cast<uint32_t*>(half + r0 * kRowBytes +
                                 (((j % 8) ^ (r0 & 7)) << 4)) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(half + (r0 + 8) * kRowBytes +
                                 (((j % 8) ^ (r0 & 7)) << 4)) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  hopper::fence_proxy_async();
  hopper::named_sync(4 + wg, 128);
  if ((tid & 127) == 0) {
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
      hopper::tma_store_5d(o_map, o_s + c * kHalfBytes, c * 64, 0, h,
                           tile_start + ((wg * 64) >> gshift), b);
    hopper::tma_store_wait();
  }
}

// Registers a thread after the producer warpgroup has given some up:
// 128 x 40 + 256 x 232 = 384 x 168.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int D>
__global__ void __launch_bounds__(kThreadsWg, 1) flash_kernel_wgmma(
    const __grid_constant__ CUtensorMap q_map,  // q as {D, G, Hkv, S, B}
    const __grid_constant__ CUtensorMap k_map,  // K, 4-D, by stride
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap o_map,  // out, as q's, 64-row boxes
    const uint32_t* __restrict__ bits,          // [B, S, 4 nKT]
    const uint8_t* __restrict__ classes,        // [B, nQT, nKT]
    int S, int gshift, int nkt, int k_t_inner, int v_t_inner,
    float scale_log2) {
  using L = WgLayout<D>;
  constexpr int kHalves = L::kHalves;
  const int BQ = kBlockRows >> gshift;

  extern __shared__ __align__(1024) uint8_t smem[];
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + L::kList);
  int* count = reinterpret_cast<int*>(smem + L::kCount);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int tile_start = qt * BQ;
  const int tid = threadIdx.x;
  // The layout needs the base the swizzle repeats on; a block without it
  // stops here rather than read misplaced rows.
  if (hopper::smem_u32(smem) & 1023) __trap();

  // The warp index, broadcast so that the compiler sees it warp-uniform
  // (the products below must not sit in a divergent path).
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (warp == 0) {
    if (lane == 0) {
      hopper::mbar_init(q_full, 1);
      for (int s = 0; s < kStages; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], kConsumers / 32);
      }
      hopper::mbar_fence_init();
    }
    // The tile's non-empty steps in order, kt | kPartialBit for a partial
    // one (the wrapper keeps nkt <= kMaxSteps).
    const uint8_t* cls = classes + ((size_t)b * gridDim.z + qt) * nkt;
    int n = 0;
    for (int base = 0; base < nkt; base += 32) {
      const int kt = base + lane;
      const uint8_t c = kt < nkt ? cls[kt] : kEmpty;
      const uint32_t live = __ballot_sync(0xffffffffu, c != kEmpty);
      const int at = n + __popc(live & ((1u << lane) - 1u));
      if (c != kEmpty && at < kMaxSteps)
        list[at] = (uint16_t)(kt | (c == kPartial ? kPartialBit : 0));
      n += __popc(live);
    }
    if (lane == 0) *count = min(n, kMaxSteps);
  }
  __syncthreads();
  const int steps = *count;

  if (warp >= kConsumers / 32) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      // Q once, then each listed step's K and V: per tile two 64-column
      // boxes of 128 rows, coordinates innermost first in the map's order.
      hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
        hopper::tma_load_5d(smem + c * kHalfBytes, &q_map, q_full, c * 64, 0,
                            h, tile_start, b);
      for (int i = 0; i < steps; ++i) {
        const int st = i % kStages;
        const int kv0 = (list[i] & ~kPartialBit) * kStep;
        hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], L::kTileBytes);
        uint8_t* dst = smem + L::kTile + st * L::kTileBytes;
#pragma unroll
        for (int c = 0; c < kHalves; ++c) {
          uint8_t* vdst = dst + (kHalves + c) * kHalfBytes;
          if (k_t_inner)
            hopper::tma_load_4d(dst + c * kHalfBytes, &k_map, &full[st],
                                c * 64, kv0, h, b);
          else
            hopper::tma_load_4d(dst + c * kHalfBytes, &k_map, &full[st],
                                c * 64, h, kv0, b);
          if (v_t_inner)
            hopper::tma_load_4d(vdst, &v_map, &full[st], c * 64, kv0, h, b);
          else
            hopper::tma_load_4d(vdst, &v_map, &full[st], c * 64, h, kv0, b);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    consume<D>(smem, q_full, full, empty, list, steps, &o_map, bits, b, h,
               gshift, tile_start, S, nkt * kWords, scale_log2, warp >> 2,
               tid);
  }
}

// A 4-D map over a strided [B, T, Hkv, D] view: D, then T and the head in
// the order of their strides (time-major or head-major storage), then B.
// Sets t_inner when T comes before the head.
int kv_map(CUtensorMap* map, const void* base, int B, int T, int Hkv, int D,
           long long sb, long long st, long long sh, int& t_inner) {
  t_inner = st <= sh;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)(t_inner ? T : Hkv),
                            (uint64_t)(t_inner ? Hkv : T), (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)(t_inner ? st : sh) * 2,
                               (uint64_t)(t_inner ? sh : st) * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, t_inner ? (uint32_t)kStep : 1u,
                           t_inner ? 1u : (uint32_t)kStep, 1};
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                            dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

int launch_mask_tiles(const uint8_t* mask, uint32_t* bits, uint8_t* classes,
                      int B, int S, int T, int BQ, cudaStream_t stream) {
  const int nkt = (T + kStep - 1) / kStep;
  const dim3 grid(nkt, (S + BQ - 1) / BQ, B);
  mask_tiles_kernel<<<grid, BQ * kWords, 0, stream>>>(mask, bits, classes, S,
                                                      T, BQ);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(const Args& a) {
  using L = WgLayout<D>;
  const int gshift = group_shift(a.G);
  const uint32_t gp = 1u << gshift;
  const int BQ = kBlockRows >> gshift;
  const int nkt = (a.T + kStep - 1) / kStep;
  if (nkt > kMaxSteps) return -1;
  int err = launch_mask_tiles(a.mask, a.bits, a.classes, a.B, a.S, a.T, BQ,
                              a.stream);
  if (err != 0) return err;
  const uint64_t Hq = (uint64_t)a.Hkv * a.G;
  CUtensorMap q_map, o_map, k_map, v_map;
  // q and out as {D, G, Hkv, S, B}: a box of gp heads of one kv head and
  // BQ queries; heads past G read as zeros and are not written.
  const uint64_t q_dims[5] = {(uint64_t)D, (uint64_t)a.G, (uint64_t)a.Hkv,
                              (uint64_t)a.S, (uint64_t)a.B};
  const uint64_t q_strides[4] = {(uint64_t)D * 2, (uint64_t)a.G * D * 2,
                                 Hq * D * 2, (uint64_t)a.S * Hq * D * 2};
  const uint32_t q_box[5] = {64, gp, 1, (uint32_t)BQ, 1};
  err = hopper::encode_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, a.q,
                           q_dims, q_strides, q_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const uint32_t o_box[5] = {64, gp, 1, 64 / gp, 1};
  err = hopper::encode_map(&o_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, a.out,
                           q_dims, q_strides, o_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  int k_t_inner = 0, v_t_inner = 0;
  err = kv_map(&k_map, a.k, a.B, a.T, a.Hkv, D, a.ksb, a.kst, a.ksh,
               k_t_inner);
  if (err != 0) return err;
  err = kv_map(&v_map, a.v, a.B, a.T, a.Hkv, D, a.vsb, a.vst, a.vsh,
               v_t_inner);
  if (err != 0) return err;

  cudaError_t cerr = cudaFuncSetAttribute(
      flash_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(a.Hkv, a.B, (a.S + BQ - 1) / BQ);
  flash_kernel_wgmma<D><<<grid, kThreadsWg, L::kBytes, a.stream>>>(
      q_map, k_map, v_map, o_map, a.bits, a.classes, a.S, gshift, nkt,
      k_t_inner, v_t_inner, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: register-tiled FMA products
// ---------------------------------------------------------------------------

constexpr int kRows = 64;   // score rows per block: (64 / G) queries x G
constexpr int kTile = 64;   // kv positions per step
constexpr int kThreads = 256;
constexpr int kPStride = kTile + 1;

// The step's mask tile [BQ][kTile] into shared memory (0 past S or T);
// returns, in every thread, whether any position of it is visible.
template <int NTHREADS>
__device__ __forceinline__ bool stage_mask(uint8_t* mask_s,
                                           const uint8_t* mask, int b, int S,
                                           int T, int BQ, int tile_start,
                                           int kv0) {
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


template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel_f32(Args a) {
  // Rows padded to an odd stride: the strided reads below (row tx + 16*j of
  // k_s, column tx + 16*jj of v_s) then hit distinct banks.
  constexpr int SW = D + 1;
  constexpr int CPR = D / 4;          // 16-byte chunks per row
  constexpr int NW = D / 16;          // output columns per thread
  const int G = a.G;
  const int BQ = kRows / G;           // queries per tile
  const int rows = BQ * G;            // score rows in use

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
    if (r < rows && q_rel < S)
      src = q + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
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
    if (!stage_mask<kThreads>(mask_s, a.mask, b, S, T, BQ, tile_start, kv0))
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
      // A row past the last query sees nothing.
      const bool row_ok = ty * 4 + i < rows;
      const uint8_t* mrow = mask_s + (row_ok ? (ty * 4 + i) / G : 0) * kTile;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        valid[j] = row_ok && mrow[tx + 16 * j] != 0;
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
    if (r >= rows || q_rel >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* orow = out + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) orow[tx + 16 * jj] = acc[i][jj] * inv;
  }
}

template <int D>
int launch_f32(const Args& a) {
  const int BQ = kRows / a.G;
  const size_t smem_bytes =
      ((size_t)(kRows + 2 * kTile) * (D + 1) + (size_t)kRows * kPStride) *
          sizeof(float) +
      (size_t)BQ * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + BQ - 1) / BQ, a.Hkv, a.B);
  flash_kernel_f32<D><<<grid, kThreads, smem_bytes, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_d(int dtype, const Args& a) {
  if (dtype == 0) return launch_wgmma<D>(a);
  if (dtype == 1) return launch_f32<D>(a);
  return -1;
}

}  // namespace

// q [B, S, Hkv*G, D] contiguous; k / v [B, T, Hkv, D] with element strides
// (k_sb, k_st, k_sh) / (v_sb, v_st, v_sh) over B, T and the head, rows of D
// contiguous and 16-byte aligned (strides too, for the tensor maps); mask
// [B, S, T] bytes (nonzero = attend); out [B, S, Hkv*G, D]. dtype: 0 =
// bfloat16, 1 = float32 (q, k, v, out). bf16 also takes the packed mask
// `bits` [B, S, 4 nKT] int32 and the tile `classes` [B, nQT, nKT] uint8 as
// scratch, nKT = ceil(T / 128) <= 1024, nQT = ceil(S / (128 / Gp)), Gp
// the group rounded up to a power of two; f32 ignores them. Returns
// cudaGetLastError() after the launches, -1 for a shape outside D in
// {64, 128}, G in 1..8, nKT <= 1024, or -2 if the driver refused a tensor
// map.
extern "C" int dli_flash_attention(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* bits, void* classes, int B, int S, int T, int Hkv, int G, int D,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if ((D != 64 && D != 128) || G < 1 || G > 8) return -1;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.bits = static_cast<uint32_t*>(bits);
  a.classes = static_cast<uint8_t*>(classes);
  a.B = B; a.S = S; a.T = T; a.Hkv = Hkv; a.G = G;
  a.ksb = k_sb; a.kst = k_st; a.ksh = k_sh;
  a.vsb = v_sb; a.vst = v_st; a.vsh = v_sh;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return D == 64 ? dispatch_d<64>(dtype, a) : dispatch_d<128>(dtype, a);
}

// The bf16 kernel's first pass alone: mask [B, S, T] bytes into `bits`
// [B, S, 4 ceil(T / 128)] and `classes` [B, ceil(S / BQ), ceil(T / 128)]
// (0 empty, 1 full, 2 partial) for query tiles of BQ rows (BQ * 4 <= 1024).
// Returns cudaGetLastError() after the launch.
extern "C" int dli_flash_mask_tiles(const void* mask, void* bits,
                                    void* classes, int B, int S, int T,
                                    int BQ, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return 0;
  if (BQ <= 0 || BQ * kWords > 1024) return -1;
  return launch_mask_tiles(static_cast<const uint8_t*>(mask),
                           static_cast<uint32_t*>(bits),
                           static_cast<uint8_t*>(classes), B, S, T, BQ,
                           static_cast<cudaStream_t>(stream));
}
