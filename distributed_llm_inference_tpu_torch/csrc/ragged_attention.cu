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
// query tile, from L2. Over int8 pages the bf16 kernel is held back further
// by turning every staged int8 tile into bf16 (issue slots and shared
// memory beside the products).
//
// bfloat16 queries (`ragged_kernel_wgmma`, kernels #1 and #4):
//
// * Work tile: 128 score rows a block, 128 / Gp queries x Gp rows a query,
//   Gp the group of G query heads a kv head rounded up to a power of two
//   (G = 3 takes 4 rows a query, G = 5..7 take 8): the rows of heads past G
//   are padding, read as zeros and never written, since Q comes and the
//   output goes through 5-D tensor maps {D, G, Hkv, S, B} whose boxes of Gp
//   heads run past the group. Two consumer warpgroups own 64 rows each and
//   share every
//   staged K/V tile; a producer warpgroup feeds them, and gives up registers
//   to them (setmaxnreg). The block walks the row's
//   slots 128 at a time (two pages at page size 64), from the first slot the
//   sliding window admits to the tile's causal frontier min(kv_len, q_start
//   + last query + 1), and no further; a tile of pad queries or an empty row
//   writes zeros at once.
// * Staging: a ring of stages in shared memory with full / empty mbarriers
//   (3 stages of bf16 K and V). The producer warp reads the row's page ids
//   from the table and brings K and V by TMA (cp.async.bulk.tensor.2d)
//   through tensor maps over each pool viewed as rows [P * Hkv * PS, D],
//   with the 128-byte swizzle. A box has gcd(PS, 64) rows, so it never
//   crosses a page and any page size works; a bf16 row comes as two boxes of
//   64 columns (the swizzle's limit), an int8 row as one. A box wholly past
//   the frontier is asked for at a negative row, which the TMA fills with
//   zeros. Q comes once a block by TMA through the 5-D map over q [B, S, Hq,
//   D], so rows past S (and heads past G) are zeros.
// * Products on wgmma, bf16 in, f32 accumulators: S = Q K^T with Q and K
//   K-major in shared memory (m64n128k16, D / 16 k-steps); P V (m64nDk16)
//   with P from
//   registers, rounded to bf16 as the TPU kernel rounds it (the score
//   accumulator's fragment is already the A operand), and V MN-major
//   (transposed by the instruction). The two warpgroups take turns at the
//   tensor cores (named barriers): one issues its next Q K^T and its P V
//   while the other runs its softmax, and a warpgroup's softmax runs while
//   its own P V is in flight.
// * Softmax in the log2 domain (log2(e) folded into the scale, ex2.approx).
//   The causal, window and length masks run only on steps that cross the
//   warpgroup's causal frontier, the window's start or kv_len. A masked
//   score is -inf, so its probability is exactly 0; the running max starts
//   at the finite kNegInf, so m_old - m_new is never inf - inf.
// * Output: each warpgroup writes its 64 rows, normalised and in bf16, into
//   its rows of the Q tile (free after its last Q K^T) and stores them by
//   TMA through a map over out, which leaves rows past S unwritten.
// * Schedule: the grid is (Hkv, B, query tiles) with the tile index
//   reversed, so the tiles with the longest causal walks start first.
// * int8 pages (#4): the TMA brings int8 K and V (half the bytes) into a
//   ring of 2 stages and the TMA warp's lanes bring each step's f32 K and V
//   scales by cp.async, on the same full barrier. The producer warpgroup's
//   other three warps turn each int8 stage into a swizzled bf16 stage
//   (exact: the byte is placed in the mantissa of 2^23 and the bias
//   subtracted, no conversion instructions) beside the consumers' products,
//   so the consumers read bf16 stages as for bf16 pages; converting in the
//   consumers would stall both warpgroups every step. A converted stage's K
//   is released once Q K^T is done and its V once P V is, a step later, so
//   the next K is converted while this V is still read. The scale arithmetic
//   is the TPU kernel's: the K scale multiplies each score, the V scale each
//   probability before P V, and l sums p itself. The TPU kernel keeps
//   p * vs in f32; one bf16 operand would round it to 2^-9 relative, a
//   bf16 output step at |out| >= 4 past the tolerance. So P V takes it as
//   two bf16 terms, hi = bf16(p * vs) and lo = bf16(p * vs - hi), two
//   products on the same V stage (about 2^-17 relative left).
// * The tensor maps are encoded per launch on the host
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, hopper_tile.cuh)
//   and passed as __grid_constant__ parameters; prefill runs eagerly.
//
// float32 queries (`ragged_kernel_f32`): register-tiled f32 FMAs, 256
// threads, 64 score rows (64 / G queries of G rows; the rows past the last
// whole query idle) and 64 slots a step, each thread a 4 x 4 patch of
// the score tile and 4 rows x D/16 columns of P V, with P going through
// shared memory. Full float32 products: the exact-parity checks of the
// engine run in this type, and TF32 would not pass them. Over int8 pages
// the staging converts rows to f32 and stages the scales beside them; p * vs
// stays in f32.
//
// Built for head_dim 64 and 128 (a D = 64 row is one 64-column half) with 1
// to 8 query heads per kv head: the group is a run-time argument of both
// kernels (the bf16 one reads it as a power-of-two shift, Gp = 2^shift).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "hopper_tile.cuh"

namespace {

using tile::group_shift;
using tile::pack_bf16;
using tile::stage_chunk;

// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// ---------------------------------------------------------------------------
// bfloat16 queries: TMA ring, wgmma
// ---------------------------------------------------------------------------

constexpr int kBlockRows = 128;  // score rows a block: two warpgroups of 64
constexpr int kStep = 128;       // kv slots a step
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kRowBytes = 128;   // a staged row: 64 bf16 or 128 int8
constexpr int kHalfBytes = kStep * kRowBytes;  // 128 rows of one half, 16 KB
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockRows == kStep, "Q and K/V halves share kHalfBytes");

// Shared memory, from a 1024-aligned base (the TMA's and wgmma's 128-byte
// swizzle repeats every 1024 bytes). A bf16 tile of 128 rows x D is D / 64
// 64-column halves of kHalfBytes; an int8 one is one plane of 128 rows of D
// bytes.
//
// bf16 pages: Q | a ring of 3 stages, each K's halves then V's | barriers.
// int8 pages: Q | the converted bf16 K/V, 2 stages | the int8 ring, 2
// stages of K and V planes | the K and V scales of each int8 stage |
// barriers. 226 KB of the 227 a block can have at D = 128, about half at
// D = 64.
template <bool Q8, int D>
struct WgLayout {
  static constexpr int kHalves = D / 64;  // 64-column halves of a bf16 row
  static constexpr int kStages = Q8 ? 2 : 3;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kQBytes = kHalves * kHalfBytes;
  static constexpr int kTile = kQBytes;  // bf16 K/V stages (ring or converted)
  static constexpr int kTileBytes = 2 * kHalves * kHalfBytes;
  static constexpr int kI8 = kTile + kStages * kTileBytes;  // int8 ring (Q8)
  static constexpr int kI8Plane = kStep * D;  // a step's int8 K (or V)
  static constexpr int kI8Bytes = 2 * kI8Plane;
  static constexpr int kScales = kI8 + (Q8 ? kStages * kI8Bytes : 0);
  static constexpr int kScaleBytes = 2 * kStep * 4;
  static constexpr int kBars = kScales + (Q8 ? kStages * kScaleBytes : 0);
  // q_full; bf16: full, empty; int8: full, empty and scales-empty of the
  // int8 ring, full and empty of the converted K and of the converted V.
  static constexpr int kNumBars = 1 + (Q8 ? 7 : 2) * kStages;
  static constexpr int kBytes = kBars + kNumBars * 8;
  // TMA bytes one ring stage receives.
  static constexpr int kTx = Q8 ? kI8Bytes : kTileBytes;
};

int box_rows_for(int PS) {  // gcd(PS, 64)
  int a = PS, b = 64;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The consumers' loop over one block's steps: warpgroup wg (0 or 1) owns
// block rows 64 wg .. 64 wg + 63, row r the query r >> gshift. `Tiles` says
// where step i's bf16 K and V lie, waits for them, releases them, and
// (int8) gives the step's scales. A step past a warpgroup's own frontier
// (its rows end up to 64 / Gp queries before the block's) is walked all
// the same and masked away: the products stay outside any branch, which
// keeps them pipelined.
template <int D, bool Q8, typename Tiles>
__device__ __forceinline__ void consume(
    const Tiles& tiles, const uint8_t* q_s, uint64_t* q_full,
    const CUtensorMap* o_map, int b, int h, int gshift,
    int tile_start, int num_new, int q_start, int kv_len, int first,
    int steps, int window, float scale_log2, int wg, int tid) {
  constexpr int kHalves = D / 64;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g4 = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g4;  // this thread's two rows
  const int row1 = row0 + 8;
  const int q_rel0 = tile_start + (row0 >> gshift);
  const int q_rel1 = tile_start + (row1 >> gshift);
  const int q_pos0 = q_start + q_rel0;
  const int q_pos1 = q_start + q_rel1;
  // The warpgroup's first query and its last real one.
  const int wq_lo = q_start + tile_start + ((wg * 64) >> gshift);
  const int wq_hi =
      q_start + min(tile_start + ((wg * 64 + 63) >> gshift), num_new - 1);
  // Scores are scaled to the log2 domain: by scale * log2(e) for bf16
  // pages, and per slot by that times the K scale for int8 pages (the
  // softmax below then multiplies by 1).
  const float mult = Q8 ? 1.f : scale_log2;
  const uint8_t* q_wg = q_s + wg * 64 * kRowBytes;

  float o[D / 2], s[64];
  uint32_t pa[kStep / 16][4];
  // int8 pages: the rounding of p * vs to bf16, P V's second operand.
  uint32_t pa_lo[Q8 ? kStep / 16 : 1][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // S = Q K^T over the warpgroup's 64 rows and step i's 128 slots.
  auto issue_s = [&](int i) {
    const uint8_t* k_t = tiles.k(i);
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
  // O = alpha O + P V over step i's 128 slots (alpha and P from step i's
  // softmax).
  float alpha0 = 1.f, alpha1 = 1.f;
  auto issue_pv = [&](int i) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    const uint8_t* v_t = tiles.v(i);
    // o += A V over one k-step: m64n128 over both halves of a D = 128 row,
    // m64n64 over the one half of a D = 64 row.
    auto pv = [&](const uint32_t (&a)[4], int kk) {
      const uint64_t desc =
          hopper::desc_sw128(v_t + kk * 16 * kRowBytes, kHalfBytes, 1024);
      if constexpr (D == 128)
        hopper::wgmma_m64n128k16_rs_tb(o, a, desc);
      else
        hopper::wgmma_m64n64k16_rs_tb(o, a, desc);
    };
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) pv(pa[kk], kk);
    if constexpr (Q8) {
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) pv(pa_lo[kk], kk);
    }
    hopper::wgmma_commit();
  };
  // P in bf16, as the TPU kernel rounds it: the score fragments of n-tiles
  // 2kk and 2kk + 1 are the A operand of k-step kk as they lie. int8 pages:
  // p * vs as hi = bf16(p * vs) and lo = bf16(p * vs - hi).
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
        pa[kk][r] = pack_bf16(a, b);
        if constexpr (Q8) {
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][r]);
          pa_lo[kk][r] = pack_bf16(a - __low2float(h), b - __high2float(h));
        }
      }
    }
  };
  // Online softmax of step i: the probabilities into s, l and m updated,
  // alpha the factor o takes before this step's P V.
  // s[4 nt + e] is row0 at slot nt * 8 + 2 t4 + e, s[4 nt + 2 + e] row1; a
  // row's 128 scores sit in the 4 lanes that share g4. The causal, window
  // and length masks run only on steps that cross the warpgroup's frontier,
  // its window's start or kv_len. A masked score is -inf, so its
  // probability is exactly 0; m starts at the finite kNegInf, so
  // m_old - m_new is never inf - inf.
  auto softmax = [&](int i) {
    const int kv0 = first + i * kStep;
    const bool inside = kv0 + kStep <= kv_len && kv0 + kStep - 1 <= wq_lo &&
                        (window <= 0 || kv0 > wq_hi - window);
    // A row sees the step's columns c with lo <= c + 2 t4 <= hi (this
    // thread's columns are nt * 8 + e + 2 t4).
    const int hi0 = min(q_pos0, kv_len - 1) - kv0 - 2 * t4;
    const int hi1 = min(q_pos1, kv_len - 1) - kv0 - 2 * t4;
    const int lo0 = window > 0 ? q_pos0 - window + 1 - kv0 - 2 * t4 : -kStep;
    const int lo1 = window > 0 ? q_pos1 - window + 1 - kv0 - 2 * t4 : -kStep;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * nt + e];
        float x1 = s[4 * nt + 2 + e];
        if constexpr (Q8) {
          // The converter warps folded scale * log2(e) into the K scales.
          const float2 f = tiles.k_scales(i, nt * 8 + 2 * t4);
          x0 *= e ? f.y : f.x;
          x1 *= e ? f.y : f.x;
        }
        if (!inside) {
          const int c = nt * 8 + e;
          if (c < lo0 || c > hi0) x0 = -INFINITY;
          if (c < lo1 || c > hi1) x1 = -INFINITY;
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
    const float mn0 = fmaxf(m0, mx0 * mult), mn1 = fmaxf(m1, mx1 * mult);
    alpha0 = hopper::exp2_approx(m0 - mn0);
    alpha1 = hopper::exp2_approx(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kStep / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = hopper::exp2_approx(fmaf(s[4 * nt + e], mult, -mn0));
        float p1 = hopper::exp2_approx(fmaf(s[4 * nt + 2 + e], mult, -mn1));
        sum0 += p0;
        sum1 += p1;
        // int8 pages: p * vs is what multiplies V; l sums p itself.
        if constexpr (Q8) {
          const float2 vq = tiles.v_scales(i, nt * 8 + 2 * t4);
          p0 *= e ? vq.y : vq.x;
          p1 *= e ? vq.y : vq.x;
        }
        s[4 * nt + e] = p0;
        s[4 * nt + 2 + e] = p1;
      }
    }
    if constexpr (Q8) tiles.release_scales(i, lane);
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

  hopper::mbar_wait(q_full, 0);
  if (steps > 0) {
    // Ping-pong: a warpgroup issues its products (Q K^T of this step, then
    // P V of the previous one) only after the other has issued its own, so
    // one runs its softmax while the other keeps the tensor cores busy; and
    // a warpgroup's softmax runs while its own P V is in flight. Warpgroup 0
    // starts; the arrivals on each barrier match its waits.
    if (wg == 1) hopper::named_arrive(2, kConsumers);
    tiles.wait_k(0);
    hopper::named_sync(2 + wg, kConsumers);
    issue_s(0);
    if (wg == 0 || steps > 1) hopper::named_arrive(2 + (wg ^ 1), kConsumers);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    tiles.release_k(0, lane);
    softmax(0);
    pack_p();
    for (int i = 1; i < steps; ++i) {
      tiles.wait_k(i);
      tiles.wait_v(i - 1);
      hopper::named_sync(2 + wg, kConsumers);
      issue_s(i);
      issue_pv(i - 1);
      if (wg == 0 || i + 1 < steps)
        hopper::named_arrive(2 + (wg ^ 1), kConsumers);
      hopper::wgmma_wait<1>();  // Q K^T of step i
      hopper::fence_regs(s);
      tiles.release_k(i, lane);
      softmax(i);
      hopper::wgmma_wait<0>();  // P V of step i - 1
      hopper::fence_regs(o);
      tiles.release_v(i - 1, lane);
      pack_p();
    }
    tiles.wait_v(steps - 1);
    issue_pv(steps - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    tiles.release_v(steps - 1, lane);
  }

  // The output goes through the warpgroup's Q rows, free since its last
  // Q K^T, in the layout of Q's tile, and out by TMA (rows past S are not
  // written). Pad queries (q_rel >= num_new) are zeros, whatever their q
  // held.
  const bool ok0 = q_rel0 < num_new, ok1 = q_rel1 < num_new;
  const float inv0 = ok0 ? 1.f / fmaxf(l0, 1e-20f) : 0.f;
  const float inv1 = ok1 ? 1.f / fmaxf(l1, 1e-20f) : 0.f;
  uint8_t* o_s = const_cast<uint8_t*>(q_wg);
  const int r0 = warp * 16 + g4;  // row0 and row1 in the warpgroup's rows
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* half = o_s + (j / 8) * kHalfBytes + 4 * t4;
    *reinterpret_cast<uint32_t*>(half + r0 * kRowBytes +
                                 (((j % 8) ^ (r0 & 7)) << 4)) =
        pack_bf16(ok0 ? o[4 * j] * inv0 : 0.f, ok0 ? o[4 * j + 1] * inv0 : 0.f);
    *reinterpret_cast<uint32_t*>(half + (r0 + 8) * kRowBytes +
                                 (((j % 8) ^ (r0 & 7)) << 4)) =
        pack_bf16(ok1 ? o[4 * j + 2] * inv1 : 0.f,
                  ok1 ? o[4 * j + 3] * inv1 : 0.f);
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

// bf16 pages: the consumers read the TMA ring's stages in place; K and V
// of a step arrive and leave together.
template <int D>
struct RingTiles {
  using L = WgLayout<false, D>;
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  static constexpr int kStages = L::kStages;
  __device__ const uint8_t* k(int i) const {
    return smem + L::kTile + (i % kStages) * L::kTileBytes;
  }
  __device__ const uint8_t* v(int i) const {
    return k(i) + L::kHalves * kHalfBytes;
  }
  __device__ void wait_k(int i) const {
    hopper::mbar_wait(&full[i % kStages], (i / kStages) & 1);
  }
  __device__ void wait_v(int) const {}
  __device__ void release_k(int, int) const {}
  __device__ void release_v(int i, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i % kStages]);
  }
};

// int8 pages: the consumers read the converted bf16 stages, and the K and V
// scales beside the int8 ring's stage. A stage's K is released once Q K^T
// is done and its V once P V is, a step later, so that the converter warps
// can turn the next int8 K into bf16 while this V is still in use.
template <int D>
struct ConvTiles {
  using L = WgLayout<true, D>;
  uint8_t* smem;
  uint64_t* kfull;
  uint64_t* kempty;
  uint64_t* vfull;
  uint64_t* vempty;
  uint64_t* sempty;
  static constexpr int kStages = L::kStages;
  __device__ const uint8_t* k(int i) const {
    return smem + L::kTile + (i % kStages) * L::kTileBytes;
  }
  __device__ const uint8_t* v(int i) const {
    return k(i) + L::kHalves * kHalfBytes;
  }
  __device__ const float* scales(int i) const {
    return reinterpret_cast<const float*>(smem + L::kScales +
                                          (i % kStages) * L::kScaleBytes);
  }
  // The (pre-scaled) K scales and the V scales of slots c, c + 1.
  __device__ float2 k_scales(int i, int c) const {
    return *reinterpret_cast<const float2*>(scales(i) + c);
  }
  __device__ float2 v_scales(int i, int c) const {
    return *reinterpret_cast<const float2*>(scales(i) + kStep + c);
  }
  __device__ void wait_k(int i) const {
    hopper::mbar_wait(&kfull[i % kStages], (i / kStages) & 1);
  }
  __device__ void wait_v(int i) const {
    hopper::mbar_wait(&vfull[i % kStages], (i / kStages) & 1);
  }
  __device__ void release_k(int i, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&kempty[i % kStages]);
  }
  __device__ void release_v(int i, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&vempty[i % kStages]);
  }
  __device__ void release_scales(int i, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sempty[i % kStages]);
  }
};

// Registers a thread after the producer warpgroup has given some up: the
// converter warps of int8 pages need more than the TMA warp alone.
template <bool Q8>
struct WgRegs {
  static constexpr int kProducer = Q8 ? 56 : 40;
  static constexpr int kConsumer = Q8 ? 224 : 232;
  static_assert(128 * kProducer + 256 * kConsumer == 384 * 168, "");
};

template <int D, bool Q8>
__global__ void __launch_bounds__(WgLayout<Q8, D>::kThreads, 1)
    ragged_kernel_wgmma(
        const __grid_constant__ CUtensorMap q_map,  // q as {D, G, Hkv, S, B}
        const __grid_constant__ CUtensorMap k_map,  // pool rows [P*Hkv*PS, D]
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap o_map,  // out, as q's, 64-row boxes
        const float* __restrict__ ks,               // [P, Hkv, PS] (Q8)
        const float* __restrict__ vs,               // [P, Hkv, PS] (Q8)
        const int* __restrict__ table,              // [B, Tw]
        const int* __restrict__ kv_lens,            // [B]
        const int* __restrict__ q_starts,           // [B]
        const int* __restrict__ num_news,           // [B]
        __nv_bfloat16* __restrict__ out,            // [B, S, Hkv*G, D]
        int S, int Hkv, int G, int gshift, int PS, int Tw, int box_rows,
        float scale_log2, int window) {
  using L = WgLayout<Q8, D>;
  constexpr int kHalves = L::kHalves;
  const int BQ = kBlockRows >> gshift;  // queries a block, Gp rows each
  constexpr int kStages = L::kStages;
  constexpr int kProducerRegs = WgRegs<Q8>::kProducer;
  constexpr int kConsumerRegs = WgRegs<Q8>::kConsumer;

  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* q_s = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;           // the TMA ring
  uint64_t* empty = full + kStages;
  uint64_t* sempty = empty + kStages;  // int8: scales read
  uint64_t* kfull = sempty + kStages;  // int8: converted K
  uint64_t* kempty = kfull + kStages;
  uint64_t* vfull = kempty + kStages;  // int8: converted V
  uint64_t* vempty = vfull + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tile_start = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int tid = threadIdx.x;
  const int Hq = Hkv * G;

  const int num_new = num_news[b];
  const int q_start = q_starts[b];
  const int kv_len = min(kv_lens[b], Tw * PS);

  if (tile_start >= num_new) {
    // Tile of pad queries only (or an empty row): zeros, no page touched.
    for (int c = tid; c < kBlockRows * (D / 8); c += L::kThreads) {
      const int r = c / (D / 8);
      const int q_rel = tile_start + (r >> gshift);
      const int g = r & ((1 << gshift) - 1);
      if (q_rel < S && g < G)
        *reinterpret_cast<uint4*>(
            out + (((size_t)b * S + q_rel) * Hq + h * G + g) * D +
            (c % (D / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // The layout needs the base the swizzle repeats on; a block without it
  // stops here rather than read misplaced rows.
  if (hopper::smem_u32(smem) & 1023) __trap();

  // Slots this tile can see: [first, end), walked in steps of kStep.
  const int last_q = min(tile_start + BQ, num_new) - 1;
  const int end = min(kv_len, q_start + last_q + 1);
  int first = 0;
  if (window > 0) first = max(0, q_start + tile_start - window + 1);
  first = (first / kStep) * kStep;
  const int steps = end > first ? (end - first + kStep - 1) / kStep : 0;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // int8: one more arrival from each TMA-warp lane's scale copies.
      hopper::mbar_init(&full[s], Q8 ? 1 + 32 : 1);
      if constexpr (Q8) {
        hopper::mbar_init(&empty[s], 3);  // the converter warps
        hopper::mbar_init(&sempty[s], kConsumers / 32);
        hopper::mbar_init(&kfull[s], 3);
        hopper::mbar_init(&kempty[s], kConsumers / 32);
        hopper::mbar_init(&vfull[s], 3);
        hopper::mbar_init(&vempty[s], kConsumers / 32);
      } else {
        hopper::mbar_init(&empty[s], kConsumers / 32);
      }
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The warp index, broadcast so that the compiler sees it warp-uniform
  // (the products below must not sit in a divergent path).
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (warp >= kConsumers / 32) {
    // The producer warpgroup gives registers to the consumers: 168 a
    // thread at launch, 128 x kProducerRegs + 256 x kConsumerRegs = 384 x 168.
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32) {
      // The TMA warp: Q once, then the ring.
      const int* trow = table + (size_t)b * Tw;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int c = 0; c < kHalves; ++c)
          hopper::tma_load_5d(q_s + c * kHalfBytes, &q_map, q_full, c * 64, 0,
                              h, tile_start, b);
      }
      for (int i = 0; i < steps; ++i) {
        const int st = i % kStages;
        const int kv0 = first + i * kStep;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        hopper::mbar_wait(&empty[st], parity);
        uint8_t* dst0;
        if constexpr (Q8) {
          hopper::mbar_wait(&sempty[st], parity);
          float* sc = reinterpret_cast<float*>(smem + L::kScales +
                                               st * L::kScaleBytes);
          for (int r = lane; r < kStep; r += 32) {
            const int pos = kv0 + r;
            const bool on = pos < end;
            const size_t slot =
                on ? ((size_t)trow[pos / PS] * Hkv + h) * PS + pos % PS : 0;
            hopper::cp_async_4(sc + r, ks + slot, on);
            hopper::cp_async_4(sc + kStep + r, vs + slot, on);
          }
          hopper::cp_async_arrive_noinc(&full[st]);
          dst0 = smem + L::kI8 + st * L::kI8Bytes;
        } else {
          dst0 = smem + L::kTile + st * L::kTileBytes;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[st], L::kTx);
          for (int r0 = 0; r0 < kStep; r0 += box_rows) {
            const int pos = kv0 + r0;
            // A box wholly past the frontier reads out of bounds: zeros.
            const int row =
                pos < end ? (trow[pos / PS] * Hkv + h) * PS + pos % PS
                          : -box_rows;
            if constexpr (Q8) {
              uint8_t* dst = dst0 + r0 * D;  // int8 rows of D bytes
              hopper::tma_load_2d(dst, &k_map, &full[st], 0, row);
              hopper::tma_load_2d(dst + L::kI8Plane, &v_map, &full[st], 0,
                                  row);
            } else {
              uint8_t* dst = dst0 + r0 * kRowBytes;
#pragma unroll
              for (int c = 0; c < kHalves; ++c) {
                hopper::tma_load_2d(dst + c * kHalfBytes, &k_map, &full[st],
                                    c * 64, row);
                hopper::tma_load_2d(dst + (kHalves + c) * kHalfBytes, &v_map,
                                    &full[st], c * 64, row);
              }
            }
          }
        }
      }
    } else if constexpr (Q8) {
      // Converter warps: each int8 stage into a converted bf16 stage, in
      // the layout the TMA gives bf16 tiles (two 64-column halves, 16-byte
      // chunk j of row r at j ^ (r % 8)), and the K scales times
      // scale * log2(e). They run beside the consumers' products, which take
      // the converted stages as the bf16 path takes the ring's.
      const int ct = tid - kConsumers - 32;  // 0 .. 95
      // Chunk c of a plane: row c / kCPR, 16 int8 at column 16 (c % kCPR);
      // a thread's chunks keep c % kCPR, as 96 is a multiple of kCPR. Four
      // are loaded before any is converted, so that their loads overlap.
      constexpr int kCPR = D / 16;  // 16-byte chunks of an int8 row
      constexpr int kChunks = kStep * kCPR;
      const int ch = ct % kCPR;
      const int j = (ch & 3) * 2;  // its first 16-byte chunk in bf16
      auto convert = [&](const uint8_t* src, uint8_t* dst) {
        for (int c0 = ct; c0 < kChunks; c0 += 4 * 96) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = c0 + u * 96;
            if (c < kChunks)
              v[u] = *reinterpret_cast<const uint4*>(
                  src + (c / kCPR) * D + ch * 16);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = c0 + u * 96;
            if (c >= kChunks) break;
            const int row = c / kCPR;
            uint32_t w[8];
            hopper::i8x4_to_bf16x2(v[u].x, w[0], w[1]);
            hopper::i8x4_to_bf16x2(v[u].y, w[2], w[3]);
            hopper::i8x4_to_bf16x2(v[u].z, w[4], w[5]);
            hopper::i8x4_to_bf16x2(v[u].w, w[6], w[7]);
            uint8_t* drow = dst + (ch >> 2) * kHalfBytes + row * kRowBytes;
            *reinterpret_cast<uint4*>(drow + ((j ^ (row & 7)) << 4)) =
                make_uint4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<uint4*>(drow + (((j + 1) ^ (row & 7)) << 4)) =
                make_uint4(w[4], w[5], w[6], w[7]);
          }
        }
        hopper::fence_proxy_async();
        __syncwarp();
      };
      for (int i = 0; i < steps; ++i) {
        const int st = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const uint8_t* src = smem + L::kI8 + st * L::kI8Bytes;
        uint8_t* dst = smem + L::kTile + st * L::kTileBytes;
        hopper::mbar_wait(&full[st], parity);
        hopper::mbar_wait(&kempty[st], parity ^ 1);
        convert(src, dst);
        float* sc =
            reinterpret_cast<float*>(smem + L::kScales + st * L::kScaleBytes);
        for (int r = ct; r < kStep; r += 96) sc[r] *= scale_log2;
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&kfull[st]);
        hopper::mbar_wait(&vempty[st], parity ^ 1);
        convert(src + L::kI8Plane, dst + kHalves * kHalfBytes);
        if (lane == 0) {
          hopper::mbar_arrive(&vfull[st]);
          hopper::mbar_arrive(&empty[st]);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    if constexpr (Q8)
      consume<D, true>(
          ConvTiles<D>{smem, kfull, kempty, vfull, vempty, sempty}, q_s,
          q_full, &o_map, b, h, gshift, tile_start, num_new, q_start, kv_len,
          first, steps, window, scale_log2, warp >> 2, tid);
    else
      consume<D, false>(RingTiles<D>{smem, full, empty}, q_s, q_full, &o_map,
                        b, h, gshift, tile_start, num_new, q_start, kv_len,
                        first, steps, window, scale_log2, warp >> 2, tid);
  }
}

template <int D, bool Q8>
int launch_wgmma(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int* table, const int* kv_lens,
                 const int* q_starts, const int* num_news, void* out, int B,
                 int S, int Hkv, int G, int PS, int Tw, float scale,
                 int window, cudaStream_t stream) {
  using L = WgLayout<Q8, D>;
  const int gshift = group_shift(G);
  const uint32_t gp = 1u << gshift;
  const uint64_t Hq = (uint64_t)Hkv * G;
  CUtensorMap q_map, k_map, v_map;
  // q and out as {D, G, Hkv, S, B}: a box of gp heads of one kv head and
  // 128 / gp queries; heads past G read as zeros and are not written.
  const uint64_t q_dims[5] = {(uint64_t)D, (uint64_t)G, (uint64_t)Hkv,
                              (uint64_t)S, (uint64_t)B};
  const uint64_t q_strides[4] = {(uint64_t)D * 2, (uint64_t)G * D * 2,
                                 Hq * D * 2, (uint64_t)S * Hq * D * 2};
  const uint32_t q_box[5] = {64, gp, 1, kBlockRows / gp, 1};
  int err = hopper::encode_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, q,
                               q_dims, q_strides, q_box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  CUtensorMap o_map;  // one consumer warpgroup's 64 rows
  const uint32_t o_box[5] = {64, gp, 1, 64 / gp, 1};
  err = hopper::encode_map(&o_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, out,
                           q_dims, q_strides, o_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  // The pool as rows of D. The interface does not pass the page count; the
  // wrapper checks that every row a table can name lies below 2^31, which
  // stands in for the extent (rows are only ever asked for by the table).
  const int box_rows = box_rows_for(PS);
  const uint64_t kv_dims[2] = {(uint64_t)D, 1ull << 31};
  const uint64_t kv_strides[1] = {(uint64_t)D * (Q8 ? 1 : 2)};
  const uint32_t kv_box[2] = {Q8 ? (uint32_t)D : 64u, (uint32_t)box_rows};
  const CUtensorMapDataType kv_type =
      Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle kv_swizzle =
      Q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  err = hopper::encode_map(&k_map, kv_type, 2, k, kv_dims, kv_strides, kv_box,
                           kv_swizzle);
  if (err != 0) return err;
  err = hopper::encode_map(&v_map, kv_type, 2, v, kv_dims, kv_strides, kv_box,
                           kv_swizzle);
  if (err != 0) return err;

  cudaError_t cerr = cudaFuncSetAttribute(
      ragged_kernel_wgmma<D, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int bq = kBlockRows >> gshift;
  const dim3 grid(Hkv, B, (S + bq - 1) / bq);
  ragged_kernel_wgmma<D, Q8><<<grid, L::kThreads, L::kBytes, stream>>>(
      q_map, k_map, v_map, o_map, ks, vs, table, kv_lens, q_starts, num_news,
      static_cast<__nv_bfloat16*>(out), S, Hkv, G, gshift, PS, Tw, box_rows,
      scale * kLog2e, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: register-tiled FMA products
// ---------------------------------------------------------------------------

constexpr int kRows = 64;   // score rows per block: (64 / G) queries x G
constexpr int kTile = 64;   // kv positions per step

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
template <int D, typename KV>
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
    int S, int Hkv, int G, int PS, int Tw, float scale, int window) {
  // Rows padded to an odd stride: the strided reads below (row tx + 16*j of
  // k_s, column tx + 16*jj of v_s) then hit distinct banks.
  constexpr bool Q8 = sizeof(KV) == 1;
  constexpr int SW = D + 1;
  constexpr int CPR = D / 4;          // 16-byte chunks per row of q
  constexpr int NW = D / 16;          // output columns per thread
  const int BQ = kRows / G;           // queries per tile
  const int rows = BQ * G;            // score rows in use

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
    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int r = idx / D;
      const int q_rel = tile_start + r / G;
      if (q_rel < S)
        out[(((size_t)b * S + q_rel) * Hq + h * G + r % G) * D + idx % D] = 0.f;
    }
    return;
  }

  // Stage the query tile once (zeros in the rows past the last query).
  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR;
    const int q_rel = tile_start + r / G;
    const float* src = nullptr;
    if (r < rows && q_rel < S)
      src = q + (((size_t)b * S + q_rel) * Hq + h * G + r % G) * D;
    stage_chunk(q_s + r * SW, src, c % CPR);
  }

  float m[4], l[4], acc[4][NW];
  int q_rel_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    // A row past the last query stands for none: past S, never written.
    q_rel_r[i] = ty * 4 + i < rows ? tile_start + (ty * 4 + i) / G : S;
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

template <int D, typename KV>
int launch_f32(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* table, const int* kv_lens,
               const int* q_starts, const int* num_news, void* out, int B,
               int S, int Hkv, int G, int PS, int Tw, float scale, int window,
               cudaStream_t stream) {
  const int bq = kRows / G;
  const size_t smem_bytes =
      ((size_t)(kRows + 2 * kTile) * (D + 1) + (size_t)kRows * kPStride +
       (sizeof(KV) == 1 ? 2 * kTile : 0)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel_f32<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + bq - 1) / bq, Hkv, B);
  ragged_kernel_f32<D, KV><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, table, kv_lens, q_starts, num_news,
      static_cast<float*>(out), S, Hkv, G, PS, Tw, scale, window);
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
  int B, S, Hkv, G, PS, Tw, window;
  float scale;
  cudaStream_t stream;
};

// BF16 picks the wgmma kernel; Q8 the int8 pages.
template <bool BF16, bool Q8, int D>
int launch(const Args& a) {
  if constexpr (BF16) {
    return launch_wgmma<D, Q8>(a.q, a.k, a.v, a.ks, a.vs, a.table, a.kv_lens,
                               a.q_starts, a.num_news, a.out, a.B, a.S, a.Hkv,
                               a.G, a.PS, a.Tw, a.scale, a.window, a.stream);
  } else {
    using KV = typename std::conditional<Q8, int8_t, float>::type;
    return launch_f32<D, KV>(a.q, a.k, a.v, a.ks, a.vs, a.table, a.kv_lens,
                             a.q_starts, a.num_news, a.out, a.B, a.S, a.Hkv,
                             a.G, a.PS, a.Tw, a.scale, a.window, a.stream);
  }
}

// The instances: head_dim 64 or 128, 1 to 8 query heads a kv head.
template <bool BF16, bool Q8>
int dispatch(int D, int G, const Args& a) {
  if (G < 1 || G > 8) return -1;
  if (D == 64) return launch<BF16, Q8, 64>(a);
  if (D == 128) return launch<BF16, Q8, 128>(a);
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
  a.B = B; a.S = S; a.Hkv = Hkv; a.G = G; a.PS = PS; a.Tw = Tw;
  a.window = window;
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
// Returns cudaGetLastError() after the launch, -1 for a shape outside
// D in {64, 128}, G in 1..8, or -2 if the driver refused a tensor map
// (bf16).
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

// The bf16 kernel's launch at these widths, as launch_wgmma makes it (the
// wrapper's `launch_plan` states the same in Python): out[0] rows a box,
// out[1] query tiles (the grid's z), out[2] threads a block, out[3] dynamic
// shared memory bytes, out[4] TMA bytes a ring stage receives, out[5]
// rows a query (the group rounded up to a power of two). Returns 0, or -1
// outside D in {64, 128}, G in 1..8.
template <int D>
void layout_plan(int q8, long long* out) {
  out[2] = q8 ? WgLayout<true, D>::kThreads : WgLayout<false, D>::kThreads;
  out[3] = q8 ? WgLayout<true, D>::kBytes : WgLayout<false, D>::kBytes;
  out[4] = q8 ? WgLayout<true, D>::kTx : WgLayout<false, D>::kTx;
}

extern "C" int dli_ragged_launch_plan(int S, int G, int D, int PS, int q8,
                                      long long* out) {
  if ((D != 64 && D != 128) || G < 1 || G > 8 || PS <= 0) return -1;
  const int gp = 1 << group_shift(G);
  out[0] = box_rows_for(PS);
  out[1] = (S + kBlockRows / gp - 1) / (kBlockRows / gp);
  if (D == 64)
    layout_plan<64>(q8, out);
  else
    layout_plan<128>(q8, out);
  out[5] = gp;
  return 0;
}
