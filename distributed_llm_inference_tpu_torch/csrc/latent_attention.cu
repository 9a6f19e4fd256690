// Absorbed-MLA attention over the latent page pool, for Hopper (sm_90a):
// the kernels behind the four latent wrappers of the port,
//
// * ops/ragged_attention.py: `latent_ragged_paged_attention` and
//   `quantized_latent_ragged_paged_attention` (prefill, chunk and decode
//   rows in one launch), which replace the JAX package's same-named
//   wrappers over `_ragged_kernel` / `_qragged_kernel`
//   (distributed_llm_inference_tpu/ops/ragged_attention.py:435, :467);
// * ops/paged_attention.py: `latent_paged_attention` and
//   `quantized_latent_paged_attention` (one query a row, m and l for
//   return_stats), which replace the wrappers over `_paged_kernel` /
//   `_qpaged_kernel` (distributed_llm_inference_tpu/ops/paged_attention.py:
//   445, :469).
//
// The function: one layer's pool holds one fused latent [c ; k_rope] of
// lat_dim D values a token, [P, 1, PS, D] f32 (or int8 with a per-token f32
// scale [P, 1, PS]); the query is the absorbed [B, S, G, D] (G = every query
// head, over the one latent head), and K = V = the stored latent. The JAX
// kernels promote q to f32 and keep p * vs in f32; only the output is
// rounded to q's type. No TF32 here: the engine's exact-stream checks need
// f32 products, as the per-head f32 kernels do.
//
// What bounds it on this card. Decode (B = 8 over 2048 tokens at D = 576,
// G = 16): bytes. 37.7 MB of f32 latents, 11 us at 3.35 TB/s (9.5 MB over
// the int8 pool, 2.8 us), against 0.60 GFLOP, 9 us at the CUDA cores' 67
// TFLOP/s, or, for the bf16 passes that f32-grade products need on the
// tensor cores, 1.5 us (5 passes, f32 pool) and 0.9 us (3, int8). A ragged
// prefill of
// 2048 queries: operations (77 GFLOP, 1.15 ms in f32 on the CUDA cores;
// on the tensor cores the bf16 passes that f32-grade products need, 5 over
// the f32 pool (0.1955 ms) and 3 over the int8 one (0.1173 ms)).
//
// The ragged form with bf16 queries at lat_dim 576 (latent_wgmma_kernel,
// in namespace wg below; DeepSeek-V2/V3's 512 + 64) runs on the tensor
// cores. The design:
//
// * Block: 64 score rows (64 >> gshift queries of G heads, G rounded up to
//   a power of two, padding heads zeros, never written), a producer
//   warpgroup and three consumer warpgroups (512 threads, one block an
//   SM). The grid is (query tiles, B), the tiles reversed: the longest
//   causal walks start first.
// * One swizzled tile serves as both K and V: a step's tile is 32 rows of
//   576 bf16 in 64-column (128-byte) blocks with the 128-byte swizzle. Read
//   K-major it is Q K^T's B operand (m64n32k16); read MN-major, with LBO
//   the distance between the blocks, P V's (m64n192k16, P from registers).
//   Over the int8 pool a row is a position (32 a step); over the f32 pool
//   position j's hi = bf16(x) is row 2j and its lo = bf16(x - hi) row 2j +
//   1 (16 positions a step).
// * Precision, f32-grade with no TF32 and no f32 operand rounded once to
//   bf16. int8: K is exact in bf16 and q is bf16, so Q K^T is one pass,
//   exact up to the order of the sum; P V takes p * vs as hi = bf16(p vs)
//   and lo = bf16(p vs - hi), two passes over the tile. f32: Q K^T meets
//   each position's hi and lo rows as two adjacent columns, added in f32
//   (two passes' work in one instruction); P V takes p as p_hi + p_lo,
//   each term against both rows (four passes: p_hi V_hi + p_hi V_lo +
//   p_lo V_hi + p_lo V_lo; the last, about 2^-32 of the result, is not
//   needed, but the hi and lo rows meet both terms of p in the same
//   k-steps). About 2^-17 of each operand is left before the output's bf16
//   rounding. The scales are the TPU kernel's: the K scale
//   multiplies the score, the V scale p before P V, l sums p.
// * The accumulator O [64 x 576] f32 (288 registers a thread in one
//   warpgroup) is split by columns: each consumer warpgroup owns three of
//   the nine column blocks (96 registers of O). Q K^T is split the same
//   way, over depth: each warpgroup's partial S over its 192 columns goes
//   through shared memory and all three sum the partials in one fixed
//   order, so every warpgroup holds the same S, m, l and P. setmaxnreg
//   gives the producer 32 registers a thread and the consumers 160.
// * Loads in flight without the consumers' registers: the producer's
//   first warp reads the page table a step ahead and brings each piece of
//   positions by the bulk-copy engine (one copy a piece where its page
//   holds it whole, else one a row; int8 scales by cp.async), counted on
//   the piece's mbarrier; its other three warps convert each landed piece
//   (f32: the hi / lo split; int8: the exact conversion, and the scales)
//   into a ring of converted tiles beside the consumers' products.
// * Shared memory (232,448 bytes a block): Q 73,728; 3 converted tiles of
//   36,864; the raw ring, 3 pieces of 4 f32 positions or 2 of 16 int8
//   ones (9,216 each); the partial scores (12,288 f32 / 24,576 int8); the
//   int8 scales; the barriers: 224,352 bytes (f32), 227,920 (int8).
// * Step: P V of step i and Q K^T of step i + 1 run together; the exchange
//   and the softmax (log2 domain, ex2.approx; masked scores -inf, m from the
//   finite kNegInf) run between steps, since beside the products they held
//   P's fragments and the scores live at once, past the 160 registers.
//
// The decode form with bf16 queries at lat_dim 576 (latent_decode_tc_kernel,
// in namespace dec below) runs on the tensor cores. The design:
//
// * One launch a call, no scratch. A thread-block cluster of C blocks (1 to
//   16; 16 needs the non-portable cluster attribute) serves one row. The
//   row's live positions [lo, hi), after the kv length and the window, are
//   cut into steps of 16 positions from lo rounded down to 16 and dealt to
//   the blocks at run time (block r takes steps r, r + C, ...), so the
//   split follows the live length, not the table's width. The wrapper
//   chooses C from the batch (B x C near the SM count) and shrinks it until
//   the card holds the batch's clusters at once (a cluster's blocks share
//   one GPC: on an H100 7 clusters of 10-16 blocks fit, 9 of 9, 15 of 8).
//   The blocks merge (O, m, l) through distributed shared memory between
//   two cluster barriers, block r writing its share of the columns: no
//   partials in device memory, no second kernel.
// * Warps: a producer, four converters and four consumers (288 threads,
//   one block an SM). The producer brings a step's 16 pool rows by one
//   bulk copy where the page holds the step whole (a page size a multiple
//   of 16; int8: and the 16 scales by another), else by one copy a row
//   (int8: the scales by cp.async onto the same barrier): a copy never
//   crosses a page, and pages of 6 work. Its lanes read the page table four
//   pairs of steps ahead. The converters turn each landed step into bf16
//   rows (f32: a hi tile of bf16(x) and a lo tile of bf16(x - hi); int8:
//   the bytes, exact in bf16, by hopper::i8x4_to_bf16x2), positions outside
//   [lo, hi) zeros. One converted tile serves as K and as V.
// * Products on the tensor cores, f32-grade, no TF32: mma.sync m16n8k16
//   with the G <= 16 query heads as the 16 rows (padding rows zero, never
//   written), the positions of a step as two n-tiles. Q K^T: K's B
//   fragments by ldmatrix; int8 one pass (q bf16, K exact), f32 two (Q K_hi
//   + Q K_lo). P V: p (int8: p vs) as bf16 hi + lo A fragments straight
//   from the score fragments, V's B fragments by ldmatrix.trans; int8 two
//   passes, f32 three (p_hi V_hi + p_hi V_lo + p_lo V_hi: p_lo V_lo, about
//   2^-32 of the result, is not run): chip_smoke.py's LATENT_PASSES, 3 and
//   5. About 2^-17 of each operand is left before the output's bf16
//   rounding. The K scale multiplies the score, the V scale p before P V,
//   l sums p.
// * The 576-wide accumulator (288 registers a lane in one warp) is split by
//   columns: consumer warp w owns 144 (its quarter of Q K^T's depth and of
//   P V's columns; 72 registers of O). Each computes its partial scores
//   over its depth, and the four partials meet in shared memory, summed in
//   warp order, so that every warp holds the same S, m, l and P (computing
//   S whole in each warp would quadruple Q K^T and its reads for nothing).
//   A step's products for step i + 1 are issued before step i's exchange,
//   softmax and P V.
// * Shared memory: Q 18,688; the converted ring, 3 steps of 37,376 (f32) or
//   6 of 18,688 (int8); the raw ring, 2 steps of 36,864 (f32) or 8 of 9,216
//   (int8); two buffers of partial scores, 8,192; the scales and barriers:
//   212,816 bytes (f32), 213,856 (int8). A converted row is 1168 bytes (a
//   stride of 4 mod 32 words: ldmatrix's 8 rows fall on distinct banks);
//   the converters' reads and writes are laid out so that theirs do too.
//   After the walk the converted ring holds the block's state for the
//   merge. Registers (-Xptxas -v): 165 (f32) / 159 (int8) a thread, 0
//   spills.
//
// The other forms are simple kernels that are right: no TMA, no tensor
// cores, which are later work for them. Their design:
//
// * K = V: a tile of kTile positions is staged ONCE in shared memory as f32
//   (int8 converted on the way in) and serves both Q K^T and P V. Every
//   product and p * vs stay f32.
// * Shared memory: at D = 576 one f32 position is 2.3 KB, so a tile is 32
//   positions (74 KB), and a block holds R score rows (R = 32 for the
//   ragged kernel: 2 queries of 16 heads; R = G rounded up to 4, 8 or 16 for
//   decode) of query (74 KB at R = 32). The output accumulator [R, D] lives
//   in registers, spread over the block's 256 threads (72 floats a thread
//   at R = 32, D = 576).
// * Products on the CUDA cores, register-tiled: for Q K^T a thread sums 4
//   rows x 4 positions over a slice of D (16-byte loads, interleaved so a
//   quarter warp reads 128 contiguous bytes), the slices reduced by
//   shuffles; for P V a thread owns its rows' float4 columns.
// * Loads in flight: tile t + 1 is copied by cp.async (16 bytes a copy,
//   every copy of a tile issued at once, zeros for positions outside the
//   block's range) while tile t is computed, into the second of two f32
//   tiles (int8 pools: into the second of two int8 stages, converted to
//   the one f32 tile once landed). One warp reads the page table for the
//   tile after next, so no thread waits on a table read before its copies.
// * Decode occupancy: with one latent head a row is one block unless its
//   positions are split; the wrapper splits them (`chunk` positions a
//   block, a multiple of kTile) and a second kernel merges the partial
//   (o, m, l) into the output and the stats.
//
// These forms take f32 queries (the engine's exact-stream checks need f32
// products) and lat_dim 80, ragged and decode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;             // positions a step
constexpr int kPStride = kTile + 1;   // floats a row of probabilities
constexpr int kRaggedRows = 32;       // score rows a ragged block
// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// Row stride of a staged tile, in floats: D + 4 puts rows 4 apart 16 banks
// apart (D is a multiple of 16), so the score loop's quarter warps (2
// position groups x 4 slices of 16 bytes) read without conflicts.
template <int D>
__host__ __device__ constexpr int k_stride() { return D + 4; }

// Row stride of an int8 stage, in bytes: a whole number of 16-byte copies.
template <int D>
__host__ __device__ constexpr int k_stage() { return D + 16; }

// Shared memory of a block, in bytes: the query rows, the f32 tile(s) (two
// over an f32 pool; one, and two int8 stages with their scales, over an
// int8 pool), the probabilities, the running (m, l, alpha) and the scales
// of the tile, the pool rows of two tiles.
template <typename KV, int D, int R>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)R * D +
                          (sizeof(KV) == 4 ? 2 : 1) * (size_t)kTile *
                              k_stride<D>() +
                          (size_t)R * kPStride + 3 * R + kTile) +
         (sizeof(KV) == 1 ? 2 * (size_t)kTile * (k_stage<D>() + 4) : 0) +
         sizeof(int) * 2 * kTile;
}

struct Params {
  const void* q;           // [B, S, G, D] bf16 or f32
  const void* pool;        // [P, 1, PS, D] f32 or int8
  const float* scales;     // [P, 1, PS] f32 (int8 pool) or null
  const int* table;        // [B, Tw]
  const int* kv_lens;      // [B]
  const int* q_pos0;       // ragged: q_start [B]; decode: q_positions [B]
  const int* num_new;      // ragged: [B]; decode: null
  void* out;               // ragged: [B, S, G, D] q's type
  float* part_o;           // decode: [B, splits, R, D] unnormalised
  float* part_m;           // decode: [B, splits, R]
  float* part_l;           // decode: [B, splits, R]
  int S, G, gshift, PS, Tw, chunk, window, q_bf16;
  float scale;
};

__device__ __forceinline__ float4 load_q4(const Params& p, size_t at) {
  if (p.q_bf16) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.q) + at);
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + at);
}

__device__ __forceinline__ void store_out4(const Params& p, size_t at,
                                           float4 v) {
  if (p.q_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + at;
    o[0] = __float2bfloat16(v.x);
    o[1] = __float2bfloat16(v.y);
    o[2] = __float2bfloat16(v.z);
    o[3] = __float2bfloat16(v.w);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) = v;
  }
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte (or 4-byte) asynchronous copy to shared memory; `ok` false
// writes zeros and reads nothing.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every copy but the last committed group has landed (this thread's).
__device__ __forceinline__ void wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Warp 0: the pool row (page * PS + slot) of each position of the tile at
// t0, -1 outside [lo, hi).
__device__ __forceinline__ void tile_rows(const Params& p, int b, int t0,
                                          int lo, int hi, int* rows) {
  const int pos = t0 + threadIdx.x;
  rows[threadIdx.x] =
      pos >= lo && pos < hi
          ? p.table[(size_t)b * p.Tw + pos / p.PS] * p.PS + pos % p.PS
          : -1;
}

// Issue the copies of one tile (its pool rows in `rows`) into `dst`: f32
// rows of kStride floats, or int8 rows of k_stage bytes (16-byte aligned)
// with their scales into `dst_scale`.
template <typename KV, int D>
__device__ __forceinline__ void issue_tile(const Params& p, const int* rows,
                                           void* dst, float* dst_scale) {
  constexpr int kBytes = D * (int)sizeof(KV);
  constexpr int kC = kBytes / 16;   // 16-byte copies a row
  constexpr int kN = kTile * kC;
  const char* pool = static_cast<const char*>(p.pool);
#pragma unroll
  for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (kN % kThreads == 0 || idx < kN) {
      const int j = idx / kC, c = idx - (idx / kC) * kC;
      const int r = rows[j];
      char* d = static_cast<char*>(dst) +
                (sizeof(KV) == 4 ? j * k_stride<D>() * 4 : j * k_stage<D>()) +
                c * 16;
      copy16(d, pool + (size_t)max(r, 0) * kBytes + c * 16, r >= 0);
    }
  }
  if (sizeof(KV) == 1 && threadIdx.x < kTile) {
    const int r = rows[threadIdx.x];
    copy4(dst_scale + threadIdx.x, p.scales + max(r, 0), r >= 0);
  }
}

// An int8 stage (rows of k_stage bytes) converted into the f32 tile.
template <int D>
__device__ __forceinline__ void convert_stage(const int8_t* stage,
                                              float* tile) {
  constexpr int kC = D / 16;
  for (int idx = threadIdx.x; idx < kTile * kC; idx += kThreads) {
    const int j = idx / kC, c = idx - (idx / kC) * kC;
    const int4 w =
        *reinterpret_cast<const int4*>(stage + j * k_stage<D>() + c * 16);
    const int words[4] = {w.x, w.y, w.z, w.w};
    float* dst = tile + j * k_stride<D>() + c * 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = words[k];
      *reinterpret_cast<float4*>(dst + 4 * k) = make_float4(
          (float)(int8_t)(x & 0xff), (float)(int8_t)((x >> 8) & 0xff),
          (float)(int8_t)((x >> 16) & 0xff), (float)(int8_t)(x >> 24));
    }
  }
}

// One block: R score rows (row r = query r >> gshift of the block, head
// r & (2^gshift - 1); heads past G and queries past the row's are padding)
// of row b over its positions, kTile at a time.
// Ragged (kDecode false): grid (query tiles, B); a tile is R >> gshift
// queries; the block walks [window start of its first query, causal
// frontier of its last) and writes the normalised output (pad queries 0).
// Decode: grid (splits, B); one query; split s walks [s * chunk, (s + 1) *
// chunk) of the row's live (and windowed) positions and writes its
// unnormalised partial (o, m, l) for latent_merge_kernel.
template <typename KV, int D, int R, bool kDecode>
__global__ void __launch_bounds__(kThreads)
    latent_kernel(const Params p) {
  constexpr int kStride = k_stride<D>();
  constexpr int kC = D / 4;
  constexpr bool kQ8 = sizeof(KV) == 1;
  // Scores: 4 rows x 4 positions a thread, the float4 chunks of D dealt
  // over kDS lanes (chunk c to lane c % kDS), reduced by shuffles.
  constexpr int kDS = 128 / R;
  static_assert(kDS >= 1 && kDS <= 32 && R % 4 == 0, "score tiling");
  // P V: row groups of kRPT rows, kCL lanes over the columns a group.
  constexpr int kRG = R < 16 ? R : 16;
  constexpr int kRPT = R / kRG;
  constexpr int kCL = kThreads / kRG;
  constexpr int kCPT = (kC + kCL - 1) / kCL;

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                          // [R][D]
  float* sk = sq + R * D;                    // [kQ8 ? 1 : 2][kTile][kStride]
  float* sp = sk + (kQ8 ? 1 : 2) * kTile * kStride;  // [R][kPStride]
  float* sm = sp + R * kPStride;             // [R] running max
  float* sl = sm + R;                        // [R] running sum
  float* salpha = sl + R;                    // [R] this step's rescale
  float* tscale = salpha + R;                // [kTile] int8 scales
  int* rows = reinterpret_cast<int*>(tscale + kTile);  // [2][kTile]
  // int8 pools: two stages of [kTile][k_stage] bytes, then their scales.
  constexpr int kStage = k_stage<D>();
  int8_t* s8 = reinterpret_cast<int8_t*>(rows + 2 * kTile);
  float* ss8 = reinterpret_cast<float*>(s8 + 2 * kTile * kStage);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int gp = 1 << p.gshift;
  const int kv_len = p.kv_lens[b];
  const int span = p.Tw * p.PS;

  // The block's queries and positions.
  int i0 = 0, nq = 1, lo = 0, hi = 0, qpos0 = p.q_pos0[b];
  if constexpr (kDecode) {
    lo = blockIdx.x * p.chunk;
    hi = min(min(lo + p.chunk, kv_len), span);
    if (p.window > 0) lo = max(lo, qpos0 - p.window + 1);
  } else {
    const int per = R >> p.gshift;
    i0 = blockIdx.x * per;
    const int nn = min(p.num_new[b], p.S);
    nq = max(0, min(per, nn - i0));
    if (nq > 0) {
      hi = min(min(kv_len, qpos0 + i0 + nq), span);
      lo = p.window > 0 ? max(0, qpos0 + i0 - p.window + 1) : 0;
    }
  }

  // Stage the query rows as f32, zeros for padding rows.
  for (int idx = tid; idx < R * kC; idx += kThreads) {
    const int r = idx / kC, c = idx - (idx / kC) * kC;
    const int qi = r >> p.gshift, h = r & (gp - 1);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h < p.G && qi < nq) {
      const size_t row = kDecode ? (size_t)b * p.G + h
                                 : ((size_t)b * p.S + i0 + qi) * p.G + h;
      v = load_q4(p, row * D + c * 4);
    }
    *reinterpret_cast<float4*>(sq + r * D + c * 4) = v;
  }
  if (tid < R) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  // This thread's score tile and its P V rows and columns.
  const int ds = tid % kDS;
  const int pg = (tid / kDS) % (kTile / 4);
  const int rg = tid / (kDS * (kTile / 4));
  const int vrg = tid / kCL, vcl = tid % kCL;
  float4 acc[kRPT][kCPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int k = 0; k < kCPT; ++k) acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int first = lo & ~(kTile - 1);
  const int tiles = hi > first ? (hi - first + kTile - 1) / kTile : 0;
  if (tid < 32) {
    tile_rows(p, b, first, lo, hi, rows);
    tile_rows(p, b, first + kTile, lo, hi, rows + kTile);
  }
  __syncthreads();  // rows, the query rows, sm and sl
  if (tiles > 0)
    issue_tile<KV, D>(p, rows, kQ8 ? (void*)s8 : (void*)sk, ss8);
  commit();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1, t0 = first + t * kTile;
    // The previous step is done with its buffers; rows[cur ^ 1] holds the
    // next tile's pool rows.
    __syncthreads();
    if (t + 1 < tiles)
      issue_tile<KV, D>(
          p, rows + (cur ^ 1) * kTile,
          kQ8 ? (void*)(s8 + (cur ^ 1) * kTile * kStage)
              : (void*)(sk + (cur ^ 1) * kTile * kStride),
          ss8 + (cur ^ 1) * kTile);
    commit();
    if (tid < 32) tile_rows(p, b, t0 + 2 * kTile, lo, hi, rows + cur * kTile);
    wait_all_but_last();
    __syncthreads();  // tile t has landed, for every thread
    float* tile = sk + (kQ8 ? 0 : cur * kTile * kStride);
    if constexpr (kQ8) {
      convert_stage<D>(s8 + cur * kTile * kStage, sk);
      if (tid < kTile) tscale[tid] = ss8[cur * kTile + tid];
      __syncthreads();
    }

    // S = Q K^T on this thread's 4 x 4 tile, its slice of D.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = ds; c < kC; c += kDS) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sq + (rg * 4 + i) * D + c * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(tile + (pg * 4 + j) * kStride +
                                                 c * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int off = kDS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const int qi = r >> p.gshift, h = r & (gp - 1);
        const int qpos = qpos0 + i0 + qi;
        const bool real = h < p.G && qi < nq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pos = t0 + pg * 4 + j;
          bool valid = real && pos >= lo && pos < hi;
          if (!kDecode) {
            valid = valid && pos <= qpos;
            if (p.window > 0) valid = valid && pos > qpos - p.window;
          }
          float v = s[i][j];
          if (kQ8) v *= tscale[pg * 4 + j];
          sp[r * kPStride + pg * 4 + j] = valid ? v * p.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax: a warp a row, a lane a position.
    for (int r = tid / 32; r < R; r += kWarps) {
      const int lane = tid % 32;
      const float v = sp[r * kPStride + lane];
      float mx = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);
      const float e = v == kNegInf ? 0.f : expf(v - m_new);
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sp[r * kPStride + lane] = kQ8 ? e * tscale[lane] : e;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[r] = alpha;
        sl[r] = alpha * sl[r] + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha O + P V over the same staged tile.
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = vrg * kRPT + i;
      const float alpha = salpha[r];
#pragma unroll
      for (int k = 0; k < kCPT; ++k) {
        acc[i][k].x *= alpha;
        acc[i][k].y *= alpha;
        acc[i][k].z *= alpha;
        acc[i][k].w *= alpha;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float pr[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) pr[i] = sp[(vrg * kRPT + i) * kPStride + j];
#pragma unroll
      for (int k = 0; k < kCPT; ++k) {
        const int c = vcl + kCL * k;
        if (c < kC) {
          const float4 v =
              *reinterpret_cast<const float4*>(tile + j * kStride + c * 4);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) fma4(acc[i][k], pr[i], v);
        }
      }
    }
  }
  __syncthreads();

  if constexpr (kDecode) {
    const size_t part = (size_t)b * gridDim.x + blockIdx.x;
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = vrg * kRPT + i;
#pragma unroll
      for (int k = 0; k < kCPT; ++k) {
        const int c = vcl + kCL * k;
        if (c < kC)
          *reinterpret_cast<float4*>(p.part_o + (part * R + r) * D + c * 4) =
              acc[i][k];
      }
    }
    if (tid < R) {
      p.part_m[part * R + tid] = sm[tid];
      p.part_l[part * R + tid] = sl[tid];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = vrg * kRPT + i;
      const int qi = r >> p.gshift, h = r & (gp - 1);
      if (h >= p.G || i0 + qi >= p.S) continue;
      // pad queries (l = 0, acc = 0) come out as zeros
      const float inv = 1.f / fmaxf(sl[r], 1e-20f);
      const size_t row = ((size_t)b * p.S + i0 + qi) * p.G + h;
#pragma unroll
      for (int k = 0; k < kCPT; ++k) {
        const int c = vcl + kCL * k;
        if (c < kC) {
          const float4 a = acc[i][k];
          store_out4(p, row * D + c * 4,
                     make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
        }
      }
    }
  }
}

// The decode splits' partials merged under one softmax, a block a (row,
// head): the splits' (m, l) and weights exp(m_s - max) in shared memory
// once, then a thread a float4 column of the output sums every split's
// weighted o (its loads independent of each other). Writes the output
// [B, 1, G, D] in q's type and m, l [B, G] f32 (an empty row: zeros, m =
// kNegInf, l = 0).
constexpr int kMaxSplits = 256;

// Threads of a merge block: a float4 column each, in whole warps (warp 0
// reduces the splits' statistics with full-warp shuffles).
template <int D>
__host__ __device__ constexpr int merge_threads() {
  return (D / 4 + 31) / 32 * 32;
}

template <int D, int R>
__global__ void __launch_bounds__(merge_threads<D>())
    latent_merge_kernel(const Params p, int splits, float* m_out,
                        float* l_out) {
  __shared__ float w[kMaxSplits];
  __shared__ float total[2];  // max m, then sum of w * l
  const int b = blockIdx.x, g = blockIdx.y, c = threadIdx.x;
  const size_t base = (size_t)b * splits;
  if (c < 32) {
    float mx = kNegInf;
    for (int s = c; s < splits; s += 32)
      mx = fmaxf(mx, p.part_m[(base + s) * R + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int s = c; s < splits; s += 32) {
      const float ls = p.part_l[(base + s) * R + g];
      // an empty split (l = 0) adds nothing
      const float ws = ls == 0.f ? 0.f : expf(p.part_m[(base + s) * R + g] - mx);
      w[s] = ws;
      l = fmaf(ws, ls, l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (c == 0) {
      total[0] = mx;
      total[1] = l;
    }
  }
  __syncthreads();
  if (c >= D / 4) return;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < splits; ++s)
    fma4(o, w[s], *reinterpret_cast<const float4*>(
                      p.part_o + ((base + s) * R + g) * D + c * 4));
  const float inv = 1.f / fmaxf(total[1], 1e-20f);
  store_out4(p, ((size_t)b * p.G + g) * D + c * 4,
             make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
  if (c == 0) {
    m_out[(size_t)b * p.G + g] = total[0];
    l_out[(size_t)b * p.G + g] = total[1];
  }
}

template <typename KV, int D, int R, bool kDecode>
int launch_main(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes<KV, D, R>();
  cudaError_t err = cudaFuncSetAttribute(
      latent_kernel<KV, D, R, kDecode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  latent_kernel<KV, D, R, kDecode><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int D>
int ragged(const Params& p, int B, cudaStream_t stream) {
  const int per = kRaggedRows >> p.gshift;
  dim3 grid((p.S + per - 1) / per, B);
  return launch_main<KV, D, kRaggedRows, false>(p, grid, stream);
}

template <typename KV, int D, int R>
int decode_r(const Params& p, int B, int splits, float* m, float* l,
             cudaStream_t stream) {
  int err = launch_main<KV, D, R, true>(p, dim3(splits, B), stream);
  if (err != 0) return err;
  latent_merge_kernel<D, R>
      <<<dim3(B, p.G), merge_threads<D>(), 0, stream>>>(p, splits, m, l);
  return static_cast<int>(cudaGetLastError());
}

// Decode rows: G rounded up to a power of two, at least 4 (a score tile's
// rows).
int decode_rows(int gshift) { return gshift <= 2 ? 4 : 1 << gshift; }

template <typename KV, int D>
int decode(const Params& p, int B, int splits, float* m, float* l,
           cudaStream_t stream) {
  switch (decode_rows(p.gshift)) {
    case 4: return decode_r<KV, D, 4>(p, B, splits, m, l, stream);
    case 8: return decode_r<KV, D, 8>(p, B, splits, m, l, stream);
    case 16: return decode_r<KV, D, 16>(p, B, splits, m, l, stream);
  }
  return -1;
}

int group_shift(int G) {
  int s = 0;
  while ((1 << s) < G) ++s;
  return s;
}

bool widths_ok(int G, int D) {
  return G >= 1 && G <= 16 && (D == 576 || D == 80);
}

Params make_params(const void* q, const void* pool, const void* scales,
                   const void* table, const void* kv_lens, const void* q_pos0,
                   const void* num_new, void* out, int S, int G, int PS,
                   int Tw, float scale, int window, int dtype) {
  Params p;
  p.q = q;
  p.pool = pool;
  p.scales = static_cast<const float*>(scales);
  p.table = static_cast<const int*>(table);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_pos0 = static_cast<const int*>(q_pos0);
  p.num_new = static_cast<const int*>(num_new);
  p.out = out;
  p.part_o = p.part_m = p.part_l = nullptr;
  p.S = S;
  p.G = G;
  p.gshift = group_shift(G);
  p.PS = PS;
  p.Tw = Tw;
  p.chunk = 0;
  p.window = window;
  p.q_bf16 = dtype == 0;
  p.scale = scale;
  return p;
}


// ---------------------------------------------------------------------------
// bf16 queries at lat_dim 576: the ragged form on the tensor cores
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kD = 576;
constexpr int kBlocks = kD / 64;            // 64-column (128-byte) blocks
constexpr int kRows = 64;                   // score rows a block
constexpr int kWGs = 3;                     // consumer warpgroups
constexpr int kWGBlocks = kBlocks / kWGs;   // column blocks a warpgroup owns
constexpr int kConsumers = kWGs * 128;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kQBlock = kRows * 128;        // one column block of Q
constexpr int kQBytes = kBlocks * kQBlock;
constexpr int kTileRows = 32;               // rows of a step's tile
constexpr int kTBlock = kTileRows * 128;    // one column block of it
constexpr int kTileBytes = kBlocks * kTBlock;
constexpr int kStages = 3;                  // converted tiles
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlocks % kWGs == 0, "column split");
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536,
              "registers");

// A step's tile is 32 rows of 576 bf16: over the int8 pool 32 positions, a
// row each; over the f32 pool 16 positions, position j's hi in row 2j and
// its lo in row 2j + 1 (so Q K^T is one m64n32 pass whose adjacent columns
// a thread holds together, and P V meets hi and lo in one k-step).
//
// Shared memory, from a 1024-aligned base: Q | the converted ring | the raw
// ring (pieces of pool rows as the bulk copies land them) | the partial
// scores | (int8) each converted stage's K and V scales, each raw piece's
// scales | the barriers.
template <typename KV>
struct Layout {
  static constexpr bool kQ8 = sizeof(KV) == 1;
  static constexpr int kStep = kQ8 ? 32 : 16;   // positions a step
  static constexpr int kScores = kStep / 4;     // a thread's of a row
  static constexpr int kRowBytes = kD * (int)sizeof(KV);
  static constexpr int kPiece = kQ8 ? 16 : 4;   // positions a raw piece
  static constexpr int kPiecesAStep = kStep / kPiece;
  static constexpr int kPieceBytes = kPiece * kRowBytes;
  static constexpr int kPieces = kQ8 ? 2 : 3;
  static constexpr int kXBytes = kWGs * 128 * 2 * kScores * 4;
  static constexpr int kConv = kQBytes;
  static constexpr int kRaw = kConv + kStages * kTileBytes;
  static constexpr int kX = kRaw + kPieces * kPieceBytes;
  // a converted stage's K scales (times scale * log2(e)), then its V scales
  static constexpr int kScales = kX + kXBytes;
  static constexpr int kRawScales =
      kScales + (kQ8 ? 2 * kStages * kStep * 4 : 0);
  static constexpr int kBars = kRawScales + (kQ8 ? kPieces * kPiece * 4 : 0);
  // raw full / empty, converted full / empty
  static constexpr int kNumBars = 2 * kPieces + 2 * kStages;
  static constexpr int kBytes = kBars + kNumBars * 8;
  static_assert(kBytes <= 232448, "shared memory of a block");
  static_assert(kTileBytes % 1024 == 0 && kRaw % 1024 == 0, "alignment");
  static_assert(kPieceBytes % 16 == 0 && kXBytes % 16 == 0, "alignment");
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One raw piece (Layout::kPiece pool rows as they landed: positions pos0..,
// the step's j0..) into the converted tile, as the 128-byte swizzle lays a
// K-major bf16 tile out (16-byte chunk c of row r at c ^ (r % 8));
// positions outside [lo, hi) become zeros (their probabilities are 0, and
// 0 * V must stay finite). f32: x = hi + lo, hi = bf16(x) into row 2j, lo =
// bf16(x - hi) into row 2j + 1. int8: the byte values, exact in bf16, into
// row j.
template <typename KV>
__device__ __forceinline__ void convert_piece(const uint8_t* raw,
                                              uint8_t* dst, int j0,
                                              int pos0, int lo, int hi,
                                              int ct) {
  if constexpr (sizeof(KV) == 4) {
    constexpr int kC = kD / 4;  // float4 chunks a row
#pragma unroll 2
    for (int c = ct; c < Layout<KV>::kPiece * kC; c += 96) {
      const int r = c / kC, c4 = c - r * kC;
      const int pos = pos0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pos >= lo && pos < hi)
        v = *reinterpret_cast<const float4*>(raw + r * (kD * 4) + c4 * 16);
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(
          v.x - __low2float(h01), v.y - __high2float(h01));
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(
          v.z - __low2float(h23), v.w - __high2float(h23));
      const int col = c4 * 4, chunk = (col >> 3) & 7;
      const int rh = 2 * (j0 + r), rl = rh + 1;
      uint8_t* blk = dst + (col >> 6) * kTBlock + (c4 & 1) * 8;
      *reinterpret_cast<uint2*>(blk + rh * 128 + ((chunk ^ (rh & 7)) << 4)) =
          make_uint2(bf16x2_bits(h01), bf16x2_bits(h23));
      *reinterpret_cast<uint2*>(blk + rl * 128 + ((chunk ^ (rl & 7)) << 4)) =
          make_uint2(bf16x2_bits(l01), bf16x2_bits(l23));
    }
  } else {
    constexpr int kC = kD / 16;  // 16-byte chunks an int8 row
    for (int c = ct; c < Layout<KV>::kPiece * kC; c += 96) {
      const int r = c / kC, ch = c - r * kC;
      const int pos = pos0 + r, row = j0 + r;
      uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (pos >= lo && pos < hi) {
        const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kD + ch * 16);
        hopper::i8x4_to_bf16x2(v.x, w[0], w[1]);
        hopper::i8x4_to_bf16x2(v.y, w[2], w[3]);
        hopper::i8x4_to_bf16x2(v.z, w[4], w[5]);
        hopper::i8x4_to_bf16x2(v.w, w[6], w[7]);
      }
      const int k = (ch & 3) * 2;
      uint8_t* drow = dst + (ch >> 2) * kTBlock + row * 128;
      *reinterpret_cast<uint4*>(drow + ((k ^ (row & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(drow + (((k + 1) ^ (row & 7)) << 4)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// The producer warpgroup. Its first warp reads the page table a step ahead
// and brings each piece's rows by bulk copies (one a piece where the page
// holds it whole, else one a live row; counted in bytes on the piece's full
// barrier; int8: the rows' scales by cp.async, which its 32 lanes' arrivals
// count on the same barrier). The other three warps turn each landed piece
// into the converted stage beside the consumers' products (int8: its K
// scales times scale * log2(e), and its V scales).
template <typename KV>
__device__ __forceinline__ void produce(const Params& p, uint8_t* smem,
                                        uint64_t* raw_full,
                                        uint64_t* raw_empty,
                                        uint64_t* conv_full,
                                        uint64_t* conv_empty, int b, int lo,
                                        int hi, int first, int steps,
                                        int warp, int lane) {
  using L = Layout<KV>;
  constexpr int kStep = L::kStep;
  const int* trow = p.table + (size_t)b * p.Tw;
  auto row_of = [&](int pos) {
    return pos >= lo && pos < hi ? trow[pos / p.PS] * p.PS + pos % p.PS : -1;
  };
  if (warp == kConsumers / 32) {
    const char* pool = static_cast<const char*>(p.pool);
    // Pages of a multiple of kPiece rows hold whole pieces (a step starts
    // on a multiple of kStep): one copy a piece, its rows consecutive in
    // the page; else one a row.
    const bool whole = p.PS % L::kPiece == 0;
    int cur = lane < kStep ? row_of(first + lane) : -1;
    for (int i = 0; i < steps; ++i) {
      const int nxt = lane < kStep ? row_of(first + (i + 1) * kStep + lane) : -1;
#pragma unroll
      for (int j = 0; j < L::kPiecesAStep; ++j) {
        const int g = i * L::kPiecesAStep + j;
        const int slot = g % L::kPieces;
        hopper::mbar_wait(&raw_empty[slot], ((g / L::kPieces) & 1) ^ 1);
        const int r = __shfl_sync(0xffffffffu, cur, (j * L::kPiece + lane) & 31);
        const bool on = lane < L::kPiece && r >= 0;
        const uint32_t live = __ballot_sync(0xffffffffu, on);
        uint8_t* dst = smem + L::kRaw + slot * L::kPieceBytes;
        if (whole) {
          // rows of dead positions come along; the converters zero them
          const int k = live ? __ffs(live) - 1 : 0;
          const int base = __shfl_sync(0xffffffffu, r, k) - k;
          if (lane == 0) {
            hopper::mbar_arrive_expect_tx(&raw_full[slot],
                                          live ? L::kPieceBytes : 0);
            if (live)
              hopper::bulk_load(dst, pool + (size_t)base * L::kRowBytes,
                                L::kPieceBytes, &raw_full[slot]);
          }
        } else {
          if (lane == 0)
            hopper::mbar_arrive_expect_tx(&raw_full[slot],
                                          __popc(live) * L::kRowBytes);
          __syncwarp();
          if (on)
            hopper::bulk_load(dst + lane * L::kRowBytes,
                              pool + (size_t)r * L::kRowBytes, L::kRowBytes,
                              &raw_full[slot]);
        }
        if constexpr (L::kQ8) {
          float* dsc = reinterpret_cast<float*>(smem + L::kRawScales) +
                       slot * L::kPiece;
          if (lane < L::kPiece)
            hopper::cp_async_4(dsc + lane, p.scales + max(r, 0), on);
          hopper::cp_async_arrive_noinc(&raw_full[slot]);
        }
      }
      cur = nxt;
    }
    return;
  }
  const int ct = (warp - kConsumers / 32 - 1) * 32 + lane;  // 0 .. 95
  const float scale_log2 = p.scale * kLog2e;
  for (int i = 0; i < steps; ++i) {
    const int st = i % kStages;
    const int kv0 = first + i * kStep;
    hopper::mbar_wait(&conv_empty[st], ((i / kStages) & 1) ^ 1);
    uint8_t* dst = smem + L::kConv + st * kTileBytes;
#pragma unroll 1
    for (int j = 0; j < L::kPiecesAStep; ++j) {
      const int g = i * L::kPiecesAStep + j;
      const int slot = g % L::kPieces;
      hopper::mbar_wait(&raw_full[slot], (g / L::kPieces) & 1);
      convert_piece<KV>(smem + L::kRaw + slot * L::kPieceBytes, dst,
                        j * L::kPiece, kv0 + j * L::kPiece, lo, hi, ct);
      if constexpr (L::kQ8) {
        if (ct < L::kPiece) {
          const float cs = reinterpret_cast<const float*>(
              smem + L::kRawScales)[slot * L::kPiece + ct];
          float* sc = reinterpret_cast<float*>(smem + L::kScales) +
                      2 * st * kStep + j * L::kPiece + ct;
          sc[0] = cs * scale_log2;  // multiplies the score
          sc[kStep] = cs;           // multiplies p before P V
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&raw_empty[slot]);
    }
    hopper::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&conv_full[st]);
  }
}

// A consumer warpgroup (wg 0..2) of the block's 64 rows (row r = query
// r >> gshift of the block, head r % 2^gshift). It owns column blocks
// kWGBlocks wg .. : its third of Q K^T's depth and its third of P V's
// columns. Per step: its partial S over its columns (m64n32, Q and the
// tile K-major), the three partials summed through shared memory in a
// fixed order (so every warpgroup holds the same S, m, l and P), the
// online softmax, then P V on its columns (m64n192, P from registers, the
// same tile read MN-major as V). P V of step i and Q K^T of step i + 1 run
// together; the exchange and the softmax run between steps (a softmax
// beside the products kept P's fragments live with the scores, over the
// 160 registers a consumer has).
template <typename KV>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem,
                                        uint64_t* conv_full,
                                        uint64_t* conv_empty, int b, int i0,
                                        int nq, int q_start, int hi,
                                        int first, int steps, int warp,
                                        int lane, int tid) {
  using L = Layout<KV>;
  constexpr bool kQ8 = L::kQ8;
  constexpr int kS = L::kScores;
  const int wg = warp >> 2;
  const int tw = tid & 127;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int row0 = (warp & 3) * 16 + g4, row1 = row0 + 8;
  const int gp = 1 << p.gshift;
  const float scale_log2 = p.scale * kLog2e;
  uint8_t* q_s = smem;

  // This warpgroup's blocks of Q, zeros for pad queries and heads past G.
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  for (int idx = tw; idx < kRows * kWGBlocks * 8; idx += 128) {
    const int r = idx / (kWGBlocks * 8), c = idx - r * (kWGBlocks * 8);
    const int blk = wg * kWGBlocks + (c >> 3), j = c & 7;
    const int qi = r >> p.gshift, h = r & (gp - 1);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h < p.G && qi < nq)
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * p.S + i0 + qi) * p.G + h) * kD + blk * 64 + j * 8);
    *reinterpret_cast<uint4*>(q_s + blk * kQBlock + r * 128 +
                              ((j ^ (r & 7)) << 4)) = v;
  }
  hopper::fence_proxy_async();
  hopper::named_sync(3 + wg, 128);

  // The positions each of this thread's rows sees: [bot, top], none for a
  // pad query.
  const int qr0 = row0 >> p.gshift, qr1 = row1 >> p.gshift;
  const int qp0 = q_start + i0 + qr0, qp1 = q_start + i0 + qr1;
  const int top0 = qr0 < nq ? min(qp0, hi - 1) : -1;
  const int top1 = qr1 < nq ? min(qp1, hi - 1) : -1;
  const int bot0 = p.window > 0 ? qp0 - p.window + 1 : 0;
  const int bot1 = p.window > 0 ? qp1 - p.window + 1 : 0;
  // This thread's k-th score of a row is position pos_of(k) of the step:
  // int8, tile column 8 (k / 2) + 2 t + k % 2; f32, the hi and lo columns
  // 8k + 2t, 8k + 2t + 1 of position 4k + t, added into the first. at(r, k)
  // is where it lies in the product's fragment (row r: row0 or row1).
  auto pos_of = [&](int k) {
    return kQ8 ? 8 * (k >> 1) + 2 * t4 + (k & 1) : 4 * k + t4;
  };
  auto at = [](int r, int k) {
    return kQ8 ? 4 * (k >> 1) + 2 * r + (k & 1) : 4 * k + 2 * r;
  };

  float o[96], s[16];
  uint32_t pa[2][4], pa_lo[2][4];
#pragma unroll
  for (int k = 0; k < 96; ++k) o[k] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float4* xb = reinterpret_cast<float4*>(smem + L::kX);
  const float* scl = reinterpret_cast<const float*>(smem + L::kScales);
  auto stage = [&](int i) {
    return smem + L::kConv + (i % kStages) * kTileBytes;
  };

  // S = Q K^T over this warpgroup's columns, all 32 tile rows. A k-step's
  // descriptors are its blocks' base descriptors plus the offset (in 16-byte
  // units, the start address field); the Q base is remade each call, so
  // that the compiler keeps no twelve Q descriptors live across the loop.
  const uint64_t q_desc =
      hopper::desc_sw128(q_s + wg * kWGBlocks * kQBlock, 16, 1024);
  auto issue_qk = [&](int i) {
    uint64_t qd = q_desc;
    asm volatile("" : "+l"(qd));
    const uint64_t td =
        hopper::desc_sw128(stage(i) + wg * kWGBlocks * kTBlock, 16, 1024);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWGBlocks * 4; ++kk) {
      const uint64_t da = qd + (((kk / 4) * kQBlock + (kk % 4) * 32) >> 4);
      const uint64_t db = td + (((kk / 4) * kTBlock + (kk % 4) * 32) >> 4);
      if (kk == 0)
        hopper::wgmma_m64n32k16_ss_first(s, da, db);
      else
        hopper::wgmma_m64n32k16_ss(s, da, db);
    }
    hopper::wgmma_commit();
  };
  // O += P V over this warpgroup's 192 columns, two k-steps of 16 tile
  // rows, the hi and the lo terms of P each: int8, (p vs)_hi V + (p vs)_lo
  // V; f32, (p_hi + p_lo) (V_hi + V_lo).
  auto issue_pv = [&](int i) {
    const uint8_t* v = stage(i) + wg * kWGBlocks * kTBlock;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dv = hopper::desc_sw128(v + kk * 16 * 128, kTBlock, 1024);
      hopper::wgmma_m64n192k16_rs_tb(o, pa[kk], dv);
      hopper::wgmma_m64n192k16_rs_tb(o, pa_lo[kk], dv);
    }
    hopper::wgmma_commit();
  };
  // This thread's scores of step i in the product's fragment (f32: hi +
  // lo), the three partials summed through shared memory in a fixed order,
  // the masks, the online softmax (o rescaled here: the last P V is done);
  // the probabilities (int8: times the V scale) left in place. Score v of
  // the 2 kS a thread holds is row v / kS's k = v % kS.
  auto sv = [&](int v) -> float& { return s[at(v / kS, v % kS)]; };
  auto softmax = [&](int i) {
    if constexpr (!kQ8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) s[2 * k] += s[2 * k + 1];
    }
    hopper::named_sync(2, kConsumers);  // the last step's partials are read
#pragma unroll
    for (int v = 0; v < kS / 2; ++v)
      xb[(wg * (kS / 2) + v) * 128 + tw] = make_float4(
          sv(4 * v), sv(4 * v + 1), sv(4 * v + 2), sv(4 * v + 3));
    hopper::named_sync(1, kConsumers);
#pragma unroll
    for (int v = 0; v < kS / 2; ++v) {
      const float4 a = xb[v * 128 + tw];
      const float4 c = xb[(kS / 2 + v) * 128 + tw];
      const float4 e = xb[(kS + v) * 128 + tw];
      sv(4 * v) = (a.x + c.x) + e.x;
      sv(4 * v + 1) = (a.y + c.y) + e.y;
      sv(4 * v + 2) = (a.z + c.z) + e.z;
      sv(4 * v + 3) = (a.w + c.w) + e.w;
    }
    const int kv0 = first + i * L::kStep;
    const float* sc = scl + 2 * (i % kStages) * L::kStep;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int pos = kv0 + pos_of(k);
      float mult;
      if constexpr (kQ8)
        mult = sc[pos_of(k)];
      else
        mult = scale_log2;
      float& x0 = s[at(0, k)];
      float& x1 = s[at(1, k)];
      x0 = pos >= bot0 && pos <= top0 ? x0 * mult : -INFINITY;
      x1 = pos >= bot1 && pos <= top1 ? x1 * mult : -INFINITY;
      mx0 = fmaxf(mx0, x0);
      mx1 = fmaxf(mx1, x1);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = hopper::exp2_approx(m0 - mn0);
    const float alpha1 = hopper::exp2_approx(m1 - mn1);
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      float p0 = hopper::exp2_approx(s[at(0, k)] - mn0);
      float p1 = hopper::exp2_approx(s[at(1, k)] - mn1);
      sum0 += p0;
      sum1 += p1;
      if constexpr (kQ8) {
        const float vs = sc[L::kStep + pos_of(k)];
        p0 *= vs;
        p1 *= vs;
      }
      s[at(0, k)] = p0;
      s[at(1, k)] = p1;
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, sh);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, sh);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
  };
  // P (int8: p vs) as the A fragments of P V's two k-steps, hi and lo bf16
  // terms. Fragment word r of k-step kk holds tile columns 16 kk + 2t, + 1
  // (+ 8 for r >= 2) of row0 (r even) or row1: int8, two positions; f32, one
  // position's hi and lo rows, both weighted by its p.
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = kQ8 ? 4 * kk + 2 * (r >> 1) : 2 * kk + (r >> 1);
        const float a = s[at(r & 1, k)];
        const float c = s[at(r & 1, k + (kQ8 ? 1 : 0))];
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
        pa[kk][r] = bf16x2_bits(h);
        pa_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(
            a - __low2float(h), c - __high2float(h)));
      }
    }
  };
  auto wait_full = [&](int i) {
    hopper::mbar_wait(&conv_full[i % kStages], (i / kStages) & 1);
  };

  if (steps > 0) {
    wait_full(0);
    issue_qk(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    softmax(0);
    pack();
    for (int i = 0; i < steps; ++i) {
      issue_pv(i);
      if (i + 1 < steps) {
        wait_full(i + 1);
        issue_qk(i + 1);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(s);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&conv_empty[i % kStages]);
      if (i + 1 < steps) {
        softmax(i + 1);
        pack();
      }
    }
  }

  // The output through this warpgroup's blocks of Q (free since its last
  // Q K^T), normalised, bf16, in Q's swizzled layout; then 16-byte rows out
  // (rows past S and heads past G are not written; pad queries are zeros).
  const bool ok0 = qr0 < nq, ok1 = qr1 < nq;
  const float inv0 = ok0 ? 1.f / fmaxf(l0, 1e-20f) : 0.f;
  const float inv1 = ok1 ? 1.f / fmaxf(l1, 1e-20f) : 0.f;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    uint8_t* blk = q_s + (wg * kWGBlocks + j / 8) * kQBlock + 4 * t4 +
                   (((j & 7) ^ (row0 & 7)) << 4);
    *reinterpret_cast<uint32_t*>(blk + row0 * 128) = bf16x2_bits(
        __floats2bfloat162_rn(ok0 ? o[4 * j] * inv0 : 0.f,
                              ok0 ? o[4 * j + 1] * inv0 : 0.f));
    *reinterpret_cast<uint32_t*>(blk + row1 * 128) = bf16x2_bits(
        __floats2bfloat162_rn(ok1 ? o[4 * j + 2] * inv1 : 0.f,
                              ok1 ? o[4 * j + 3] * inv1 : 0.f));
  }
  hopper::named_sync(3 + wg, 128);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  for (int idx = tw; idx < kRows * kWGBlocks * 8; idx += 128) {
    const int r = idx / (kWGBlocks * 8), c = idx - r * (kWGBlocks * 8);
    const int blk = wg * kWGBlocks + (c >> 3), j = c & 7;
    const int qi = r >> p.gshift, h = r & (gp - 1);
    if (h < p.G && i0 + qi < p.S)
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * p.S + i0 + qi) * p.G + h) * kD + blk * 64 +
          j * 8) = *reinterpret_cast<const uint4*>(
          q_s + blk * kQBlock + r * 128 + ((j ^ (r & 7)) << 4));
  }
}

// One block: 64 score rows (64 >> gshift queries of the row b, from query
// i0) over the positions [lo, hi) they see, Layout::kStep a step from lo
// rounded down. Grid (query tiles, B), the tiles reversed: the longest
// causal walks start first. A tile of pad queries (or an empty row) writes
// zeros at once.
template <typename KV>
__global__ void __launch_bounds__(kThreads, 1)
    latent_wgmma_kernel(const Params p) {
  using L = Layout<KV>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int per = kRows >> p.gshift;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * per;
  const int nn = min(p.num_new[b], p.S);
  if (i0 >= nn) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    const int rows = min(per, p.S - i0) * p.G;
    for (int c = tid; c < rows * (kD / 8); c += kThreads)
      *reinterpret_cast<uint4*>(out + (((size_t)b * p.S + i0) * p.G) * kD +
                                (size_t)c * 8) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // The swizzled layout needs the 1024-byte base it repeats on.
  if (hopper::smem_u32(smem) & 1023) __trap();
  const int nq = min(per, nn - i0);
  const int q_start = p.q_pos0[b];
  const int kv_len = min(p.kv_lens[b], p.Tw * p.PS);
  const int hi = min(kv_len, q_start + i0 + nq);
  const int lo = p.window > 0 ? max(0, q_start + i0 - p.window + 1) : 0;
  const int first = lo - lo % L::kStep;
  const int steps = hi > first ? (hi - first + L::kStep - 1) / L::kStep : 0;

  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* raw_empty = raw_full + L::kPieces;
  uint64_t* conv_full = raw_empty + L::kPieces;
  uint64_t* conv_empty = conv_full + kStages;
  if (tid == 0) {
    for (int s = 0; s < L::kPieces; ++s) {
      // int8: and the TMA warp's 32 arrivals after its scale copies
      hopper::mbar_init(&raw_full[s], L::kQ8 ? 1 + 32 : 1);
      hopper::mbar_init(&raw_empty[s], 3);  // the converter warps
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&conv_full[s], 3);
      hopper::mbar_init(&conv_empty[s], kConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // The warp index, broadcast so that the compiler sees it warp-uniform.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (warp >= kConsumers / 32) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    produce<KV>(p, smem, raw_full, raw_empty, conv_full, conv_empty, b, lo,
                hi, first, steps, warp, lane);
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    consume<KV>(p, smem, conv_full, conv_empty, b, i0, nq, q_start, hi,
                first, steps, warp, lane, tid);
  }
}

template <typename KV>
int launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<KV>;
  const cudaError_t err =
      cudaFuncSetAttribute(latent_wgmma_kernel<KV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = kRows >> p.gshift;
  const dim3 grid((p.S + per - 1) / per, B);
  latent_wgmma_kernel<KV><<<grid, kThreads, L::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
void plan(int S, int gshift, long long* out) {
  using L = Layout<KV>;
  const int per = kRows >> gshift;
  out[0] = (S + per - 1) / per;
  out[1] = per;
  out[2] = kThreads;
  out[3] = L::kBytes;
  out[4] = kStages;
  out[5] = L::kPieces;
  out[6] = L::kPiece;
  out[7] = L::kStep;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 queries at lat_dim 576: the decode form on the tensor cores
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kD = 576;
constexpr int kWarps = 4;                    // consumer warps
constexpr int kConvWarps = 4;                // converter warps
constexpr int kThreads = (kWarps + kConvWarps + 1) * 32;  // + the producer
constexpr int kProducer = kWarps + kConvWarps;            // its warp
constexpr int kCols = kD / kWarps;           // columns a consumer warp owns
constexpr int kKSteps = kCols / 16;          // its k-steps of Q K^T
constexpr int kStep = 16;                    // positions a step
constexpr int kMaxCluster = 16;
// A converted row: 576 bf16 and 16 bytes of padding, a stride of 4 mod 32
// words, so that ldmatrix's 8 rows of 16 bytes fall on distinct banks.
constexpr int kTRow = kD * 2 + 16;
constexpr int kTile = kStep * kTRow;         // a step's converted tile
static_assert(kCols % 16 == 0 && kD % kWarps == 0, "column split");
static_assert((kTRow / 4) % 32 == 4, "converted row stride");

// Shared memory: Q [16][kTRow] bf16 | the converted ring (f32 pool: a hi
// and a lo tile a step) | the raw ring (a step's pool rows as the bulk
// copies land them) | the partial scores, two buffers | (int8) each raw
// step's scales, then each converted step's | the barriers. Once the walk
// is done the converted ring's first bytes take the block's state: O
// [16][kD] f32, then m [16] and l [16].
template <typename KV>
struct Layout {
  static constexpr bool kQ8 = sizeof(KV) == 1;
  static constexpr int kRowBytes = kD * (int)sizeof(KV);
  static constexpr int kRawBytes = kStep * kRowBytes;
  static constexpr int kRaws = kQ8 ? 8 : 2;
  static constexpr int kConvBytes = (kQ8 ? 1 : 2) * kTile;
  static constexpr int kConvs = kQ8 ? 6 : 3;
  static constexpr int kQ = 0;
  static constexpr int kConv = 16 * kTRow;
  static constexpr int kRaw = kConv + kConvs * kConvBytes;
  static constexpr int kX = kRaw + kRaws * kRawBytes;
  static constexpr int kXBytes = 2 * kWarps * 2 * 32 * 16;
  static constexpr int kScales = kX + kXBytes;
  static constexpr int kConvScales = kScales + (kQ8 ? kRaws * kStep * 4 : 0);
  static constexpr int kBars =
      kConvScales + (kQ8 ? kConvs * kStep * 4 : 0);
  // raw full / empty, converted full / empty
  static constexpr int kNumBars = 2 * kRaws + 2 * kConvs;
  static constexpr int kBytes = kBars + kNumBars * 8;
  static constexpr int kState = kConv;
  static constexpr int kStateML = kState + 16 * kD * 4;
  static_assert(kStateML + 2 * 16 * 4 <= kRaw, "the state over the ring");
  static_assert((3 * kMaxCluster + 1) * 16 * 4 <= kXBytes,
                "the merge's (m, l) and weights over the partial scores");
  static_assert(kConv % 16 == 0 && kRaw % 16 == 0 && kBars % 8 == 0,
                "alignment");
  static_assert(kBytes <= 232448, "shared memory of a block");
};

// c += A B, m16n8k16, bf16 in, f32 accumulators (mma.sync fragments: a0 =
// A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];
// b0 = B[2t..][g], b1 = B[2t+8..][g]; c0, c1 = C[g][2t..], c2, c3 =
// C[g+8][2t..]; g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// (x, y) as bf16x2 (x in the low half), and the rest of each as another.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = wg::bf16x2_bits(__floats2bfloat162_rn(x, y));
  lo = wg::bf16x2_bits(__floats2bfloat162_rn(
      x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u)));
}

// The producer warp: two steps at a time, 16 positions a half warp (lane
// / 16 its step), the pool rows resolved four pairs ahead. Where a page
// holds whole steps (a page size a multiple of 16: a step starts on a
// multiple of 16), a step is one bulk copy of its 16 consecutive pool rows
// (int8: and one of their 16 scales), counted in bytes on the raw slot's
// full barrier; rows of dead positions come along, and the converters zero
// them. Else each live row is a copy of its own (int8: its scale by
// cp.async, zeros for a dead row, then the lane's arrival). A copy never
// crosses a page, and any page size works.
template <typename KV>
__device__ __forceinline__ void produce(const Params& p, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int b, int r, int C, int lo, int hi,
                                        int first, int mine, bool whole,
                                        int lane) {
  using L = Layout<KV>;
  const int* trow = p.table + (size_t)b * p.Tw;
  const char* pool = static_cast<const char*>(p.pool);
  const int e = lane / kStep, jr = lane % kStep;
  // A whole step's first row, or this lane's live row; -1 for none.
  auto row_of = [&](int i) {
    const int pos = first + (r + i * C) * kStep + jr;
    if (i >= mine) return -1;
    if (whole) return jr == 0 ? trow[pos / p.PS] * p.PS + pos % p.PS : -1;
    return pos >= lo && pos < hi ? trow[pos / p.PS] * p.PS + pos % p.PS : -1;
  };
  // The rows of the next kAhead pairs of steps, their table reads in
  // flight together.
  constexpr int kAhead = 4;
  int ahead[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) ahead[a] = row_of(2 * a + e);
  for (int i0 = 0; i0 < mine; i0 += 2) {
    const int i = i0 + e;
    const int cur = ahead[0];
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) ahead[a] = ahead[a + 1];
    ahead[kAhead - 1] = row_of(i + 2 * kAhead);
    const uint32_t live = __ballot_sync(0xffffffffu, cur >= 0);
    if (i < mine) {
      const int slot = i % L::kRaws;
      uint8_t* dst = smem + L::kRaw + slot * L::kRawBytes;
      float* dsc = reinterpret_cast<float*>(smem + L::kScales) + slot * kStep;
      hopper::mbar_wait(&empty[slot], ((i / L::kRaws) & 1) ^ 1);
      if (whole) {
        if (jr == 0) {
          hopper::mbar_arrive_expect_tx(
              &full[slot], L::kRawBytes + (L::kQ8 ? kStep * 4 : 0));
          hopper::bulk_load(dst, pool + (size_t)cur * L::kRowBytes,
                            L::kRawBytes, &full[slot]);
          if constexpr (L::kQ8)
            hopper::bulk_load(dsc, p.scales + cur, kStep * 4, &full[slot]);
        }
      } else {
        if (jr == 0)
          hopper::mbar_arrive_expect_tx(
              &full[slot],
              __popc((live >> (kStep * e)) & 0xffffu) * L::kRowBytes);
        __syncwarp(e ? 0xffff0000u : 0x0000ffffu);
        if (cur >= 0)
          hopper::bulk_load(dst + jr * L::kRowBytes,
                            pool + (size_t)cur * L::kRowBytes, L::kRowBytes,
                            &full[slot]);
        if constexpr (L::kQ8) {
          hopper::cp_async_4(dsc + jr, p.scales + max(cur, 0), cur >= 0);
          hopper::cp_async_arrive_noinc(&full[slot]);
        }
      }
    }
  }
}

// The converter warps (ct = 0..127): each landed raw step into a converted
// tile, as bf16 rows of kTRow bytes; positions outside [lo, hi) become
// zeros (their probabilities are 0, and 0 * V must stay finite). f32: x =
// hi + lo, hi = bf16(x) into the hi tile, lo = bf16(x - hi) into the lo
// tile. int8: the byte values, exact in bf16 (hopper::i8x4_to_bf16x2), and
// the step's scales.
template <typename KV>
__device__ __forceinline__ void convert(uint8_t* smem, uint64_t* raw_full,
                                        uint64_t* raw_empty,
                                        uint64_t* conv_full,
                                        uint64_t* conv_empty, int r, int C,
                                        int lo, int hi, int first, int mine,
                                        int ct, int lane) {
  using L = Layout<KV>;
  constexpr int kLanes = kConvWarps * 32;
  for (int i = 0; i < mine; ++i) {
    const int rs = i % L::kRaws, cs = i % L::kConvs;
    const int s0 = first + (r + i * C) * kStep;
    hopper::mbar_wait(&conv_empty[cs], ((i / L::kConvs) & 1) ^ 1);
    hopper::mbar_wait(&raw_full[rs], (i / L::kRaws) & 1);
    const uint8_t* raw = smem + L::kRaw + rs * L::kRawBytes;
    uint8_t* dst = smem + L::kConv + cs * L::kConvBytes;
    if constexpr (L::kQ8) {
      // Lane ct: row ct / 8, bytes 72 (ct % 8) .. + 71 of it as 9 reads of
      // 8 (a half warp's reads, and a quarter warp's writes of 16, fall on
      // distinct banks).
      const int row = ct >> 3, seg = ct & 7;
      const bool live = s0 + row >= lo && s0 + row < hi;
      const uint2* src =
          reinterpret_cast<const uint2*>(raw + row * kD + seg * 72);
      uint4* out = reinterpret_cast<uint4*>(dst + row * kTRow + seg * 144);
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (live) {
          const uint2 x = src[j];
          hopper::i8x4_to_bf16x2(x.x, v.x, v.y);
          hopper::i8x4_to_bf16x2(x.y, v.z, v.w);
        }
        out[j] = v;
      }
      if (ct < kStep) {
        const int pos = s0 + ct;
        reinterpret_cast<float*>(smem + L::kConvScales)[cs * kStep + ct] =
            pos >= lo && pos < hi
                ? reinterpret_cast<const float*>(smem + L::kScales)[rs * kStep + ct]
                : 0.f;
      }
    } else {
      // Lane ct: rows ct / 16 and 8 + ct / 16, float4 ct % 16 + 16 j of
      // each (a quarter warp's reads and a half warp's writes contiguous).
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const int row = (ct >> 4) + 8 * pass, seg = ct & 15;
        const bool live = s0 + row >= lo && s0 + row < hi;
        const float4* src =
            reinterpret_cast<const float4*>(raw + row * (kD * 4)) + seg;
        uint2* hi_out = reinterpret_cast<uint2*>(dst + row * kTRow) + seg;
        uint2* lo_out =
            reinterpret_cast<uint2*>(dst + kTile + row * kTRow) + seg;
#pragma unroll
        for (int j = 0; j < kD / 64; ++j) {
          const float4 v = live ? src[16 * j] : make_float4(0.f, 0.f, 0.f, 0.f);
          uint32_t h0, l0, h1, l1;
          split2(v.x, v.y, h0, l0);
          split2(v.z, v.w, h1, l1);
          hi_out[16 * j] = make_uint2(h0, h1);
          lo_out[16 * j] = make_uint2(l0, l1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(&raw_empty[rs]);
      hopper::mbar_arrive(&conv_full[cs]);
    }
  }
}

// A consumer warp (w = 0..3): columns [w kCols, (w + 1) kCols) of Q K^T's
// depth and of P V's output, for the 16 score rows (head g, g + 8; rows
// past G are zeros, never written). A step: its partial S over its
// columns (2 n-tiles of 8 positions, K by ldmatrix from the converted
// tile), the four partials summed through shared memory in warp order
// (every warp then holds the same S, m, l and P), the online softmax, P V
// on its columns (18 n-tiles, V by ldmatrix.trans from the same tile);
// then the block's state written to shared memory once every warp is done.
template <typename KV>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem,
                                        uint64_t* conv_full,
                                        uint64_t* conv_empty, int b, int r,
                                        int C, int lo, int hi, int first,
                                        int mine, int w, int lane) {
  using L = Layout<KV>;
  constexpr bool kQ8 = L::kQ8;
  const int g = lane >> 2, t = lane & 3;

  // This warp's columns of Q, zeros for heads past G (rows of kTRow bytes:
  // no other warp reads them).
  {
    const __nv_bfloat16* q =
        static_cast<const __nv_bfloat16*>(p.q) + (size_t)b * p.G * kD;
#pragma unroll
    for (int it = 0; it < 16 * kCols / 8 / 32; ++it) {
      const int idx = it * 32 + lane;
      const int row = idx / (kCols / 8), c8 = idx % (kCols / 8);
      const int col = w * kCols + c8 * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < p.G)
        v = *reinterpret_cast<const uint4*>(q + row * kD + col);
      *reinterpret_cast<uint4*>(smem + L::kQ + row * kTRow + col * 2) = v;
    }
    __syncwarp();
  }
  // ldmatrix lane addresses: matrix m = lane / 8, its row lane % 8. Q's A
  // fragment (m: rows + 8 (m & 1), k + 8 (m >> 1)); K's B fragments of the
  // two n-tiles (m: positions + 8 (m >> 1), k + 8 (m & 1)); V's (.trans;
  // m: positions + 8 (m & 1), columns + 8 (m >> 1)).
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t q_at = hopper::smem_u32(smem + L::kQ) +
                        (mr + ((mi & 1) << 3)) * kTRow +
                        (w * kCols + ((mi >> 1) << 3)) * 2;
  const uint32_t k_at = (mr + ((mi >> 1) << 3)) * kTRow +
                        (w * kCols + ((mi & 1) << 3)) * 2;
  const uint32_t v_at = (mr + ((mi & 1) << 3)) * kTRow +
                        (w * kCols + ((mi >> 1) << 3)) * 2;

  float o[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float4* xb = reinterpret_cast<float4*>(smem + L::kX);
  const float* scl = reinterpret_cast<const float*>(smem + L::kConvScales);
  const float minus_inf = __uint_as_float(0xff800000u);

  // This warp's partial S of step i, issued: n-tile j is positions 8 j ..
  // 8 j + 7; an accumulator a k-step parity and (f32) a term, so that no
  // product waits on the one before it. Step i + 1's products are issued
  // before step i's exchange, softmax and P V, and run beside them.
  float acc[2][kQ8 ? 1 : 2][2][4];
  auto issue_qk = [&](int i) {
    const int cs = i % L::kConvs;
    hopper::mbar_wait(&conv_full[cs], (i / L::kConvs) & 1);
    const uint32_t tile =
        hopper::smem_u32(smem + L::kConv + cs * L::kConvBytes);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < (kQ8 ? 1 : 2); ++e)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][e][j][c] = 0.f;
#pragma unroll
    for (int k = 0; k < kKSteps; ++k) {
      uint32_t qa[4], kf[4];
      ldsm_x4(q_at + k * 32, qa);
      ldsm_x4(tile + k_at + k * 32, kf);
      mma(acc[k & 1][0][0], qa, kf[0], kf[1]);
      mma(acc[k & 1][0][1], qa, kf[2], kf[3]);
      if constexpr (!kQ8) {
        ldsm_x4(tile + kTile + k_at + k * 32, kf);
        mma(acc[k & 1][1][0], qa, kf[0], kf[1]);
        mma(acc[k & 1][1][1], qa, kf[2], kf[3]);
      }
    }
  };
  if (mine > 0) issue_qk(0);

  for (int i = 0; i < mine; ++i) {
    const int cs = i % L::kConvs;
    const int s0 = first + (r + i * C) * kStep;
    const uint32_t tile =
        hopper::smem_u32(smem + L::kConv + cs * L::kConvBytes);
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = acc[0][0][j][c] + acc[1][0][j][c];
        if constexpr (!kQ8)
          s[j][c] += acc[0][kQ8 ? 0 : 1][j][c] + acc[1][kQ8 ? 0 : 1][j][c];
      }
    if (i + 1 < mine) issue_qk(i + 1);

    // The four partials summed in warp order (buffer i & 1: a warp writes
    // step i + 2's partial only after every warp passed step i + 1's
    // barrier, so after every read of step i's).
    float4* xs = xb + (i & 1) * kWarps * 2 * 32;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      xs[(w * 2 + j) * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2],
                                                s[j][3]);
    hopper::named_sync(1, kWarps * 32);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 x0 = xs[j * 32 + lane];
      const float4 x1 = xs[(2 + j) * 32 + lane];
      const float4 x2 = xs[(4 + j) * 32 + lane];
      const float4 x3 = xs[(6 + j) * 32 + lane];
      s[j][0] = ((x0.x + x1.x) + x2.x) + x3.x;
      s[j][1] = ((x0.y + x1.y) + x2.y) + x3.y;
      s[j][2] = ((x0.z + x1.z) + x2.z) + x3.z;
      s[j][3] = ((x0.w + x1.w) + x2.w) + x3.w;
    }

    // The online softmax. Element c of n-tile j: head g + 8 (c >> 1),
    // position 8 j + 2 t + (c & 1) of the step.
    float mx[2] = {minus_inf, minus_inf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int at = 8 * j + 2 * t + (c & 1);
        const int pos = s0 + at;
        // The TPU kernel's order: (q . k) * ks, then * scale.
        float x = s[j][c];
        if constexpr (kQ8) x *= scl[cs * kStep + at];
        x = pos >= lo && pos < hi ? x * p.scale : minus_inf;
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      alpha[hh] = __expf(m_run[hh] - m_new);
      m_run[hh] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pr = __expf(s[j][c] - m_run[c >> 1]);
        sum[c >> 1] += pr;
        if constexpr (kQ8) pr *= scl[cs * kStep + 8 * j + 2 * t + (c & 1)];
        s[j][c] = pr;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + sum[hh];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // O += P V: P (int8: p vs) as bf16 hi + lo A fragments (the score
    // fragments are, lane for lane, P's: a0 / a1 from n-tile 0, a2 / a3
    // from n-tile 1); V's B fragments of two n-tiles an ldmatrix.trans.
    uint32_t ph[4], pl[4];
    split2(s[0][0], s[0][1], ph[0], pl[0]);
    split2(s[0][2], s[0][3], ph[1], pl[1]);
    split2(s[1][0], s[1][1], ph[2], pl[2]);
    split2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int cp = 0; cp < kCols / 16; ++cp) {
      uint32_t vf[4];
      ldsm_x4_t(tile + v_at + cp * 32, vf);
      mma(o[2 * cp], ph, vf[0], vf[1]);
      mma(o[2 * cp + 1], ph, vf[2], vf[3]);
      mma(o[2 * cp], pl, vf[0], vf[1]);
      mma(o[2 * cp + 1], pl, vf[2], vf[3]);
      if constexpr (!kQ8) {
        uint32_t vl[4];
        ldsm_x4_t(tile + kTile + v_at + cp * 32, vl);
        mma(o[2 * cp], ph, vl[0], vl[1]);
        mma(o[2 * cp + 1], ph, vl[2], vl[3]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&conv_empty[cs]);
  }

  // l's partial sums across the quad; then, with every warp of the block
  // done with the rings, the state into the converted ring's bytes.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
  }
  hopper::named_sync(2, kThreads);
  float* state = reinterpret_cast<float*>(smem + L::kState);
  float* sml = reinterpret_cast<float*>(smem + L::kStateML);
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    const int col = w * kCols + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(state + g * kD + col) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(state + (g + 8) * kD + col) =
        make_float2(o[n][2], o[n][3]);
  }
  if (w == 0 && t == 0) {
    sml[g] = m_run[0];
    sml[g + 8] = m_run[1];
    sml[16 + g] = l_run[0];
    sml[16 + g + 8] = l_run[1];
  }
}

// One block: rank r of the cluster of C that serves row b. The row's live
// positions [lo, hi) (hi = min(kv_len, Tw PS), lo from the window anchored
// at q_positions), in steps of 16 from lo rounded down to 16, are dealt to
// the blocks in turn (block r takes steps r, r + C, ...); each block walks
// its own, then the cluster merges the blocks' (O, m, l) through
// distributed shared memory, block r writing its share of the columns.
// Every block runs to the end: the cluster's barriers count them all.
template <typename KV>
__global__ void __launch_bounds__(kThreads, 1)
    latent_decode_tc_kernel(const Params p, float* m_out, float* l_out) {
  using L = Layout<KV>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* raw_empty = raw_full + L::kRaws;
  uint64_t* conv_full = raw_empty + L::kRaws;
  uint64_t* conv_empty = conv_full + L::kConvs;
  const int C = gridDim.x;
  const int r = hopper::cluster_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  // The warp index, broadcast so that the compiler sees it warp-uniform.
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;

  const int hi = min(p.kv_lens[b], p.Tw * p.PS);
  const int lo = p.window > 0 ? max(0, p.q_pos0[b] - p.window + 1) : 0;
  const int first = lo & ~(kStep - 1);
  const int nsteps = hi > lo ? (hi - first + kStep - 1) / kStep : 0;
  const int mine = nsteps > r ? (nsteps - r + C - 1) / C : 0;

  // Pages of a multiple of 16 rows hold whole steps: one copy a step.
  const bool whole = p.PS % kStep == 0;
  if (tid == 0) {
    for (int s = 0; s < L::kRaws; ++s) {
      // int8 rows copied one by one: and the 16 lanes of the step after
      // their scale copies
      hopper::mbar_init(&raw_full[s], L::kQ8 && !whole ? 1 + kStep : 1);
      hopper::mbar_init(&raw_empty[s], kConvWarps);
    }
    for (int s = 0; s < L::kConvs; ++s) {
      hopper::mbar_init(&conv_full[s], kConvWarps);
      hopper::mbar_init(&conv_empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (warp == kProducer) {
    produce<KV>(p, smem, raw_full, raw_empty, b, r, C, lo, hi, first, mine,
                whole, lane);
    hopper::named_sync(2, kThreads);
  } else if (warp >= kWarps) {
    convert<KV>(smem, raw_full, raw_empty, conv_full, conv_empty, r, C, lo,
                hi, first, mine, tid - kWarps * 32, lane);
    hopper::named_sync(2, kThreads);
  } else {
    consume<KV>(p, smem, conv_full, conv_empty, b, r, C, lo, hi, first,
                mine, warp, lane);
  }
  __syncthreads();

  // The merge: every block's (m, l) of each head read once into the
  // partial scores' bytes, the weights exp(m_k - M) and the total l, a head
  // a thread; then block r's share of the columns, 4 at a time, each item's
  // reads of every block's O issued together and summed in rank order.
  const float* state = reinterpret_cast<const float*>(smem + L::kState);
  const float* sml = reinterpret_cast<const float*>(smem + L::kStateML);
  float* ml = reinterpret_cast<float*>(smem + L::kX);  // [2][C][16]
  float* wts = ml + 2 * kMaxCluster * 16;              // [C][16], l [16]
  hopper::cluster_sync();
  for (int idx = tid; idx < C * 16; idx += kThreads) {
    const int k = idx >> 4, g = idx & 15;
    const float mk = hopper::cluster_load(sml + g, k);
    const float lk = hopper::cluster_load(sml + 16 + g, k);
    ml[idx] = mk;
    ml[kMaxCluster * 16 + idx] = lk;
  }
  __syncthreads();
  if (tid < p.G) {
    float mx = kNegInf;
    for (int k = 0; k < C; ++k) mx = fmaxf(mx, ml[k * 16 + tid]);
    float l = 0.f;
    for (int k = 0; k < C; ++k) {
      const float f = __expf(ml[k * 16 + tid] - mx);
      wts[k * 16 + tid] = f;
      l = fmaf(ml[kMaxCluster * 16 + k * 16 + tid], f, l);
    }
    wts[kMaxCluster * 16 + tid] = l;
    if (r == 0) {
      m_out[(size_t)b * p.G + tid] = mx;
      l_out[(size_t)b * p.G + tid] = l;
    }
  }
  __syncthreads();
  constexpr int kC4 = kD / 4;
  const int share = (kC4 + C - 1) / C;
  const int c_lo = min(r * share, kC4), n_c = min(kC4, c_lo + share) - c_lo;
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.out) + (size_t)b * p.G * kD;
  for (int it = tid; it < p.G * n_c; it += kThreads) {
    const int g = it / n_c, c4 = c_lo + it % n_c;
    float4 v[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < C) v[k] = hopper::cluster_load4(state + g * kD + 4 * c4, k);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < C) {
        const float f = wts[k * 16 + g];
        acc.x = fmaf(v[k].x, f, acc.x);
        acc.y = fmaf(v[k].y, f, acc.y);
        acc.z = fmaf(v[k].z, f, acc.z);
        acc.w = fmaf(v[k].w, f, acc.w);
      }
    }
    // A row with nothing to attend: l = 0 gives zeros.
    const float inv = 1.f / fmaxf(wts[kMaxCluster * 16 + g], 1e-20f);
    *reinterpret_cast<uint2*>(out + g * kD + 4 * c4) = make_uint2(
        wg::bf16x2_bits(__floats2bfloat162_rn(acc.x * inv, acc.y * inv)),
        wg::bf16x2_bits(__floats2bfloat162_rn(acc.z * inv, acc.w * inv)));
  }
  hopper::cluster_sync();
}

template <typename KV>
cudaError_t attributes() {
  static const cudaError_t err = [] {
    auto* kernel = latent_decode_tc_kernel<KV>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<KV>::kBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

// The launch of a grid of (C, B) blocks in clusters of C; `attr` holds the
// cluster's dimension.
template <typename KV>
cudaLaunchConfig_t config(cudaLaunchAttribute (&attr)[1], int C, int B,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<KV>::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename KV>
int launch(const Params& p, int B, int C, float* m, float* l,
           cudaStream_t stream) {
  cudaError_t err = attributes<KV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<KV>(attr, C, B, stream);
  err = cudaLaunchKernelEx(&cfg, latent_decode_tc_kernel<KV>, p, m, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int clusters(int C) {
  cudaError_t err = attributes<KV>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<KV>(attr, C, 1, 0);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, latent_decode_tc_kernel<KV>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename KV>
void plan(long long* out) {
  using L = Layout<KV>;
  out[0] = kThreads;
  out[1] = L::kBytes;
  out[2] = L::kRaws;
  out[3] = L::kConvs;
  out[4] = kStep;
  out[5] = kTRow;
  out[6] = kMaxCluster;
  out[7] = kCols;
}

}  // namespace dec

}  // namespace

// Ragged latent attention. q, out: [B, S, G, D] (dtype 0 = bfloat16, 1 =
// float32); pool: [P, 1, PS, D] f32, or int8 with `scales` f32 [P, 1, PS]
// (non-null: the int8 form); table [B, Tw], kv_lens, q_starts, num_news
// [B] int32; window 0 = none. Returns cudaGetLastError() after the launch,
// or -1 outside G in 1..16, D in {80, 576}.
extern "C" int dli_latent_ragged_attention(
    const void* q, const void* pool, const void* scales, const void* table,
    const void* kv_lens, const void* q_starts, const void* num_news,
    void* out, int B, int S, int G, int D, int PS, int Tw, float scale,
    int window, int dtype, void* stream) {
  if (!widths_ok(G, D) || (dtype != 0 && dtype != 1)) return -1;
  if (B <= 0 || S <= 0) return 0;
  const Params p = make_params(q, pool, scales, table, kv_lens, q_starts,
                               num_news, out, S, G, PS, Tw, scale, window,
                               dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scales != nullptr)
    return D == 576 ? ragged<int8_t, 576>(p, B, st) : ragged<int8_t, 80>(p, B, st);
  return D == 576 ? ragged<float, 576>(p, B, st) : ragged<float, 80>(p, B, st);
}

// As dli_latent_ragged_attention on the tensor cores (latent_wgmma_kernel):
// bf16 q (dtype 0) at lat_dim 576 only, 1 to 16 query heads, over the f32
// pool or the int8 one (`scales` non-null); pool and scales 16-byte
// aligned. Returns cudaGetLastError() after the launch, or -1 outside those
// widths.
extern "C" int dli_latent_ragged_wgmma(
    const void* q, const void* pool, const void* scales, const void* table,
    const void* kv_lens, const void* q_starts, const void* num_news,
    void* out, int B, int S, int G, int D, int PS, int Tw, float scale,
    int window, int dtype, void* stream) {
  if (D != wg::kD || dtype != 0 || G < 1 || G > 16) return -1;
  if (B <= 0 || S <= 0) return 0;
  const Params p = make_params(q, pool, scales, table, kv_lens, q_starts,
                               num_news, out, S, G, PS, Tw, scale, window,
                               dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scales != nullptr ? wg::launch<int8_t>(p, B, st)
                           : wg::launch<float>(p, B, st);
}

// The tensor-core instance's launch for S queries of G heads, as
// wg::launch makes it (the wrapper's `latent_wgmma_plan` states the same in
// Python): out[0] query tiles (the grid's x), out[1] queries a block,
// out[2] threads a block, out[3] dynamic shared memory bytes, out[4]
// converted stages, out[5] raw pieces, out[6] positions a piece, out[7]
// positions a step. Returns 0, or -1 outside G in 1..16.
extern "C" int dli_latent_wgmma_plan(int S, int G, int q8, long long* out) {
  if (G < 1 || G > 16 || S <= 0) return -1;
  if (q8)
    wg::plan<int8_t>(S, group_shift(G), out);
  else
    wg::plan<float>(S, group_shift(G), out);
  return 0;
}

// Decode latent attention, one query a row. q, out: [B, 1, G, D]; m, l:
// [B, G] f32; q_positions [B] int32 (read only under a window); `splits`
// blocks a row of `chunk` positions each (a multiple of 32) and their
// scratch part_o [B, splits, R, D], part_m / part_l [B, splits, R] f32 with
// R = decode_rows (G rounded up to 4, 8 or 16). Two launches: the splits,
// then the merge.
extern "C" int dli_latent_paged_attention(
    const void* q, const void* pool, const void* scales, const void* table,
    const void* kv_lens, const void* q_positions, void* out, void* m,
    void* l, void* part_o, void* part_m, void* part_l, int B, int G, int D,
    int PS, int Tw, int splits, int chunk, float scale, int window,
    int dtype, void* stream) {
  if (!widths_ok(G, D) || (dtype != 0 && dtype != 1)) return -1;
  if (chunk <= 0 || chunk % kTile != 0 || splits <= 0 || splits > kMaxSplits)
    return -1;
  if (B <= 0) return 0;
  Params p = make_params(q, pool, scales, table, kv_lens, q_positions,
                         nullptr, out, 1, G, PS, Tw, scale, window, dtype);
  p.chunk = chunk;
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (scales != nullptr)
    return D == 576 ? decode<int8_t, 576>(p, B, splits, mo, lo, st)
                    : decode<int8_t, 80>(p, B, splits, mo, lo, st);
  return D == 576 ? decode<float, 576>(p, B, splits, mo, lo, st)
                  : decode<float, 80>(p, B, splits, mo, lo, st);
}

template <typename KV, int D>
long long smem_of(int r) {
  switch (r) {
    case 4: return (long long)smem_bytes<KV, D, 4>();
    case 8: return (long long)smem_bytes<KV, D, 8>();
    case 16: return (long long)smem_bytes<KV, D, 16>();
    case 32: return (long long)smem_bytes<KV, D, 32>();
  }
  return -1;
}

// Dynamic shared memory bytes of a block: ragged (decode = 0) or decode,
// over an f32 (q8 = 0) or int8 pool.
extern "C" long long dli_latent_smem_bytes(int G, int D, int decode, int q8) {
  if (!widths_ok(G, D)) return -1;
  const int r = decode ? decode_rows(group_shift(G)) : kRaggedRows;
  if (q8) return D == 576 ? smem_of<int8_t, 576>(r) : smem_of<int8_t, 80>(r);
  return D == 576 ? smem_of<float, 576>(r) : smem_of<float, 80>(r);
}

// Decode latent attention on the tensor cores (latent_decode_tc_kernel):
// bf16 q (dtype 0) [B, 1, G, 576], 1 to 16 query heads, over the f32 pool
// or the int8 one (`scales` non-null), pool and scales 16-byte aligned; out
// [B, 1, G, 576] bf16, m and l [B, G] f32; q_positions [B] int32 (read only
// under a window). One launch of B clusters of C (1..16) blocks, no
// scratch. Returns cudaGetLastError() after the launch, or -1 outside
// those widths.
extern "C" int dli_latent_decode_tc(
    const void* q, const void* pool, const void* scales, const void* table,
    const void* kv_lens, const void* q_positions, void* out, void* m,
    void* l, int B, int G, int D, int PS, int Tw, int C, float scale,
    int window, int dtype, void* stream) {
  if (D != dec::kD || dtype != 0 || G < 1 || G > 16 || C < 1 ||
      C > dec::kMaxCluster || PS < 1 || Tw < 1)
    return -1;
  if (B <= 0) return 0;
  const Params p = make_params(q, pool, scales, table, kv_lens, q_positions,
                               nullptr, out, 1, G, PS, Tw, scale, window,
                               dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  return scales != nullptr ? dec::launch<int8_t>(p, B, C, mo, lo, st)
                           : dec::launch<float>(p, B, C, mo, lo, st);
}

// Clusters of C blocks of latent_decode_tc_kernel (over the int8 pool if
// q8) the card holds at once (cudaOccupancyMaxActiveClusters), or minus a
// CUDA error, or -1 for C outside 1..16.
extern "C" int dli_latent_decode_clusters(int C, int q8) {
  if (C < 1 || C > dec::kMaxCluster) return -1;
  return q8 ? dec::clusters<int8_t>(C) : dec::clusters<float>(C);
}

// The tensor-core decode instance's layout, as dec::Layout makes it (the
// wrapper's `latent_decode_plan` states the same in Python): out[0]
// threads a block, out[1] dynamic shared memory bytes, out[2] raw steps of
// the ring, out[3] converted steps, out[4] positions a step, out[5] bytes
// a converted row, out[6] the largest cluster, out[7] columns a consumer
// warp.
extern "C" int dli_latent_decode_plan(int q8, long long* out) {
  if (q8)
    dec::plan<int8_t>(out);
  else
    dec::plan<float>(out);
  return 0;
}

