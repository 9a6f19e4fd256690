// int4-weight matmul for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of distributed_llm_inference_tpu/ops/quant_matmul.py:
// `_int4_kernel` behind `int4_matmul` and `_int4_stacked_kernel` behind
// `int4_matmul_stacked`. out[r, c] = (sum_k x[r, k] * w[k, c]) * scale[c] for
// a weight packed "half-split": byte column j of a packed row holds output
// channel j in its low nibble and channel j + outp in its high one (outp =
// out_pad / 2 byte columns). The stacked form is the flat one over weight
// [L, in_pad, outp] and scales [L, outp] with the layer index turned into an
// offset (of the scales' base pointers, and of the weight's rows in one
// tensor map over the whole stack), so no layer is ever sliced out or copied.
//
// What bounds it on this card: bytes. At decode x has 1 to 8 rows, so a
// weight byte (two values) feeds at most 16 multiply-adds, far below the
// ~295 operations per byte at which the tensor cores would matter: the
// least time is the packed weight over the HBM rate (8 MB: 2.5 us; the
// 128256-wide head, 264 MB: 79 us). The f32 instance below, which converts
// every nibble to f32 (I2F, a quarter of the FMA rate) and sums 8 x RB f32
// FMAs a word on the CUDA cores, is bound by issue at ~8x that, plus a
// second launch and an f32 round trip to add its split partials; bf16 x,
// every decode call, no longer takes it.
//
// bfloat16 x (`int4_mma_kernel<NT>`, NT = n-tiles of 8 rows, 1 2 4 or 8):
//
// * One launch a call. A cluster of C blocks (1-16, the wrapper's
//   `mma_plan`) owns a tile of 128 byte columns (256 output channels) and
//   splits the input rows: block `rank` takes rows [rank * k_block, ...).
//   The grid is (tiles * C, passes of 64 x rows).
// * Bytes: a producer warp streams the block's rows of the tile into a ring
//   of 3 stages of 128 rows x 128 bytes by TMA (one box a stage, 128-byte
//   swizzle; 48 KB in flight a block, two blocks an SM at decode). The map
//   covers the whole stack [L * in_pad, outp] and is encoded once per
//   weight (cached on the host by its geometry), so a call encodes nothing.
// * Products on the tensor cores: mma.sync m16n8k16, bf16 in, f32
//   accumulators, the weight as A (M = output channels) and x as B (N = 8
//   rows). An A register holds one channel at two k, but a packed byte holds
//   two channels at one k: a lane reads one word (4 byte columns) of rows
//   2t, 2t+1, 2t+8 and 2t+9 of a 16-row step (conflict-free under the
//   swizzle) and pairs two rows' bytes with prmt; the k order is the mma's
//   own, so x needs no permutation. One word of paired bytes gives 4 bf16
//   pairs: 4 m-tiles a step for a lane's 4 columns (low and high nibbles).
// * No conversion instructions: a nibble u (n = u or u - 16) goes into the
//   mantissa of bf16 128, 0x4300 | (u ^ 8) = 136 + n, and an HFMA2
//   subtracts 136: one lop3 and one HFMA2 for two values, exact for n in
//   [-8, 7]. Products of bf16 x and int4 w are exact in f32.
// * x: the block's rows of x for its k range (at most 56 KB, in windows past
//   that) are staged once by the consumer warps, in the order of the mma's
//   B fragments (one 8-byte load an n-tile a step).
// * Warps: 8 consumer warps, 4 along the tile's columns (32 bytes each) and
//   2 along k (alternate 16-row steps of a stage); their sums add in a fixed
//   order (k warp 0 + k warp 1) into shared memory over the drained ring.
//   The split over k is summed in the cluster: block `rank` adds its 256 / C
//   channels of every block's partial, read through distributed shared
//   memory in rank order, multiplies the f32 scales in and rounds once to
//   bf16. No f32 scratch leaves the SMs, and two calls on the same inputs
//   give the same bytes. Every block runs to the end (the cluster barriers).
//
// float32 x (`int4_matmul_kernel`, for the exact-parity runs; TF32
// products would not pass them): a block owns 128 byte columns
// and a range of input rows, its 8 warps every 8th row, 16 loads in flight a
// lane; a lane unpacks its word by shift and sign extension ((b << 4) >> 4
// low, b >> 4 high), converts to f32 and accumulates for up to 8 rows of x
// staged in shared memory. When the input rows are split over blocks (grid
// y, about two blocks an SM), each writes an f32 partial and
// `int4_combine_kernel` adds them in split order. The products round as the
// TPU kernel's f32 products do.
//
// Both: input rows past in_dim (the zero padding of x) contribute nothing;
// channels past out_dim (the padding) are never written; both halves of the
// output go into one [rows, out_dim] tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 x: the CUDA-core kernel and its combine
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileWords = 32;   // 32-bit words (4 byte columns) per tile row
constexpr int kStage = 512;      // input rows of x staged per step
constexpr int kUnroll = 16;      // loads in flight per lane

// Channel of accumulator slot e (0..7) of a lane's word: even e = low nibble
// of byte e / 2 (channel col + e / 2), odd e = its high nibble (channel
// col + e / 2 + outp).
template <int RB>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(
    const float* __restrict__ x,        // [rows, in_dim]
    const uint32_t* __restrict__ w,     // [in_pad, outp / 4] words, this layer
    const float* __restrict__ s_lo,     // [outp], this layer
    const float* __restrict__ s_hi,     // [outp], this layer
    float* __restrict__ out,            // [rows, out_dim]
    float* __restrict__ part,           // [splits, rows, 2 * outp] or unused
    int rows, int in_dim, int outp, int out_dim, int chunk) {
  __shared__ float smem[4 * RB * 8 * 32];  // x stage, then the warp merge
  static_assert(kStage * RB <= 4 * RB * 8 * 32, "x stage must fit");
  static_assert(RB * kStage % kThreads == 0, "whole stage per thread");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = outp >> 2;
  const int word = blockIdx.x * kTileWords + lane;
  const bool col_ok = word < words;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * RB;
  const int k0 = split * chunk;
  const int k1 = min(in_dim, k0 + chunk);

  float acc[RB][8];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  constexpr int kPer = RB * kStage / kThreads;  // staged x values a thread
  for (int ks = k0; ks < k1; ks += kStage) {
    const int ke = min(k1, ks + kStage);
    // All of a thread's x loads are issued before any is stored: a load
    // followed by its dependent store per iteration paid one memory latency
    // per iteration, ~19 us a launch even for a 2 MB weight.
    float xv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kStage;
      const int k = ks + i % kStage;
      xv[j] = (k < ke && r0 + r < rows) ? x[(size_t)(r0 + r) * in_dim + k]
                                        : 0.f;
    }
    __syncthreads();  // the previous step is done with the stage
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      smem[(i % kStage) * RB + i / kStage] = xv[j];
    }
    __syncthreads();
    for (int kb = ks + warp; kb < ke; kb += kWarps * kUnroll) {
      uint32_t wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kWarps;
        wv[u] = (col_ok && k < ke) ? __ldg(w + (size_t)k * words + word) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kWarps;
        if (k >= ke) break;
        float wf[8];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          wf[2 * b] = (float)((int32_t)(wv[u] << (28 - 8 * b)) >> 28);
          wf[2 * b + 1] = (float)((int32_t)(wv[u] << (24 - 8 * b)) >> 28);
        }
        const float* xr = smem + (k - ks) * RB;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xv = xr[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] += xv * wf[e];
        }
      }
    }
  }

  // Merge the 8 warps: 4 slots of [RB][8][32] floats, halved three times.
  __syncthreads();  // every warp is done with the x stage
  constexpr int kSlot = RB * 8 * 32;
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          smem[(warp - half) * kSlot + (r * 8 + e) * 32 + lane] = acc[r][e];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[r][e] += smem[warp * kSlot + (r * 8 + e) * 32 + lane];
    }
    __syncthreads();
  }
  if (warp != 0 || !col_ok) return;

  const int col = word * 4;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r0 + r >= rows) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = col + e / 2 + ((e & 1) ? outp : 0);
      if (ch >= out_dim) continue;
      if (gridDim.y == 1) {
        const float sc = (e & 1) ? s_hi[col + e / 2] : s_lo[col + e / 2];
        out[(size_t)(r0 + r) * out_dim + ch] = acc[r][e] * sc;
      } else {
        part[((size_t)split * rows + r0 + r) * 2 * outp + ch] = acc[r][e];
      }
    }
  }
}

// Adds the partials of the input-row splits in split order, multiplies the
// scale in and rounds once.
__global__ void __launch_bounds__(kThreads) int4_combine_kernel(
    const float* __restrict__ part, const float* __restrict__ s_lo,
    const float* __restrict__ s_hi, float* __restrict__ out, int rows,
    int outp, int out_dim, int splits) {
  const size_t n = (size_t)rows * out_dim;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    const int r = (int)(i / out_dim);
    const int ch = (int)(i % out_dim);
    float sum = 0.f;
    for (int s = 0; s < splits; ++s)
      sum += part[((size_t)s * rows + r) * 2 * outp + ch];
    const float sc = ch < outp ? s_lo[ch] : s_hi[ch - outp];
    out[i] = sum * sc;
  }
}

template <int RB>
int launch_f32(const float* x, const uint32_t* w, const float* s_lo,
               const float* s_hi, float* out, float* part, int rows,
               int in_dim, int outp, int out_dim, int splits,
               cudaStream_t stream) {
  const int tiles = (outp / 4 + kTileWords - 1) / kTileWords;
  // Each split's range is a whole number of warp-strides.
  int chunk = (in_dim + splits - 1) / splits;
  chunk = (chunk + kWarps - 1) / kWarps * kWarps;
  splits = (in_dim + chunk - 1) / chunk;
  dim3 grid(tiles, splits, (rows + RB - 1) / RB);
  int4_matmul_kernel<RB><<<grid, kThreads, 0, stream>>>(
      x, w, s_lo, s_hi, out, part, rows, in_dim, outp, out_dim, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = (long long)rows * out_dim;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096
                               ? (n + kThreads - 1) / kThreads : 4096);
  int4_combine_kernel<<<blocks, kThreads, 0, stream>>>(
      part, s_lo, s_hi, out, rows, outp, out_dim, splits);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const float* x, const uint32_t* w, const float* s_lo,
                 const float* s_hi, float* out, float* part, int rows,
                 int in_dim, int outp, int out_dim, int splits,
                 cudaStream_t stream) {
#define DLI_ROWS(RB)                                                        \
  return launch_f32<RB>(x, w, s_lo, s_hi, out, part, rows, in_dim, outp,    \
                        out_dim, splits, stream)
  if (rows <= 1) DLI_ROWS(1);
  if (rows <= 2) DLI_ROWS(2);
  if (rows <= 4) DLI_ROWS(4);
  DLI_ROWS(8);
#undef DLI_ROWS
}

// ---------------------------------------------------------------------------
// bfloat16 x: tensor-core products on a TMA ring, the split-K sum in a
// cluster
// ---------------------------------------------------------------------------

constexpr int kTile = 128;        // byte columns of a tile: 256 channels
constexpr int kStageRows = 128;   // packed rows of a ring stage
constexpr int kStageBytes = kStageRows * kTile;
// Ring stages (tools/torch_cluster_sweep.py --int4 rebuilds with others):
// on an H100, 2 and 3 time alike; 4 and 6 leave one block an SM at 8 rows
// and run up to 17% slower on the 29 MB projections and the head.
#ifndef INT4_STAGES
#define INT4_STAGES 3
#endif
constexpr int kRingStages = INT4_STAGES;
constexpr int kRing = kRingStages * kStageBytes;
constexpr int kKWarps = 2;          // consumer warps along k
constexpr int kConsumerWarps = 4 * kKWarps;  // x 4 along the columns
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kMmaThreads = kConsumers + 32;  // + the producer warp
constexpr int kPassRows = 64;      // x rows of one pass over the weight
constexpr int kMaxCluster = 16;
// Bytes of x a block stages at once: with the ring, two blocks of 8-row
// calls fit an SM (2 x 106 KB of its 228).
constexpr int kXBudget = 56 * 1024;
constexpr int kRedRow = 2 * kTile;   // floats of a row of a block's partial

// Shared memory from a 1024-aligned base: the ring, then the x window;
// the block's partial sums (8 NT rows x 256 channels, f32) over the start
// once the ring is drained; then the ring's full and empty barriers.
struct MmaLayout {
  int x_window;  // rows of x staged at once, a multiple of kStageRows
  int bars;      // offset of the barriers
  int alloc;     // dynamic shared memory a block asks for
};

inline MmaLayout mma_layout(int nt, int k_block) {
  MmaLayout l;
  const int most = kXBudget / (nt * 16) / kStageRows * kStageRows;
  l.x_window = k_block < most ? k_block : most;
  int used = kRing + l.x_window * nt * 16;
  const int red = nt * 8 * kRedRow * 4;
  if (used < red) used = red;
  l.bars = used;
  l.alloc = l.bars + 2 * kRingStages * 8 + 1024;
  return l;
}

constexpr int kMaxAlloc = kRing + kXBudget + 2 * kRingStages * 8 + 1024;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A word of paired packed bytes, p = [c0 at k, c1 at k, c0 at k', c1 at
// k'] (byte 0 first), as four bf16 pairs (k low half, k' high half): the
// low nibbles of c0, the high nibbles of c0, then those of c1. A nibble u
// (the int4 n = u, or u - 16 from 8 on) lands in the mantissa of bf16 128:
// 0x4300 | (u ^ 8) is 136 + n, one lop3 ((p & mask) ^ magic, both in
// registers), and the HFMA2 subtracts 136, exactly.
__device__ __forceinline__ void nibble_pairs(uint32_t p, uint32_t (&o)[4]) {
  const uint32_t mask = 0x000F000Fu, magic = 0x43084308u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v;
    asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
        : "=r"(v) : "r"(p >> (4 * i)), "r"(mask), "r"(magic));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(o[i]) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x rows row0 .. row0 + 8 NT - 1, inputs k0 .. k0 + n - 1 (n a multiple of
// 16), into `xs` in the order of the B fragments: for 16-row step q and
// n-tile j, lane (g, t) finds its 8 bytes, x[row0 + 8j + g][k0 + 16q + 2t
// + {0, 1, 8, 9}], at ((q NT + j) 32 + lane) 8. Zeros past `rows` and past
// k_end. Run by the consumer threads; each pair of values is one 4-byte
// cp.async (all of a thread's in flight at once), or two plain loads where
// x's rows are not 4-byte aligned and at an odd k_end.
template <int NT>
__device__ __forceinline__ void stage_x(uint8_t* xs,
                                        const __nv_bfloat16* __restrict__ x,
                                        int rows, int in_dim, int row0,
                                        int k0, int k_end, int n) {
  const uint16_t* xu = reinterpret_cast<const uint16_t*>(x);
  const bool pairs_aligned =
      (in_dim & 1) == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  const int count = (n >> 4) * NT * 64;  // 32-bit pairs
  for (int p = threadIdx.x; p < count; p += kConsumers) {
    const int h = p & 1, ln = (p >> 1) & 31, qj = p >> 6;
    const int j = qj % NT, q = qj / NT;
    const int r = row0 + 8 * j + (ln >> 2);
    const int k = k0 + 16 * q + 2 * (ln & 3) + 8 * h;
    const bool live = r < rows && k < k_end;
    uint32_t* dst = reinterpret_cast<uint32_t*>(xs) + p;
    const uint16_t* at = live ? xu + (size_t)r * in_dim + k : xu;
    if (pairs_aligned && (!live || k + 1 < k_end)) {
      hopper::cp_async_4(dst, at, live);
    } else {
      uint32_t v = 0;
      if (live) {
        v = __ldg(at);
        if (k + 1 < k_end) v |= (uint32_t)__ldg(at + 1) << 16;
      }
      *dst = v;
    }
  }
  hopper::cp_async_wait_all();
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads, NT <= 2 ? 2 : 1)
    int4_mma_kernel(
        const __grid_constant__ CUtensorMap w_map,  // [L * in_pad, outp] bytes
        const __nv_bfloat16* __restrict__ x,        // [rows, in_dim]
        const float* __restrict__ s_lo,             // [outp], this layer
        const float* __restrict__ s_hi,             // [outp], this layer
        __nv_bfloat16* __restrict__ out,            // [rows, out_dim]
        int rows, int in_dim, int outp, int out_dim, int row_base,
        int k_block, int x_window, int bars_off) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* xs = smem + kRing;
  float* red = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars_off);
  uint64_t* empty = full + kRingStages;

  const int C = hopper::cluster_blocks();  // a power of two
  const int log_c = __ffs(C) - 1;
  const int rank = hopper::cluster_rank();
  const int tile = blockIdx.x >> log_c;
  const int row0 = blockIdx.y * kPassRows;
  const int k_begin = rank * k_block;
  const int k_end = min(in_dim, k_begin + k_block);
  const int steps =
      k_end > k_begin ? (k_end - k_begin + kStageRows - 1) / kStageRows : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = warp & 3;         // consumer: 32 byte columns of the tile
  const int kw = warp >> 2;        // consumer: every other 16-row step

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // acc[m][j]: m-tile m (m & 1: low or high nibbles; m >> 1: columns c0,
  // c1 or c2, c3 of the lane's word) against n-tile j.
  float acc[4][NT][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  if (warp == kConsumerWarps) {
    // The producer: one TMA box a stage, as soon as its slot is free.
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int slot = i % kRingStages;
        hopper::mbar_wait(&empty[slot], ((i / kRingStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[slot], kStageBytes);
        hopper::tma_load_2d(ring + slot * kStageBytes, &w_map, &full[slot],
                            tile * kTile, row_base + k_begin + i * kStageRows);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    // The lane's word: byte columns col .. col + 3 of rows 2t and 2t + 1
    // of a step (and 2t + 8, 2t + 9: the same swizzle phase), where the
    // 128-byte swizzle put them (16-byte chunk c of row r at c ^ (r & 7)).
    const int col = 32 * cw + 4 * g;
    const int off_e =
        (2 * t) * kTile + ((((col >> 4) ^ (2 * t)) << 4) | (col & 15));
    const int off_o =
        (2 * t + 1) * kTile + ((((col >> 4) ^ (2 * t + 1)) << 4) | (col & 15));
    int xk = x_window;  // rows of the staged window behind this stage
    for (int i = 0; i < steps; ++i) {
      const int kk = i * kStageRows;
      if (xk == x_window) {
        if (i > 0) hopper::named_sync(1, kConsumers);  // done with the last
        stage_x<NT>(xs, x, rows, in_dim, row0, k_begin + kk, k_end,
                    min(x_window, steps * kStageRows - kk));
        hopper::named_sync(1, kConsumers);
        xk = 0;
      }
      const int slot = i % kRingStages;
      hopper::mbar_wait(&full[slot], (i / kRingStages) & 1);
      const uint8_t* st = ring + slot * kStageBytes;
      const int xq = xk >> 4;
      xk += kStageRows;
#pragma unroll
      for (int qq = 0; qq < kStageRows / 16 / kKWarps; ++qq) {
        const int q = kKWarps * qq + kw;
        const uint8_t* base = st + q * 16 * kTile;
        const uint32_t w0 = lds32(base + off_e);
        const uint32_t w1 = lds32(base + off_o);
        const uint32_t w8 = lds32(base + 8 * kTile + off_e);
        const uint32_t w9 = lds32(base + 8 * kTile + off_o);
        uint32_t c01[4], c01_8[4], c23[4], c23_8[4];
        nibble_pairs(hopper::prmt(w0, w1, 0x5410), c01);    // k 2t, 2t+1
        nibble_pairs(hopper::prmt(w8, w9, 0x5410), c01_8);  // 2t+8, 2t+9
        nibble_pairs(hopper::prmt(w0, w1, 0x7632), c23);
        nibble_pairs(hopper::prmt(w8, w9, 0x7632), c23_8);
        // A fragments: a0 = (m = g, k 2t..), a1 = (g + 8, 2t..), a2 = (g,
        // 2t+8..), a3 = (g + 8, 2t+8..); m = g is the word's first column
        // of the pair, g + 8 its second.
        const uint32_t a[4][4] = {{c01[0], c01[2], c01_8[0], c01_8[2]},
                                  {c01[1], c01[3], c01_8[1], c01_8[3]},
                                  {c23[0], c23[2], c23_8[0], c23_8[2]},
                                  {c23[1], c23[3], c23_8[1], c23_8[3]}};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              xs + (((xq + q) * NT + j) * 32 + lane) * 8);
#pragma unroll
          for (int m = 0; m < 4; ++m) mma_bf16(acc[m][j], a[m], b.x, b.y);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    }

    // The block's partial: the last k warp's sums, then each k warp's
    // added to them in turn down to k warp 0 (a fixed order), into
    // red[row][channel slot] (slot = 128 * high + byte column).
    hopper::named_sync(1, kConsumers);  // every consumer is done with the ring
#pragma unroll
    for (int pass = kKWarps - 1; pass >= 0; --pass) {
      if (kw == pass) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int slot = (m & 1) * kTile + col + 2 * (m >> 1) + (e >> 1);
              float* at = red + (8 * j + 2 * t + (e & 1)) * kRedRow + slot;
              *at = pass == kKWarps - 1 ? acc[m][j][e] : acc[m][j][e] + *at;
            }
      }
      if (pass > 0) hopper::named_sync(1, kConsumers);
    }
  }

  // The cluster's sum: block `rank` takes 256 / C channel slots of every
  // row of the pass, 4 at a time, adding the C partials in rank order
  // (loads issued 4 blocks at a time, then added in order).
  __syncwarp();  // the producer warp's lanes meet again
  hopper::cluster_sync();
  const int pass_rows = min(NT * 8, rows - row0);
  const int log_per4 = 6 - log_c;  // 64 / C groups of 4 slots a block
  for (int e = threadIdx.x; e < pass_rows << log_per4; e += kMmaThreads) {
    const int r = e >> log_per4;
    const int slot = ((rank << log_per4) + (e & ((1 << log_per4) - 1))) * 4;
    const float* at = red + r * kRedRow + slot;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < C; q0 += 4) {
      float4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q0 + q < C) v[q] = hopper::cluster_load4(at, q0 + q);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q0 + q < C) {
          sum[0] += v[q].x;
          sum[1] += v[q].y;
          sum[2] += v[q].z;
          sum[3] += v[q].w;
        }
      }
    }
    const bool high = slot >= kTile;
    const float* sc = high ? s_hi : s_lo;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int bc = tile * kTile + (slot & (kTile - 1)) + u;
      const int ch = (high ? outp : 0) + bc;
      if (bc < outp && ch < out_dim)
        out[(size_t)(row0 + r) * out_dim + ch] =
            __float2bfloat16(sum[u] * sc[bc]);
    }
  }
  hopper::cluster_sync();  // no block leaves while its partial is read
}

// One tensor map per weight stack, rows [L * in_pad] of outp bytes, boxes
// of 128 rows x 128 bytes, encoded at its first call and kept: the key is
// the map's whole geometry, so a map found is right for whatever tensor
// lies at that address now. Returns 0, or -2 if cuTensorMapEncodeTiled
// refused it.
int weight_map(const void* base, uint64_t rows, uint64_t cols,
               CUtensorMap* map) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    uint64_t rows, cols;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].base == base && cache[i].rows == rows &&
        cache[i].cols == cols) {
      *map = cache[i].map;
      return 0;
    }
  }
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols};
  const uint32_t box[2] = {(uint32_t)kTile, (uint32_t)kStageRows};
  const int err = hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                                     base, dims, strides, box,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  cache[next].map = *map;
  cache[next].base = base;
  cache[next].rows = rows;
  cache[next].cols = cols;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return 0;
}

template <int NT>
cudaError_t mma_attributes() {
  static const cudaError_t err = [] {
    auto* kernel = int4_mma_kernel<NT>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxAlloc);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

// The launch of a grid of (tiles * C, passes) blocks in clusters of C;
// `attr` holds the cluster's dimension.
inline cudaLaunchConfig_t mma_config(cudaLaunchAttribute (&attr)[1],
                                     int threads, int alloc, int tiles, int C,
                                     int passes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C, passes, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = alloc;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NT>
int launch_mma(const CUtensorMap& map, const void* x, const float* s_lo,
               const float* s_hi, void* out, int rows, int in_dim, int outp,
               int out_dim, int row_base, int C, int k_block,
               cudaStream_t stream) {
  cudaError_t err = mma_attributes<NT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const MmaLayout l = mma_layout(NT, k_block);
  const int tiles = (outp + kTile - 1) / kTile;
  const int passes = (rows + kPassRows - 1) / kPassRows;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      mma_config(attr, kMmaThreads, l.alloc, tiles, C, passes, stream);
  err = cudaLaunchKernelEx(&cfg, int4_mma_kernel<NT>, map,
                           static_cast<const __nv_bfloat16*>(x), s_lo, s_hi,
                           static_cast<__nv_bfloat16*>(out), rows, in_dim,
                           outp, out_dim, row_base, k_block, l.x_window,
                           l.bars);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int occupancy_mma(int C, int k_block, long long* out) {
  cudaError_t err = mma_attributes<NT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* kernel = int4_mma_kernel<NT>;
  const MmaLayout l = mma_layout(NT, k_block);
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kMmaThreads, l.alloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      mma_config(attr, kMmaThreads, l.alloc, 1, C, 1, 0);
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.alloc;
  out[1] = blocks;
  out[2] = clusters;
  out[3] = fa.numRegs;
  out[4] = fa.localSizeBytes;
  out[5] = l.x_window;
  return 0;
}

int n_tiles(int rows) { return rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : 8; }

}  // namespace

// float32 x. x: [rows, in_dim]; packed: int8 [L, in_pad, outp] (outp a
// multiple of 4); scale_lo / scale_hi: f32 [L, outp]; out: f32 [rows,
// out_dim]; part: f32 scratch [splits, rows, 2 * outp] when splits > 1
// (unused otherwise). `layer` selects the weight and scales of one layer by
// offset. bfloat16 x takes dli_int4_matmul_mma. Returns cudaGetLastError()
// after the launches, or -1 for arguments the kernel does not take.
extern "C" int dli_int4_matmul(
    const void* x, const void* packed, const void* scale_lo,
    const void* scale_hi, void* out, void* part, int rows, int in_dim,
    int in_pad, int outp, int out_dim, int layer, int splits, void* stream) {
  if (rows <= 0 || out_dim <= 0) return 0;
  if (in_dim <= 0 || in_dim > in_pad || outp % 4 || out_dim > 2 * outp ||
      layer < 0 || splits < 1)
    return -1;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      static_cast<const int8_t*>(packed) + (size_t)layer * in_pad * outp);
  const float* lo = static_cast<const float*>(scale_lo) + (size_t)layer * outp;
  const float* hi = static_cast<const float*>(scale_hi) + (size_t)layer * outp;
  return dispatch_f32(static_cast<const float*>(x), w, lo, hi,
                      static_cast<float*>(out), static_cast<float*>(part),
                      rows, in_dim, outp, out_dim, splits,
                      static_cast<cudaStream_t>(stream));
}

// bfloat16 x, one launch. packed: int8 [num_layers, in_pad, outp] (outp a
// multiple of 16, 16-byte aligned); scale_lo / scale_hi: f32 [num_layers,
// outp]; out: bf16 [rows, out_dim]. Clusters of `cluster` blocks (1, 2, 4,
// 8 or 16) split the input rows, `k_block` (a multiple of 128) a block, and
// cluster * k_block must cover in_dim. Returns cudaGetLastError() after the
// launch, -1 for arguments the kernel does not take, -2 if
// cuTensorMapEncodeTiled refused the tensor map.
extern "C" int dli_int4_matmul_mma(
    const void* x, const void* packed, const void* scale_lo,
    const void* scale_hi, void* out, int rows, int in_dim, int in_pad,
    int outp, int out_dim, int layer, int num_layers, int cluster,
    int k_block, void* stream) {
  if (rows <= 0 || out_dim <= 0) return 0;
  if (in_dim <= 0 || in_dim > in_pad || outp % 16 || out_dim > 2 * outp ||
      layer < 0 || layer >= num_layers || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      k_block <= 0 || k_block % kStageRows ||
      (long long)cluster * k_block < in_dim ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return -1;
  CUtensorMap map;
  const int err = weight_map(packed, (uint64_t)num_layers * in_pad,
                             (uint64_t)outp, &map);
  if (err != 0) return err;
  const float* lo = static_cast<const float*>(scale_lo) + (size_t)layer * outp;
  const float* hi = static_cast<const float*>(scale_hi) + (size_t)layer * outp;
  const int row_base = layer * in_pad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLI_NT(NT)                                                           \
  return launch_mma<NT>(map, x, lo, hi, out, rows, in_dim, outp, out_dim,   \
                        row_base, cluster, k_block, st)
  switch (n_tiles(rows)) {
    case 1: DLI_NT(1);
    case 2: DLI_NT(2);
    case 4: DLI_NT(4);
    default: DLI_NT(8);
  }
#undef DLI_NT
}

// The bf16 instance's resources for `rows` rows of x, clusters of `cluster`
// blocks and `k_block` input rows a block: out[0] shared memory a block,
// out[1] blocks an SM, out[2] clusters the card holds at once, out[3]
// registers a thread, out[4] local memory (spills) a thread, out[5] rows of
// x staged at once. Returns 0 or the CUDA error of a query.
extern "C" int dli_int4_mma_occupancy(int rows, int cluster, int k_block,
                                      long long* out) {
  if (cluster < 1 || cluster > kMaxCluster || k_block <= 0) return -1;
  switch (n_tiles(rows)) {
    case 1: return occupancy_mma<1>(cluster, k_block, out);
    case 2: return occupancy_mma<2>(cluster, k_block, out);
    case 4: return occupancy_mma<4>(cluster, k_block, out);
    default: return occupancy_mma<8>(cluster, k_block, out);
  }
}
