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
// head, over the one latent head), and K = V = the stored latent. Every
// product and p * vs stay f32 (the JAX kernels promote q to f32); only the
// output is rounded to q's type. No TF32: the engine's exact-stream checks
// need f32 products, as the per-head f32 kernels do.
//
// What bounds it on this card. Decode (B = 8 over 2048 tokens at D = 576,
// G = 16): 37.7 MB of f32 latents, 11 us at 3.35 TB/s, and 0.60 GFLOP, 9 us
// at the CUDA cores' 67 TFLOP/s: both, nearly equally. A ragged prefill of
// 2048 queries: operations (77 GFLOP, 1.15 ms). What the design does:
//
// * K = V: a tile of kTile positions is staged ONCE in shared memory as f32
//   (int8 converted on the way in) and serves both Q K^T and P V.
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
// A simple kernel that is right: no TMA, no tensor cores. Those are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
