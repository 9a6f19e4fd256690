// int4-weight matmul for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of distributed_llm_inference_tpu/ops/quant_matmul.py:
// `_int4_kernel` behind `int4_matmul` and `_int4_stacked_kernel` behind
// `int4_matmul_stacked`. out[r, c] = (sum_k x[r, k] * w[k, c]) * scale[c] for
// a weight packed "half-split": byte column j of a packed row holds output
// channel j in its low nibble and channel j + outp in its high one (outp =
// out_pad / 2 byte columns). The stacked form is the flat one over weight
// [L, in_pad, outp] and scales [L, outp] with the layer index turned into an
// offset of their base pointers, so no layer is ever sliced out or copied.
//
// What bounds it on this card: bytes. At decode x has at most 8 rows, so a
// weight byte (two values) feeds at most 16 multiply-adds, far below the
// ~295 operations per byte at which the arithmetic units would matter. The
// kernel therefore reads each packed byte once, 4 bytes a lane with
// neighbouring lanes on neighbouring addresses, and does the rest in
// registers:
//
// * A block owns a tile of 128 byte columns (one warp-wide row segment, 256
//   output channels) and a range of input rows; its 8 warps take every 8th
//   row of the range, 16 loads in flight each (with 4, each warp's walk was
//   a chain of load latencies: 22 us for a 2 MB projection). A lane unpacks
//   its word by shift and sign extension of each byte ((b << 4) >> 4 low,
//   b >> 4 high, done on the 32-bit word), converts to f32 and accumulates
//   x * w for up to 8 rows of x, which are staged in shared memory as f32.
// * The 8 warps' sums merge through shared memory. When the input rows are
//   split over several blocks (grid y, sized by the wrapper so that about
//   two blocks per SM exist), each block writes an f32 partial and a second
//   small kernel adds the partials in a fixed order: the result does not
//   depend on scheduling, so two runs of the engine give the same tokens.
// * The epilogue multiplies the f32 scales in and rounds once to x's type,
//   writing both halves of the output into one [rows, out_dim] tensor;
//   channels past out_dim (the padding) are never written.
//
// Input rows past in_dim (the zero padding of x) are skipped. Products of
// bf16 x and int4 w are exact in f32, so in bf16 only the order of the f32
// sums differs from the plain version; in f32 the products round as the TPU
// kernel's f32 products do (no TF32).
//
// Left to later changes: tensor-core products (mma with the unpacked tile
// as one operand), which would matter only for many rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileWords = 32;   // 32-bit words (4 byte columns) per tile row
constexpr int kStage = 512;      // input rows of x staged per step
constexpr int kUnroll = 16;      // loads in flight per lane

__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Channel of accumulator slot e (0..7) of a lane's word: even e = low nibble
// of byte e / 2 (channel col + e / 2), odd e = its high nibble (channel
// col + e / 2 + outp).
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(
    const T* __restrict__ x,            // [rows, in_dim]
    const uint32_t* __restrict__ w,     // [in_pad, outp / 4] words, this layer
    const float* __restrict__ s_lo,     // [outp], this layer
    const float* __restrict__ s_hi,     // [outp], this layer
    T* __restrict__ out,                // [rows, out_dim]
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
      xv[j] = (k < ke && r0 + r < rows)
                  ? load_one(x + (size_t)(r0 + r) * in_dim + k) : 0.f;
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
        store_one(out + (size_t)(r0 + r) * out_dim + ch, acc[r][e] * sc);
      } else {
        part[((size_t)split * rows + r0 + r) * 2 * outp + ch] = acc[r][e];
      }
    }
  }
}

// Adds the partials of the input-row splits in split order, multiplies the
// scale in and rounds once.
template <typename T>
__global__ void __launch_bounds__(kThreads) int4_combine_kernel(
    const float* __restrict__ part, const float* __restrict__ s_lo,
    const float* __restrict__ s_hi, T* __restrict__ out, int rows, int outp,
    int out_dim, int splits) {
  const size_t n = (size_t)rows * out_dim;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    const int r = (int)(i / out_dim);
    const int ch = (int)(i % out_dim);
    float sum = 0.f;
    for (int s = 0; s < splits; ++s)
      sum += part[((size_t)s * rows + r) * 2 * outp + ch];
    const float sc = ch < outp ? s_lo[ch] : s_hi[ch - outp];
    store_one(out + i, sum * sc);
  }
}

template <typename T, int RB>
int launch(const void* x, const uint32_t* w, const float* s_lo,
           const float* s_hi, void* out, float* part, int rows, int in_dim,
           int outp, int out_dim, int splits, cudaStream_t stream) {
  const int tiles = (outp / 4 + kTileWords - 1) / kTileWords;
  // Each split's range is a whole number of warp-strides.
  int chunk = (in_dim + splits - 1) / splits;
  chunk = (chunk + kWarps - 1) / kWarps * kWarps;
  splits = (in_dim + chunk - 1) / chunk;
  dim3 grid(tiles, splits, (rows + RB - 1) / RB);
  int4_matmul_kernel<T, RB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, s_lo, s_hi, static_cast<T*>(out), part,
      rows, in_dim, outp, out_dim, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = (long long)rows * out_dim;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096
                               ? (n + kThreads - 1) / kThreads : 4096);
  int4_combine_kernel<T><<<blocks, kThreads, 0, stream>>>(
      part, s_lo, s_hi, static_cast<T*>(out), rows, outp, out_dim, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_rows(const void* x, const uint32_t* w, const float* s_lo,
                  const float* s_hi, void* out, float* part, int rows,
                  int in_dim, int outp, int out_dim, int splits,
                  cudaStream_t stream) {
#define DLI_ROWS(RB)                                                        \
  return launch<T, RB>(x, w, s_lo, s_hi, out, part, rows, in_dim, outp,     \
                       out_dim, splits, stream)
  if (rows <= 1) DLI_ROWS(1);
  if (rows <= 2) DLI_ROWS(2);
  if (rows <= 4) DLI_ROWS(4);
  DLI_ROWS(8);
#undef DLI_ROWS
}

}  // namespace

// x: [rows, in_dim] (dtype 0 = bfloat16, 1 = float32); packed: int8
// [L, in_pad, outp] (outp a multiple of 4); scale_lo / scale_hi: f32 [L, outp];
// out: [rows, out_dim] of x's type; part: f32 scratch [splits, rows, 2 * outp]
// when splits > 1 (unused otherwise). `layer` selects the weight and scales
// of one layer by offset. Returns cudaGetLastError() after the launches, or
// -1 for arguments the kernel does not take.
extern "C" int dli_int4_matmul(
    const void* x, const void* packed, const void* scale_lo,
    const void* scale_hi, void* out, void* part, int rows, int in_dim,
    int in_pad, int outp, int out_dim, int layer, int splits, int dtype,
    void* stream) {
  if (rows <= 0 || out_dim <= 0) return 0;
  if (in_dim <= 0 || in_dim > in_pad || outp % 4 || out_dim > 2 * outp ||
      layer < 0 || splits < 1)
    return -1;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      static_cast<const int8_t*>(packed) + (size_t)layer * in_pad * outp);
  const float* lo = static_cast<const float*>(scale_lo) + (size_t)layer * outp;
  const float* hi = static_cast<const float*>(scale_hi) + (size_t)layer * outp;
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_rows<__nv_bfloat16>(x, w, lo, hi, out, pt, rows, in_dim,
                                        outp, out_dim, splits, st);
  if (dtype == 1)
    return dispatch_rows<float>(x, w, lo, hi, out, pt, rows, in_dim, outp,
                                out_dim, splits, st);
  return -1;
}
