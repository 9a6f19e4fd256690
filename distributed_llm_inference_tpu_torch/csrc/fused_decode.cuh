// Fused decode step over int8 K/V with an int8 write-behind tail, for
// Hopper (sm_90a). Shared by two TPU kernels' replacements:
//
// * `quantized_paged_fused_attention` (distributed_llm_inference_tpu/ops/
//   paged_attention.py), whose big segment is the int8 page pool read in
//   place through the page table (Paged = true, csrc/paged_attention.cu);
// * `quantized_fused_decode_attention` (distributed_llm_inference_tpu/ops/
//   quant_attention.py), whose big segment is a contiguous [L, B, Hkv, T, D]
//   stack gathered once per window (Paged = false,
//   csrc/quant_attention.cu).
//
// One call (three launches, below) is one (layer, step) of a fused K-step
// decode window. It quantizes the step's new K and V per (row, kv head)
// exactly as cache/dense.py:_quantize_kv does (f32 amax over D,
// max(amax, 1e-8) / 127, round half to even, clip to +-127), writes them
// into tail slot `step` of layer `layer` for every row, and runs one online
// softmax over the row's live big-segment positions, then over the tail as
// the last tile.
//
// The arithmetic is the TPU kernel's, rounding included, so that the f32
// instance agrees with the plain version (and the JAX kernel) to 2e-5:
// q and p * vs are rounded to bf16 before the two products (int8 K and V are
// exact in bf16; the products are exact in f32), scores are
// (q . k) * ks * scale, and the softmax walks the SAME tiles in the same
// order with the same running max: a tile is one page (Paged) or `tile`
// positions (contiguous, min(256, T)), and the tail is one tile after them.
// The running max at each tile decides how p * vs rounds. Tiles that hold
// no live position are skipped; in the TPU kernel they are exact no-ops
// (alpha = 1, p = 0). The score of a position is summed in a fixed order
// (16 products a lane in turn, then a butterfly over the lanes) that the
// plain version repeats (ops/quant_attention.py:_lane_order_dot): a score
// one ulp apart can round p * vs to the neighbouring bf16 value, which a
// short row feels at 1e-3.
//
// Three launches, so that the tiles of a row run in parallel and still see
// the running max of the sequential walk:
//   1. scores: one block per (row, kv head, tile) computes the tile's
//      scores for the G query heads (K read once for all of them) into
//      scratch, and the tile's max; the tail's block first quantizes the
//      step's K/V and writes slot `step`;
//   2. sums: one block per (row, kv head, tile) takes the running max at
//      its tile (the prefix max of the tile maxes, what the sequential walk
//      holds there), p = exp(s - m), the tile's sum of p, bf16(p * vs) and
//      its P V, into scratch;
//   3. combine: one block per (row, query head) adds the tiles' sums,
//      each scaled by exp(m_tile - m_last) (the product of the walk's
//      alpha factors after the tile), and normalises.
// Scores, maxima, p and bf16(p * vs) are bit for bit those of the walk;
// only the order of the final f32 sums differs.
//
// The tail: the step's K/V are quantized and written to slot `step` by the
// one block that scores the tail tile (it reads the slot from its shared
// memory); the sums pass, a later launch, reads the slot from the tail
// planes. `step` is read from device memory, so a CUDA graph that captures
// the launches stays valid for every step of the window.
//
// What bounds it on this card: bytes (every live K and V byte is read once
// for a few flops; the scratch adds 4 bytes a score, written and read, and
// D floats a tile). A first form walked all tiles of a (row, query head) in
// one block, 256 blocks at batch 8: bound by that chain, 13.9x the bytes
// bound on an H100 (PERF.md); staging its tiles by cp.async did not help.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused {

constexpr int kD = 128;                // head_dim the kernels are built for
constexpr int kThreads = 128;          // one thread per output element
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 256;          // widest tile (page, stack tile, tail)
constexpr int kEPL = 16;               // int8 elements per lane (16 bytes)
constexpr int kLPP = kD / kEPL;        // lanes per position
constexpr int kPPW = 32 / kLPP;        // positions per warp step
// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 int8 values of one 16-byte word as floats (sign-extended bytes).
__device__ __forceinline__ void unpack16(uint4 v, float* o) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Rows of one (layer, kv head) of the page pool, through the row's table.
struct PagedRows {
  const int8_t *k, *v;      // layer's [P, Hkv, PS, D]
  const float *ks, *vs;     // layer's [P, Hkv, PS]
  const int* table;         // this row's [Tw] page ids
  int hkv, h, ps;
  __device__ __forceinline__ size_t row(int pos) const {
    const int page = table[pos / ps];
    return ((size_t)page * hkv + h) * ps + pos % ps;
  }
};

// Rows of one (layer, row, kv head) of a contiguous [.., T, D] stack.
struct DenseRows {
  const int8_t *k, *v;      // [T, D]
  const float *ks, *vs;     // [T]
  __device__ __forceinline__ size_t row(int pos) const { return pos; }
};

struct Args {
  const void *q, *k_new, *v_new;          // [B, Hq, D], [B, Hkv, D] x2
  const int8_t *big_k, *big_v;            // pool or stack, all layers
  const float *big_ks, *big_vs;
  int8_t *tail_k, *tail_v;                // [L, B, Hkv, KT, D]
  float *tail_ks, *tail_vs;               // [L, B, Hkv, KT]
  const int *table;                       // [B, Tw] (paged)
  const int *base_len, *tail_vlen, *q_pos, *step;
  void* out;                              // [B, Hq, D]
  float* scratch;     // B * Hq * NT * (W + 3 + D) floats: scores [NT, W],
                      // tile max, running max, sum of p [NT], P V [NT, D]
                      // of each (row, query head), in that order
  int B, Hkv, rows;   // rows: pages P (paged) or stack length T
  int ps, tw;         // page size and table width (paged)
  int tile_w, KT, layer, window;
  int NT, W;          // tiles a row may have (big + tail), widest tile
  float scale;
};

// A row's tiles: big-segment tiles holding a live position inside the
// sliding window, in order, then the tail (slots below tail_vlen, this
// step's included, inside the window of the query).
struct Geometry {
  int lo, hi, tw, first, nbig, tlo, vlen, ntiles;
  __device__ Geometry(const Args& a, int b, bool paged) {
    const int base = a.base_len[b];
    const int qpos = a.q_pos[b];
    const int cap = paged ? a.tw * a.ps : a.rows;
    lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
    hi = min(base, cap);
    tw = paged ? a.ps : a.tile_w;
    first = (lo / tw) * tw;
    nbig = hi > lo ? (hi - first + tw - 1) / tw : 0;
    vlen = min(a.tail_vlen[b], a.KT);
    tlo = a.window > 0 ? max(0, qpos - a.window + 1 - base) : 0;
    ntiles = nbig + (tlo < vlen ? 1 : 0);
  }
  // Positions [vlo, vlo + n) of tile j, every one of them valid.
  __device__ void range(int j, int& vlo, int& n) const {
    if (j < nbig) {
      const int start = first + j * tw;
      vlo = max(lo, start);
      n = min(hi, start + tw) - vlo;
    } else {
      vlo = tlo;
      n = vlen - tlo;
    }
  }
};

template <bool Paged>
struct BigRows;
template <>
struct BigRows<true> {
  static __device__ PagedRows make(const Args& a, int b, int h) {
    const size_t lp = (size_t)a.layer * a.rows * a.Hkv * a.ps;
    return PagedRows{a.big_k + lp * kD, a.big_v + lp * kD, a.big_ks + lp,
                     a.big_vs + lp, a.table + (size_t)b * a.tw, a.Hkv, h,
                     a.ps};
  }
};
template <>
struct BigRows<false> {
  static __device__ DenseRows make(const Args& a, int b, int h) {
    const size_t r0 = (((size_t)a.layer * a.B + b) * a.Hkv + h) * a.rows;
    return DenseRows{a.big_k + r0 * kD, a.big_v + r0 * kD, a.big_ks + r0,
                     a.big_vs + r0};
  }
};

__device__ __forceinline__ DenseRows tail_rows(const Args& a, int b, int h) {
  const size_t trow = ((size_t)a.layer * a.B + b) * a.Hkv + h;
  return DenseRows{a.tail_k + trow * a.KT * kD, a.tail_v + trow * a.KT * kD,
                   a.tail_ks + trow * a.KT, a.tail_vs + trow * a.KT};
}

// Pass 1, scores of one tile for the G query heads of kv head h. Position
// `fresh` reads the step's quantized K from shared memory.
template <int G, class Rows>
__device__ __forceinline__ void tile_scores(const Args& a, const Rows& rows,
                                            int vlo, int n, int fresh,
                                            const int8_t* fresh_k,
                                            float fresh_ks,
                                            const float (&qr)[G][kEPL],
                                            float* const (&s)[G],
                                            float (&mloc)[G]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLPP;
  const int sub = lane % kLPP;
  for (int i0 = warp * kPPW; i0 < n; i0 += kWarps * kPPW) {
    const int i = i0 + grp;
    const bool live = i < n;
    float kk[kEPL];
    float ksc = 0.f;
    if (live) {
      const int pos = vlo + i;
      uint4 kw;
      if (pos == fresh) {
        kw = reinterpret_cast<const uint4*>(fresh_k)[sub];
        ksc = fresh_ks;
      } else {
        const size_t r = rows.row(pos);
        kw = reinterpret_cast<const uint4*>(rows.k + r * kD)[sub];
        ksc = rows.ks[r];
      }
      unpack16(kw, kk);
    } else {
#pragma unroll
      for (int e = 0; e < kEPL; ++e) kk[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) dot += qr[g][e] * kk[e];
#pragma unroll
      for (int o = kLPP / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (live && sub == 0) {
        const float sc = dot * ksc * a.scale;
        s[g][i] = sc;
        mloc[g] = fmaxf(mloc[g], sc);
      }
    }
  }
}

template <typename T, bool Paged, int G>
__global__ void __launch_bounds__(kThreads) fused_scores_kernel(Args a) {
  __shared__ __align__(16) int8_t fresh_k[kD];
  __shared__ float fresh_ks;
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int j = blockIdx.z;
  const int t = threadIdx.x;
  const Geometry geo(a, b, Paged);
  if (j >= geo.ntiles) return;
  const size_t bh = (size_t)b * a.Hkv + h;
  const bool is_tail = j == geo.nbig;
  const int step = *a.step;
  if (is_tail) {
    // This step's K/V, quantized as _quantize_kv does, into tail slot
    // `step` (this block alone writes it) and into shared memory.
    const float kx = to_f(static_cast<const T*>(a.k_new)[bh * kD + t]);
    const float vx = to_f(static_cast<const T*>(a.v_new)[bh * kD + t]);
    const float ksc = fmaxf(block_max(fabsf(kx), red), 1e-8f) / 127.f;
    const float vsc = fmaxf(block_max(fabsf(vx), red), 1e-8f) / 127.f;
    const int8_t kq = (int8_t)fminf(fmaxf(rintf(kx / ksc), -127.f), 127.f);
    const int8_t vq = (int8_t)fminf(fmaxf(rintf(vx / vsc), -127.f), 127.f);
    const size_t trow = ((size_t)a.layer * a.B + b) * a.Hkv + h;
    a.tail_k[(trow * a.KT + step) * kD + t] = kq;
    a.tail_v[(trow * a.KT + step) * kD + t] = vq;
    if (t == 0) {
      a.tail_ks[trow * a.KT + step] = ksc;
      a.tail_vs[trow * a.KT + step] = vsc;
      fresh_ks = ksc;
    }
    fresh_k[t] = kq;
    __syncthreads();
  }
  // The query heads' slices of q, rounded to bf16 as the TPU kernel's
  // product does, in the lane layout of tile_scores.
  const int sub = (t & 31) % kLPP;
  float qr[G][kEPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = static_cast<const T*>(a.q) + (bh * G + g) * kD + sub * kEPL;
#pragma unroll
    for (int e = 0; e < kEPL; ++e) qr[g][e] = bf16_round(to_f(qp[e]));
  }
  float* s[G];
  float mloc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    s[g] = a.scratch + ((bh * G + g) * a.NT + j) * a.W;
    mloc[g] = kNegInf;
  }
  int vlo, n;
  geo.range(j, vlo, n);
  if (is_tail)
    tile_scores<G>(a, tail_rows(a, b, h), vlo, n, step, fresh_k, fresh_ks,
                   qr, s, mloc);
  else
    tile_scores<G>(a, BigRows<Paged>::make(a, b, h), vlo, n, -1, fresh_k,
                   0.f, qr, s, mloc);
  float* tmax = a.scratch + (size_t)a.B * a.Hkv * G * a.NT * a.W;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m = block_max(mloc[g], red);
    if (t == 0) tmax[(bh * G + g) * a.NT + j] = m;
  }
}

// Pass 2, the sums of one tile under the running max at it.
template <bool Paged, int G>
__global__ void __launch_bounds__(kThreads) fused_sums_kernel(Args a) {
  __shared__ float pw[G][kMaxTile];
  __shared__ __align__(16) int8_t v[kMaxTile][kD];
  __shared__ float vsm[kMaxTile];
  __shared__ float mj[G];
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int j = blockIdx.z;
  const int t = threadIdx.x;
  const Geometry geo(a, b, Paged);
  if (j >= geo.ntiles) return;
  const size_t bh = (size_t)b * a.Hkv + h;
  const size_t heads = (size_t)a.B * a.Hkv * G;
  const float* scores = a.scratch;
  const float* tmax = scores + heads * a.NT * a.W;
  float* run_m = const_cast<float*>(tmax) + heads * a.NT;
  float* sum_l = run_m + heads * a.NT;
  float* sum_pv = sum_l + heads * a.NT;
  if (t < G) {
    float m = kNegInf;
    for (int k = 0; k <= j; ++k) m = fmaxf(m, tmax[(bh * G + t) * a.NT + k]);
    mj[t] = m;
  }
  int vlo, n;
  geo.range(j, vlo, n);
  constexpr int kChunks = kD / 16;
  auto stage = [&](const auto& rows) {
    for (int idx = t; idx < n * kChunks; idx += kThreads) {
      const int i = idx / kChunks;
      const int c = idx % kChunks;
      const size_t r = rows.row(vlo + i);
      reinterpret_cast<uint4*>(v[i])[c] =
          reinterpret_cast<const uint4*>(rows.v + r * kD)[c];
    }
    for (int i = t; i < n; i += kThreads) vsm[i] = rows.vs[rows.row(vlo + i)];
  };
  if (j == geo.nbig)
    stage(tail_rows(a, b, h));
  else
    stage(BigRows<Paged>::make(a, b, h));
  __syncthreads();
  float lsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lsum[g] = 0.f;
    const float* sg = scores + ((bh * G + g) * a.NT + j) * a.W;
    for (int i = t; i < n; i += kThreads) {
      const float p = expf(sg[i] - mj[g]);
      lsum[g] += p;
      pw[g][i] = bf16_round(p * vsm[i]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // block_sum's barriers also publish pw to every thread.
    const float l = block_sum(lsum[g], red);
    const size_t o = (bh * G + g) * a.NT + j;
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += pw[g][i] * (float)v[i][t];
    sum_pv[o * kD + t] = acc;
    if (t == 0) {
      run_m[o] = mj[g];
      sum_l[o] = l;
    }
  }
}

// Pass 3, one (row, query head): the tiles' sums, each scaled by
// exp(m_tile - m_last), normalised.
template <typename T, bool Paged>
__global__ void __launch_bounds__(kThreads) fused_combine_kernel(Args a,
                                                                 int G) {
  const int b = blockIdx.x;
  const int hq = blockIdx.y;
  const int t = threadIdx.x;
  const Geometry geo(a, b, Paged);
  const size_t heads = (size_t)a.B * a.Hkv * G;
  const float* run_m = a.scratch + heads * a.NT * a.W + heads * a.NT;
  const float* sum_l = run_m + heads * a.NT;
  const float* sum_pv = sum_l + heads * a.NT;
  const size_t o = ((size_t)b * a.Hkv * G + hq) * a.NT;
  float num = 0.f, den = 0.f;
  if (geo.ntiles > 0) {
    const float m_last = run_m[o + geo.ntiles - 1];
    for (int k = 0; k < geo.ntiles; ++k) {
      const float w = expf(run_m[o + k] - m_last);
      num += w * sum_pv[(o + k) * kD + t];
      den += w * sum_l[o + k];
    }
  }
  // A row with nothing to attend gives zeros.
  store(static_cast<T*>(a.out) + ((size_t)b * a.Hkv * G + hq) * kD + t,
        num / fmaxf(den, 1e-20f));
}

template <typename T, bool Paged, int G>
int launch_passes(const Args& a, cudaStream_t s) {
  const dim3 grid(a.B, a.Hkv, a.NT);
  fused_scores_kernel<T, Paged, G><<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sums_kernel<Paged, G><<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_combine_kernel<T, Paged><<<dim3(a.B, a.Hkv * G), kThreads, 0, s>>>(
      a, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Paged>
int dispatch_g(const Args& a, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch_passes<T, Paged, 1>(a, s);
    case 4: return launch_passes<T, Paged, 4>(a, s);
  }
  return -1;
}

// dtype: 0 = bfloat16, 1 = float32 (q, k_new, v_new, out). Returns
// cudaGetLastError() after the launches, or -1 for a shape the kernels are
// not built for (D = 128, G in {1, 4}, tiles and tail of 1..256, NT and W
// that hold every row's tiles).
template <bool Paged>
int launch(const Args& a, int G, int D, int dtype, void* stream) {
  if (a.B <= 0) return 0;
  const int tw = Paged ? a.ps : a.tile_w;
  const int cap = Paged ? a.tw * a.ps : a.rows;
  if (D != kD || a.KT < 1 || a.KT > kMaxTile || tw < 1 || tw > kMaxTile)
    return -1;
  if (a.W < tw || a.W < a.KT || a.NT < (cap + tw - 1) / tw + 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_g<__nv_bfloat16, Paged>(a, G, s);
  if (dtype == 1) return dispatch_g<float, Paged>(a, G, s);
  return -1;
}

}  // namespace fused
