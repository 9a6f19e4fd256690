// Fused decode step over int8 K/V with an int8 write-behind tail, for
// Hopper (sm_90a). Shared by three TPU kernels' replacements, each a
// geometry policy of the passes below:
//
// * `quantized_paged_fused_attention` (distributed_llm_inference_tpu/ops/
//   paged_attention.py), whose big segment is the int8 page pool read in
//   place through the page table (BigThenTail<true>, csrc/paged_attention.cu);
// * `quantized_fused_decode_attention` (distributed_llm_inference_tpu/ops/
//   quant_attention.py), whose big segment is a contiguous [L, B, Hkv, T, D]
//   stack gathered once per window (BigThenTail<false>,
//   csrc/quant_attention.cu);
// * `sink_fused_decode_attention` (the same file), the int8 sink ring: masked
//   ring tiles, a tile of sinks with a query of its own, then the tail
//   (csrc/sink_attention.cu).
//
// tail_scatter_kernel at the end is the window's flush into contiguous
// planes, shared by the dense cache and the sink ring in the same way.
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

// What every form passes: the queries, the step's K/V, the tail planes it is
// quantized into, the output and the scratch.
struct Common {
  const void *q, *k_new, *v_new;          // [B, Hq, D], [B, Hkv, D] x2
  int8_t *tail_k, *tail_v;                // [L, B, Hkv, KT, D]
  float *tail_ks, *tail_vs;               // [L, B, Hkv, KT]
  const int* step;                        // one int32 in device memory
  void* out;                              // [B, Hq, D]
  float* scratch;     // B * Hq * NT * (W + 3 + D) floats: scores [NT, W],
                      // tile max, running max, sum of p [NT], P V [NT, D]
                      // of each (row, query head), in that order
  int B, Hkv, KT, layer;
  int NT, W;          // tiles a row may have (tail included), widest tile
  float scale;
};

// The paged and contiguous forms: a big segment, then the tail.
struct Args : Common {
  const int8_t *big_k, *big_v;            // pool or stack, all layers
  const float *big_ks, *big_vs;
  const int *table;                       // [B, Tw] (paged)
  const int *base_len, *tail_vlen, *q_pos;
  int rows;           // pages P (paged) or stack length T
  int ps, tw;         // page size and table width (paged)
  int tile_w, window;
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

__device__ __forceinline__ DenseRows tail_rows(const Common& a, int b,
                                               int h) {
  const size_t trow = ((size_t)a.layer * a.B + b) * a.Hkv + h;
  return DenseRows{a.tail_k + trow * a.KT * kD, a.tail_v + trow * a.KT * kD,
                   a.tail_ks + trow * a.KT, a.tail_vs + trow * a.KT};
}

// Every position of a tile is valid (the paged and contiguous forms, whose
// tiles are ranges of valid positions).
struct AllLive {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// The passes below are written against a geometry policy P, the kernels'
// argument struct (Common and the form's own fields), which provides:
//   P::Geo geo(b)           a row's tiles; Geo::ntiles counts them;
//   bool is_tail(geo, j)    tile j is the tail (quantize the step there);
//   const void* query(geo, j)         the query tile j is scored with;
//   visit(geo, b, h, j, f)  calls f(rows, vlo, n, live): tile j is
//                           positions [vlo, vlo + n) of `rows`, valid
//                           where live(i).
// BigThenTail is the paged and contiguous forms' policy;
// csrc/sink_attention.cu has the sink ring's.
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

template <bool Paged>
struct BigThenTail : Args {
  using Geo = Geometry;
  __device__ Geo geo(int b) const { return Geometry(*this, b, Paged); }
  __device__ bool is_tail(const Geo& g, int j) const { return j == g.nbig; }
  __device__ const void* query(const Geo&, int) const { return q; }
  template <class F>
  __device__ void visit(const Geo& g, int b, int h, int j, F&& f) const {
    int vlo, n;
    g.range(j, vlo, n);
    if (j == g.nbig)
      f(tail_rows(*this, b, h), vlo, n, AllLive());
    else
      f(BigRows<Paged>::make(*this, b, h), vlo, n, AllLive());
  }
};

// Pass 1, scores of one tile for the G query heads of kv head h. Position
// `fresh` reads the step's quantized K from shared memory. A position i of
// the tile for which `is_live(i)` is false (the sink ring's masked slots)
// reads nothing, scores kNegInf and leaves the tile's max alone.
template <int G, class Rows, class Live>
__device__ __forceinline__ void tile_scores(float scale, const Rows& rows,
                                            int vlo, int n, int fresh,
                                            const int8_t* fresh_k,
                                            float fresh_ks,
                                            const float (&qr)[G][kEPL],
                                            float* const (&s)[G],
                                            float (&mloc)[G],
                                            const Live& is_live) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLPP;
  const int sub = lane % kLPP;
  for (int i0 = warp * kPPW; i0 < n; i0 += kWarps * kPPW) {
    const int i = i0 + grp;
    const bool in = i < n;
    const bool live = in && is_live(i);
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
      if (in && sub == 0) {
        const float sc = live ? dot * ksc * scale : kNegInf;
        s[g][i] = sc;
        mloc[g] = fmaxf(mloc[g], sc);
      }
    }
  }
}

template <typename T, class P, int G>
__global__ void __launch_bounds__(kThreads) fused_scores_kernel(P a) {
  __shared__ __align__(16) int8_t fresh_k[kD];
  __shared__ float fresh_ks;
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int j = blockIdx.z;
  const int t = threadIdx.x;
  const auto geo = a.geo(b);
  if (j >= geo.ntiles) return;
  const size_t bh = (size_t)b * a.Hkv + h;
  const bool is_tail = a.is_tail(geo, j);
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
  // The query heads' slices of the tile's query, rounded to bf16 as the TPU
  // kernel's product does, in the lane layout of tile_scores.
  const T* qsrc = static_cast<const T*>(a.query(geo, j));
  const int sub = (t & 31) % kLPP;
  float qr[G][kEPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = qsrc + (bh * G + g) * kD + sub * kEPL;
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
  const int fresh = is_tail ? step : -1;
  const float fks = is_tail ? fresh_ks : 0.f;
  const int8_t* fk = fresh_k;
  a.visit(geo, b, h, j,
          [&](const auto& rows, int vlo, int n, const auto& live) {
            tile_scores<G>(a.scale, rows, vlo, n, fresh, fk, fks, qr, s,
                           mloc, live);
          });
  float* tmax = a.scratch + (size_t)a.B * a.Hkv * G * a.NT * a.W;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m = block_max(mloc[g], red);
    if (t == 0) tmax[(bh * G + g) * a.NT + j] = m;
  }
}

// Pass 2, the sums of one tile under the running max at it; a slot that is
// not live takes p = 0.
template <class P, int G>
__global__ void __launch_bounds__(kThreads) fused_sums_kernel(P a) {
  __shared__ float pw[G][kMaxTile];
  __shared__ __align__(16) int8_t v[kMaxTile][kD];
  __shared__ float vsm[kMaxTile];
  __shared__ float mj[G];
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int j = blockIdx.z;
  const int t = threadIdx.x;
  const auto geo = a.geo(b);
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
  a.visit(geo, b, h, j, [&](const auto& rows, int vlo, int n,
                            const auto& live) {
    constexpr int kChunks = kD / 16;
    for (int idx = t; idx < n * kChunks; idx += kThreads) {
      const int i = idx / kChunks;
      const int c = idx % kChunks;
      const size_t r = rows.row(vlo + i);
      reinterpret_cast<uint4*>(v[i])[c] =
          reinterpret_cast<const uint4*>(rows.v + r * kD)[c];
    }
    for (int i = t; i < n; i += kThreads) vsm[i] = rows.vs[rows.row(vlo + i)];
    __syncthreads();
    float lsum[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lsum[g] = 0.f;
      const float* sg = scores + ((bh * G + g) * a.NT + j) * a.W;
      for (int i = t; i < n; i += kThreads) {
        const float p = live(i) ? expf(sg[i] - mj[g]) : 0.f;
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
  });
}

// Pass 3, one (row, query head): the tiles' sums, each scaled by
// exp(m_tile - m_last), normalised.
template <typename T, class P>
__global__ void __launch_bounds__(kThreads) fused_combine_kernel(P a, int G) {
  const int b = blockIdx.x;
  const int hq = blockIdx.y;
  const int t = threadIdx.x;
  const int ntiles = a.geo(b).ntiles;
  const size_t heads = (size_t)a.B * a.Hkv * G;
  const float* run_m = a.scratch + heads * a.NT * a.W + heads * a.NT;
  const float* sum_l = run_m + heads * a.NT;
  const float* sum_pv = sum_l + heads * a.NT;
  const size_t o = ((size_t)b * a.Hkv * G + hq) * a.NT;
  float num = 0.f, den = 0.f;
  if (ntiles > 0) {
    const float m_last = run_m[o + ntiles - 1];
    for (int k = 0; k < ntiles; ++k) {
      const float w = expf(run_m[o + k] - m_last);
      num += w * sum_pv[(o + k) * kD + t];
      den += w * sum_l[o + k];
    }
  }
  // A row with nothing to attend gives zeros.
  store(static_cast<T*>(a.out) + ((size_t)b * a.Hkv * G + hq) * kD + t,
        num / fmaxf(den, 1e-20f));
}

template <typename T, class P, int G>
int launch_passes(const P& a, cudaStream_t s) {
  const dim3 grid(a.B, a.Hkv, a.NT);
  fused_scores_kernel<T, P, G><<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sums_kernel<P, G><<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_combine_kernel<T, P><<<dim3(a.B, a.Hkv * G), kThreads, 0, s>>>(a, G);
  return static_cast<int>(cudaGetLastError());
}

// The instances: G in {1, 4} query heads a kv head, q in bf16 (dtype 0) or
// f32 (1). -1 for any other.
template <class P>
int dispatch(const P& a, int G, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && G == 1) return launch_passes<__nv_bfloat16, P, 1>(a, s);
  if (dtype == 0 && G == 4) return launch_passes<__nv_bfloat16, P, 4>(a, s);
  if (dtype == 1 && G == 1) return launch_passes<float, P, 1>(a, s);
  if (dtype == 1 && G == 4) return launch_passes<float, P, 4>(a, s);
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
  BigThenTail<Paged> p;
  static_cast<Args&>(p) = a;
  return dispatch(p, G, dtype, stream);
}

// The fused window's int8 tail merged into contiguous planes, a direct
// scatter (the dense cache's flush and the sink ring's). One block per
// (row, layer) binds its row's destination once, `r = dest.row(b)`, and
// copies tail slots [r.first, r.end) of row b, 16 bytes a thread, to slot
// r.slot(i) of the big planes [L, B, Hkv, T, D] (scales [L, B, Hkv, T]
// beside them); a slot < 0 is skipped. Bound by bytes: each tail byte is
// read once and written once.
template <class Dest>
__global__ void __launch_bounds__(kThreads) tail_scatter_kernel(
    int8_t* __restrict__ bk, float* __restrict__ bks,
    int8_t* __restrict__ bv, float* __restrict__ bvs,  // [L, B, Hkv, T(, D)]
    const int8_t* __restrict__ tk, const float* __restrict__ tks,
    const int8_t* __restrict__ tv, const float* __restrict__ tvs,  // [L, B, Hkv, KT(, D)]
    int B, int Hkv, int T, int KT, int D, Dest dest) {
  const int b = blockIdx.x;
  const int l = blockIdx.y;
  const auto r = dest.row(b);
  const int first = r.first;
  const int n = min(r.end, KT);
  const int chunks = D / 16;
  const int total = max(n - first, 0) * Hkv * chunks;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int c = idx % chunks;
    const int h = (idx / chunks) % Hkv;
    const int i = first + idx / (chunks * Hkv);
    const int slot = r.slot(i);
    if (slot < 0) continue;
    const size_t row = ((size_t)l * B + b) * Hkv + h;
    const size_t dst = row * T + slot;
    const size_t src = row * KT + i;
    reinterpret_cast<uint4*>(bk + dst * D)[c] =
        reinterpret_cast<const uint4*>(tk + src * D)[c];
    reinterpret_cast<uint4*>(bv + dst * D)[c] =
        reinterpret_cast<const uint4*>(tv + src * D)[c];
    if (c == 0) {
      bks[dst] = tks[src];
      bvs[dst] = tvs[src];
    }
  }
}

// Launches tail_scatter_kernel; D a multiple of 16. Returns
// cudaGetLastError() after the launch, -1 for another D.
template <class Dest>
int launch_tail_scatter(void* bk, void* bks, void* bv, void* bvs,
                        const void* tk, const void* tks, const void* tv,
                        const void* tvs, int L, int B, int Hkv, int T, int KT,
                        int D, const Dest& dest, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  if (D % 16 != 0) return -1;
  tail_scatter_kernel<<<dim3(B, L), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(bk), static_cast<float*>(bks),
      static_cast<int8_t*>(bv), static_cast<float*>(bvs),
      static_cast<const int8_t*>(tk), static_cast<const float*>(tks),
      static_cast<const int8_t*>(tv), static_cast<const float*>(tvs), B, Hkv,
      T, KT, D, dest);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fused
