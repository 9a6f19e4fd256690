// Decode attention (one query token a row) over f32 or int8 K/V with f32
// queries, for Hopper (sm_90a): the device code of the f32 instances of two
// kernel files (their bf16-query instances are paged_decode.cuh's cluster
// kernel).
//
// * paged_attention.cu: `paged_attention` and `quantized_paged_attention`,
//   K/V read in place from a page pool [P, Hkv, PS, D] through a page table
//   [B, Tw];
// * quant_attention.cu: `quantized_decode_attention`, K/V read from the
//   int8 dense cache's contiguous head-major buffer [B, Hkv, T, D]: the same
//   walk with no table (`table` null): row b is its own page of PS = T
//   slots.
//
// What bounds it on this card: bytes; what a simple kernel runs into
// first, though, is instruction issue: with a whole warp on one position,
// ten shuffle instructions go with every four useful FMAs. Hence a
// position belongs to a group of D / EPL lanes, each holding EPL = 16
// contiguous elements of the K and V slot, loaded 16 bytes at a time (at
// D = 128 a dot product needs 3 shuffle steps, a warp works on 4
// positions per instruction); each
// lane group keeps its own running (m, l, acc) in f32 registers; a row's
// positions are split over several blocks (grid z), sized by the wrapper
// from the table width, and a second small kernel merges their partials.
// The int8 forms keep everything in f32: the K scale multiplies the score,
// the V scale the probability before P V (no bf16 rounding), as the TPU
// kernels `_qpaged_kernel` and `_qdense_kernel` do. The engine's
// exact-parity runs are the only callers.
//
// Built for head_dim 64 and 128 and 1 to 8 query heads a kv head: the
// instances take the group rounded up to 1, 2, 4 or 8 (Gp) and the heads
// past G stay zero and are never written. At Gp = 8 a lane holds EPL = 8
// elements (its 8 heads' queries and sums then fit the registers the
// 4-head instance uses).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// ops/attention.py:_NEG_INF, -0.7 * float32 max: finite, so that
// (m_old - m_new) never becomes inf - inf.
constexpr float kNegInf = -0.7f * 3.402823466e+38f;

// N contiguous elements of global memory (16-byte aligned, N a multiple of
// 4 floats or of 8 int8) as floats, in 16-byte loads where N allows.
template <int N>
__device__ __forceinline__ void load_run(const float* p, float* o) {
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + c);
    o[c] = v.x; o[c + 1] = v.y; o[c + 2] = v.z; o[c + 3] = v.w;
  }
}

__device__ __forceinline__ void bytes_to_f32(uint32_t w, float* o) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = (float)((int32_t)(w << (24 - 8 * j)) >> 24);
}

template <int N>
__device__ __forceinline__ void load_run(const int8_t* p, float* o) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + c);
      bytes_to_f32(v.x, o + c);
      bytes_to_f32(v.y, o + c + 4);
      bytes_to_f32(v.z, o + c + 8);
      bytes_to_f32(v.w, o + c + 12);
    }
  } else {
    static_assert(N == 8, "int8 runs of 8 or of multiples of 16");
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    bytes_to_f32(v.x, o);
    bytes_to_f32(v.y, o + 4);
  }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }

// Partial attention of one (row, kv head) over the positions
// [split * chunk, (split + 1) * chunk) that are live and inside the window,
// for the G <= Gp query heads of the kv head. KV is T, or int8_t with the
// scale planes ks / vs (null otherwise).
template <typename T, typename KV, int D, int Gp>
__global__ void __launch_bounds__(kThreads) paged_partial_kernel(
    const T* __restrict__ q,          // [B, Hkv*G, D]
    const KV* __restrict__ k_pages,   // [P, Hkv, PS, D]
    const KV* __restrict__ v_pages,   // [P, Hkv, PS, D]
    const float* __restrict__ ks,     // [P, Hkv, PS] (int8 pages)
    const float* __restrict__ vs,     // [P, Hkv, PS] (int8 pages)
    const int* __restrict__ table,    // [B, Tw], or null (contiguous)
    const int* __restrict__ kv_lens,  // [B]
    const int* __restrict__ q_pos,    // [B]
    float* __restrict__ part_o,       // [B, Hkv, NS, G, D]
    float* __restrict__ part_m,       // [B, Hkv, NS, G]
    float* __restrict__ part_l,       // [B, Hkv, NS, G]
    int Hkv, int G, int PS, int Tw, int chunk, float scale, int window) {
  constexpr int EPL = Gp == 8 ? 8 : 16;  // elements per lane
  constexpr int LPP = D / EPL;            // lanes per position
  constexpr int PPW = 32 / LPP;           // positions per warp instruction
  constexpr bool kQuant = sizeof(KV) == 1;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int NS = gridDim.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPP;
  const int sub = lane % LPP;
  const int Hq = Hkv * G;

  const int kv_len = min(kv_lens[b], Tw * PS);
  int first = 0;
  if (window > 0) first = max(0, q_pos[b] - window + 1);
  const int lo = max(first, split * chunk);
  const int hi = min(kv_len, (split + 1) * chunk);

  float qr[Gp][EPL];
#pragma unroll
  for (int g = 0; g < Gp; ++g) {
    if (g < G) {
      load_run<EPL>(q + ((size_t)b * Hq + h * G + g) * D + sub * EPL, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) qr[g][i] = 0.f;
    }
  }
  float m[Gp], l[Gp], acc[Gp][EPL];
#pragma unroll
  for (int g = 0; g < Gp; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  // All lanes walk the loop together (the shuffles need them); a lane group
  // whose position falls past the range loads nothing and updates nothing.
  // No table: the contiguous form, row b's positions are its own "page".
  const int* trow = table != nullptr ? table + (size_t)b * Tw : nullptr;
  for (int p0 = lo + warp * PPW; p0 < hi; p0 += kWarps * PPW) {
    const int pos = p0 + grp;
    const bool live = pos < hi;
    float kk[EPL], vv[EPL];
    float ksc = 1.f, vsc = 1.f;
    if (live) {
      const int page = trow != nullptr ? trow[pos / PS] : b;
      const size_t slot = ((size_t)page * Hkv + h) * PS + pos % PS;
      const size_t base = slot * D + sub * EPL;
      load_run<EPL>(k_pages + base, kk);
      load_run<EPL>(v_pages + base, vv);
      if constexpr (kQuant) {
        ksc = ks[slot];
        vsc = vs[slot];
      }
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) kk[i] = vv[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < Gp; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot += qr[g][i] * kk[i];
#pragma unroll
      for (int o = LPP / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (live) {
        const float s = kQuant ? dot * ksc * scale : dot * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        const float pw = kQuant ? p * vsc : p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] = acc[g][i] * alpha + pw * vv[i];
        m[g] = m_new;
      }
    }
  }

  // Merge the lane groups of a warp: afterwards every lane holds the warp's
  // state for its own EPL elements.
#pragma unroll
  for (int o = LPP; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < Gp; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float fa = expf(m[g] - m_new);
      const float fb = expf(m_o - m_new);
      l[g] = l[g] * fa + l_o * fb;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * fa + a_o * fb;
      }
      m[g] = m_new;
    }
  }

  // Merge the warps through shared memory and write the block's partial.
  __shared__ float sm_m[kWarps][Gp];
  __shared__ float sm_l[kWarps][Gp];
  __shared__ float sm_acc[kWarps][Gp][D];
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < Gp; ++g) {
      if (sub == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) sm_acc[warp][g][sub * EPL + i] = acc[g][i];
    }
  }
  __syncthreads();
  const size_t slot = ((size_t)b * Hkv + h) * NS + split;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * f;
      o += sm_acc[w][g][d] * f;
    }
    part_o[(slot * G + g) * D + d] = o;
    if (d == 0) {
      part_m[slot * G + g] = mm;
      part_l[slot * G + g] = ll;
    }
  }
}

// Merge the NS partials of each (row, kv head), normalise, write the results.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part_o,  // [B, Hkv, NS, G, D]
    const float* __restrict__ part_m,  // [B, Hkv, NS, G]
    const float* __restrict__ part_l,  // [B, Hkv, NS, G]
    T* __restrict__ out,               // [B, Hkv*G, D]
    float* __restrict__ m_out,         // [B, Hkv, G]
    float* __restrict__ l_out,         // [B, Hkv, G]
    int NS, int G, int D) {
  const size_t pair = (size_t)blockIdx.x * gridDim.y + blockIdx.y;  // b*Hkv+h
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mm = kNegInf;
    for (int s = 0; s < NS; ++s)
      mm = fmaxf(mm, part_m[(pair * NS + s) * G + g]);
    float ll = 0.f, o = 0.f;
    for (int s = 0; s < NS; ++s) {
      const size_t slot = pair * NS + s;
      const float f = expf(part_m[slot * G + g] - mm);
      ll += part_l[slot * G + g] * f;
      o += part_o[(slot * G + g) * D + d] * f;
    }
    // kv_len == 0 (or a window with nothing in it): l == 0 -> zeros.
    store_one(out + (pair * G + g) * D + d, o / fmaxf(ll, 1e-20f));
    if (d == 0) {
      m_out[pair * G + g] = mm;
      l_out[pair * G + g] = ll;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *table, *kv_lens, *q_pos;
  void* out;
  float *m_out, *l_out, *part_o, *part_m, *part_l;
  int B, Hkv, PS, Tw, NS, chunk, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, int Gp>
int launch(int G, const Args& a) {
  dim3 grid(a.B, a.Hkv, a.NS);
  paged_partial_kernel<T, KV, D, Gp><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.ks, a.vs, a.table, a.kv_lens, a.q_pos,
      a.part_o,
      a.part_m, a.part_l, a.Hkv, G, a.PS, a.Tw, a.chunk, a.scale, a.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<T><<<dim3(a.B, a.Hkv), kThreads, 0, a.stream>>>(
      a.part_o, a.part_m, a.part_l, static_cast<T*>(a.out), a.m_out, a.l_out,
      a.NS, G, D);
  return static_cast<int>(cudaGetLastError());
}

// G query heads a kv head on the instance of the next power of two.
template <typename T, typename KV, int D>
int dispatch_g(int G, const Args& a) {
  if (G == 1) return launch<T, KV, D, 1>(G, a);
  if (G == 2) return launch<T, KV, D, 2>(G, a);
  if (G >= 3 && G <= 4) return launch<T, KV, D, 4>(G, a);
  if (G >= 5 && G <= 8) return launch<T, KV, D, 8>(G, a);
  return -1;
}

template <typename T, typename KV>
int dispatch_d(int D, int G, const Args& a) {
  if (D == 64) return dispatch_g<T, KV, 64>(G, a);
  if (D == 128) return dispatch_g<T, KV, 128>(G, a);
  return -1;
}

inline int fill_and_dispatch(Args& a, const void* q, const void* table,
                      const void* kv_lens, const void* q_pos, void* out,
                      void* m_out, void* l_out, void* part_o, void* part_m,
                      void* part_l, int B, int Hkv, int G, int D, int PS,
                      int Tw, int NS, int chunk, float scale, int window,
                      int dtype, bool quant, void* stream) {
  if (B <= 0) return 0;
  if (NS <= 0 || (long long)NS * chunk < (long long)Tw * PS) return -1;
  a.q = q;
  a.table = static_cast<const int*>(table);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = out;
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.part_o = static_cast<float*>(part_o);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.B = B; a.Hkv = Hkv; a.PS = PS; a.Tw = Tw; a.NS = NS; a.chunk = chunk;
  a.window = window; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  // bf16 queries: csrc/paged_decode.cuh's kernel.
  if (dtype != 1) return -1;
  if (quant) return dispatch_d<float, int8_t>(D, G, a);
  return dispatch_d<float, float>(D, G, a);
}

}  // namespace decode
