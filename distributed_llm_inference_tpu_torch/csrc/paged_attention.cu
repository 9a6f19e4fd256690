// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of
// distributed_llm_inference_tpu/ops/paged_attention.py: `_paged_kernel`
// behind `paged_attention` and `_qpaged_kernel` behind
// `quantized_paged_attention`. One query token per row (S = 1) attends over
// the first kv_lengths[b] slots of the row's pages, read in place from the
// page pool through the page table; the per-head online-softmax stats
// (running max m, denominator l) are written as well, so a caller can merge
// this segment with another under one softmax. The pages hold the query's
// type, or int8 with an f32 scale per (slot, kv head) in two planes beside
// them: the K scale multiplies the score, s = (q . k) * ks * scale, and the
// V scale the probability before P V, acc += (p * vs) * v, while l sums p,
// as `_qpaged_kernel` does; the pages are never dequantized into a copy.
//
// Which form takes which kernel:
//
// * bf16 queries, over bf16 pages (`paged_attention`) or int8 pages
//   (`quantized_paged_attention`): one launch of paged_decode.cuh's kernel,
//   a thread-block cluster a (row, kv head), a TMA-fed ring, the products
//   on the tensor cores, no scratch (that file says what bounds it and what
//   its design does about it). Over int8 pages p * vs enters P V as two
//   bf16 terms (hi and the rest), about 2^-17 of a term.
// * f32 queries, over f32 or int8 pages: the split walk of
//   decode_attention.cuh, everything in f32 (the engine's exact-parity runs
//   are its only callers). It gives a position to a group of 8 lanes, 16
//   elements a lane in 16-byte loads, keeps the online-softmax state in f32
//   registers, splits a row's positions over blocks sized by the wrapper
//   from the table width, and a second small kernel merges their partials
//   from scratch the wrapper allocates. Blocks cover live positions only
//   (and only those inside the sliding window); a block whose range holds
//   no live position writes (m = -0.7 * float32 max, l = 0) and leaves.
//
// Built for head_dim 128 with 1 or 4 query heads per kv head (MHA, and the
// Llama-3 grouping this package serves); a model with other widths adds its
// instance to paged_decode.cuh's dispatch and decode_attention.cuh's
// dispatch_g / dispatch_d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "fused_decode.cuh"
#include "paged_decode.cuh"

// bf16 q [B, Hkv*G, D] and pages [P, Hkv, PS, D], table [B, Tw], kv_lens and
// q_pos [B] int32; out as q, m_out / l_out f32 [B, Hkv, G]. window: 0 = no
// sliding window. One launch of paged_decode.cuh's kernel, a cluster of C
// blocks (1..8) a (row, kv head). Returns cudaGetLastError() after the
// launch, -1 for a shape outside D = 128, G in {1, 4}, -2 if the driver
// refused a tensor map.
extern "C" int dli_paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* kv_lens, const void* q_pos, void* out,
    void* m_out, void* l_out, int B, int Hkv, int G, int D, int PS, int Tw,
    int C, float scale, int window, void* stream) {
  if (PS < 1 || Tw < 1) return -1;
  return pdec::dispatch<__nv_bfloat16>(
      q, k_pages, v_pages, nullptr, nullptr,
      pdec::PageRows{static_cast<const int*>(table), Tw, PS, Hkv},
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_pos), out,
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, Hkv, G, D,
      Tw * PS, pdec::box_rows_for(PS), C, scale, window,
      static_cast<cudaStream_t>(stream));
}

// bf16 q [B, Hkv*G, D] and int8 pages [P, Hkv, PS, D] with f32 scale
// planes ks_pages / vs_pages [P, Hkv, PS]; the rest as
// dli_paged_attention_bf16, one launch of the same kernel over int8 rows.
extern "C" int dli_quantized_paged_attention_bf16(
    const void* q, const void* k_pages, const void* ks_pages,
    const void* v_pages, const void* vs_pages, const void* table,
    const void* kv_lens, const void* q_pos, void* out, void* m_out,
    void* l_out, int B, int Hkv, int G, int D, int PS, int Tw, int C,
    float scale, int window, void* stream) {
  if (PS < 1 || Tw < 1) return -1;
  return pdec::dispatch<int8_t>(
      q, k_pages, v_pages, static_cast<const float*>(ks_pages),
      static_cast<const float*>(vs_pages),
      pdec::PageRows{static_cast<const int*>(table), Tw, PS, Hkv},
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_pos), out,
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, Hkv, G, D,
      Tw * PS, pdec::box_rows_for(PS), C, scale, window,
      static_cast<cudaStream_t>(stream));
}

// The occupancy of the cluster kernel over bf16 (int8 = 0) or int8 rows
// with G query heads a kv head, clusters of C blocks: out[0] shared memory
// a block, out[1] blocks an SM, out[2] clusters the card holds at once.
// Returns 0, -1 outside G in {1, 4} and C in 1..8, or a CUDA error.
extern "C" int dli_decode_occupancy(int int8, int G, int C, long long* out) {
  if (C < 1 || C > pdec::kMaxCluster) return -1;
  if (G == 1)
    return int8 ? pdec::occupancy<1, int8_t>(C, out)
                : pdec::occupancy<1, __nv_bfloat16>(C, out);
  if (G == 4)
    return int8 ? pdec::occupancy<4, int8_t>(C, out)
                : pdec::occupancy<4, __nv_bfloat16>(C, out);
  return -1;
}

// The f32 instances (dtype 1; bf16 takes the entries above): the split
// walk of decode_attention.cuh. window: 0 = no sliding window. NS blocks
// share a row's positions, `chunk` positions each (NS * chunk >= Tw * PS);
// part_o / part_m / part_l are f32 scratch of [B, Hkv, NS, G, D] and twice
// [B, Hkv, NS, G]. Returns cudaGetLastError() after the launches, or -1 for
// a shape outside D = 128, G in {1, 4}, or another dtype.
extern "C" int dli_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* kv_lens, const void* q_pos, void* out,
    void* m_out, void* l_out, void* part_o, void* part_m, void* part_l,
    int B, int Hkv, int G, int D, int PS, int Tw, int NS, int chunk,
    float scale, int window, int dtype, void* stream) {
  decode::Args a;
  a.k = k_pages; a.v = v_pages; a.ks = nullptr; a.vs = nullptr;
  return decode::fill_and_dispatch(
      a, q, table, kv_lens, q_pos, out, m_out, l_out, part_o, part_m, part_l,
      B, Hkv, G, D, PS, Tw, NS, chunk, scale, window, dtype, false, stream);
}

// As dli_paged_attention over int8 pages: k_pages / v_pages int8
// [P, Hkv, PS, D], ks_pages / vs_pages f32 [P, Hkv, PS].
extern "C" int dli_quantized_paged_attention(
    const void* q, const void* k_pages, const void* ks_pages,
    const void* v_pages, const void* vs_pages, const void* table,
    const void* kv_lens, const void* q_pos, void* out, void* m_out,
    void* l_out, void* part_o, void* part_m, void* part_l, int B, int Hkv,
    int G, int D, int PS, int Tw, int NS, int chunk, float scale, int window,
    int dtype, void* stream) {
  decode::Args a;
  a.k = k_pages; a.v = v_pages;
  a.ks = static_cast<const float*>(ks_pages);
  a.vs = static_cast<const float*>(vs_pages);
  return decode::fill_and_dispatch(
      a, q, table, kv_lens, q_pos, out, m_out, l_out, part_o, part_m, part_l,
      B, Hkv, G, D, PS, Tw, NS, chunk, scale, window, dtype, true, stream);
}

// ---------------------------------------------------------------------------
// The fused K-step decode window over the int8 pool (slice 3).
// ---------------------------------------------------------------------------

// Replaces `quantized_paged_fused_attention` (the TPU kernel
// `_qpaged_fused_kernel`): one (layer, step) of the fused window over the
// int8 page pool read in place, the step's K/V quantized into the tail, in
// one launch of a thread-block cluster a (row, kv head). See
// fused_decode.cuh. The whole [L, P, Hkv, PS, D] pool and [L, B, Hkv, KT,
// D] tail are passed; `layer` picks the layer, `step` is read from device
// memory; NT >= Tw + 1 tiles a row and W >= max(PS, KT) size the shared
// memory. Returns cudaGetLastError() after the launch, -1 for a shape
// outside D = 128, G in {1, 4}, PS and KT in 1..256, or one whose shared
// memory does not fit a block.
extern "C" int dli_quantized_paged_fused_attention(
    const void* q, const void* k_new, const void* v_new, const void* pool_k,
    const void* pool_ks, const void* pool_v, const void* pool_vs,
    void* tail_k, void* tail_ks, void* tail_v, void* tail_vs,
    const void* table, const void* base_len, const void* tail_vlen,
    const void* q_pos, const void* step, void* out, int B, int Hkv, int G,
    int D, int P, int PS, int Tw, int KT, int layer, int NT, int W,
    float scale, int window, int dtype, void* stream) {
  fused::Args a;
  a.q = q; a.k_new = k_new; a.v_new = v_new;
  a.big_k = static_cast<const int8_t*>(pool_k);
  a.big_v = static_cast<const int8_t*>(pool_v);
  a.big_ks = static_cast<const float*>(pool_ks);
  a.big_vs = static_cast<const float*>(pool_vs);
  a.tail_k = static_cast<int8_t*>(tail_k);
  a.tail_v = static_cast<int8_t*>(tail_v);
  a.tail_ks = static_cast<float*>(tail_ks);
  a.tail_vs = static_cast<float*>(tail_vs);
  a.table = static_cast<const int*>(table);
  a.base_len = static_cast<const int*>(base_len);
  a.tail_vlen = static_cast<const int*>(tail_vlen);
  a.q_pos = static_cast<const int*>(q_pos);
  a.step = static_cast<const int*>(step);
  a.out = out;
  a.NP = NT; a.W = W;
  a.B = B; a.Hkv = Hkv; a.rows = P; a.ps = PS; a.tw = Tw; a.tile_w = PS;
  a.piece_w = PS;
  a.KT = KT; a.layer = layer; a.window = window; a.scale = scale;
  return fused::launch<true>(a, G, D, dtype, stream);
}

namespace {

using decode::kThreads;

// Replaces `paged_tail_flush` (its TPU kernel read-modify-writes whole
// pages through VMEM, with clamped duplicate visits): a direct scatter of
// row b's tail slots i < tail_len[b] to positions base_len[b] + i of its
// pages, scales beside them. Nothing is written for a position past the
// table or on the null page 0 (nor on an id outside the pool).
//
// Bound by bytes (each live tail byte read once and written once), and at
// the size of one window (L = 32, B = 8, KT = 16: 8.6 MB each way) by
// latency: 3.35 TB/s needs ~3 MB in flight over a microsecond, and a thread
// that walks its (slot, head, 16 bytes) items in turn, each a chain of a
// table read, a load and a store, keeps one item in flight. Here a
// block takes `hb` kv heads of one (row, layer), hb * KT tail rows that lie
// contiguous in the tail planes, WORDS 16-byte words of K and of V a thread
// a pass: each thread first issues the loads of all its words (every tail
// slot, unconditionally: the planes are in bounds and a window's rows are
// full but for rows that stopped) and of their rows' scales, then reads
// base_len, tail_len and the table entry of each word's slot, and stores
// only then. The launch (dli_paged_tail_flush) takes WORDS = 2 and as many
// heads a block as one pass covers: at that size 1024 blocks of 54
// registers a thread, all resident at once (9 an SM), so every byte of the
// window is in flight before a store waits. One head a block with 4 words
// (2048 blocks of 72 registers, 7 an SM: two waves) and 8 heads with 8
// words (256 blocks) were slower on an H100 (tools/torch_cluster_sweep.py
// --flush rebuilds this source with other PAGED_FLUSH_WORDS and
// PAGED_FLUSH_HEADS; PERF.md).
template <int WORDS>
__global__ void __launch_bounds__(kThreads) tail_flush_kernel(
    int8_t* __restrict__ pk, float* __restrict__ pks,
    int8_t* __restrict__ pv, float* __restrict__ pvs,  // [L, P, Hkv, PS(, D)]
    const int8_t* __restrict__ tk, const float* __restrict__ tks,
    const int8_t* __restrict__ tv, const float* __restrict__ tvs,  // [L, B, Hkv, KT(, D)]
    const int* __restrict__ table, const int* __restrict__ base_len,
    const int* __restrict__ tail_len, int B, int P, int Hkv, int PS, int Tw,
    int KT, int D, int hb) {
  const int h0 = blockIdx.x * hb;
  const int b = blockIdx.y;
  const int l = blockIdx.z;
  const int t = threadIdx.x;
  const int chunks = D / 16;
  const int total = min(hb, Hkv - h0) * KT;          // tail rows of the block
  const int rows = kThreads * WORDS / chunks;         // tail rows a pass
  const size_t src0 = (((size_t)l * B + b) * Hkv + h0) * KT;
  const uint4* ksrc = reinterpret_cast<const uint4*>(tk + src0 * D);
  const uint4* vsrc = reinterpret_cast<const uint4*>(tv + src0 * D);
  // The pool row of the block's tail row j (kv head h0 + j / KT, slot
  // j % KT), or -1 where nothing is written.
  auto dest = [&](int j, int start, int n) -> long long {
    const int i = j % KT;
    const int pos = start + i;
    const int slot = pos / PS;
    if (i >= n || slot >= Tw) return -1;
    const int page = table[(size_t)b * Tw + slot];
    if (page <= 0 || page >= P) return -1;
    return (((long long)l * P + page) * Hkv + h0 + j / KT) * PS + pos % PS;
  };
  for (int r0 = 0; r0 < total; r0 += rows) {
    const int words = min(rows, total - r0) * chunks;
    uint4 kw[WORDS], vw[WORDS];
    float ksw[WORDS], vsw[WORDS];
#pragma unroll
    for (int u = 0; u < WORDS; ++u) {
      const int w = u * kThreads + t;
      if (w < words) {
        kw[u] = ksrc[(size_t)r0 * chunks + w];
        vw[u] = vsrc[(size_t)r0 * chunks + w];
      }
      if (w < rows && r0 + w < total) {
        ksw[u] = tks[src0 + r0 + w];
        vsw[u] = tvs[src0 + r0 + w];
      }
    }
    const int start = base_len[b];
    const int n = min(tail_len[b], KT);
#pragma unroll
    for (int u = 0; u < WORDS; ++u) {
      const int w = u * kThreads + t;
      if (w < words) {
        const long long dst = dest(r0 + w / chunks, start, n);
        if (dst >= 0) {
          reinterpret_cast<uint4*>(pk + dst * D)[w % chunks] = kw[u];
          reinterpret_cast<uint4*>(pv + dst * D)[w % chunks] = vw[u];
        }
      }
      if (w < rows && r0 + w < total) {
        const long long dst = dest(r0 + w, start, n);
        if (dst >= 0) {
          pks[dst] = ksw[u];
          pvs[dst] = vsw[u];
        }
      }
    }
  }
}

// Words a thread and kv heads a block of the launch below (0: as many as
// one pass covers).
#ifndef PAGED_FLUSH_WORDS
#define PAGED_FLUSH_WORDS 2
#endif
#ifndef PAGED_FLUSH_HEADS
#define PAGED_FLUSH_HEADS 0
#endif

// Launches tail_flush_kernel<WORDS> with hb kv heads a block.
template <int WORDS>
int launch_tail_flush(void* pool_k, void* pool_ks, void* pool_v,
                      void* pool_vs, const void* tail_k, const void* tail_ks,
                      const void* tail_v, const void* tail_vs,
                      const void* table, const void* base_len,
                      const void* tail_len, int L, int B, int P, int Hkv,
                      int PS, int Tw, int KT, int D, int hb, void* stream) {
  tail_flush_kernel<WORDS><<<dim3((Hkv + hb - 1) / hb, B, L), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(pool_k), static_cast<float*>(pool_ks),
      static_cast<int8_t*>(pool_v), static_cast<float*>(pool_vs),
      static_cast<const int8_t*>(tail_k), static_cast<const float*>(tail_ks),
      static_cast<const int8_t*>(tail_v), static_cast<const float*>(tail_vs),
      static_cast<const int*>(table), static_cast<const int*>(base_len),
      static_cast<const int*>(tail_len), B, P, Hkv, PS, Tw, KT, D, hb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool planes [L, P, Hkv, PS, D] int8 / [L, P, Hkv, PS] f32, tail planes
// [L, B, Hkv, KT, D] / [L, B, Hkv, KT], table [B, Tw], base_len and tail_len
// [B] int32. D a multiple of 16 up to 16 * 2 * kThreads. One launch of
// tail_flush_kernel<2>, a block the kv heads of a (row, layer) that one
// pass of 2 words of K and of V a thread covers (2 at KT = 16, D = 128; at
// least 1). Returns cudaGetLastError() after the launch, -1 for another D
// or a grid the card does not take.
extern "C" int dli_paged_tail_flush(
    void* pool_k, void* pool_ks, void* pool_v, void* pool_vs,
    const void* tail_k, const void* tail_ks, const void* tail_v,
    const void* tail_vs, const void* table, const void* base_len,
    const void* tail_len, int L, int B, int P, int Hkv, int PS, int Tw,
    int KT, int D, void* stream) {
  if (L <= 0 || B <= 0 || KT <= 0) return 0;
  constexpr int kWords = PAGED_FLUSH_WORDS;
  if (D % 16 != 0 || D / 16 > kWords * kThreads || Hkv < 1 || B > 65535 ||
      L > 65535)
    return -1;
  const int per_head = KT * (D / 16);  // 16-byte words of a head's tail
  int hb = PAGED_FLUSH_HEADS > 0 ? PAGED_FLUSH_HEADS
                                 : kWords * kThreads / per_head;
  hb = hb < 1 ? 1 : hb > Hkv ? Hkv : hb;
  return launch_tail_flush<kWords>(pool_k, pool_ks, pool_v, pool_vs, tail_k,
                                   tail_ks, tail_v, tail_vs, table, base_len,
                                   tail_len, L, B, P, Hkv, PS, Tw, KT, D, hb,
                                   stream);
}

// The fused step's cluster launch at these widths (bf16 queries), as
// fused::launch_cluster makes it, NT tiles a row (a page each) of W rows:
// fused::cluster_plan's seven values. Returns 0, -1 outside G in {1, 4},
// or the CUDA error of the occupancy query.
extern "C" int dli_fused_cluster_plan(int NT, int W, int G, long long* out) {
  return fused::cluster_plan<fused::BigThenTail<true>>(NT, W, G, out);
}
