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
// Built for head_dim 64 and 128 with 1 to 8 query heads per kv head (MHA,
// and the published GQA groupings up to Llama-3-70B's 8); a model with
// other widths adds its instance to paged_decode.cuh's dispatch and
// decode_attention.cuh's dispatch_g / dispatch_d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "fused_decode.cuh"
#include "paged_decode.cuh"
#include "tail_flush.cuh"

// bf16 q [B, Hkv*G, D] and pages [P, Hkv, PS, D], table [B, Tw], kv_lens and
// q_pos [B] int32; out as q, m_out / l_out f32 [B, Hkv, G]. window: 0 = no
// sliding window. One launch of paged_decode.cuh's kernel, a cluster of C
// blocks (1..8) a (row, kv head). Returns cudaGetLastError() after the
// launch, -1 for a shape outside D in {64, 128}, G in 1..8, -2 if the
// driver refused a tensor map.
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
// of head_dim D (any G: its shared memory does not depend on it), clusters
// of C blocks: out[0] shared memory a block, out[1] blocks an SM, out[2]
// clusters the card holds at once. Returns 0, -1 outside D in {64, 128}
// and C in 1..8, or a CUDA error.
extern "C" int dli_decode_occupancy(int int8, int D, int C, long long* out) {
  if (C < 1 || C > pdec::kMaxCluster) return -1;
  if (D == 64)
    return int8 ? pdec::occupancy<64, int8_t>(C, out)
                : pdec::occupancy<64, __nv_bfloat16>(C, out);
  if (D == 128)
    return int8 ? pdec::occupancy<128, int8_t>(C, out)
                : pdec::occupancy<128, __nv_bfloat16>(C, out);
  return -1;
}

// The f32 instances (dtype 1; bf16 takes the entries above): the split
// walk of decode_attention.cuh. window: 0 = no sliding window. NS blocks
// share a row's positions, `chunk` positions each (NS * chunk >= Tw * PS);
// part_o / part_m / part_l are f32 scratch of [B, Hkv, NS, G, D] and twice
// [B, Hkv, NS, G]. Returns cudaGetLastError() after the launches, or -1 for
// a shape outside D in {64, 128}, G in 1..8, or another dtype.
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
// outside D in {64, 128}, G in 1..8, PS and KT in 1..256, or one whose
// shared memory does not fit a block.
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
  a.G = G; a.D = D;
  return fused::launch<true>(a, dtype, stream);
}

namespace {

// Replaces `paged_tail_flush` (its TPU kernel read-modify-writes whole
// pages through VMEM, with clamped duplicate visits): tail_flush.cuh's
// kernel with this destination. Row b's tail slot i < tail_len[b] goes to
// position base_len[b] + i of its pages, scales beside them; nothing is
// written for a position past the table or on the null page 0 (nor on an
// id outside the pool).
struct PagedDest {
  const int *table, *base_len, *tail_len;
  int P, Hkv, PS, Tw;
  struct Row {
    int start, n;
  };
  __device__ Row row(int b) const { return Row{base_len[b], tail_len[b]}; }
  __device__ long long at(const Row& r, int l, int b, int h, int i) const {
    const int pos = r.start + i;
    const int slot = pos / PS;
    if (i >= r.n || slot >= Tw) return -1;
    const int page = table[(size_t)b * Tw + slot];
    if (page <= 0 || page >= P) return -1;
    return (((long long)l * P + page) * Hkv + h) * PS + pos % PS;
  }
};

}  // namespace

// pool planes [L, P, Hkv, PS, D] int8 / [L, P, Hkv, PS] f32, tail planes
// [L, B, Hkv, KT, D] / [L, B, Hkv, KT], table [B, Tw], base_len and tail_len
// [B] int32. D a multiple of 16 up to 16 * 2 * 128. One launch of
// tail_flush.cuh's kernel (launch_tail_flush: 2 words of K and of V a
// thread, the kv heads of a (row, layer) that one pass covers a block, 2
// at KT = 16, D = 128). Returns cudaGetLastError() after the launch, -1
// for another D or a grid the card does not take.
extern "C" int dli_paged_tail_flush(
    void* pool_k, void* pool_ks, void* pool_v, void* pool_vs,
    const void* tail_k, const void* tail_ks, const void* tail_v,
    const void* tail_vs, const void* table, const void* base_len,
    const void* tail_len, int L, int B, int P, int Hkv, int PS, int Tw,
    int KT, int D, void* stream) {
  if (PS < 1) return -1;
  const PagedDest dest{static_cast<const int*>(table),
                       static_cast<const int*>(base_len),
                       static_cast<const int*>(tail_len), P, Hkv, PS, Tw};
  return flush::launch_tail_flush(pool_k, pool_ks, pool_v, pool_vs, tail_k,
                                  tail_ks, tail_v, tail_vs, L, B, Hkv, KT, D,
                                  dest, stream);
}

// The fused step's cluster launch at these widths (bf16 queries), as
// fused::launch_cluster makes it, NT tiles a row (a page each) of W rows:
// fused::cluster_plan's seven values. Returns 0, -1 outside G in 1..8 and
// D in {64, 128}, or the CUDA error of the occupancy query.
extern "C" int dli_fused_cluster_plan(int NT, int W, int G, int D,
                                      long long* out) {
  return fused::cluster_plan<fused::BigThenTail<true>>(NT, W, G, D, out);
}
