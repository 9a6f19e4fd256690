// Kernels over the int8 dense cache's contiguous head-major buffers
// [L, B, Hkv, T, D] (+ [L, B, Hkv, T] f32 scales), for Hopper (sm_90a),
// plain C interface. They replace three TPU kernels of
// distributed_llm_inference_tpu/ops/quant_attention.py:
//
// * `_qfused_kernel` behind `quantized_fused_decode_attention`: one (layer,
//   step) of the fused K-step decode window over contiguous int8 stacks
//   (the dense cache's own buffers, or the int8 page pool's rows gathered
//   once per window below INPLACE_CTX, cache/paged.py), in tiles of
//   min(256, T) positions as the TPU kernel tiles them, with the step's K/V
//   quantized into the int8 tail as the last tile. One launch of
//   fused_decode.cuh's cluster kernel with Paged = false, the tiles dealt
//   to the cluster's blocks as pieces of 64; that file says what bounds
//   it.
// * `_qdense_kernel` behind `quantized_decode_attention`: one decode token a
//   row over one layer's [B, Hkv, T, D] buffer. Bound by bytes. bf16
//   queries: one launch of paged_decode.cuh's cluster kernel over the
//   buffer as one run of B * Hkv * T rows (DenseRows), no scratch; p * vs
//   enters P V as two bf16 terms. f32 queries: the split walk of
//   decode_attention.cuh with no table (row b is its own page of T slots),
//   everything f32, p * vs included.
// * `fused_tail_flush`: the fused window's int8 tail merged into the
//   buffers, a direct scatter: tail_flush.cuh's kernel, shared with the
//   pool's flush and the sink ring's, under the destination DenseDest
//   below.

#include "decode_attention.cuh"
#include "fused_decode.cuh"
#include "paged_decode.cuh"
#include "tail_flush.cuh"

// big stacks [L, B, Hkv, T, D] int8 / [L, B, Hkv, T] f32, tail planes
// [L, B, Hkv, KT, D] / [L, B, Hkv, KT]; q [B, Hkv*G, D], k_new / v_new
// [B, Hkv, D] and out in `dtype` (0 = bf16, 1 = f32); base_len, tail_vlen,
// q_pos [B] int32; step one int32 in device memory; tile_w the TPU
// kernel's tile, min(256, T). One launch of fused_decode.cuh's cluster
// kernel, pieces of min(kPiece, tile_w) positions. Returns
// cudaGetLastError() after the launch, -1 for a shape outside D in
// {64, 128}, G in 1..8, tile_w and KT in 1..256, or past a block's shared
// memory.
extern "C" int dli_quantized_fused_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* big_k,
    const void* big_ks, const void* big_v, const void* big_vs, void* tail_k,
    void* tail_ks, void* tail_v, void* tail_vs, const void* base_len,
    const void* tail_vlen, const void* q_pos, const void* step, void* out,
    int B, int Hkv, int G, int D, int T, int tile_w, int KT, int layer,
    float scale, int window, int dtype, void* stream) {
  fused::Args a;
  a.q = q; a.k_new = k_new; a.v_new = v_new;
  a.big_k = static_cast<const int8_t*>(big_k);
  a.big_v = static_cast<const int8_t*>(big_v);
  a.big_ks = static_cast<const float*>(big_ks);
  a.big_vs = static_cast<const float*>(big_vs);
  a.tail_k = static_cast<int8_t*>(tail_k);
  a.tail_v = static_cast<int8_t*>(tail_v);
  a.tail_ks = static_cast<float*>(tail_ks);
  a.tail_vs = static_cast<float*>(tail_vs);
  a.table = nullptr;
  a.base_len = static_cast<const int*>(base_len);
  a.tail_vlen = static_cast<const int*>(tail_vlen);
  a.q_pos = static_cast<const int*>(q_pos);
  a.step = static_cast<const int*>(step);
  a.out = out;
  if (tile_w < 1 || KT < 1) return -1;
  const int pw = tile_w < fused::kPiece ? tile_w : fused::kPiece;
  a.piece_w = pw;
  a.NP = (T + pw - 1) / pw + (KT + pw - 1) / pw;
  a.W = pw;
  a.B = B; a.Hkv = Hkv; a.rows = T; a.ps = 0; a.tw = 0; a.tile_w = tile_w;
  a.KT = KT; a.layer = layer; a.window = window; a.scale = scale;
  a.G = G; a.D = D;
  return fused::launch<false>(a, dtype, stream);
}

// The cluster launch of dli_quantized_fused_decode_attention at stacks of T
// positions, tiles of tile_w, a tail of KT and G query heads a kv head
// (bf16 queries): fused::cluster_plan's seven values, out[7] the piece
// width. Returns 0, -1 for shapes it does not take, or the CUDA error of
// the occupancy query.
extern "C" int dli_fused_dense_plan(int T, int tile_w, int KT, int G, int D,
                                    long long* out) {
  if (T < 1 || tile_w < 1 || KT < 1) return -1;
  const int pw = tile_w < fused::kPiece ? tile_w : fused::kPiece;
  out[7] = pw;
  return fused::cluster_plan<fused::BigThenTail<false>>(
      (T + pw - 1) / pw + (KT + pw - 1) / pw, pw, G, D, out);
}

// bf16 q [B, Hkv*G, D] and out; k / v int8 [B, Hkv, T, D] and ks / vs f32
// [B, Hkv, T] (one layer of the cache); kv_lens and q_pos [B] int32; m_out
// / l_out f32 [B, Hkv, G] or null. window 0 = none. One launch of
// paged_decode.cuh's kernel, a cluster of C blocks (1..8) a (row, kv head),
// boxes of 64 rows over the buffer's B * Hkv * T rows (below 2^31). Returns
// cudaGetLastError() after the launch, -1 for a shape outside D in
// {64, 128}, G in 1..8, -2 if the driver refused a tensor map.
extern "C" int dli_quantized_decode_attention_bf16(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* kv_lens, const void* q_pos, void* out,
    void* m_out, void* l_out, int B, int Hkv, int G, int D, int T, int C,
    float scale, int window, void* stream) {
  const long long rows = (long long)B * Hkv * T;
  if (T < 1 || rows >= (1ll << 31)) return -1;
  return pdec::dispatch<int8_t>(
      q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
      pdec::DenseRows{T, Hkv, static_cast<int>(rows)},
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_pos), out,
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, Hkv, G, D, T,
      pdec::kStep, C, scale, window, static_cast<cudaStream_t>(stream));
}

// The f32 instance (dtype 1; bf16 takes the entry above): q [B, Hkv*G, D]
// and out f32, the planes as above; NS blocks share a row's T positions,
// `chunk` each (NS * chunk >= T); m_out / l_out f32 [B, Hkv, G]; part_o /
// part_m / part_l f32 scratch of [B, Hkv, NS, G, D] and twice [B, Hkv, NS,
// G]. window 0 = none. Returns cudaGetLastError() after the launches, -1
// for a shape outside D in {64, 128}, G in 1..8, or another dtype.
extern "C" int dli_quantized_decode_attention(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* kv_lens, const void* q_pos, void* out,
    void* m_out, void* l_out, void* part_o, void* part_m, void* part_l,
    int B, int Hkv, int G, int D, int T, int NS, int chunk, float scale,
    int window, int dtype, void* stream) {
  decode::Args a;
  a.k = k; a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  return decode::fill_and_dispatch(
      a, q, nullptr, kv_lens, q_pos, out, m_out, l_out, part_o, part_m,
      part_l, B, Hkv, G, D, T, 1, NS, chunk, scale, window, dtype, true,
      stream);
}

namespace {

// Replaces `fused_tail_flush` (its TPU kernel read-modify-writes the
// 32-token value blocks and 128-slot scale blocks a row's window touches,
// with clamped duplicate visits): tail_flush.cuh's kernel with this
// destination. Each of a row's tail_len[b] tail slots goes to position
// base_len[b] + i of the buffers; nothing is written at or past T.
struct DenseDest {
  const int *base_len, *tail_len;
  int B, Hkv, T;
  struct Row {
    int start, n;
  };
  __device__ Row row(int b) const { return Row{base_len[b], tail_len[b]}; }
  __device__ long long at(const Row& r, int l, int b, int h, int i) const {
    const int pos = r.start + i;
    if (i >= r.n || pos < 0 || pos >= T) return -1;
    return (((long long)l * B + b) * Hkv + h) * T + pos;
  }
};

}  // namespace

// big planes [L, B, Hkv, T, D] int8 / [L, B, Hkv, T] f32, tail planes
// [L, B, Hkv, KT, D] / [L, B, Hkv, KT], base_len and tail_len [B] int32. D a
// multiple of 16 up to 16 * 2 * 128. One launch of tail_flush.cuh's kernel,
// as dli_paged_tail_flush's. Returns cudaGetLastError() after the launch,
// -1 for another D or a grid the card does not take.
extern "C" int dli_fused_tail_flush(
    void* big_k, void* big_ks, void* big_v, void* big_vs, const void* tail_k,
    const void* tail_ks, const void* tail_v, const void* tail_vs,
    const void* base_len, const void* tail_len, int L, int B, int Hkv, int T,
    int KT, int D, void* stream) {
  const DenseDest dest{static_cast<const int*>(base_len),
                       static_cast<const int*>(tail_len), B, Hkv, T};
  return flush::launch_tail_flush(big_k, big_ks, big_v, big_vs, tail_k,
                                  tail_ks, tail_v, tail_vs, L, B, Hkv, KT, D,
                                  dest, stream);
}
