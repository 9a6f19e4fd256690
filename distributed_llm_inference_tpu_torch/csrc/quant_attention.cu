// Fused decode step over a contiguous int8 K/V stack, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel `_qfused_kernel` behind
// `quantized_fused_decode_attention` in
// distributed_llm_inference_tpu/ops/quant_attention.py. The int8 page pool's
// fused window below INPLACE_CTX (cache/paged.py) gathers every row's pages
// once per window into contiguous [L, B, Hkv, T, D] stacks (plain PyTorch
// indexing, outside any kernel, as the JAX package leaves it to XLA); each
// (layer, step) of the window then runs these kernels over those stacks, in
// tiles of min(256, T) positions as the TPU kernel tiles them, with the
// step's K/V quantized into the int8 tail as the last tile. The kernels are
// fused_decode.cuh's with Paged = false; that file says what bounds them.

#include "fused_decode.cuh"

// big stacks [L, B, Hkv, T, D] int8 / [L, B, Hkv, T] f32, tail planes
// [L, B, Hkv, KT, D] / [L, B, Hkv, KT]; q [B, Hkv*G, D], k_new / v_new
// [B, Hkv, D] and out in `dtype` (0 = bf16, 1 = f32); base_len, tail_vlen,
// q_pos [B] int32; step one int32 in device memory; `scratch` holds
// B * Hkv * G * NT * (W + 3 + D) floats, NT >= ceil(T / tile_w) + 1,
// W >= max(tile_w, KT). Returns cudaGetLastError() after the launches, -1
// for a shape outside D = 128, G in {1, 4}, tile_w and KT in 1..256.
extern "C" int dli_quantized_fused_decode_attention(
    const void* q, const void* k_new, const void* v_new, const void* big_k,
    const void* big_ks, const void* big_v, const void* big_vs, void* tail_k,
    void* tail_ks, void* tail_v, void* tail_vs, const void* base_len,
    const void* tail_vlen, const void* q_pos, const void* step, void* out,
    void* scratch, int B, int Hkv, int G, int D, int T, int tile_w, int KT,
    int layer, int NT, int W, float scale, int window, int dtype,
    void* stream) {
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
  a.scratch = static_cast<float*>(scratch);
  a.NT = NT; a.W = W;
  a.B = B; a.Hkv = Hkv; a.rows = T; a.ps = 0; a.tw = 0; a.tile_w = tile_w;
  a.KT = KT; a.layer = layer; a.window = window; a.scale = scale;
  return fused::launch<false>(a, G, D, dtype, stream);
}
