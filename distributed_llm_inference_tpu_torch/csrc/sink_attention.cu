// Kernels over the int8 StreamingLLM sink ring (cache/sink.py:
// QuantizedSinkKVCache), for Hopper (sm_90a), plain C interface. They
// replace two TPU kernels of distributed_llm_inference_tpu/ops/
// quant_attention.py, each an instance of fused_decode.cuh's kernels:
//
// * `_qsink_kernel` behind `sink_fused_decode_attention`: one (layer, step)
//   of the fused K-step decode window over three segments under one
//   softmax, in this order:
//     1. the ring [L, B, Hkv, TR, D] in tiles of `tile_w` slots (the
//        largest multiple of 32 up to 256 that divides TR). Slot `t` is
//        valid where t < ring_len and ((t - ring_ptr) mod ring_slots) >=
//        evict_len: the in-flight tail has already evicted the evict_len
//        oldest slots from ring_ptr on. Ring keys are rotated at absolute
//        positions and scored with q;
//     2. one tile of SP sink slots [L, B, Hkv, SP, D], valid below
//        sink_len, scored with q_sink (the query rotated at its
//        window-relative position);
//     3. the tail [L, B, Hkv, KT, D], valid below tail_vlen, with the
//        step's K/V quantized into slot `step` first.
//   The three passes of fused_decode.cuh under the policy `Ring` below: a
//   masked slot reads nothing, scores kNegInf and takes p = 0. A ring tile
//   past ring_len holds nothing valid and is skipped (an exact no-op in the
//   TPU kernel's walk). The arithmetic is the TPU kernel's, rounding
//   included (q and p * vs rounded to bf16 before the products, scores
//   (q . k) * ks * scale); ops/quant_attention.py:
//   sink_fused_decode_attention_plain walks the same tiles.
// * `sink_tail_flush`: the window's int8 tail merged into the ring planes.
//   The TPU kernel's blocked read-modify-write (32-slot value and 128-slot
//   scale blocks, a third visit pinned to block 0 for wrapped windows) is a
//   VMEM tiling rule; here fused_decode.cuh's direct scatter with the
//   destination `RingDest`: tail token i (skip <= i < tail_len) goes to
//   ring slot (ring_ptr + i - skip) % ring_slots, values and scales written
//   once, the padding slots [ring_slots, TR) never. No limit on KT beyond
//   tail_len - skip <= ring_slots.
//
// What bounds them on this card: bytes. The step reads each live ring,
// sink and tail byte once for a few flops a byte (the scratch adds 4 bytes
// a score, written and read, and D floats a tile); the flush reads each
// tail byte once and writes it once.

#include "fused_decode.cuh"

namespace sink {

using fused::DenseRows;
using fused::kD;

enum Segment { kRing = 0, kSinks = 1, kTail = 2 };

struct Tile {
  int seg, lo, n;  // segment, first slot, width
};

// Validity of slot lo + i of a row's tile.
struct Live {
  int seg, lo, ring_len, ptr, evict, ring_slots, sink_len, vlen;
  __device__ __forceinline__ bool operator()(int i) const {
    if (seg == kSinks) return i < sink_len;
    if (seg == kTail) return i < vlen;
    const int slot = lo + i;
    const int dd = slot - ptr + (slot < ptr ? ring_slots : 0);
    return slot < ring_len && dd >= evict;
  }
};

// The geometry policy of fused_decode.cuh's passes for the sink ring. A
// row's tiles: its ring tiles below ring_len, then the sinks, then the
// tail.
struct Ring : fused::Common {
  const void* q_sink;                       // [B, Hq, D]
  const int8_t *ring_k, *ring_v;            // [L, B, Hkv, TR, D]
  const float *ring_ks, *ring_vs;           // [L, B, Hkv, TR]
  const int8_t *sink_k, *sink_v;            // [L, B, Hkv, SP, D]
  const float *sink_ks, *sink_vs;           // [L, B, Hkv, SP]
  const int *ring_len, *ring_ptr, *evict, *sink_len, *tail_vlen;
  int TR, SP, tile_w, ring_slots;

  struct Geo {
    int nring, ntiles;
  };
  __device__ Geo geo(int b) const {
    const int len = min(ring_len[b], TR);
    const int nring = len > 0 ? (len + tile_w - 1) / tile_w : 0;
    return Geo{nring, nring + 2};
  }
  __device__ bool is_tail(const Geo& g, int j) const {
    return j == g.nring + 1;
  }
  __device__ const void* query(const Geo& g, int j) const {
    return j == g.nring ? q_sink : q;
  }
  // The planes of one (layer, row, kv head) of a segment.
  __device__ DenseRows rows_of(int seg, int b, int h) const {
    const size_t r = ((size_t)layer * B + b) * Hkv + h;
    if (seg == kRing)
      return DenseRows{ring_k + r * TR * kD, ring_v + r * TR * kD,
                       ring_ks + r * TR, ring_vs + r * TR};
    if (seg == kSinks)
      return DenseRows{sink_k + r * SP * kD, sink_v + r * SP * kD,
                       sink_ks + r * SP, sink_vs + r * SP};
    return fused::tail_rows(*this, b, h);
  }
  template <class F>
  __device__ void visit(const Geo& g, int b, int h, int j, F&& f) const {
    const Tile t = j < g.nring    ? Tile{kRing, j * tile_w, tile_w}
                   : j == g.nring ? Tile{kSinks, 0, SP}
                                  : Tile{kTail, 0, KT};
    f(rows_of(t.seg, b, h), t.lo, t.n,
      Live{t.seg, t.lo, ring_len[b], ring_ptr[b], evict[b], ring_slots,
           sink_len[b], min(tail_vlen[b], KT)});
  }
};

// The flush's destination: tail token i of row b, skip <= i < tail_len, to
// ring slot (ring_ptr + i - skip) % ring_slots.
struct RingDest {
  const int *ring_ptr, *skip, *tail_len;
  int ring_slots;
  struct Row {
    int first, end, ptr, ring_slots;
    __device__ int slot(int i) const {
      return (ptr + i - first) % ring_slots;
    }
  };
  __device__ Row row(int b) const {
    return Row{max(skip[b], 0), tail_len[b], ring_ptr[b], ring_slots};
  }
};

}  // namespace sink

// q, q_sink [B, Hkv*G, D], k_new / v_new [B, Hkv, D] and out in `dtype`
// (0 = bf16, 1 = f32); ring planes [L, B, Hkv, TR, D] int8 / [L, B, Hkv, TR]
// f32, sink planes [L, B, Hkv, SP(, D)], tail planes [L, B, Hkv, KT(, D)];
// ring_len, ring_ptr, evict, sink_len, tail_vlen [B] int32; step one int32
// in device memory; `scratch` B * Hkv * G * NT * (W + 3 + D) floats, NT >=
// TR / tile_w + 2, W >= max(tile_w, SP, KT). Returns cudaGetLastError()
// after the launches, -1 for a shape outside D = 128, G in {1, 4}, tile_w
// dividing TR, SP and KT in 1..256.
extern "C" int dli_sink_fused_decode_attention(
    const void* q, const void* q_sink, const void* k_new, const void* v_new,
    const void* ring_k, const void* ring_ks, const void* ring_v,
    const void* ring_vs, const void* sink_k, const void* sink_ks,
    const void* sink_v, const void* sink_vs, void* tail_k, void* tail_ks,
    void* tail_v, void* tail_vs, const void* ring_len, const void* ring_ptr,
    const void* evict, const void* sink_len, const void* tail_vlen,
    const void* step, void* out, void* scratch, int B, int Hkv, int G, int D,
    int TR, int SP, int KT, int tile_w, int layer, int ring_slots, int NT,
    int W, float scale, int dtype, void* stream) {
  using fused::kMaxTile;
  if (B <= 0) return 0;
  if (D != fused::kD || tile_w < 1 || tile_w > kMaxTile || TR % tile_w != 0 ||
      SP < 1 || SP > kMaxTile || KT < 1 || KT > kMaxTile || ring_slots < 1 ||
      ring_slots > TR)
    return -1;
  if (W < tile_w || W < SP || W < KT || NT < TR / tile_w + 2) return -1;
  sink::Ring a;
  a.q = q; a.q_sink = q_sink; a.k_new = k_new; a.v_new = v_new;
  a.ring_k = static_cast<const int8_t*>(ring_k);
  a.ring_v = static_cast<const int8_t*>(ring_v);
  a.ring_ks = static_cast<const float*>(ring_ks);
  a.ring_vs = static_cast<const float*>(ring_vs);
  a.sink_k = static_cast<const int8_t*>(sink_k);
  a.sink_v = static_cast<const int8_t*>(sink_v);
  a.sink_ks = static_cast<const float*>(sink_ks);
  a.sink_vs = static_cast<const float*>(sink_vs);
  a.tail_k = static_cast<int8_t*>(tail_k);
  a.tail_v = static_cast<int8_t*>(tail_v);
  a.tail_ks = static_cast<float*>(tail_ks);
  a.tail_vs = static_cast<float*>(tail_vs);
  a.ring_len = static_cast<const int*>(ring_len);
  a.ring_ptr = static_cast<const int*>(ring_ptr);
  a.evict = static_cast<const int*>(evict);
  a.sink_len = static_cast<const int*>(sink_len);
  a.tail_vlen = static_cast<const int*>(tail_vlen);
  a.step = static_cast<const int*>(step);
  a.out = out;
  a.scratch = static_cast<float*>(scratch);
  a.B = B; a.Hkv = Hkv; a.TR = TR; a.SP = SP; a.KT = KT; a.tile_w = tile_w;
  a.layer = layer; a.ring_slots = ring_slots; a.NT = NT; a.W = W;
  a.scale = scale;
  return fused::dispatch(a, G, dtype, stream);
}

// ring planes [L, B, Hkv, TR, D] int8 / [L, B, Hkv, TR] f32, tail planes
// [L, B, Hkv, KT, D] / [L, B, Hkv, KT], ring_ptr, skip, tail_len [B] int32
// (0 <= ring_ptr < ring_slots <= TR, tail_len - skip <= ring_slots). D a
// multiple of 16. Returns cudaGetLastError() after the launch.
extern "C" int dli_sink_tail_flush(
    void* ring_k, void* ring_ks, void* ring_v, void* ring_vs,
    const void* tail_k, const void* tail_ks, const void* tail_v,
    const void* tail_vs, const void* ring_ptr, const void* skip,
    const void* tail_len, int L, int B, int Hkv, int TR, int KT, int D,
    int ring_slots, void* stream) {
  if (ring_slots < 1 || ring_slots > TR) return -1;
  const sink::RingDest dest{static_cast<const int*>(ring_ptr),
                            static_cast<const int*>(skip),
                            static_cast<const int*>(tail_len), ring_slots};
  return fused::launch_tail_scatter(ring_k, ring_ks, ring_v, ring_vs, tail_k,
                                    tail_ks, tail_v, tail_vs, L, B, Hkv, TR,
                                    KT, D, dest, stream);
}
