// Kernels over the int8 StreamingLLM sink ring (cache/sink.py:
// QuantizedSinkKVCache), for Hopper (sm_90a), plain C interface. They
// replace two TPU kernels of distributed_llm_inference_tpu/ops/
// quant_attention.py, the step an instance of fused_decode.cuh's cluster
// kernel, the flush of tail_flush.cuh's kernel:
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
//   One launch of fused_decode.cuh's cluster kernel under the policy `Ring`
//   below, a cluster of 7 blocks a (row, kv head). A ring tile is dealt as
//   pieces of `piece_w` slots (64, or 32 where 64 does not divide the
//   tile: TR = 1056 has 96-wide tiles), never across its edge, so each
//   tile's running max stays the walk's; the sinks and the tail are one
//   piece each, after the ring. Ring tiles, and the slots of the last one,
//   at or past ring_len hold nothing valid and are not read (exact no-ops
//   in the TPU kernel's walk); the sinks past sink_len and the tail past
//   tail_vlen likewise. An evicted slot inside ring_len is read with its
//   piece, scores kNegInf and takes p = 0, so a piece that is evicted
//   whole leaves the running max and the sums as they were. The block that
//   holds the sink piece loads its query registers from q_sink's rounded
//   values in shared memory for that piece alone. The arithmetic is the
//   TPU kernel's, rounding included (q and p * vs rounded to bf16 before
//   the products, scores (q . k) * ks * scale);
//   ops/quant_attention.py:sink_fused_decode_attention_plain walks the
//   same tiles.
// * `sink_tail_flush`: the window's int8 tail merged into the ring planes.
//   The TPU kernel's blocked read-modify-write (32-slot value and 128-slot
//   scale blocks, a third visit pinned to block 0 for wrapped windows) is a
//   VMEM tiling rule; here tail_flush.cuh's kernel (shared with the pool's
//   flush and the dense cache's) under the destination `RingDest`: tail
//   token i (skip <= i < tail_len) goes to ring slot (ring_ptr + i - skip)
//   % ring_slots, values and scales written once, the padding slots
//   [ring_slots, TR) never. No limit on KT beyond tail_len - skip <=
//   ring_slots.
//
// What bounds them on this card: bytes. The step reads each live ring,
// sink and tail byte once for a few flops a byte (and the evicted ring
// slots of a window, at most KT rows, with their pieces); the flush reads
// each tail byte once and writes it once.

#include "fused_decode.cuh"
#include "tail_flush.cuh"

namespace sink {

using fused::AllLive;
using fused::DenseRows;

// Validity of ring slot lo + i of a piece: outside the evicted range,
// the evict oldest slots from ptr on (mod ring_slots).
struct RingLive {
  int lo, ptr, evict, ring_slots;
  __device__ __forceinline__ bool operator()(int i) const {
    const int slot = lo + i;
    return slot - ptr + (slot < ptr ? ring_slots : 0) >= evict;
  }
};

// A row's pieces: ring pieces k < nring, each up to pw slots of one tile
// below ring_len; then the sinks below sink_len (if any), then the tail
// below tail_vlen (if any), one piece each.
struct RingGeo {
  int len, pw, tw, nring, sink_k, tail_k, nsink, vlen, npieces;
  int ptr, evict;
  __device__ void piece(int k, int& vlo, int& n) const {
    if (k < nring) {
      vlo = k * pw;
      n = min(len, vlo + pw) - vlo;
    } else {
      vlo = 0;
      n = k == sink_k ? nsink : vlen;
    }
  }
  __device__ int tile_last_piece(int k) const {
    if (k >= nring) return k;
    return min(nring, (k * pw / tw + 1) * (tw / pw)) - 1;
  }
  __device__ int step_piece(int step) const {
    return tail_k >= 0 && step >= 0 && step < vlen ? tail_k : -1;
  }
};

// The geometry policy of fused_decode.cuh's cluster kernel for the ring.
struct Ring : fused::Common {
  using Geo = RingGeo;
  static constexpr bool kTwoQueries = true;
  const void* q_sink;                       // [B, Hq, D]
  const int8_t *ring_k, *ring_v;            // [L, B, Hkv, TR, D]
  const float *ring_ks, *ring_vs;           // [L, B, Hkv, TR]
  const int8_t *sink_k, *sink_v;            // [L, B, Hkv, SP, D]
  const float *sink_ks, *sink_vs;           // [L, B, Hkv, SP]
  const int *ring_len, *ring_ptr, *evict, *sink_len, *tail_vlen;
  int TR, SP, tile_w, piece_w, ring_slots;

  __device__ Geo geo(int b) const {
    Geo g;
    g.len = max(0, min(ring_len[b], TR));
    g.pw = piece_w;
    g.tw = tile_w;
    g.nring = (g.len + piece_w - 1) / piece_w;
    g.nsink = max(0, min(sink_len[b], SP));
    g.vlen = max(0, min(tail_vlen[b], KT));
    g.sink_k = g.nsink > 0 ? g.nring : -1;
    g.tail_k = g.vlen > 0 ? g.nring + (g.nsink > 0) : -1;
    g.npieces = g.nring + (g.nsink > 0) + (g.vlen > 0);
    g.ptr = ring_ptr[b];
    g.evict = evict[b];
    return g;
  }
  __device__ int query(const Geo& g, int k) const {
    return k == g.sink_k ? 1 : 0;
  }
  __device__ const void* query_ptr(int w) const { return w ? q_sink : q; }
  // The planes of one (layer, row, kv head) of the ring or the sinks.
  __device__ DenseRows rows_of(bool ring, int b, int h) const {
    const size_t r = ((size_t)layer * B + b) * Hkv + h;
    if (ring)
      return DenseRows{ring_k + r * TR * D, ring_v + r * TR * D,
                       ring_ks + r * TR, ring_vs + r * TR};
    return DenseRows{sink_k + r * SP * D, sink_v + r * SP * D,
                     sink_ks + r * SP, sink_vs + r * SP};
  }
  template <class F>
  __device__ void visit_piece(const Geo& g, int b, int h, int k,
                              F&& f) const {
    int vlo, n;
    g.piece(k, vlo, n);
    if (k < g.nring)
      f(rows_of(true, b, h), vlo, n,
        RingLive{vlo, g.ptr, g.evict, ring_slots});
    else if (k == g.sink_k)
      f(rows_of(false, b, h), vlo, n, AllLive());
    else
      f(fused::tail_rows(*this, b, h), vlo, n, AllLive());
  }
};

// The flush's destination (tail_flush.cuh's kernel): tail token i of row
// b, skip <= i < tail_len, to ring slot (ring_ptr + i - skip) % ring_slots
// of the ring planes [L, B, Hkv, TR(, D)].
struct RingDest {
  const int *ring_ptr, *skip, *tail_len;
  int B, Hkv, TR, ring_slots;
  struct Row {
    int first, end, ptr;
  };
  __device__ Row row(int b) const {
    return Row{max(skip[b], 0), tail_len[b], ring_ptr[b]};
  }
  __device__ long long at(const Row& r, int l, int b, int h, int i) const {
    if (i < r.first || i >= r.end) return -1;
    const int slot = (r.ptr + i - r.first) % ring_slots;
    if (slot < 0) return -1;
    return (((long long)l * B + b) * Hkv + h) * TR + slot;
  }
};

}  // namespace sink

// The pieces and the widest piece of a launch: TR / piece_w ring pieces,
// the sinks, the tail; W = max(piece_w, SP, KT) rows a stage. False for a
// shape outside D in {64, 128}, tile_w dividing TR, piece_w dividing tile_w, SP
// and KT in 1..256, 0 < ring_slots <= TR.
static bool ring_shape(int D, int TR, int SP, int KT, int tile_w,
                       int piece_w, int ring_slots, int& NP, int& W) {
  using fused::kMaxTile;
  if ((D != 64 && D != 128) || tile_w < 1 || tile_w > kMaxTile ||
      TR % tile_w != 0 ||
      piece_w < 1 || tile_w % piece_w != 0 || SP < 1 || SP > kMaxTile ||
      KT < 1 || KT > kMaxTile || ring_slots < 1 || ring_slots > TR)
    return false;
  NP = TR / piece_w + 2;
  W = SP > KT ? SP : KT;
  if (piece_w > W) W = piece_w;
  return true;
}

// q, q_sink [B, Hkv*G, D], k_new / v_new [B, Hkv, D] and out in `dtype`
// (0 = bf16, 1 = f32); ring planes [L, B, Hkv, TR, D] int8 / [L, B, Hkv, TR]
// f32, sink planes [L, B, Hkv, SP(, D)], tail planes [L, B, Hkv, KT(, D)];
// ring_len, ring_ptr, evict, sink_len, tail_vlen [B] int32; step one int32
// in device memory. One launch of fused_decode.cuh's cluster kernel, ring
// tiles of tile_w dealt as pieces of piece_w. Returns cudaGetLastError()
// after the launch, -1 for a shape outside D in {64, 128}, G in 1..8, tile_w
// dividing TR, piece_w dividing tile_w, SP and KT in 1..256, or past a
// block's shared memory.
extern "C" int dli_sink_fused_decode_attention(
    const void* q, const void* q_sink, const void* k_new, const void* v_new,
    const void* ring_k, const void* ring_ks, const void* ring_v,
    const void* ring_vs, const void* sink_k, const void* sink_ks,
    const void* sink_v, const void* sink_vs, void* tail_k, void* tail_ks,
    void* tail_v, void* tail_vs, const void* ring_len, const void* ring_ptr,
    const void* evict, const void* sink_len, const void* tail_vlen,
    const void* step, void* out, int B, int Hkv, int G, int D, int TR,
    int SP, int KT, int tile_w, int piece_w, int layer, int ring_slots,
    float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  sink::Ring a;
  if (!ring_shape(D, TR, SP, KT, tile_w, piece_w, ring_slots, a.NP, a.W))
    return -1;
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
  a.B = B; a.Hkv = Hkv; a.TR = TR; a.SP = SP; a.KT = KT; a.tile_w = tile_w;
  a.piece_w = piece_w; a.layer = layer; a.ring_slots = ring_slots;
  a.scale = scale; a.G = G; a.D = D;
  return fused::dispatch_cluster(a, dtype, stream);
}

// The cluster launch of dli_sink_fused_decode_attention at these widths
// (bf16 queries): fused::cluster_plan's seven values, out[7] the pieces a
// row may have (NP), out[8] the widest piece (W). Returns 0, -1 for shapes
// it does not take, or the CUDA error of the occupancy query.
extern "C" int dli_sink_cluster_plan(int TR, int SP, int KT, int tile_w,
                                     int piece_w, int G, int D,
                                     long long* out) {
  int NP, W;
  if (!ring_shape(D, TR, SP, KT, tile_w, piece_w, TR, NP, W)) return -1;
  out[7] = NP;
  out[8] = W;
  return fused::cluster_plan<sink::Ring>(NP, W, G, D, out);
}

// ring planes [L, B, Hkv, TR, D] int8 / [L, B, Hkv, TR] f32, tail planes
// [L, B, Hkv, KT, D] / [L, B, Hkv, KT], ring_ptr, skip, tail_len [B] int32
// (0 <= ring_ptr < ring_slots <= TR, tail_len - skip <= ring_slots). D a
// multiple of 16 up to 16 * 2 * 128. One launch of tail_flush.cuh's
// kernel, as dli_paged_tail_flush's. Returns cudaGetLastError() after the
// launch, -1 outside 1 <= ring_slots <= TR, for another D or a grid the
// card does not take.
extern "C" int dli_sink_tail_flush(
    void* ring_k, void* ring_ks, void* ring_v, void* ring_vs,
    const void* tail_k, const void* tail_ks, const void* tail_v,
    const void* tail_vs, const void* ring_ptr, const void* skip,
    const void* tail_len, int L, int B, int Hkv, int TR, int KT, int D,
    int ring_slots, void* stream) {
  if (ring_slots < 1 || ring_slots > TR) return -1;
  const sink::RingDest dest{static_cast<const int*>(ring_ptr),
                            static_cast<const int*>(skip),
                            static_cast<const int*>(tail_len), B, Hkv, TR,
                            ring_slots};
  return flush::launch_tail_flush(ring_k, ring_ks, ring_v, ring_vs, tail_k,
                                  tail_ks, tail_v, tail_vs, L, B, Hkv, KT, D,
                                  dest, stream);
}
