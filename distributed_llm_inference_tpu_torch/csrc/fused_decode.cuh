// Fused decode step over int8 K/V with an int8 write-behind tail, for
// Hopper (sm_90a). Shared by three TPU kernels' replacements, each a
// geometry policy of the one kernel below, `fused_cluster_kernel`:
//
// * `quantized_paged_fused_attention` (distributed_llm_inference_tpu/ops/
//   paged_attention.py), whose big segment is the int8 page pool read in
//   place through the page table (BigThenTail<true>, csrc/paged_attention.cu);
// * `quantized_fused_decode_attention` (distributed_llm_inference_tpu/ops/
//   quant_attention.py), whose big segment is a contiguous [L, B, Hkv, T, D]
//   stack, the dense cache's own buffers or the int8 pool's rows gathered
//   once per window (BigThenTail<false>, csrc/quant_attention.cu), its
//   256-wide tiles dealt to the cluster as pieces of 64;
// * `sink_fused_decode_attention` (the same file), the int8 sink ring
//   (sink::Ring, csrc/sink_attention.cu): masked ring tiles dealt as
//   pieces, a tile of sinks scored with a query of its own, then the tail.
//
// The window's flushes (the tail into the pool, the dense buffers, the
// ring) are tail_flush.cuh's kernel.
//
// One call is one (layer, step) of a fused K-step decode window. It
// quantizes the step's new K and V per (row, kv head) exactly as
// cache/dense.py:_quantize_kv does (f32 amax over D, max(amax, 1e-8) / 127,
// round half to even, clip to +-127), writes them into tail slot `step` of
// layer `layer` for every row, and runs one online softmax over the row's
// live big-segment positions, then over the tail as the last tile.
//
// The arithmetic is the TPU kernel's, rounding included, so that the f32
// instance agrees with the plain version (and the JAX kernel) to 2e-5:
// q and p * vs are rounded to bf16 before the two products (int8 K and V are
// exact in bf16; the products are exact in f32), scores are
// (q . k) * ks * scale, and the softmax walks the SAME tiles in the same
// order with the same running max: a tile is one page (Paged), `tile`
// positions (contiguous, min(256, T); the sink ring's ring_tile_width), the
// sinks (the ring), and the tail is one tile after them. The running max at
// each tile decides how p * vs rounds. Tiles that hold no live position are
// skipped; in the TPU kernel they are exact no-ops (alpha = 1, p = 0). The
// score of a position is summed in a fixed order (16 products a lane in
// turn, then a butterfly over the lanes) that the plain version repeats
// (ops/quant_attention.py:_lane_order_dot): a score one ulp apart can round
// p * vs to the neighbouring bf16 value, which a short row feels at 1e-3.
//
// The tiles of a row run in parallel and still see the running max of the
// sequential walk: each tile's max is taken first, and the running max at
// tile j is the prefix max of the tile maxima, exactly what the walk holds
// there; each tile's sums are scaled by exp(m_j - m_last) (the product of
// the walk's alpha factors after it) when they are added up. One launch
// (`launch_cluster`): a thread-block cluster per (row, kv head) deals the
// row's pieces of tiles to its blocks and exchanges their maxima and the
// sums through distributed shared memory behind cluster barriers; nothing
// goes through device memory but the inputs, the tail slot and the output
// (see the section below).
//
// `step` is read from device memory, so a CUDA graph that captures the
// launch stays valid for every step of the window.
//
// What bounds it on this card: bytes (every live K and V byte is read once
// for a few flops). The kernel keeps every stage of a block in flight at
// once by bulk copies, splits P V over the warps, and keeps the scores,
// maxima and sums on chip: no scratch round trip, no second launch.
//
// Built for head_dim 64 and 128 (a template argument D) and 1 to 8 query
// heads a kv head: the instances take the group rounded up to 1, 4 or 8
// (Gp); the queries of heads past G are zeros, and their scores and sums,
// computed beside the others, are never written out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tile.cuh"

namespace fused {

constexpr int kThreads = 128;          // a thread per output element (D 128)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 256;          // widest tile (page, stack tile, tail)
constexpr int kEPL = 16;               // int8 elements per lane (16 bytes)
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

// What every form passes: the query, the step's K/V, the tail planes it is
// quantized into, the output.
struct Common {
  const void *q, *k_new, *v_new;          // [B, Hq, D], [B, Hkv, D] x2
  int8_t *tail_k, *tail_v;                // [L, B, Hkv, KT, D]
  float *tail_ks, *tail_vs;               // [L, B, Hkv, KT]
  const int* step;                        // one int32 in device memory
  void* out;                              // [B, Hq, D]
  int B, Hkv, KT, layer;
  int G, D;           // query heads a kv head, head_dim
  int W;              // widest piece: a stage's rows
  int NP;             // pieces a row may have
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
  int piece_w;        // contiguous: the cluster kernel's piece width
};

// Positions of the contiguous form's pieces: a 256-wide tile is dealt to
// the cluster's blocks as pieces of at most 64 (min(256, T) positions
// give 4 tiles at T = 640, but 11 pieces for 7 blocks).
constexpr int kPiece = 64;

// A row's tiles: big-segment tiles holding a live position inside the
// sliding window, in order, then the tail (slots below tail_vlen, this
// step's included, inside the window of the query). The cluster kernel
// deals them as pieces: positions aligned on multiples of the piece width
// pw (tpw in the tail), inside one tile each since pw divides the tile
// width (or the stack is one tile); a page and the paged form's tail are
// one piece each, as they are one tile.
struct Geometry {
  int lo, hi, tw, first, nbig, tlo, vlen;
  int pw, tpw, fp, nbp, ftp, npieces;
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
    pw = paged ? a.ps : a.piece_w;
    tpw = paged ? a.KT : a.piece_w;
    fp = (lo / pw) * pw;
    nbp = hi > lo ? (hi - fp + pw - 1) / pw : 0;
    ftp = (tlo / tpw) * tpw;
    npieces = nbp + (tlo < vlen ? (vlen - ftp + tpw - 1) / tpw : 0);
  }
  // Positions [vlo, vlo + n) of piece k, every one valid; the tail's
  // pieces are those from nbp on.
  __device__ void piece(int k, int& vlo, int& n) const {
    if (k < nbp) {
      const int start = fp + k * pw;
      vlo = max(lo, start);
      n = min(hi, start + pw) - vlo;
    } else {
      const int start = ftp + (k - nbp) * tpw;
      vlo = max(tlo, start);
      n = min(vlen, start + tpw) - vlo;
    }
  }
  // The last piece of the tile that holds piece k.
  __device__ int tile_last_piece(int k) const {
    if (k >= nbp) return npieces - 1;
    const int j = (fp + k * pw - first) / tw;       // tile of piece k
    const int end = min(hi, first + (j + 1) * tw);  // past its last position
    return (end - 1 - fp) / pw;
  }
  // The piece that holds tail slot `step`, or -1.
  __device__ int step_piece(int step) const {
    if (tlo >= vlen || step < tlo || step >= vlen) return -1;
    return nbp + (step - ftp) / tpw;
  }
};

__device__ __forceinline__ DenseRows tail_rows(const Common& a, int b,
                                               int h) {
  const size_t trow = ((size_t)a.layer * a.B + b) * a.Hkv + h;
  return DenseRows{a.tail_k + trow * a.KT * a.D, a.tail_v + trow * a.KT * a.D,
                   a.tail_ks + trow * a.KT, a.tail_vs + trow * a.KT};
}

// Every position of a piece is valid (the paged and contiguous forms, whose
// pieces are ranges of valid positions).
struct AllLive {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// The cluster kernel is written against a geometry policy P, the kernel's
// argument struct (Common and the form's own fields), which provides:
//   P::Geo geo(b)            a row's pieces: Geo::npieces counts them,
//                            Geo::piece(k, vlo, n) gives piece k's positions,
//                            Geo::tile_last_piece(k) the last piece of the
//                            tile holding piece k, Geo::step_piece(step) the
//                            piece holding tail slot `step` (or -1);
//   int query(geo, k)        the query piece k is scored with: 0 = q, 1 =
//                            the policy's second (kTwoQueries);
//   const void* query_ptr(i) query i, [B, Hq, D];
//   visit_piece(geo, b, h, k, f)  calls f(rows, vlo, n, live): piece k is
//                            positions [vlo, vlo + n) of `rows`, contiguous
//                            from rows.row(vlo), valid where live(i).
// BigThenTail below is the paged and contiguous forms'; sink::Ring
// (csrc/sink_attention.cu) the sink ring's.
template <bool Paged>
struct BigRows;
template <>
struct BigRows<true> {
  static __device__ PagedRows make(const Args& a, int b, int h) {
    const size_t lp = (size_t)a.layer * a.rows * a.Hkv * a.ps;
    return PagedRows{a.big_k + lp * a.D, a.big_v + lp * a.D, a.big_ks + lp,
                     a.big_vs + lp, a.table + (size_t)b * a.tw, a.Hkv, h,
                     a.ps};
  }
};
template <>
struct BigRows<false> {
  static __device__ DenseRows make(const Args& a, int b, int h) {
    const size_t r0 = (((size_t)a.layer * a.B + b) * a.Hkv + h) * a.rows;
    return DenseRows{a.big_k + r0 * a.D, a.big_v + r0 * a.D, a.big_ks + r0,
                     a.big_vs + r0};
  }
};

template <bool Paged>
struct BigThenTail : Args {
  using Geo = Geometry;
  static constexpr bool kTwoQueries = false;
  __device__ Geo geo(int b) const { return Geometry(*this, b, Paged); }
  __device__ int query(const Geo&, int) const { return 0; }
  __device__ const void* query_ptr(int) const { return q; }
  template <class F>
  __device__ void visit_piece(const Geo& g, int b, int h, int k,
                              F&& f) const {
    int vlo, n;
    g.piece(k, vlo, n);
    if (k >= g.nbp)
      f(tail_rows(*this, b, h), vlo, n, AllLive());
    else
      f(BigRows<Paged>::make(*this, b, h), vlo, n, AllLive());
  }
};

// ---------------------------------------------------------------------------
// One launch: a thread-block cluster a (row, kv head)
// ---------------------------------------------------------------------------
//
// A cluster of kCluster blocks serves one (row, kv head); the row's pieces
// of tiles (Geometry::piece: a page, the paged tail, or up to kPiece
// positions of a contiguous tile or tail; sink::Ring's: up to 64 positions
// of a ring tile, the sinks, the tail; never across a tile's edge), read
// from the per-row vectors at run time, are dealt to its blocks in turn
// (piece k to block k % kCluster), so one fixed grid of
// (kCluster, Hkv, B) blocks serves every row length, and a block with no
// piece only takes part in the exchanges. Pieces narrower than the TPU
// kernel's 256-wide tiles keep all seven blocks at work on a short row
// (T = 640: 11 pieces of 64, against 4 tiles).
//
// 1. Scores. Each block brings its pieces' K rows (a piece's rows are
//    contiguous: part of one page of one head, of the tail or of a stack)
//    by bulk copy and their scales by 4-byte cp.async into a ring of
//    stages, every stage in flight at once; its V rows follow into the
//    stages its K rows free, so they arrive while the scores are computed
//    and exchanged. The scores of the G query heads stay in shared memory,
//    and so does each piece's max.
// 2. Exchange. Behind a cluster barrier every block reads the piece maxima
//    of the whole row from the blocks' shared memory (distributed shared
//    memory), takes their running maxima in order, and gives each piece the
//    running max at the end of its tile: the max of the tile's pieces
//    after the tiles before it, which is the running max the sequential
//    walk holds at that tile, exactly.
// 3. Sums. Each block forms, for its pieces, p = exp(s - m_j) under the
//    max of the piece's tile j, the sum of p, bf16(p * vs) and its P V (the
//    warps take positions in turn, each lane 4 columns: a warp a position
//    at D = 128, half a warp at D = 64), each piece's terms scaled by
//    exp(m_j - m_last) into the block's accumulators.
// 4. Reduce. Behind a second cluster barrier each block adds up its share
//    of the output elements over the cluster's blocks, normalises and
//    writes it; a third barrier keeps every block's shared memory alive
//    until the others have read it.
//
// Where a block's scores of every piece it holds do not fit its shared
// memory (stacks of ~70,000 positions and more), the layout keeps one
// piece's scores only and the block reads each piece's K twice: once for
// the maxima, once more just before its sums, where the scores are formed
// again, bit for bit, by the same code. This costs one more read of the K
// bytes (half the call's bytes); the results are the same.
//
// The block that owns the piece holding tail slot `step` (block 0 if no
// piece holds it) quantizes the step's K/V first and writes slot `step`; it
// patches its staged copy of that slot from shared memory, since the bulk
// copy of the piece may read the slot before or after the write. Scores,
// maxima, p and bf16(p * vs) are bit for bit those of the walk; only the
// order of the f32 sums of P V, l and the combine differs. No scratch in
// device memory.
//
// The query's bf16-rounded slices sit in registers (qr) while a piece is
// scored, 4 heads at a time. A policy with a second query (the sink ring's
// q_sink, for its sink piece), the instance that reads K twice and the
// instances of 8 heads have the queries staged in shared memory, rounded,
// at the start: the first loads qr from there whenever the next piece
// takes the other query, so no second register set is held; the second
// loads qr before each piece it scores, so that no query register is held
// through the sums; the third loads each group of 4 heads before it scores
// a piece with them, K read from the stage once a group.

// 4 int8 (one word, element 0 in the low byte) as exact floats, without
// conversion instructions: each byte, biased to b + 128, becomes the low
// mantissa byte of 2^23; subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* o) {
  const uint32_t u = w ^ 0x80808080u;
  o[0] = __uint_as_float(hopper::prmt(u, 0x4B000000u, 0x7650)) - 8388736.f;
  o[1] = __uint_as_float(hopper::prmt(u, 0x4B000000u, 0x7651)) - 8388736.f;
  o[2] = __uint_as_float(hopper::prmt(u, 0x4B000000u, 0x7652)) - 8388736.f;
  o[3] = __uint_as_float(hopper::prmt(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// Blocks a (row, kv head), and blocks an SM. A cluster is placed whole
// inside one GPC, so how many fit at once depends on the GPCs' sizes:
// seven, not the portable maximum of eight, lets a batch of 8 rows x 8 kv
// heads (64 clusters) be resident at once at four blocks an SM (128
// registers a thread: no spills), and an SM then carries at most 4 blocks
// against 3.4 on average (`dli_fused_cluster_plan` reports how many fit;
// PERF.md).
constexpr int kCluster = 7;
constexpr int kClusterBlocksPerSM = 4;
constexpr int kRingBudget = 32 * 1024;  // stage bytes a block aims at
constexpr int kSmemLimit = 232448;      // dynamic shared memory of a block

__host__ __device__ __forceinline__ int cluster_align(int x) {
  return (x + 127) & ~127;
}

// Whether the queries are staged in shared memory (see above): a second
// query, K read twice, or more than 4 heads.
__host__ __device__ constexpr bool staged_queries(bool two_q, bool keep,
                                                  int G) {
  return two_q || !keep || G > 4;
}

// Dynamic shared memory of one block, the same in every block of a launch,
// for M pieces a block, NP pieces a row, W rows a piece, G (the instance's
// Gp) heads and head_dim D: a ring of `stages` stages (W rows of D int8,
// then W f32 scales), the scores [M][G][W] (or [1][G][W] where `keep` is
// false), bf16(p * vs) [W][G], the piece maxima [M][G] (and the warps'
// [M][kWarps][G]) and sizes [M], the row's maxima [NP][G], the step's K/V
// and scales, the block's sums of l [G], the queries' rounded values
// [1|2][G][D] (where they are staged), the sources of its loads (rows,
// scales) [loads][2], the ring's barriers. The warps' P V partials,
// [kWarps][G][D], then the block's P V [G][D] in their first slot, reuse
// the ring when it is large enough.
struct ClusterSmem {
  int stage_bytes, stages, scores, pw, tmax, tmw, tn, pm, fresh, den, qs,
      srcs, red, bars, bytes;
  bool keep;  // the scores of every piece kept from phase 1 to the sums
  __host__ __device__ ClusterSmem(int W, int M, int NP, int G, int D,
                                  bool two_q, bool keep_all)
      : keep(keep_all) {
    const int loads = (keep ? 2 : 3) * M;
    stage_bytes = cluster_align(W * D + W * 4);
    stages = kRingBudget / stage_bytes;
    if (stages < 2) stages = 2;
    if (stages > loads) stages = loads;
    int off = stages * stage_bytes;
    scores = off;
    off += (keep ? M : 1) * G * W * 4;
    pw = off;
    off += G * W * 4;
    tmax = off;
    off += M * G * 4;
    tmw = off;
    off += M * kWarps * G * 4;
    tn = off;
    off += M * 4;
    pm = off;
    off += NP * G * 4;
    fresh = cluster_align(off);
    off = fresh + 2 * D + 16;
    den = cluster_align(off);
    off = den + G * 4;
    qs = cluster_align(off);
    off = qs + (two_q ? 2 : staged_queries(two_q, keep, G) ? 1 : 0) * G * D * 4;
    srcs = (off + 7) & ~7;
    off = srcs + loads * 16;
    const int red_bytes = kWarps * G * D * 4;
    if (stages * stage_bytes >= red_bytes) {
      red = 0;
    } else {
      red = cluster_align(off);
      off = red + red_bytes;
    }
    bars = (off + 7) & ~7;
    bytes = bars + stages * 8;
  }
};

// The layout of a launch: every piece's scores kept where that fits a
// block, else one piece's (K read twice).
__host__ __device__ inline ClusterSmem cluster_layout(int W, int M, int NP,
                                                      int G, int D,
                                                      bool two_q) {
  const ClusterSmem keep(W, M, NP, G, D, two_q, true);
  return keep.bytes <= kSmemLimit
             ? keep
             : ClusterSmem(W, M, NP, G, D, two_q, false);
}

// The butterfly that sums each head's dot product over the LPP lanes of a
// position (xor LPP / 2, ..., 1), as a reduce-scatter while more than one
// head is left: each step a lane adds its partner's value of the heads it
// keeps, every sum in the butterfly's order (a + b on one lane is b + a on
// the other), so each value is bit for bit the full butterfly's. v holds
// CNT heads; at the end v[0] holds head butterfly_head<CNT, O>(sub).
template <int CNT, int O>
__device__ __forceinline__ void head_butterfly(float* v, int sub) {
  if constexpr (O > 0) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool hi = (sub & O) != 0;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = hi ? v[j] : v[H + j];
        const float keep = hi ? v[H + j] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      head_butterfly<H, O / 2>(v, sub);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      head_butterfly<1, O / 2>(v, sub);
    }
  }
}

// The head of the CNT that head_butterfly<CNT, O> leaves on lane `sub`:
// the upper half at each step whose bit of sub is set.
template <int CNT, int O>
__device__ __forceinline__ int butterfly_head(int sub) {
  int head = 0;
#pragma unroll
  for (int o = O, c = CNT / 2; c > 0 && o > 0; o >>= 1, c >>= 1)
    if (sub & o) head += c;
  return head;
}

// Keep: the layout keeps every piece's scores (the instance a launch takes
// follows cluster_layout). Two instances, so that the one that keeps them
// holds no query registers past the scores. L, the launch's layout, comes
// as a parameter (its offsets read from the constant bank, not held in
// registers). Gp heads (1, 4 or 8) of which a.G are real; D the head_dim.
template <typename T, class P, int Gp, bool Keep, int D>
__global__ void __launch_bounds__(kThreads, kClusterBlocksPerSM)
    fused_cluster_kernel(P a, const ClusterSmem L) {
  static_assert(Gp == 1 || Gp == 4 || Gp == 8, "the instances of the group");
  static_assert(D == 64 || D == 128, "the instances of head_dim");
  constexpr int kLPP = D / kEPL;          // lanes a position
  constexpr int kPPW = 32 / kLPP;         // positions a warp step
  constexpr int HG = Gp < 4 ? Gp : 4;     // heads scored at a time
  constexpr int kGroups = Gp / HG;
  constexpr int kPVLanes = D / 4;         // lanes a position in P V
  constexpr int kPVPos = 32 / kPVLanes;   // positions a warp in P V
  extern __shared__ __align__(128) uint8_t csm[];
  __shared__ float red_s[kWarps];
  constexpr bool keep = Keep;
  const int r = hopper::cluster_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int grp = lane / kLPP;
  const int sub = lane % kLPP;
  const int G = a.G;
  // The step's K/V element of this thread, loaded before the memory
  // system fills with the ring's copies (only the quantizing block uses
  // them).
  const size_t bh = (size_t)b * a.Hkv + h;
  const float kx = t < D ? to_f(static_cast<const T*>(a.k_new)[bh * D + t]) : 0.f;
  const float vx = t < D ? to_f(static_cast<const T*>(a.v_new)[bh * D + t]) : 0.f;
  const auto geo = a.geo(b);
  const int npieces = geo.npieces;
  // This block's pieces: k = r + u * C, u < mine.
  constexpr int C = kCluster;
  const int mine = npieces > r ? (npieces - r + C - 1) / C : 0;
  // Loads: K of each piece, then V of each (keep), or K of each, then K
  // and V of each in turn (the scores formed again before the sums).
  const int loads = (keep ? 2 : 3) * mine;
  float* scores = reinterpret_cast<float*>(csm + L.scores);   // [M|1][Gp][W]
  float* pw = reinterpret_cast<float*>(csm + L.pw);           // [W][Gp]
  float* tmax = reinterpret_cast<float*>(csm + L.tmax);       // [M][Gp]
  float* tmw = reinterpret_cast<float*>(csm + L.tmw);         // [M][kWarps][Gp]
  int* tn = reinterpret_cast<int*>(csm + L.tn);               // [M]
  float* pm = reinterpret_cast<float*>(csm + L.pm);           // [NP][Gp]
  int8_t* fresh_k = reinterpret_cast<int8_t*>(csm + L.fresh);
  int8_t* fresh_v = fresh_k + D;
  float* fresh_s = reinterpret_cast<float*>(fresh_v + D);     // ks, vs
  float* den_s = reinterpret_cast<float*>(csm + L.den);       // [Gp]
  float* red = reinterpret_cast<float*>(csm + L.red);         // [kWarps][Gp][D]
  uint64_t* srcs = reinterpret_cast<uint64_t*>(csm + L.srcs);  // [loads][2]
  uint64_t* full = reinterpret_cast<uint64_t*>(csm + L.bars);
  const int R = L.stages;

  if (t == 0) {
    // The TMA-side arrival with its bytes, and one from each lane of warp
    // 0 once its scale copies have landed.
    for (int s = 0; s < R; ++s) hopper::mbar_init(&full[s], 1 + 32);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // Load idx as (piece u of this block, V or K).
  auto load_of = [&](int idx, int& u, bool& is_v) {
    if (idx < mine) {
      u = idx;
      is_v = false;
    } else if (keep) {
      u = idx - mine;
      is_v = true;
    } else {
      u = (idx - mine) >> 1;
      is_v = (idx - mine) & 1;
    }
  };
  auto stage = [&](int idx) { return csm + (idx % R) * L.stage_bytes; };
  // Load idx (warp 0): its rows and their scales, from the sources the
  // prologue found.
  auto issue = [&](int idx) {
    int u;
    bool is_v;
    load_of(idx, u, is_v);
    const int n = tn[u];
    uint8_t* st = stage(idx);
    float* sc = reinterpret_cast<float*>(st + a.W * D);
    const float* ssrc = reinterpret_cast<const float*>(srcs[2 * idx + 1]);
    uint64_t* bar = &full[idx % R];
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(bar, n * D);
      hopper::bulk_load(st, reinterpret_cast<const void*>(srcs[2 * idx]),
                        n * D, bar);
    }
    for (int i = lane; i < n; i += 32) hopper::cp_async_4(sc + i, ssrc + i, true);
    hopper::cp_async_arrive_noinc(bar);
  };
  auto wait_load = [&](int idx) { hopper::mbar_wait(&full[idx % R], (idx / R) & 1); };

  if (warp == 0) {
    // The lanes find the loads' sources together (the page table's reads
    // overlap), then the ring's first stages go out.
    for (int idx = lane; idx < loads; idx += 32) {
      int u;
      bool is_v;
      load_of(idx, u, is_v);
      a.visit_piece(geo, b, h, r + u * C,
                    [&](const auto& rows, int vlo, int n, const auto&) {
                      const size_t r0 = rows.row(vlo);
                      srcs[2 * idx] = reinterpret_cast<uint64_t>(
                          (is_v ? rows.v : rows.k) + r0 * D);
                      srcs[2 * idx + 1] = reinterpret_cast<uint64_t>(
                          (is_v ? rows.vs : rows.ks) + r0);
                      if (idx < mine) tn[u] = n;
                    });
    }
    __syncwarp();
    for (int idx = 0; idx < min(R, loads); ++idx) issue(idx);
  }

  // The step's K/V, quantized as _quantize_kv does, into tail slot `step`
  // (one block alone writes it) and into shared memory: by the block of
  // the piece that holds the slot just before it scores that piece, or by
  // block 0 at the end of the scores when no piece holds it. Threads past
  // D hold zeros, which leave the maxima as they are.
  const int step = *a.step;
  const int sk = geo.step_piece(step);
  auto quantize = [&]() {
    const float ksc = fmaxf(block_max(fabsf(kx), red_s), 1e-8f) / 127.f;
    const float vsc = fmaxf(block_max(fabsf(vx), red_s), 1e-8f) / 127.f;
    const int8_t kq = (int8_t)fminf(fmaxf(rintf(kx / ksc), -127.f), 127.f);
    const int8_t vq = (int8_t)fminf(fmaxf(rintf(vx / vsc), -127.f), 127.f);
    const size_t trow = ((size_t)a.layer * a.B + b) * a.Hkv + h;
    if (t < D) {
      a.tail_k[(trow * a.KT + step) * D + t] = kq;
      a.tail_v[(trow * a.KT + step) * D + t] = vq;
      fresh_k[t] = kq;
      fresh_v[t] = vq;
    }
    if (t == 0) {
      a.tail_ks[trow * a.KT + step] = ksc;
      a.tail_vs[trow * a.KT + step] = vsc;
      fresh_s[0] = ksc;
      fresh_s[1] = vsc;
    }
    __syncthreads();
  };
  // Puts the step's row (K or V) into the staged piece that holds slot
  // `step`; the next bulk copy into the stage comes after a proxy fence
  // and a barrier.
  auto patch = [&](int k, int vlo, int n, uint8_t* st, bool is_v) {
    const int i = step - vlo;
    if (k != sk || i < 0 || i >= n) return;
    if (t < D)
      st[i * D + t] = static_cast<uint8_t>((is_v ? fresh_v : fresh_k)[t]);
    if (t == 0)
      reinterpret_cast<float*>(st + a.W * D)[i] = fresh_s[is_v ? 1 : 0];
    hopper::fence_proxy_async();
    __syncthreads();
  };

  // The query heads' slices, rounded to bf16 as the TPU kernel's product
  // does, in the lane layout of the scores: lane `sub` of a position holds
  // elements [16 sub, 16 sub + 16) of each head. Staged: the queries go to
  // shared memory first ([nq][Gp][D], heads past G zero) and qr is loaded
  // from there, query `held`, group of heads `held_group`.
  constexpr bool staged = staged_queries(P::kTwoQueries, keep, Gp);
  float qr[HG][kEPL];
  int held = -1, held_group = -1;
  if constexpr (staged) {
    float* qs = reinterpret_cast<float*>(csm + L.qs);
#pragma unroll
    for (int w = 0; w < (P::kTwoQueries ? 2 : 1); ++w) {
      const T* qsrc = static_cast<const T*>(a.query_ptr(w));
      for (int e = t; e < Gp * D; e += kThreads) {
        const int g = e / D;
        qs[w * Gp * D + e] =
            g < G ? bf16_round(to_f(qsrc[(bh * G + g) * D + e % D])) : 0.f;
      }
    }
    __syncthreads();
  }
  auto load_query = [&](int w, int hg) {
    if constexpr (staged) {
      const float* qs = reinterpret_cast<const float*>(csm + L.qs);
#pragma unroll
      for (int j = 0; j < HG; ++j)
#pragma unroll
        for (int e = 0; e < kEPL; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              qs + (w * Gp + hg * HG + j) * D + sub * kEPL + e);
          qr[j][e] = v.x; qr[j][e + 1] = v.y; qr[j][e + 2] = v.z;
          qr[j][e + 3] = v.w;
        }
    } else {
      const T* qsrc = static_cast<const T*>(a.query_ptr(w));
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        const int g = hg * HG + j;
        const T* qp = qsrc + (bh * G + g) * D + sub * kEPL;
#pragma unroll
        for (int e = 0; e < kEPL; ++e)
          qr[j][e] = g < G ? bf16_round(to_f(qp[e])) : 0.f;
      }
    }
    held = w;
    held_group = hg;
  };
  if constexpr (!staged) load_query(0, 0);
  // Scores of piece k, staged at st, for the Gp query heads into s_u
  // [Gp][W], HG heads at a time (K read from the stage once a group); with
  // `maxima`, the warps' maxima of them into tmw's slot u.
  auto score = [&](int k, uint8_t* st, float* s_u, bool maxima, int u) {
    a.visit_piece(geo, b, h, k, [&](const auto&, int vlo, int n,
                                    const auto& live) {
      patch(k, vlo, n, st, false);
      const float* sc = reinterpret_cast<const float*>(st + a.W * D);
      // Head `head` of a group ends on the lanes whose bits below
      // kLPP / HG are 0 (the writers).
      const int head = butterfly_head<HG, kLPP / 2>(sub);
      const bool writer = (sub & (kLPP / HG - 1)) == 0;
#pragma unroll
      for (int hg = 0; hg < kGroups; ++hg) {
        if constexpr (staged) {
          const int w = a.query(geo, k);
          if (!keep || w != held || hg != held_group) load_query(w, hg);
        }
        // The max of the scores this lane writes: one head of the group.
        float tm = kNegInf;
        for (int i0 = warp * kPPW; i0 < n; i0 += kWarps * kPPW) {
          const int i = i0 + grp;
          const bool in = i < n;
          const bool lv = in && live(i);
          float kk[kEPL];
          float ksc = 0.f;
          if (lv) {
            const uint4 w = reinterpret_cast<const uint4*>(st + i * D)[sub];
            i8x4_to_f32(w.x, kk);
            i8x4_to_f32(w.y, kk + 4);
            i8x4_to_f32(w.z, kk + 8);
            i8x4_to_f32(w.w, kk + 12);
            ksc = sc[i];
          } else {
#pragma unroll
            for (int e = 0; e < kEPL; ++e) kk[e] = 0.f;
          }
          float dot[HG];
#pragma unroll
          for (int j = 0; j < HG; ++j) {
            dot[j] = 0.f;
#pragma unroll
            for (int e = 0; e < kEPL; ++e) dot[j] += qr[j][e] * kk[e];
          }
          head_butterfly<HG, kLPP / 2>(dot, sub);
          if (in && writer) {
            const float sv = lv ? dot[0] * ksc * a.scale : kNegInf;
            s_u[(hg * HG + head) * a.W + i] = sv;
            tm = fmaxf(tm, sv);
          }
        }
        if (maxima) {
          // Over the warp's positions (lanes kLPP apart hold the same
          // head), then one value a (warp, head) for the piece's max below.
#pragma unroll
          for (int o = kLPP; o < 32; o <<= 1)
            tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, o));
          if (grp == 0 && writer)
            tmw[((size_t)u * kWarps + warp) * Gp + hg * HG + head] = tm;
        }
      }
    });
  };

  // 1. Scores of each piece and the warps' maxima.
  for (int u = 0; u < mine; ++u) {
    const int k = r + u * C;
    if (k == sk) quantize();
    wait_load(u);
    score(k, stage(u), scores + (keep ? (size_t)u * Gp * a.W : 0), true, u);
    __syncthreads();  // the stage is read
    if (warp == 0 && u + R < loads) issue(u + R);
  }
  if (sk < 0 && r == 0) quantize();
  // Each piece's max over the warps.
  for (int e = t; e < mine * Gp; e += kThreads) {
    const int u = e / Gp, g = e % Gp;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, tmw[((size_t)u * kWarps + w) * Gp + g]);
    tmax[e] = m;
  }

  // 2. The row's piece maxima from the cluster; their running maxima; each
  //    piece then takes the running max at the end of its tile.
  hopper::cluster_sync();
  for (int e = t; e < npieces * Gp; e += kThreads) {
    const int k = e / Gp, g = e % Gp;
    pm[e] = hopper::cluster_load(tmax + (k / C) * Gp + g, k % C);
  }
  __syncthreads();
  for (int g = warp; g < Gp; g += kWarps) {
    // Warp w, heads w, w + 4: the running maxima by a max-scan over the
    // lanes, 32 pieces at a time; then each piece takes the value of its
    // tile's last piece (which keeps its own, so the pass needs no second
    // buffer).
    float carry = kNegInf;
    for (int k0 = 0; k0 < npieces; k0 += 32) {
      const int k = k0 + lane;
      float m = k < npieces ? pm[k * Gp + g] : kNegInf;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, m, o);
        if (lane >= o) m = fmaxf(m, y);
      }
      m = fmaxf(m, carry);
      if (k < npieces) pm[k * Gp + g] = m;
      carry = __shfl_sync(0xffffffffu, m, 31);
    }
    __syncwarp();
    for (int k = lane; k < npieces; k += 32)
      pm[k * Gp + g] = pm[geo.tile_last_piece(k) * Gp + g];
  }
  __syncthreads();

  // 3. Sums of each piece under the running max at its tile. A lane takes
  //    4 columns of V at its position of the warp's kPVPos.
  const int pv_pos = lane / kPVLanes;
  const int pv_col = lane % kPVLanes;
  float m_last[Gp], acc[Gp][4], den[Gp];
#pragma unroll
  for (int g = 0; g < Gp; ++g) {
    m_last[g] = npieces > 0 ? pm[(npieces - 1) * Gp + g] : kNegInf;
    den[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  }
  for (int u = 0; u < mine; ++u) {
    const int k = r + u * C;
    int idx = keep ? mine + u : mine + 2 * u;
    const float* s_u = scores + (keep ? (size_t)u * Gp * a.W : 0);
    if constexpr (!keep) {
      // The piece's scores again, from a second copy of its K.
      wait_load(idx);
      score(k, stage(idx), scores, false, 0);
      __syncthreads();  // the stage is read, the scores written
      if (warp == 0 && idx + R < loads) issue(idx + R);
      ++idx;
    }
    wait_load(idx);
    uint8_t* st = stage(idx);
    a.visit_piece(geo, b, h, k, [&](const auto&, int vlo, int n,
                                    const auto& live) {
      patch(k, vlo, n, st, true);
      const float* vsc = reinterpret_cast<const float*>(st + a.W * D);
      float wj[Gp];
#pragma unroll
      for (int g = 0; g < Gp; ++g) {
        const float mj = pm[k * Gp + g];
        wj[g] = expf(mj - m_last[g]);
        float lsum = 0.f;
        for (int i = t; i < n; i += kThreads) {
          const float p = live(i) ? expf(s_u[g * a.W + i] - mj) : 0.f;
          lsum += p;
          pw[i * Gp + g] = bf16_round(p * vsc[i]);
        }
        den[g] += wj[g] * lsum;
      }
      __syncthreads();  // pw
      // P V, HG heads at a time (V read from the stage once a group).
#pragma unroll
      for (int hg = 0; hg < kGroups; ++hg) {
        float pv[HG][4];
#pragma unroll
        for (int j = 0; j < HG; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[j][c] = 0.f;
        for (int i = warp * kPVPos + pv_pos; i < n; i += kWarps * kPVPos) {
          float v[4];
          i8x4_to_f32(reinterpret_cast<const uint32_t*>(st + i * D)[pv_col],
                      v);
          float p[HG];
          if constexpr (HG == 4) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(pw + i * Gp + hg * HG);
            p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
          } else {
#pragma unroll
            for (int j = 0; j < HG; ++j) p[j] = pw[i * Gp + hg * HG + j];
          }
#pragma unroll
          for (int j = 0; j < HG; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) pv[j][c] += p[j] * v[c];
        }
#pragma unroll
        for (int j = 0; j < HG; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[hg * HG + j][c] += wj[hg * HG + j] * pv[j][c];
      }
    });
    __syncthreads();  // the stage, pw and the scores are read
    if (warp == 0 && idx + R < loads) issue(idx + R);
  }

  // The block's sums: P V over its warps (red, over the drained ring; at
  // D = 64 a warp's two half-warps first), l over its threads (a warp's
  // sum into tmw, free since the maxima).
#pragma unroll
  for (int g = 0; g < Gp; ++g) {
#pragma unroll
    for (int o = kPVLanes; o < 32; o <<= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], o);
    if (pv_pos == 0)
      *reinterpret_cast<float4*>(red + ((size_t)warp * Gp + g) * D +
                                 4 * pv_col) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      den[g] += __shfl_xor_sync(0xffffffffu, den[g], o);
    if (lane == 0) tmw[warp * Gp + g] = den[g];
  }
  __syncthreads();
  if (t < D) {
#pragma unroll
    for (int g = 0; g < Gp; ++g) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[((size_t)w * Gp + g) * D + t];
      red[(size_t)g * D + t] = s;  // slot of warp 0: only this thread reads it
    }
  }
  if (t < Gp) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += tmw[w * Gp + t];
    den_s[t] = l;
  }

  // 4. The cluster's sums of this block's share of the outputs (the G real
  //    heads).
  hopper::cluster_sync();
  const int share = (G * D + C - 1) / C;
  const int end = min((r + 1) * share, G * D);
  for (int e = r * share + t; e < end; e += kThreads) {
    const int g = e / D;
    float num = 0.f, l = 0.f;
    for (int k = 0; k < C; ++k) {
      num += hopper::cluster_load(red + e, k);
      l += hopper::cluster_load(den_s + g, k);
    }
    // A row with nothing to attend gives zeros.
    store(static_cast<T*>(a.out) + bh * G * D + e, num / fmaxf(l, 1e-20f));
  }
  hopper::cluster_sync();
}

// The group's instance: 1, 4 (G = 2..4) or 8 (G = 5..8) heads.
inline int padded_group(int G) { return G <= 1 ? 1 : G <= 4 ? 4 : 8; }

// The cluster launch of fused_cluster_kernel<T, P, Gp, keep, D> for `a`: M
// pieces a block at most, the layout and the shared memory it needs set on
// the kernel.
// `clusters`, when not null, receives how many such clusters the card holds
// at once instead of a launch.
template <typename T, class P, int Gp, int D>
int launch_cluster(const P& a, cudaStream_t s, int* clusters = nullptr) {
  constexpr int C = kCluster;
  const int M = (a.NP + C - 1) / C;
  const ClusterSmem L = cluster_layout(a.W, M, a.NP, Gp, D, P::kTwoQueries);
  if (L.bytes > kSmemLimit) return -1;
  auto* kernel = L.keep ? fused_cluster_kernel<T, P, Gp, true, D>
                        : fused_cluster_kernel<T, P, Gp, false, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.Hkv, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        clusters, reinterpret_cast<const void*>(kernel), &cfg));
  err = cudaLaunchKernelEx(&cfg, kernel, a, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instances: G in 1..8 query heads a kv head (a.G), head_dim a.D in
// {64, 128}, q in bf16 (dtype 0) or f32 (1). -1 for any other.
template <class P>
int dispatch_cluster(const P& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.G < 1 || a.G > 8 || (a.D != 64 && a.D != 128) ||
      (dtype != 0 && dtype != 1))
    return -1;
  const int gp = padded_group(a.G);
  auto go = [&](auto t_tag, auto d_tag) -> int {
    using T = decltype(t_tag);
    constexpr int D = decltype(d_tag)::value;
    if (gp == 1) return launch_cluster<T, P, 1, D>(a, s);
    if (gp == 4) return launch_cluster<T, P, 4, D>(a, s);
    return launch_cluster<T, P, 8, D>(a, s);
  };
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (dtype == 0)
    return a.D == 64 ? go(__nv_bfloat16(), D64()) : go(__nv_bfloat16(), D128());
  return a.D == 64 ? go(float(), D64()) : go(float(), D128());
}

// The cluster launch's plan for pieces of W rows, NP a row, G query heads a
// kv head at head_dim D (bf16 queries) under the policy P: out[0] blocks a
// cluster, out[1] pieces a block can hold (M), out[2] ring stages, out[3]
// bytes a stage, out[4] dynamic shared memory bytes a block, out[5] the
// clusters the card holds at once, out[6] 1 if every piece's scores are
// kept (0: K is read twice). Returns 0, -1 outside G in 1..8, D in
// {64, 128} or past a block's shared memory, or the CUDA error of the
// occupancy query.
template <class P>
int cluster_plan(int NP, int W, int G, int D, long long* out) {
  if (G < 1 || G > 8 || (D != 64 && D != 128) || NP < 1 || W < 1) return -1;
  const int gp = padded_group(G);
  const int M = (NP + kCluster - 1) / kCluster;
  const ClusterSmem L = cluster_layout(W, M, NP, gp, D, P::kTwoQueries);
  P a;
  a.NP = NP;
  a.W = W;
  a.B = 1;
  a.Hkv = 1;
  a.G = G;
  a.D = D;
  int clusters = 0;
  auto query = [&](auto d_tag) -> int {
    constexpr int Dc = decltype(d_tag)::value;
    if (gp == 1)
      return launch_cluster<__nv_bfloat16, P, 1, Dc>(a, nullptr, &clusters);
    if (gp == 4)
      return launch_cluster<__nv_bfloat16, P, 4, Dc>(a, nullptr, &clusters);
    return launch_cluster<__nv_bfloat16, P, 8, Dc>(a, nullptr, &clusters);
  };
  const int err = D == 64 ? query(std::integral_constant<int, 64>())
                          : query(std::integral_constant<int, 128>());
  if (err != 0) return err;
  out[0] = kCluster;
  out[1] = M;
  out[2] = L.stages;
  out[3] = L.stage_bytes;
  out[4] = L.bytes;
  out[5] = clusters;
  out[6] = L.keep ? 1 : 0;
  return 0;
}

// dtype: 0 = bfloat16, 1 = float32 (q, k_new, v_new, out); a.G and a.D the
// group and head_dim. Returns cudaGetLastError() after the launch, or -1
// for a shape the kernel is not built for (D in {64, 128}, G in 1..8,
// tiles and tail of 1..256, pieces inside one tile each, NP and W that
// hold every row's pieces, shared memory within a block's 227 KB).
template <bool Paged>
int launch(const Args& a, int dtype, void* stream) {
  if (a.B <= 0) return 0;
  const int tw = Paged ? a.ps : a.tile_w;
  const int cap = Paged ? a.tw * a.ps : a.rows;
  if (a.KT < 1 || a.KT > kMaxTile || tw < 1 || tw > kMaxTile) return -1;
  const int pw = Paged ? a.ps : a.piece_w;
  const int tpw = Paged ? a.KT : a.piece_w;
  if (pw < 1 || (tw % pw != 0 && tw < cap)) return -1;
  if (a.W < pw || a.W < (tpw < a.KT ? tpw : a.KT) ||
      a.NP < (cap + pw - 1) / pw + (a.KT + tpw - 1) / tpw)
    return -1;
  BigThenTail<Paged> p;
  static_cast<Args&>(p) = a;
  return dispatch_cluster(p, dtype, stream);
}

}  // namespace fused
