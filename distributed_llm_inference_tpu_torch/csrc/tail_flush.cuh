// The fused window's int8 tail flushed into the cache's planes, for Hopper
// (sm_90a): one kernel for the three TPU flushes, each a destination policy
// of `tail_flush_kernel`:
//
// * `paged_tail_flush` (distributed_llm_inference_tpu/ops/
//   paged_attention.py), into the page pool through the page table
//   (PagedDest, csrc/paged_attention.cu);
// * `fused_tail_flush` (distributed_llm_inference_tpu/ops/
//   quant_attention.py), into the dense cache's buffers at base_len
//   (DenseDest, csrc/quant_attention.cu);
// * `sink_tail_flush` (the same file), into the sink ring's planes mod
//   ring_slots (sink::RingDest, csrc/sink_attention.cu).
//
// The TPU kernels read-modify-write whole blocks of the destination through
// VMEM (pages; 32-slot value and 128-slot scale blocks), with clamped
// duplicate visits. Here each live tail word is copied once: a direct
// scatter, values and scales, the destination untouched elsewhere.
//
// Bound by bytes (each live tail byte read once and written once), and at
// the size of one window (L = 32, B = 8, KT = 16, Hkv = 8, D = 128: 8.6 MB
// each way) by latency: 3.35 TB/s needs ~3 MB in flight over a
// microsecond, and a thread that walks its (slot, head, 16 bytes) items in
// turn, each a chain of a load, an index computation and a store, keeps one
// item in flight. Here a block takes `hb` kv heads of one (row, layer),
// hb * KT tail rows that lie contiguous in the tail planes, WORDS 16-byte
// words of K and of V a thread a pass: each thread first issues the loads
// of all its words (every tail slot, unconditionally: the planes are in
// bounds and a window's rows are full but for rows that stopped) and of
// their rows' scales; only then does the block read its row's scalars
// through the policy (once, in the first pass), and each word's
// destination row, `dest.at(...)` (or -1: nothing written), orders its
// stores. `launch_tail_flush` takes WORDS = 2 and as many heads a block as
// one pass covers: at that size 1024 blocks of 45-54 registers a thread
// (the three policies), all resident at once, so every byte of the window
// is in flight before a store waits. One head a block with 4 words (2048
// blocks of 67-72 registers: two waves) and 8 heads with 8 words (256
// blocks of 124-128) were slower on an H100 (tools/torch_cluster_sweep.py
// --flush rebuilds each of the three sources with other FLUSH_WORDS and
// FLUSH_HEADS; PERF.md).
//
// A policy `Dest` provides `Row row(int b)`, the row's scalars read from
// device memory, and `long long at(const Row&, int l, int b, int h, int i)`:
// the destination plane row of tail slot i of (layer l, row b, kv head h),
// whose values are the D bytes at that row times D and whose scale is the
// float at that row, or -1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Words a thread and kv heads a block of launch_tail_flush (0: as many as
// one pass covers).
#ifndef FLUSH_WORDS
#define FLUSH_WORDS 2
#endif
#ifndef FLUSH_HEADS
#define FLUSH_HEADS 0
#endif

namespace flush {

constexpr int kThreads = 128;

template <int WORDS, class Dest>
__global__ void __launch_bounds__(kThreads) tail_flush_kernel(
    int8_t* __restrict__ dk, float* __restrict__ dks,
    int8_t* __restrict__ dv, float* __restrict__ dvs,  // destination planes
    const int8_t* __restrict__ tk, const float* __restrict__ tks,
    const int8_t* __restrict__ tv, const float* __restrict__ tvs,  // [L, B, Hkv, KT(, D)]
    int B, int Hkv, int KT, int D, int hb, Dest dest) {
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
  typename Dest::Row row;
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
    if (r0 == 0) row = dest.row(b);
#pragma unroll
    for (int u = 0; u < WORDS; ++u) {
      const int w = u * kThreads + t;
      if (w < words) {
        const int j = r0 + w / chunks;
        const long long dst = dest.at(row, l, b, h0 + j / KT, j % KT);
        if (dst >= 0) {
          reinterpret_cast<uint4*>(dk + dst * D)[w % chunks] = kw[u];
          reinterpret_cast<uint4*>(dv + dst * D)[w % chunks] = vw[u];
        }
      }
      if (w < rows && r0 + w < total) {
        const int j = r0 + w;
        const long long dst = dest.at(row, l, b, h0 + j / KT, j % KT);
        if (dst >= 0) {
          dks[dst] = ksw[u];
          dvs[dst] = vsw[u];
        }
      }
    }
  }
}

// kv heads a block of launch_tail_flush: FLUSH_HEADS, or as many as one
// pass of `words` 16-byte words of K and of V a thread covers (2 at
// KT = 16, D = 128), within [1, Hkv].
inline int heads_a_block(int Hkv, int KT, int D, int words) {
  const int per_head = KT * (D / 16);  // 16-byte words of a head's tail
  int hb = FLUSH_HEADS > 0 ? FLUSH_HEADS : words * kThreads / per_head;
  return hb < 1 ? 1 : hb > Hkv ? Hkv : hb;
}

// One launch of tail_flush_kernel<FLUSH_WORDS, Dest> over tail planes
// [L, B, Hkv, KT, D] int8 / [L, B, Hkv, KT] f32 into the destination
// planes d*, a block the heads_a_block kv heads of a (row, layer). D a
// multiple of 16 up to 16 * FLUSH_WORDS * kThreads, B and L up to 65535.
// Returns cudaGetLastError() after the launch, 0 with nothing to do, -1
// for a shape outside those.
template <class Dest>
int launch_tail_flush(void* dk, void* dks, void* dv, void* dvs,
                      const void* tk, const void* tks, const void* tv,
                      const void* tvs, int L, int B, int Hkv, int KT, int D,
                      const Dest& dest, void* stream) {
  if (L <= 0 || B <= 0 || KT <= 0) return 0;
  constexpr int kWords = FLUSH_WORDS;
  if (D < 16 || D % 16 != 0 || D / 16 > kWords * kThreads || Hkv < 1 ||
      B > 65535 || L > 65535)
    return -1;
  const int hb = heads_a_block(Hkv, KT, D, kWords);
  tail_flush_kernel<kWords, Dest><<<dim3((Hkv + hb - 1) / hb, B, L), kThreads,
                                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(dk), static_cast<float*>(dks),
      static_cast<int8_t*>(dv), static_cast<float*>(dvs),
      static_cast<const int8_t*>(tk), static_cast<const float*>(tks),
      static_cast<const int8_t*>(tv), static_cast<const float*>(tvs), B, Hkv,
      KT, D, hb, dest);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flush
