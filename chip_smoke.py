#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run it from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and `nvcc`; with no device it exits non-zero and
prints no result. It imports only the port (`distributed_llm_inference_tpu_torch`),
builds the CUDA kernels from `csrc/` into `build/` (one `nvcc` per source, all
started together), and runs four phases, one JSON line each (phases 3 and 4
one line per engine configuration or comparison):

1. device   - the card's name and power limit, as `nvidia-smi` gives them.
2. kernels  - every kernel against its plain PyTorch version on the card, in
              bf16 and f32, each case with its tolerance; every attention
              kernel (#1-#12) also at each of 1 to 8 query heads a kv head
              and head_dim 64 and 128 (`WIDTHS`, `width_cases`: edge rows,
              windows, pages of 16/48/128), and timed at Qwen2.5-7B's,
              Llama-3-70B's and Llama-3.2-1B's widths (`time_widths`);
              `paged_attention`,
              `ragged_paged_attention` and their int8-page forms
              `quantized_paged_attention`, `quantized_ragged_paged_attention`
              at Llama-3-8B shapes (32 query heads, 8 kv heads, head_dim 128,
              page size 64; once as MHA too), mixed lengths and an empty row;
              `paged_attention` and `quantized_paged_attention` also over
              pages of 16, 48 and 128 slots, the latter of 1 too (empty,
              one-slot and page-edge rows, windows of 37 and 300 slots,
              the query past the cache, MHA, B = 1), m and l beside the
              output;
              the ragged pair also over pools of page size 16, 48, 128 and 12
              in one B = 8 launch (a prompt, a chunk of 600 queries from
              position 1500, a decode token, an empty row, lengths off the
              kernel's 128-slot step), without a window and with windows of
              300 and 77 slots, and as MHA; besides, `nvcc -Xptxas -v`'s
              registers, shared memory and spills of the wgmma instances
              (the ragged kernels' and flash's), of the fused step's
              cluster kernel over the pool and over stacks, and of the
              decode cluster kernel over bf16 and int8 pages and the int8
              dense buffer, of the fused step's cluster kernel over the
              sink ring and of the three tail flushes (one kernel
              template, `csrc/tail_flush.cuh`), the ragged
              kernels' launch plans (C against
              the wrapper's `launch_plan`), the fused step's cluster plans
              (blocks a cluster, ring stages, shared memory; over stacks
              of T = 640 to 80000, over rings of TR = 1024 and 1056) and
              the host time a launch spends encoding its tensor maps;
              `int4_matmul` and `int4_matmul_stacked` at the model's
              projection shapes and odd ones, and at 1, 8, 64 and 256 rows
              of the projections and the head, each call repeated (the
              same bytes); for their bf16 kernel, `-Xptxas -v`, the count
              of I2F in its SASS (`cuobjdump -sass`, must be 0) and its
              split plans with their occupancy; the fused window's
              `quantized_paged_fused_attention` (the int8 pool in place, one
              launch of a cluster a (row, kv head)),
              `quantized_fused_decode_attention` (contiguous stacks, T = 640,
              and 2048 and 4096 with an empty and a tail-only row; one
              launch of the same cluster kernel, pieces of 64)
              over four steps of a window (B = 8, KT = 16; a row that stops,
              a sliding window, MHA; the former also over pages of 16, 48
              and 128 slots with an empty row, short rows and windows that
              start inside a page; the latter also over stacks of 80000,
              where the kernel forms the scores twice), their int8 tails
              EQUAL to the plain version's, and `paged_tail_flush`, the pool's bytes EQUAL
              (also KT = 48 over pages of 16, null table entries, rows
              past the table's width, empty tails); the
              dense caches' `flash_attention` (a buffer wider than the
              prompts, an empty row, a sliding window, MHA, strided K/V; the
              causal, window, sink, random and empty-row mask families at S
              and T multiples of 128 and below 128, rows that see nothing
              exact zeros; its first pass, the packed mask and tile
              classes, EQUAL to `mask_tiles`),
              `quantized_decode_attention` (rows of 0 to 2048 live
              positions; buffers of 40, 200 and 300 positions, not
              multiples of 64, whose last (row, head) runs to the buffer's
              end, windows, MHA, B = 8 and 1)
              and `fused_tail_flush` (KT = 16 and 48, edge windows; bytes
              EQUAL); the three flushes also over planes of other widths
              (`FLUSH_WIDTHS`: 3 kv heads, head_dim 64 and 256, KT = 80);
              the int8 sink ring's `sink_fused_decode_attention`
              over four steps of a window (B = 8, KT = 16; the sink phase,
              a partly filled, a just-full and wrapped rings, an evicted
              range across the ring's end, a row that stops; window 1024
              with 4 sinks and with none, GQA and MHA, and a span of 1050
              whose tiles are 96 wide; longer in-flight tails, KT = 80 and
              48, that evict whole pieces of the cluster kernel, one of
              them across the ring's end), its tails EQUAL, and
              `sink_tail_flush` (spans 1020 and 50, KT = 16 and 48,
              pointers near the ring's end, sink-bound heads, empty tails;
              bytes EQUAL, the padding slots untouched); last, #4's pinned
              case (seed 0, pages of 48, B = 8: the bf16 excursion that
              rounding p * vs to bf16 caused). The latent family
              (`phase_latent_kernels`, a line of its own): the four
              latent wrappers (#15a-d, `csrc/latent_attention.cu`)
              against their plain versions at 1, 8 and 16 query heads over
              lat_dim 576 and 80, f32 pools with bf16 and f32 queries and
              int8 pools, one B = 8 launch each of `LATENT_RAGGED` (a
              prompt, a 129-query chunk from 1500, an empty row, one slot,
              a page edge, a decode token) and of `LATENT_DECODE_LENS`,
              pages of 16 and 64, a window of 300 and none, m and l beside
              the output (bf16 q at 576 on the tensor-core instances,
              `latent_wgmma_kernel` for the ragged wrappers and
              `latent_decode_tc_kernel` for the decode ones, their counts
              checked case by case; the rest on the CUDA-core kernel); the
              instances' precision (`latent_precision`: unscaled q over
              latents of 8, every element within one bf16 step of the plain
              version's f32 output, a one-pass bf16 control that must miss
              it, ragged and decode, both pools); timed at DeepSeek-V2-Lite's
              shapes (decode at B = 8 and 1 over 2048 tokens, one launch a
              call, a 2048-token prompt) beside their plain versions, SDPA
              over the gathered latent and the bound (the bytes against
              the tensor-core passes', and the f32 CUDA-core one beside it;
              the CUDA-core kernel timed in the same call beside the
              tensor-core one); `-Xptxas -v` of every latent instance (0
              spills asserted for the tensor-core ones), each block's
              shared memory, the tensor-core launch plan against the
              wrapper's. Then the timed call's floor
              (an empty kernel timed as the kernels are), and, at the
              shapes of the main paths, each kernel's
              output against the plain version's on the same inputs and its
              time beside the plain version's, a library yardstick where one
              PyTorch call computes the same function
              (`scaled_dot_product_attention` on contiguous K/V, with the
              same mask for flash, which is also timed at its path's own
              shape, S = 2048 into a 4096-wide buffer; the three decode
              kernels `paged_attention`, `quantized_paged_attention` and
              `quantized_decode_attention` are also timed at B = 1, and
              their launches a call counted by the profiler; for the
              flushes four
              `index_put_` calls, and each flush's registers and spills and
              the timed call's floor beside its time;
              for the int4 matmuls there is none: a bf16 `torch.matmul` on
              the dequantized weight is shown as a yardstick of its own,
              per projection, at 8 rows and at 1 and 64; for
              the sink step none, as no one call scores with two queries)
              and the card's bound for the same work.
3. engine   - `InferenceEngine` at Llama-3-8B widths with random seeded
              weights, at the default `decode_steps=None`: K = 16 fused steps
              a window, each step replayed from a CUDA graph, ticks
              pipelined, admission overlapped. This slice's main path runs
              at full depth: int4 weights over the int8 sink ring (window
              1024, 4 sinks, as the JAX package's `sink_1k`: the window's
              step and flush kernels), on traffic of its own: ten greedy
              prompts of 1 to 2100 tokens (the longest two chunked at the
              ring span, the rings wrapping inside the windows, one stream
              of 37 tokens), 48 new tokens each. Then the dense main path
              at full depth: int4 weights over the int8 dense cache (the
              window on the cache's own buffers, its flush kernel, flash for
              the long batched prefill of the first admission wave); the
              paged pools' main paths at full depth, in bf16 and with int4
              weights over int8 pages; the model-dtype sink ring at 4
              layers (K = 1, with and without flash prefill); int8 weights
              over int8 pages at 4
              layers on short traffic (every row under 640 slots, so that the
              window gathers its stacks; W8A8 prefill); the dense caches'
              other paths at 8 layers (the int8 cache at `decode_steps=1`:
              `quantized_decode_attention`; the model-dtype cache with
              `use_pallas_attention`: flash prefill, K = 1; the model-dtype
              cache at K = 16, its tail in plain PyTorch, captured); the
              paths of slices 1 and 2 (`decode_steps=1`), cut to 4 layers.
              The traffic: 12 greedy prompts queue for 8 slots, a stream is
              cancelled as soon as it starts, a 3000-token greedy prompt
              arrives beside live decode (chunk-admitted on the paged pools,
              chunked synchronously on the dense caches), two sampled
              prompts ride along. Each configuration runs twice with the
              same seed and must repeat itself; the launch counters of its
              path's kernels are zeroed before its first run and read after
              it (every one must be non-zero). Every dispatch shape that run
              made (for the dense caches every shape each kernel was called
              at) is then given to its kernels again, in bf16 and f32, and
              held against the plain versions. For the main paths at full
              depth, a few windows and prefill dispatches are profiled for
              the device's idle share and the kernels that take the time;
              the windows over the int8 sink ring, the int8 dense cache
              and int8 and bf16 pages must launch their attention kernel
              once a call (and none of the three passes), and
              the int4 windows (dense, pages, sink ring) the int4 matmul's
              bf16 kernel once a call (7 a layer and the head, each step)
              and no combine kernel. The
              K = 1 paths over the int8 dense cache and over int8 pages
              profile a few decode ticks at their depth, which must launch
              `quantized_decode_attention` / `quantized_paged_attention`
              once a layer (and, over int8 pages, the int4 matmul once a
              call).
              Then captured against eager: the same greedy traffic at full
              width and depth in bf16 with the window's step replayed from
              graphs and run eagerly must give identical streams.
              Last, the later model families at full width, each through
              the same traffic, checks and profiles, with a summary line
              (`engine_family`: tokens/s, the K = 16 window's wall and
              device ms, idle share, peak memory, launches) beside the
              card's name and power limit: `mixtral8l_int8_dense`
              (Mixtral-8x7B's layer at 8 layers, as the JAX package's
              `MIXTRAL_8L`, int8 weights over the int8 dense cache, #9,
              #10, #3) and `mixtral8l_bf16_pages` (bf16 over bf16 pages,
              #1, #2), each with its experts' step time (layer 0's
              `moe_mlp` at 8 rows, times the layers) against the card's
              bound for their bytes; `mistral7b_swa128_int8_pages`
              (Mistral-7B, 32 layers, window 128, int8 weights over int8
              pages: #4, #6, #7 with the window's masks live);
              `qwen2_mha4l_bf16_pages` (Qwen1.5-7B's widths, q/k/v
              biases, 32 kv heads, 4 layers, bf16 pages: #1, #2 at G = 1).
              Then the head widths, configs built by
              `ModelConfig.from_hf_config` from their published
              config.json restated: `qwen25_7b_bf16_pages` (Qwen2.5-7B, 28
              heads over 4, G = 7, q/k/v biases, 28 layers, bf16 pages: #1,
              #2), `llama3_70b_int4_int8pages` (Llama-3-70B, G = 8, int4
              weights made one matrix at a time over int8 pages, all
              80 layers: #4, #6, #7, #13, #14),
              `llama32_1b_int4_int8dense` and `llama32_1b_bf16_pages`
              (Llama-3.2-1B, head_dim 64, tied head, 16 layers: #3, #9,
              #10, #14; #1, #2), each with its summary line. Then the
              latent family: `deepseek_v2_lite_f32latent_pages` and
              `deepseek_v2_lite_int8latent_pages` (DeepSeek-V2-Lite from
              its config.json restated, 16 heads over one 576-wide latent,
              27 layers, bf16 weights, less what `LATENT_CUTS` lists) at
              K = 1 on the same traffic: tokens/s, prefill and tick ms,
              `kv_bytes_per_token`, `latent_decompress_dispatches`, the
              latent wrappers' launches (> 0, every one on a tensor-core
              instance), no per-head attention kernel, no
              plain version and no gather, a decode tick and a prefill
              profiled (the idle share; the prefill's latent kernel ms,
              one launch a layer).
4. parity   - 2 layers of the same widths in f32 (TF32 off): the bf16 pool
              at K = 16, at K = 1 and on the gather path, identical greedy
              streams; int4 weights over the int8 pool, kernels against the
              gather path at K = 1, identical, and K = 16 against K = 1 with
              the share of equal tokens and the first divergence printed;
              the model-dtype dense cache with flash against without, at
              K = 1 and K = 16, identical; the int8 dense cache at K = 1 with
              `quantized_decode_attention` against without, identical, and
              K = 16 against K = 1, shown as above; the int8 sink ring
              (window 256) with its kernels against their plain versions
              and captured against eager, identical, and against the
              segments path and K = 1, shown; the model-dtype sink ring
              (window 256) with flash prefill against without, identical.
              Then 2 layers of Mixtral-8x7B's widths: bf16 pages at K = 16,
              K = 1 and the gather path, identical; the int8 dense cache
              with #8 against without at K = 1, identical, K = 16 against
              K = 1 shown; `moe_mlp_dispatch` at full capacity against the
              dense combine on a 2048-token prefill, its error printed;
              and of Mistral-7B's (window 128): bf16 pages with kernels at
              K = 16 and K = 1 against the gather path, int8 pages with
              kernels against the gather path at K = 1, identical. Then 2
              layers of Qwen2.5-7B's widths (G = 7) and of Llama-3.2-1B's
              (D = 64): bf16 pages at K = 16, K = 1 and the gather path,
              identical; int8 pages (Qwen) with kernels against the gather
              path at K = 1 and the int8 dense cache (Llama) with #8
              against without at K = 1, identical; their K = 16 against
              K = 1 shown. Then 2 layers of DeepSeek-V2-Lite's widths over
              both latent pools: the latent kernels against the gather
              path at K = 1 and at an explicit K = 4, identical.

Then a line `{"kernels": [...]}` with one entry per kernel (the only line
with that key: phase 2 lists its results under `checked`), then phase 5:

5. serve    - a checkpoint loaded and served through the OpenAI gateway.
              A 2-layer checkpoint at Llama-3-8B widths (bf16, seeded) is
              written in the HF layout by the port's safetensors writer (an
              index, two shards, config.json) into a temporary directory
              under `build/`, deleted at the end pass or fail;
              `python -m distributed_llm_inference_tpu_torch info` must
              call it supported with its widths, and `load_model_params`
              must return every tensor bitwise equal to the written one,
              transposed (load seconds printed). Then 8 concurrent requests
              through `ApiServer.start()` over `EngineBackend` on the
              default engine (bf16 pages, K = 16): token-id prompts of 20
              to 2100 tokens, 32 new tokens; two SSE streams ending in
              [DONE], one sampled request, a client that disconnects
              mid-stream, a `timeout_s` that expires; the first window's
              capture is held until a request has reached the gateway, so
              the gateway serves while the driver captures. `/metrics` and
              `/healthz`, a drain; the launches of the ragged prefill and
              paged decode kernels; tokens/s, the gateway's p50 TTFT and
              peak memory. Then the real entry point,
              `python -m distributed_llm_inference_tpu_torch api --dtype
              float32`, as a subprocess: 3 greedy requests, one at a time,
              equal token for token to `InferenceEngine.generate` of the
              same prompt on the same weights in this process; SIGTERM, a
              drain, exit 0. Last, `local --quantize int4 --kv-quant int8`
              on the checkpoint, with the launches of its kernels (#14 at
              the config's int4 projections a layer a step: 7). Then a
              1-layer checkpoint at Mixtral-8x7B's widths (`block_sparse_moe`
              keys, 3.4 GB): `info` supported with 8 experts, a bitwise
              load (each expert in its slot of the stacks), `local` in bf16
              and with int4 + int8 KV (#14 at 4 calls a layer a step).
              Then a checkpoint at Llama-3.2-1B's full widths and depth
              (16 layers, head_dim 64, the head tied to the embedding,
              about 2.5 GB): `info` supported, a bitwise load, `local
              --quantize int4 --kv-quant int8` on the card. Last, a
              2-layer checkpoint at DeepSeek-V2-Lite's widths in the
              DeepSeek-V2 layout (q_proj, kv_a_proj_with_mqa,
              kv_a_layernorm, kv_b_proj, o_proj): `info` supported, a
              bitwise load (kv_b_proj as wk_b and wv_b), `local` over the
              f32 and the int8 latent pools.

The last line is `{"ok": true, "device": {...}}`. Any failing phase raises:
exit code non-zero.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import http.client
import io
import json
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from distributed_llm_inference_tpu_torch.cache.base import window_ladder
from distributed_llm_inference_tpu_torch import cli
from distributed_llm_inference_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    RopeScaling,
    ServingConfig,
)
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama
from distributed_llm_inference_tpu_torch.serving import ApiServer, EngineBackend
from distributed_llm_inference_tpu_torch.utils import checkpoint
from distributed_llm_inference_tpu_torch.cache.dense import _quantize_kv
from distributed_llm_inference_tpu_torch.cache.latent import (
    LatentPagedKVCache,
    QuantizedLatentPagedKVCache,
)
from distributed_llm_inference_tpu_torch.ops import _build, quant
from distributed_llm_inference_tpu_torch.ops import flash_attention as fa
from distributed_llm_inference_tpu_torch.ops import moe
from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
from distributed_llm_inference_tpu_torch.ops import quant_attention as qa
from distributed_llm_inference_tpu_torch.ops import quant_matmul as qm
from distributed_llm_inference_tpu_torch.ops import ragged_attention as ra

# bench.py:48 LLAMA3_8B of the JAX package's benchmark, restated.
LLAMA3_8B = ModelConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=500000.0, max_position_embeddings=8192,
    rope_scaling=RopeScaling(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0,
        high_freq_factor=4.0, original_max_position_embeddings=8192,
    ),
)
HQ, HKV, D, PS = 32, 8, 128, 64
KT = 16  # the fused window: decode_steps=None resolves to 16
# The flushes' other widths (kv heads, head_dim, tail slots) checked in phase
# 2 beside the main path's 8, 128, 16: a partial last group of kv heads a
# block (3 heads, 2 a block), 4 heads a block (D = 64), one head a block in
# three passes (KT = 80), 16 words a row (D = 256).
FLUSH_WIDTHS = ((3, 128, 16), (8, 64, 16), (3, 64, 80), (2, 256, 48))

# Published peaks of one H100 SXM (dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# bf16: the kernel and the plain version both accumulate in f32 from the same
# bf16 inputs and round once at the end, in another order of summation, so
# they differ by at most one bf16 step of an output of magnitude < 4 (2^-6).
# The int8-page forms take p * vs into P V as two bf16 terms, hi + lo (the
# TPU kernel keeps it in f32), about 2^-17 relative per term.
# f32: only the order of summation differs.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# int4 matmuls, relative to max |out|. bf16: products of bf16 x and int4 w
# are exact in f32 and both sides sum in f32, so they differ only where the
# one final rounding to bf16 falls differently: at most one bf16 step, 2^-7
# of the largest output. f32: the products round, and K <= 14336 terms are
# summed in another order: well under 1e-5 of the largest output.
TOL4 = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# Llama-3-8B's projections (in, out) in the order a layer runs them.
PROJECTIONS = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
               "wo": (4096, 4096), "wg": (4096, 14336), "wu": (4096, 14336),
               "wd": (14336, 4096)}
HEAD = (4096, 128256)

# The model families of phase 3's later paths. bench.py:1001-1016
# MIXTRAL_8L of the JAX package's benchmark, restated: Mixtral-8x7B's exact
# layer (8 experts of width 14336, top-2, 32/8 heads of 128) at 8 of its 32
# layers (the JAX benchmark's own cut).
MIXTRAL_8L = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=8, num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=1000000.0, max_position_embeddings=4096,
    num_experts=8, num_experts_per_tok=2, family="mixtral",
)
# bench.py:948-960 MISTRAL_7B: Mistral-7B's widths and depth, its sliding
# window cut to 128 so that the window's masks are live in every phase.
MISTRAL_7B = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=10000.0, max_position_embeddings=8192, sliding_window=128,
    family="mistral",
)
# Qwen1.5-7B's published config (HF model_type "qwen2": q/k/v biases, MHA
# with 32 kv heads), cut to 4 layers.
QWEN15_7B_4L = ModelConfig(
    vocab_size=151936, hidden_size=4096, intermediate_size=11008,
    num_layers=4, num_heads=32, num_kv_heads=32, head_dim=128,
    rms_norm_eps=1e-6, rope_theta=1000000.0, max_position_embeddings=32768,
    qkv_bias=True, family="qwen2",
)

# The head-width paths: published configs restated from their config.json
# (not downloaded) and built as a checkpoint's load builds them.
# Qwen/Qwen2.5-7B: 28 heads over 4 kv heads (G = 7), q/k/v biases, the
# sliding window of 131072 as from_hf_config reads it.
QWEN25_7B = ModelConfig.from_hf_config({
    "model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584,
    "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4,
    "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "max_position_embeddings": 131072, "sliding_window": 131072,
    "use_sliding_window": False, "max_window_layers": 28,
    "tie_word_embeddings": False})
# meta-llama/Meta-Llama-3-70B: 64 heads over 8 (G = 8).
LLAMA3_70B = ModelConfig.from_hf_config({
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 8192,
    "intermediate_size": 28672, "num_hidden_layers": 80,
    "num_attention_heads": 64, "num_key_value_heads": 8,
    "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
    "max_position_embeddings": 8192, "tie_word_embeddings": False})
# meta-llama/Llama-3.2-1B: 32 heads of 64 over 8 kv heads, the head tied to
# the embedding, llama3 rope scaling.
LLAMA32_1B = ModelConfig.from_hf_config({
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
    "intermediate_size": 8192, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "tie_word_embeddings": True,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192}})

DEV = "cuda"
CARD = None  # nvidia-smi's "name, power limit", set by phase 1
SPIN_CYCLES = 10_000_000  # about 5 ms of device spin at 1.7-2 GHz


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(line, flush=True)
    global CARD
    CARD = line
    name, _, limit = line.partition(",")
    emit({"phase": "device", "name": name.strip(),
          "power_limit": limit.strip(),
          "torch": torch.__version__, "cuda": torch.version.cuda})


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def normal(rng, shape, dtype):
    """Standard normal values drawn on the card, from a seed that ``rng``
    (a numpy generator) draws: repeatable, and quick at full depth."""
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**62)))
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def make_pool(rng, num_pages, dtype, hkv=HKV, ps=PS, d=D):
    shape = (num_pages, hkv, ps, d)
    return normal(rng, shape, dtype), normal(rng, shape, dtype)


def make_qpool(rng, num_pages, hkv=HKV, ps=PS, d=D):
    """An int8 pool as the cache stores it: ``(k, ks, v, vs)``, values
    quantized per (slot, head) from normal data."""
    k, v = make_pool(rng, num_pages, torch.float32, hkv, ps, d)
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    return kq, ks, vq, vs


def make_table(rng, batch, width, num_pages):
    """Distinct non-null pages per slot, in a shuffled order."""
    assert batch * width <= num_pages - 1
    ids = rng.permutation(num_pages - 1)[: batch * width] + 1
    return torch.as_tensor(ids.reshape(batch, width).astype(np.int32)).to(DEV)


def i32(values):
    return torch.as_tensor(np.asarray(values, np.int32)).to(DEV)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# A pool is (k, v) in the working type or (k, ks, v, vs) with int8 pages;
# these pick the kernel wrapper and plain version for it.
def paged_fns(pool):
    if len(pool) == 4:
        return "qpaged", pa.quantized_paged_attention, pa.quantized_paged_attention_plain
    return "paged", pa.paged_attention, pa.paged_attention_plain


def ragged_fns(pool):
    if len(pool) == 4:
        return ("qragged", ra.quantized_ragged_paged_attention,
                ra.quantized_ragged_paged_attention_plain)
    return "ragged", ra.ragged_paged_attention, ra.ragged_paged_attention_plain


def ragged_plain_by_rows(pool, q, table, kv_len, num_new, q_start=None,
                         sliding_window=None):
    """The plain version one row at a time: it materialises the whole
    [heads, S, slots] score tensor in f32, about 1 GiB a row at S = 2048 over
    4096 slots, so a batch is not given to it in one piece."""
    plain = ragged_fns(pool)[2]
    return torch.cat([
        plain(q[i:i + 1], *pool, table[i:i + 1], kv_len[i:i + 1],
              num_new[i:i + 1], None if q_start is None else q_start[i:i + 1],
              sliding_window=sliding_window)
        for i in range(q.shape[0])])


def compare_paged(cases, tag, dtype, q, pool, table, kv_len, **kw):
    """The decode kernel for ``pool`` against its plain version on the same
    inputs: the output and both softmax stats, appended to ``cases``.
    Returns the output's max abs error."""
    _, kernel, plain = paged_fns(pool)
    got, gm, gl = kernel(q, *pool, table, kv_len, return_stats=True, **kw)
    want, wm, wl = plain(q, *pool, table, kv_len, return_stats=True, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    cases.append((tag, err, TOL[dtype]))
    # Stats are f32 on both sides whatever the pool's type.
    cases.append((tag + "_m", max_err(gm, wm), 1e-4))
    cases.append((tag + "_l", float(
        ((gl - wl).abs() / wl.clamp_min(1.0)).max()), 1e-4))
    empty = kv_len == 0
    if bool(empty.any()):
        assert float(got[empty].abs().max()) == 0.0, "empty row must be zero"
        assert float(gl[empty].max()) == 0.0
    return err


def compare_ragged(cases, tag, dtype, q, pool, table, kv_len, num_new, **kw):
    """The ragged kernel for ``pool`` against its plain version on the same
    inputs, appended to ``cases``; pad queries must come out as exact
    zeros."""
    kernel = ragged_fns(pool)[1]
    got = kernel(q, *pool, table, kv_len, num_new, **kw)
    want = ragged_plain_by_rows(pool, q, table, kv_len, num_new, **kw)
    torch.cuda.synchronize()
    pad = torch.arange(q.shape[1], device=DEV)[None, :] >= num_new[:, None]
    if bool(pad.any()):
        assert float(got[pad].abs().max()) == 0.0, "pad queries must be zero"
    err = max_err(got, want)
    cases.append((tag, err, TOL[dtype]))
    return err


def make_qplanes(rng, lead, n, d=D):
    """int8 planes as the cache and the tail store them: ``(k, ks, v,
    vs)``, ``lead + (n, d)`` int8 and ``lead + (n,)`` f32, quantized per
    (slot, head) from normal data."""
    k = normal(rng, (*lead, n, d), torch.float32)
    v = normal(rng, (*lead, n, d), torch.float32)
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    return kq, ks, vq, vs


def fused_fns(form):
    """(case prefix, wrapper, plain version) of the fused step: "inplace"
    (#6, the pool through its table) or "gathered" (#9, the stacks)."""
    if form == "inplace":
        return ("qfusedp", pa.quantized_paged_fused_attention,
                pa.quantized_paged_fused_attention_plain)
    return ("qfusedd", qa.quantized_fused_decode_attention,
            qa.quantized_fused_decode_attention_plain)


def compare_fused(cases, tag, dtype, form, big, base, rng, table=None,
                  window=None, g=HQ // HKV, steps=4, layer=1, dead=(),
                  hkv=HKV, d=D):
    """The fused step (#6 over the pool ``big`` through ``table``, or #9
    over the stacks ``big``) against its plain version over ``steps`` steps
    of one window on the same inputs, each side with its own copy of the
    tail: the output within TOL, the tail's int8 values and scales EQUAL.
    The last row stops after the first step; the rows in ``dead`` take no
    token at all (with ``base`` 0, a row with nothing to attend, whose
    output must be zeros). Returns the output's error."""
    _, kernel, plain = fused_fns(form)
    b = base.shape[0]
    tail = make_qplanes(rng, (big[0].shape[0], b, hkv), KT, d)
    tail2 = [t.clone() for t in tail]
    tail_len = torch.zeros(b, dtype=torch.int32, device=DEV)
    alive = torch.ones(b, dtype=torch.int32, device=DEV)
    alive[list(dead)] = 0
    extra = {} if table is None else {"page_table": table}
    err = tail_err = 0.0
    for step in range(steps):
        q = normal(rng, (b, 1, hkv * g, d), dtype)
        kn = normal(rng, (b, 1, hkv, d), dtype)
        vn = normal(rng, (b, 1, hkv, d), dtype)
        kw = dict(layer_idx=layer, step_idx=i32([step]), base_len=base,
                  tail_valid_len=tail_len + alive, q_positions=base + tail_len,
                  sliding_window=window, **extra)
        got = kernel(q, kn, vn, *big, *tail, **kw)[0]
        want = plain(q, kn, vn, *big, *tail2, **kw)[0]
        torch.cuda.synchronize()
        err = max(err, max_err(got, want))
        empty = (base == 0) & (kw["tail_valid_len"] == 0)
        if bool(empty.any()):
            assert float(got[empty].abs().max()) == 0.0, "empty rows must be zero"
        tail_err = max(tail_err, *(max_err(a, w) for a, w in zip(tail, tail2)))
        tail_len += alive
        alive[-1] = 0
    cases.append((tag, err, TOL[dtype]))
    cases.append((tag + "_tail_bytes", tail_err, 0.0))
    return err


def compare_flush(cases, tag, pool, table, base, tail_len, rng, kt=KT):
    """`paged_tail_flush` (#7) against its plain version on copies of one
    pool, a tail of ``kt`` slots at the pool's widths: every byte of every
    plane EQUAL. Returns the error (0)."""
    num_l, _, hkv, _, d = pool[0].shape
    tail = make_qplanes(rng, (num_l, table.shape[0], hkv), kt, d)
    mine = [p.clone() for p in pool]
    ref = [p.clone() for p in pool]
    pa.paged_tail_flush(*mine, *tail, table, base, tail_len)
    pa.paged_tail_flush_plain(*ref, *tail, table, base, tail_len)
    torch.cuda.synchronize()
    err = max(max_err(a, w) for a, w in zip(mine, ref))
    cases.append((tag, err, 0.0))
    return err


def fused_cases(cases, dtype, rng):
    """#6 and #9 at B = 8, KT = 16, over a window's first steps: fresh,
    continued, page-edge and long rows, a row that stops, a sliding window,
    GQA (4 query heads per kv head) and MHA; #6 also over pages of 16, 48
    and 128 slots with an empty row and windows that start inside a page.
    #7 over mixed tail lengths, windows that straddle a page and an
    unmapped table slot; and KT = 48 over pages of 16 (a tail across three
    or four pages), null table entries (page 0) inside the mapped range,
    rows that run past the table's width and rows with an empty tail; and
    over planes of the other widths of FLUSH_WIDTHS."""
    width, b = 40, 8
    pages = b * width + 1
    pool = make_qplanes(rng, (2, pages, HKV), PS)
    table = make_table(rng, b, width, pages)
    base6 = i32([0, 1, 63, 64, 65, 1000, 2048, 2500])
    stacks = make_qplanes(rng, (2, b, HKV), 640)
    base9 = i32([0, 1, 63, 64, 65, 300, 600, 624])
    for window in (None, 200):
        for g in (HQ // HKV, 1):
            compare_fused(cases, f"qfusedp_g{g}_window_{window}", dtype,
                          "inplace", pool, base6, rng, table=table,
                          window=window, g=g)
            compare_fused(cases, f"qfusedd_g{g}_window_{window}", dtype,
                          "gathered", stacks, base9, rng, window=window, g=g)
    # #6 over pages of 16, 48 and 128 slots: an empty row (nothing cached,
    # no token), short rows with fewer live tiles than the cluster has
    # blocks, rows across and at page edges, long rows; windows of 37 and
    # 300 slots start inside a page.
    for ps, rows in ((16, [0, 1, 15, 16, 17, 100, 600, 639]),
                     (48, [0, 1, 47, 48, 49, 700, 1500, 1919]),
                     (128, [0, 1, 127, 128, 129, 1000, 2000, 2559])):
        width = -(-(max(rows) + KT) // ps)
        pages = b * width + 1
        pps = make_qplanes(rng, (2, pages, HKV), ps)
        tps = make_table(rng, b, width, pages)
        for window in (None, 37, 300):
            for g in ((HQ // HKV, 1) if window == 37 else (HQ // HKV,)):
                compare_fused(cases, f"qfusedp_ps{ps}_g{g}_window_{window}",
                              dtype, "inplace", pps, i32(rows), rng,
                              table=tps, window=window, g=g, dead=(0,))
        del pps
    flush_table = table.clone()
    flush_table[7, 5] = 0
    compare_flush(cases, "flush_mixed", pool, flush_table,
                  i32([0, 1, 63, 64, 60, 1000, 2040, 330]),
                  i32([16, 3, 16, 0, 16, 9, 16, 1]), rng)
    ps16, width16 = 16, 12
    pool16 = make_qplanes(rng, (2, b * width16 + 1, HKV), ps16)
    table16 = make_table(rng, b, width16, b * width16 + 1)
    table16[1, 2] = 0
    table16[2, 0:2] = 0
    table16[6, 9] = 0
    compare_flush(cases, "flush_kt48_ps16", pool16, table16,
                  i32([0, 20, 0, 15, 100, 150, 140, 33]),
                  i32([48, 48, 40, 0, 48, 48, 47, 0]), rng, kt=48)
    del pool16
    for hkv, d, kt in FLUSH_WIDTHS:
        pool_w = make_qplanes(rng, (2, b * width16 + 1, hkv), ps16, d)
        compare_flush(cases, f"flush_h{hkv}_d{d}_kt{kt}", pool_w, table16,
                      i32([0, 20, 0, 15, 100, 150, 140, 33]),
                      i32([kt, kt, kt - 1, 0, kt, kt, kt // 2, 1]), rng,
                      kt=kt)


def paged_decode_cases(cases, dtype, rng):
    """#2 (bf16: the cluster kernel, csrc/paged_decode.cuh) over pools of
    page size 16, 48 and 128 (64 is above), B = 8: an empty row, a row of
    one position, rows at and across a page's edge and long rows over many
    steps of 64; no window and windows of 37 and 300 positions (starting
    inside a page and a step), the query 7 positions past the cache under
    the first; 4 query heads a kv head and 1. Output, m and l against the
    plain version."""
    for ps in (16, 48, 128):
        lens = [0, 1, ps - 1, ps, ps + 1, 700, 1500, 2000]
        width = -(-max(lens) // ps) + 1
        pages = 8 * width + 1
        pool = make_pool(rng, pages, dtype, ps=ps)
        table = make_table(rng, 8, width, pages)
        kv = i32(lens)
        q = normal(rng, (8, 1, HQ, D), dtype)
        for window, qpos in ((None, None), (37, i32([n + 7 for n in lens])),
                             (300, None)):
            for g in ((HQ // HKV, 1) if window == 37 else (HQ // HKV,)):
                qg = q if g == HQ // HKV else q[:, :, :HKV * g].contiguous()
                compare_paged(cases, f"paged_ps{ps}_g{g}_window_{window}",
                              dtype, qg, pool, table, kv,
                              sliding_window=window, q_positions=qpos)
        del pool


def quantized_decode_cases(cases, dtype, rng):
    """#5 (int8 pages) and #8 (the int8 dense buffer), with bf16 queries
    the cluster kernel (csrc/paged_decode.cuh) over int8 rows. #5 over
    pools of page size 1 (boxes of one row), 16, 48 and 128 (64 is in
    ``check_cases``), B = 8: an empty row, a row of one position, rows at
    and across a page's edge and long rows over many steps of 64; no window
    and windows of 37 and 300 positions (starting inside a page and a
    step), the query 7 positions past the cache under the first; 4 query
    heads a kv head and 1; then B = 1, one long row. Output, m and l
    against the plain version. #8 over buffers of T = 40, 200 and 300
    positions (widths of the window ladder that are not multiples of 64:
    a step's box runs into the next (row, head)'s rows, and at the last
    (row, head) past the buffer's end), B = 8 with full, empty, one-slot
    and partial rows, windows of 37 (the query past the cache) and 100,
    4 query heads a kv head and 1; then B = 1, its one row full."""
    for ps in (1, 16, 48, 128):
        lens = [0, 1, ps - 1, ps, ps + 1, 700, 1500, 2000]
        width = -(-max(lens) // ps) + 1
        pages = 8 * width + 1
        pool = make_qpool(rng, pages, ps=ps)
        table = make_table(rng, 8, width, pages)
        kv = i32(lens)
        q = normal(rng, (8, 1, HQ, D), dtype)
        for window, qpos in ((None, None), (37, i32([n + 7 for n in lens])),
                             (300, None)):
            for g in ((HQ // HKV, 1) if window == 37 else (HQ // HKV,)):
                qg = q if g == HQ // HKV else q[:, :, :HKV * g].contiguous()
                compare_paged(cases, f"qpaged_ps{ps}_g{g}_window_{window}",
                              dtype, qg, pool, table, kv,
                              sliding_window=window, q_positions=qpos)
        compare_paged(cases, f"qpaged_ps{ps}_b1", dtype, q[:1], pool,
                      table[:1], i32([1999]))
        del pool
    qd = normal(rng, (8, 1, HQ, D), dtype)
    for t in (40, 200, 300):
        planes = make_qplanes(rng, (8, HKV), t)
        lens = [0, 1, t // 2 + 3, t - 1, 33, t, t // 3, t]
        qpos = i32([n + 7 for n in lens])
        for window, qp in ((None, None), (37, qpos), (100, None)):
            for g in ((HQ // HKV, 1) if window == 37 else (HQ // HKV,)):
                qg = qd if g == HQ // HKV else qd[:, :, :HKV * g].contiguous()
                compare_qdense(cases, f"qdense_t{t}_g{g}_window_{window}",
                               dtype, qg, planes, i32(lens),
                               sliding_window=window, q_positions=qp)
        compare_qdense(cases, f"qdense_t{t}_b1", dtype, qd[:1],
                       [p[:1].contiguous() for p in planes], i32([t]))


def random_qplanes(gen, lead, n):
    """int8 planes of random bytes and positive scales, made on the card
    (the widest stacks, where drawing normal values and quantizing them
    would take seconds): ``(k, ks, v, vs)``."""
    def plane():
        return torch.randint(-127, 128, (*lead, n, D), generator=gen,
                             device=DEV, dtype=torch.int8)

    def scales():
        return torch.rand((*lead, n), generator=gen, device=DEV) * 0.02 + 1e-3

    return plane(), scales(), plane(), scales()


# Stacks past which a block of #9's cluster cannot keep every piece's
# scores (4 query heads a kv head): the kernel then reads K twice.
RECOMPUTE_T = 80000


def contiguous_fused_cases(cases, dtype, rng):
    """#9 (one cluster launch) at the engine's widths beyond phase 2's
    T = 640: T = 2048 and 4096 (the dense cache's default `max_seq_len`),
    B = 8, over a window's first steps: an empty row (nothing cached, no
    token), a tail-only row, rows at and across tile and piece edges, long
    rows; no window and a window of 200; 4 query heads a kv head and 1.
    Then T = 80000, where a block's scores do not all fit its shared memory
    (its plan says so) and the kernel forms them twice: two rows over most
    of the stacks, with and without a window. Tails EQUAL."""
    for t in (2048, 4096):
        stacks = make_qplanes(rng, (2, 8, HKV), t)
        base = i32([0, 0, 1, 255, 256, 257, t // 2 + 5, t - KT])
        for window in (None, 200):
            for g in (HQ // HKV, 1):
                compare_fused(cases, f"qfusedd_T{t}_g{g}_window_{window}",
                              dtype, "gathered", stacks, base, rng,
                              window=window, g=g, dead=(0,))
        del stacks
    plan = dense_plan(RECOMPUTE_T, HQ // HKV)
    assert plan["scores_kept"] == 0, plan
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**62)))
    stacks = random_qplanes(gen, (2, 2, HKV), RECOMPUTE_T)
    for window in (None, 1000):
        compare_fused(cases, f"qfusedd_T{RECOMPUTE_T}_window_{window}", dtype,
                      "gathered", stacks, i32([70001, RECOMPUTE_T - KT]),
                      rng, window=window, steps=2)
    del stacks


def int4_weight(gen, shape):
    """A random stacked weight ``[L, in, out]``, int4-quantized."""
    return quant.quantize_int4_split(
        torch.randn(shape, generator=gen, device=DEV) * 0.02)


def compare_int4(cases, tag, dtype, x, w, layer=None):
    """`int4_matmul_stacked` at ``layer`` (or `int4_matmul` on the layer's 2-D
    weight when ``layer`` is None, layer 0) against its plain version;
    error relative to the largest output."""
    if layer is None:
        args = (x, w.q[0], w.scale_lo[0], w.scale_hi[0], w.out_dim)
        got, want = qm.int4_matmul(*args), qm.int4_matmul_plain(*args)
        name = "int4"
    else:
        args = (x, w.q, w.scale_lo, w.scale_hi, layer, w.out_dim)
        got = qm.int4_matmul_stacked(*args)
        want = qm.int4_matmul_stacked_plain(*args)
        name = "int4s"
    torch.cuda.synchronize()
    err = max_err(got, want) / max(float(want.float().abs().max()), 1e-30)
    cases.append((f"{name}_{tag}", err, TOL4[dtype]))
    return err


def int4_repeat(cases, tag, x, w, layer=None):
    """The int4 kernel called twice on the same inputs: the outputs must
    be the same bytes (the split over input rows is summed in a fixed
    order). Appended with tolerance 0."""
    if layer is None:
        args = (x, w.q[0], w.scale_lo[0], w.scale_hi[0], w.out_dim)
        a, b = qm.int4_matmul(*args), qm.int4_matmul(*args)
        name = "int4"
    else:
        args = (x, w.q, w.scale_lo, w.scale_hi, layer, w.out_dim)
        a, b = qm.int4_matmul_stacked(*args), qm.int4_matmul_stacked(*args)
        name = "int4s"
    torch.cuda.synchronize()
    cases.append((f"{name}_{tag}_repeat", 0.0 if torch.equal(a, b) else 1.0,
                  0.0))


# Projections of the head-width paths' models beside Llama-3-8B's: the
# int4 kernels' split plans at their shapes (the head the flat form).
WIDTH_PROJECTIONS = {"qwen2.5-7b_wk": (3584, 512),
                     "qwen2.5-7b_wq": (3584, 3584),
                     "llama-3.2-1b_wk": (2048, 512),
                     "llama-3.2-1b_wg": (2048, 8192),
                     "llama-3-70b_wg": (8192, 28672),
                     "llama-3-70b_wd": (28672, 8192),
                     "llama-3-70b_head": (8192, 128256)}


def int4_route_cases(cases, dtype):
    """The int4 kernels at the rows the routing sends them (`ops/quant.py`:
    decode, and calls of at most 256 rows): 1, 8, 64 and 256 rows at
    Llama-3-8B's projection shapes (a stack of 2 layers, layer 1) and the
    head (the flat form), then at ``WIDTH_PROJECTIONS``, each call repeated
    (the same bytes). Drawn after every other int4 case, from a generator
    of their own."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    shapes = {n: PROJECTIONS[n] for n in ("wq", "wk", "wg", "wd")}
    for name, (ind, outd) in [*shapes.items(), ("head", HEAD),
                              *WIDTH_PROJECTIONS.items()]:
        layer = None if name.endswith("head") else 1
        w = int4_weight(gen, (1 if layer is None else 2, ind, outd))
        for rows in (1, 8, 64, 256):
            x = torch.randn((rows, ind), generator=gen, device=DEV).to(dtype)
            tag = f"route_{name}_r{rows}"
            compare_int4(cases, tag, dtype, x, w, layer)
            int4_repeat(cases, tag, x, w, layer)
        del w


# #4's bf16 excursion, pinned: the B = 8 launch of ``RAGGED_ROWS`` over
# int8 pages of 48 slots, no window, inputs drawn from seed 0 of a
# generator of their own. Before p * vs went into P V as hi + lo, the
# kernel was 0.03125 off the plain version here (one bf16 step at
# |out| >= 4, past the 2e-2 tolerance); after it, 0.0039.
PINNED_RAGGED_SEED = 0


def pinned_ragged_case(cases, dtype):
    rng = np.random.default_rng(PINNED_RAGGED_SEED)
    rows = {k: i32(v) for k, v in RAGGED_ROWS.items()}
    s, ps = max(RAGGED_ROWS["num_new"]), 48
    q = normal(rng, (8, s, HQ, D), dtype)
    width = -(-max(RAGGED_ROWS["kv_len"]) // ps) + 1
    pages = 8 * width + 1
    pool = make_qpool(rng, pages, ps=ps)
    table = make_table(rng, 8, width, pages)
    compare_ragged(cases, f"qragged_pinned_seed{PINNED_RAGGED_SEED}_ps{ps}"
                   "_b8_window_None", dtype, q, pool, table, rows["kv_len"],
                   rows["num_new"], q_start=rows["q_start"],
                   sliding_window=None)


def assert_cases(cases, dtype):
    for name, err, limit in cases:
        assert np.isfinite(err) and err <= limit, (
            f"{name} [{dtype}]: max abs err {err} > tolerance {limit}")


def check_cases(dtype):
    """Every correctness case for one dtype: (name, error, tolerance)."""
    rng = np.random.default_rng(1234)
    cases = []

    pages, width, s = 160, 16, 256
    pools = {"": make_pool(rng, pages, dtype), "int8": make_qpool(rng, pages)}
    table = make_table(rng, 4, width, pages)
    q = normal(rng, (4, s, HQ, D), dtype)
    num_new = i32([200, 128, 1, 0])
    kv_len = i32([200, 428, 777, 0])
    lens = [0, 1, 64, 65, 1000, 1024, 513, 37]
    qd = normal(rng, (8, 1, HQ, D), dtype)
    table8 = make_table(rng, 8, width, pages)
    kv8 = i32(lens)
    for pool in pools.values():
        rname, pname = ragged_fns(pool)[0], paged_fns(pool)[0]
        # Ragged: a full-prompt row, a chunk row with q_start > 0, a decode
        # row and an empty row in one launch, padded to S = 256.
        for window in (None, 100):
            compare_ragged(cases, f"{rname}_mixed_window_{window}", dtype, q,
                           pool, table, kv_len, num_new, sliding_window=window)
        # Explicit q_start (a chunk whose queries are not the newest tokens).
        compare_ragged(cases, f"{rname}_q_start", dtype, q, pool, table,
                       kv_len, num_new, q_start=i32([0, 250, 776, 0]))
        # Paged decode: ragged lengths including 0 and page edges, stats, a
        # sliding window, and q_positions past the pool contents.
        for window, qpos in ((None, None), (200, None),
                             (200, i32([n + 7 for n in lens]))):
            tag = (f"{pname}_window_{window}_qpos_"
                   f"{'past' if qpos is not None else 'default'}")
            compare_paged(cases, tag, dtype, qd, pool, table8, kv8,
                          sliding_window=window, q_positions=qpos)
        # MHA (one query head per kv head): the other grouping the kernels
        # are built for, same pool, 8 query heads.
        compare_ragged(cases, f"{rname}_mha", dtype,
                       q[:, :, :HKV].contiguous(), pool, table, kv_len,
                       num_new, sliding_window=100)
        compare_paged(cases, f"{pname}_mha", dtype,
                      qd[:, :, :HKV].contiguous(), pool, table8, kv8,
                      sliding_window=200)

    # int4 matmuls: the projection shapes, odd widths (padding on both
    # axes), 1 to 20 rows (20 = three row blocks), layers of a stack.
    gen = torch.Generator(device=DEV).manual_seed(5)
    for rows, (ind, outd), num_l, layer in (
            (8, PROJECTIONS["wq"], 3, 2), (3, PROJECTIONS["wk"], 2, 1),
            (1, PROJECTIONS["wd"], 1, 0), (8, PROJECTIONS["wg"], 1, 0),
            (20, (4100, 1030), 2, 1), (5, (72, 24), 1, 0)):
        w = int4_weight(gen, (num_l, ind, outd))
        x = torch.randn((rows, ind), generator=gen, device=DEV).to(dtype)
        tag = f"r{rows}_{ind}x{outd}"
        compare_int4(cases, f"{tag}_l{layer}", dtype, x, w, layer)
        if num_l == 1:
            compare_int4(cases, tag, dtype, x, w)
    paged_decode_cases(cases, dtype, rng)
    ragged_cases(cases, dtype, rng)
    fused_cases(cases, dtype, rng)
    contiguous_fused_cases(cases, dtype, rng)
    dense_cases(cases, dtype, rng)
    sink_cases(cases, dtype, rng)
    quantized_decode_cases(cases, dtype, rng)
    int4_route_cases(cases, dtype)
    pinned_ragged_case(cases, dtype)
    width_cases(cases, dtype, np.random.default_rng(4321))
    assert_cases(cases, dtype)
    return cases


# The ragged kernels' edges: one B = 8 launch padded to S = 640 that mixes a
# prompt, a chunk of 600 queries from q_start 1500 (five 128-slot ring steps
# and more, q_start off the step grid), a decode token whose position lies
# before the row's newest slot, an empty row, prompts and chunks whose
# lengths are not multiples of 128 (and one of 129); kv rows of up to 2100
# slots.
RAGGED_ROWS = {"q_start": [0, 1500, 990, 0, 0, 200, 130, 0],
               "num_new": [300, 600, 1, 0, 640, 77, 5, 129],
               "kv_len": [300, 2100, 1000, 0, 640, 277, 135, 129]}


def ragged_cases(cases, dtype, rng):
    """#1 and #4 over pools of page size 16, 48 and 128 (64 is above) and
    12 (boxes of 4 rows): the B = 8 launch of ``RAGGED_ROWS``, without a
    window and with windows of 300 and 77 slots, which start inside a
    128-slot step; the same rows as MHA at page size 48."""
    rows = {k: i32(v) for k, v in RAGGED_ROWS.items()}
    s = max(RAGGED_ROWS["num_new"])
    q = normal(rng, (8, s, HQ, D), dtype)
    for ps in (16, 48, 128, 12):
        width = -(-max(RAGGED_ROWS["kv_len"]) // ps) + 1
        pages = 8 * width + 1
        pools = (make_pool(rng, pages, dtype, ps=ps),
                 make_qpool(rng, pages, ps=ps))
        table = make_table(rng, 8, width, pages)
        for pool in pools:
            rname = ragged_fns(pool)[0]
            for window in (None, 300, 77):
                compare_ragged(cases, f"{rname}_ps{ps}_b8_window_{window}",
                               dtype, q, pool, table, rows["kv_len"],
                               rows["num_new"], q_start=rows["q_start"],
                               sliding_window=window)
            if ps == 48:
                compare_ragged(cases, f"{rname}_ps{ps}_b8_mha", dtype,
                               q[:, :, :HKV].contiguous(), pool, table,
                               rows["kv_len"], rows["num_new"],
                               q_start=rows["q_start"], sliding_window=300)


# ---------------------------------------------------------------------------
# phase 2, the dense caches' kernels (slice 4): flash prefill (#3), int8
# dense decode (#8), the dense tail flush (#10)
# ---------------------------------------------------------------------------

def causal(b, s, t, lens, q0, window=None):
    """Bool mask [B, S, T] as the dense caches build it: query i of row r at
    position q0[r] + i sees positions <= its own, below lens[r], inside the
    window."""
    q = i32(q0)[:, None, None] + torch.arange(s, device=DEV)[None, :, None]
    k = torch.arange(t, device=DEV)[None, None, :]
    m = (k <= q) & (k < i32(lens)[:, None, None])
    if window is not None:
        m &= k > q - window
    return m.contiguous()


def compare_flash(cases, tag, dtype, q, k, v, mask):
    """`flash_attention` (#3) against its plain version on the same inputs;
    rows whose mask is empty must come out as exact zeros."""
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    empty = ~mask.any(dim=-1)                       # [B, S]
    if bool(empty.any()):
        assert float(got[empty].abs().max()) == 0.0, "masked rows must be zero"
    err = max_err(got, want)
    cases.append((tag, err, TOL[dtype]))
    return err


def flash_masks(b, s, t, rng):
    """The mask families #3 is held to, ``{name: bool [B, S, T]}`` on the
    card: causal over a longer buffer with a shorter row, a sliding window,
    sinks beside a window (the sink ring's), random bits, and a row that
    sees nothing beside a row whose later queries see nothing."""
    q0 = [t - s] * b
    sink = causal(b, s, t, [t] * b, q0, max(2, s // 4))
    sink |= causal(b, s, t, [4] * b, q0)
    empty = causal(b, s, t, [0] + [t] * (b - 1), q0)
    empty[-1, s // 2:] = False
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**62)))
    return {"causal": causal(b, s, t, [t] + [t // 2] * (b - 1), [0] * b),
            "window": causal(b, s, t, [t] * b, q0, max(2, s // 3)),
            "sinks": sink.contiguous(),
            "random": (torch.rand((b, s, t), generator=gen, device=DEV)
                       < 0.3).contiguous(),
            "empty_rows": empty.contiguous()}


def flash_family_cases(cases, dtype, rng):
    """#3 over every mask family at S, T multiples of 128 (256 x 384) and
    below 128 (40 x 72), GQA and MHA; in bf16 also its first pass (the
    packed mask and the tile classes) against ``mask_tiles``, EQUAL."""
    for s, t in ((256, 384), (40, 72)):
        q = normal(rng, (2, s, HQ, D), dtype)
        k = normal(rng, (2, t, HKV, D), dtype)
        v = normal(rng, (2, t, HKV, D), dtype)
        for name, mask in flash_masks(2, s, t, rng).items():
            for g in (HQ // HKV, 1):
                compare_flash(cases, f"flash_{name}_{s}x{t}_g{g}", dtype,
                              q[:, :, :HKV * g].contiguous(), k, v, mask)
            if dtype != torch.bfloat16:
                continue
            for bq in (32, 128):
                got = fa.device_mask_tiles(mask, bq)
                want = fa.mask_tiles(mask, bq)
                torch.cuda.synchronize()
                same = all(torch.equal(a, w) for a, w in zip(got, want))
                cases.append((f"flash_tiles_{name}_{s}x{t}_bq{bq}",
                              0.0 if same else 1.0, 0.0))


def compare_qdense(cases, tag, dtype, q, planes, lens, **kw):
    """`quantized_decode_attention` (#8) against its plain version; a row
    with no live position must be zero."""
    got = qa.quantized_decode_attention(q, *planes, lens, **kw)
    want = qa.quantized_decode_attention_plain(q, *planes, lens, **kw)
    torch.cuda.synchronize()
    if bool((lens == 0).any()):
        assert float(got[lens == 0].abs().max()) == 0.0, "empty row must be zero"
    err = max_err(got, want)
    cases.append((tag, err, TOL[dtype]))
    return err


def compare_qflush(cases, tag, big, tail, base, tail_len):
    """`fused_tail_flush` (#10) against its plain version on copies of the
    same buffers: every byte of every plane EQUAL."""
    mine = [p.clone() for p in big]
    ref = [p.clone() for p in big]
    qa.fused_tail_flush(*mine, *tail, base, tail_len)
    qa.fused_tail_flush_plain(*ref, *tail, base, tail_len)
    torch.cuda.synchronize()
    err = max(max_err(a, w) for a, w in zip(mine, ref))
    cases.append((tag, err, 0.0))
    return err


def dense_cases(cases, dtype, rng):
    """#3 over a buffer wider than the prompts (a continued row, a fresh
    one, an empty one), with and without a sliding window, GQA and MHA, and
    on strided K/V (the int8 cache's gather path hands time-major views of
    head-major tensors), and over the mask families of ``flash_masks``; #8 over 2048 positions with rows of 0 to 2048 live
    positions, a sliding window, GQA and MHA; #10 at KT = 16 and 48 with
    in-block, block-spanning, empty, edge-partial, buffer-end and past-end
    windows, also over planes of the other widths of FLUSH_WIDTHS."""
    b, s, t = 3, 256, 384
    q = normal(rng, (b, s, HQ, D), dtype)
    k = normal(rng, (b, t, HKV, D), dtype)
    v = normal(rng, (b, t, HKV, D), dtype)
    for window in (None, 100):
        mask = causal(b, s, t, [300, 200, 0], [44, 0, 0], window)
        compare_flash(cases, f"flash_window_{window}", dtype, q, k, v, mask)
        compare_flash(cases, f"flash_mha_window_{window}", dtype,
                      q[:, :, :HKV].contiguous(), k, v, mask)
    kh = normal(rng, (b, HKV, t, D), dtype)
    vh = normal(rng, (b, HKV, t, D), dtype)
    compare_flash(cases, "flash_strided", dtype, q, kh.transpose(1, 2),
                  vh.transpose(1, 2), causal(b, s, t, [384, 256, 100],
                                             [128, 0, 0]))
    # Shapes the tiling rule admits but the kernel's tiles do not divide: a
    # partial last query tile (S = 24) and kv step (T = 40).
    qs, ks, vs = (normal(rng, (2, n, h, D), dtype)
                  for n, h in ((24, HQ), (40, HKV), (40, HKV)))
    for g in (HQ // HKV, 1):
        compare_flash(cases, f"flash_odd_g{g}", dtype,
                      qs[:, :, :HKV * g].contiguous(), ks, vs,
                      causal(2, 24, 40, [40, 30], [16, 0]))
    flash_family_cases(cases, dtype, rng)
    bq, tq = 8, 2048
    planes = make_qplanes(rng, (bq, HKV), tq)
    lens = i32([0, 1, 127, 128, 129, 1000, 2047, 2048])
    qd = normal(rng, (bq, 1, HQ, D), dtype)
    for window in (None, 200):
        compare_qdense(cases, f"qdense_window_{window}", dtype, qd, planes,
                       lens, sliding_window=window)
    compare_qdense(cases, "qdense_mha", dtype, qd[:, :, :HKV].contiguous(),
                   planes, lens, sliding_window=200)
    for kt in (16, 48):
        big = make_qplanes(rng, (2, bq, HKV), tq)
        tail = make_qplanes(rng, (2, bq, HKV), kt)
        compare_qflush(cases, f"qflush_kt{kt}", big, tail,
                       i32([0, 10, 30, 70, tq - 10, tq - kt, tq, 1000]),
                       i32([kt, kt, 0, 10, kt, kt, 3, 5]))
    for hkv, d, kt in FLUSH_WIDTHS:
        t = 400
        big = make_qplanes(rng, (2, bq, hkv), t, d)
        tail = make_qplanes(rng, (2, bq, hkv), kt, d)
        compare_qflush(cases, f"qflush_h{hkv}_d{d}_kt{kt}", big, tail,
                       i32([0, 10, 30, 70, t - 10, t - kt, t, 300]),
                       i32([kt, kt, 0, 10, kt, kt, 3, 5]))


# ---------------------------------------------------------------------------
# phase 2, the int8 sink ring's kernels (slice 5): the fused sink decode step
# (#11), the mod-ring tail flush (#12)
# ---------------------------------------------------------------------------

def sink_scalars(base, tail_len, alive, sinks, r):
    """The int8 ring's per-row arguments of a window step
    (`QuantizedSinkKVCache._tail_scalars`): live ring prefix, write pointer,
    slots evicted by the in-flight tail with this step's token, valid sinks,
    valid tail slots."""
    ring_len = (base - sinks).clamp(0, r)
    ring_ptr = torch.remainder((base - sinks).clamp_min(0), r)
    evict = tail_len + alive
    return dict(ring_len=ring_len, ring_ptr=ring_ptr, evict_len=evict,
                sink_len=base.clamp_max(sinks), tail_valid_len=evict)


def compare_sink(cases, tag, dtype, ring, sink, base, sinks, r, rng,
                 g=HQ // HKV, steps=4, layer=1, kt=KT, start=0, hkv=HKV, d=D):
    """`sink_fused_decode_attention` (#11) against its plain version over
    ``steps`` steps of one window (a tail of ``kt`` slots, the steps from
    slot ``start`` on, every row's tail that long before them) on the same
    inputs, each side with its own copy of the tail: the output within TOL,
    the tail's int8 values and scales EQUAL. The last row stops after the
    first step. Returns the output's error."""
    b = base.shape[0]
    tail = make_qplanes(rng, (ring[0].shape[0], b, hkv), kt, d)
    tail2 = [t.clone() for t in tail]
    tail_len = torch.full((b,), start, dtype=torch.int32, device=DEV)
    alive = torch.ones(b, dtype=torch.int32, device=DEV)
    err = tail_err = 0.0
    for step in range(steps):
        q, qs = (normal(rng, (b, 1, hkv * g, d), dtype) for _ in range(2))
        kn, vn = (normal(rng, (b, 1, hkv, d), dtype) for _ in range(2))
        kw = dict(layer_idx=layer, step_idx=i32([start + step]), ring_slots=r,
                  **sink_scalars(base, tail_len, alive, sinks, r))
        got = qa.sink_fused_decode_attention(q, qs, kn, vn, *ring, *sink,
                                             *tail, **kw)[0]
        want = qa.sink_fused_decode_attention_plain(q, qs, kn, vn, *ring,
                                                    *sink, *tail2, **kw)[0]
        torch.cuda.synchronize()
        err = max(err, max_err(got, want))
        tail_err = max(tail_err, *(max_err(a, w) for a, w in zip(tail, tail2)))
        tail_len += alive
        alive[-1] = 0
    cases.append((tag, err, TOL[dtype]))
    cases.append((tag + "_tail_bytes", tail_err, 0.0))
    return err


def compare_sink_flush(cases, tag, big, tail, ring_ptr, skip, tail_len, r):
    """`sink_tail_flush` (#12) against its plain version on copies of the
    same ring planes: every byte EQUAL, the padding slots untouched."""
    mine = [p.clone() for p in big]
    ref = [p.clone() for p in big]
    qa.sink_tail_flush(*mine, *tail, ring_ptr, skip, tail_len, r)
    qa.sink_tail_flush_plain(*ref, *tail, ring_ptr, skip, tail_len, r)
    torch.cuda.synchronize()
    err = max(max_err(a, w) for a, w in zip(mine, ref))
    pad = max(max_err(a[:, :, :, r:], o[:, :, :, r:])
              for a, o in zip(mine, big))
    cases.append((tag, err, 0.0))
    cases.append((tag + "_padding", pad, 0.0))
    return err


def sink_rows(sinks, r):
    """Stream lengths of 8 rows at a window's start: empty, in the sink
    phase, a partly filled ring, a just-full ring, a wrapped ring whose
    write pointer sits 2 slots before the ring's end (the evicted range
    crosses it from the window's third step), two deeper wraps, and a row
    that stops after the first step."""
    return i32([0, min(2, sinks), sinks + 300, sinks + r,
                sinks + 3 * r + r - 2, sinks + r + 77, 5000, 777])


def evict_rows(sinks, r, pw):
    """Stream lengths of 8 rows whose in-flight tail (``evict_len`` of 41
    or more, a tail of 48 or 80) evicts whole pieces of ``pw`` slots: a
    full ring whose pointer sits on a piece's edge (the piece from it
    evicted whole), a pointer 2 slots before the ring's end (the evicted
    range wraps past it, the ring's first piece evicted whole), a pointer
    one piece in; an empty row (the tail alone), a row in the sink phase, a
    partly filled ring, a pointer inside a piece, and a row that stops
    after the first step."""
    return i32([sinks + r + 5 * pw, sinks + 3 * r - 2, sinks + r + pw, 0,
                min(2, sinks), sinks + 300, sinks + r + 7, 777])


def sink_cases(cases, dtype, rng):
    """#11 at B = 8 over the main path's ring (window 1024, 4 sinks: r =
    1020, TR = 1024, 256-wide tiles dealt as pieces of 64) with 4 and 1
    query heads per kv head, without sinks, and over r = 1050 (TR = 1056:
    96-wide tiles, pieces of 32); over both again with a longer in-flight
    tail (KT = 80 from slot 66, KT = 48 from slot 40) that evicts whole
    pieces, one of them past the ring's end; over a ring of TR = 90112,
    where the kernel forms the scores twice; #12 over the main ring and r
    = 50 (TR = 64) at KT = 16 and 48, pointers near the ring's end,
    sink-bound heads, empty and full tails; and over a ring of r = 90 (TR
    = 96) at the other widths of FLUSH_WIDTHS."""
    for sinks, r, g in ((4, 1020, HQ // HKV), (4, 1020, 1), (0, 1020, HQ // HKV),
                        (4, 1050, HQ // HKV)):
        tr = -(-r // 32) * 32
        ring = make_qplanes(rng, (2, 8, HKV), tr)
        sink = make_qplanes(rng, (2, 8, HKV), 32)
        compare_sink(cases, f"qsink_g{g}_s{sinks}_r{r}", dtype, ring, sink,
                     sink_rows(sinks, r), sinks, r, rng, g=g)
    for r, kt, start, g in ((1020, 80, 66, HQ // HKV), (1050, 48, 40, 1)):
        tr = -(-r // 32) * 32
        pw = qa.ring_piece_width(qa.ring_tile_width(tr))
        ring = make_qplanes(rng, (2, 8, HKV), tr)
        sink = make_qplanes(rng, (2, 8, HKV), 32)
        compare_sink(cases, f"qsink_evict_g{g}_r{r}_kt{kt}", dtype, ring,
                     sink, evict_rows(4, r, pw), 4, r, rng, g=g, kt=kt,
                     start=start)
    # The instance that forms the scores twice: a ring so wide (TR = 90112,
    # 1410 pieces a row) that at 4 query heads a kv head a block's scores
    # do not all fit its shared memory (its plan says so); two rows, a
    # wrapped and a partly filled ring.
    wide = 90112
    assert sink_plan(wide, KT, HQ // HKV)["scores_kept"] == 0
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**62)))
    ring = random_qplanes(gen, (2, 2, HKV), wide)
    sink = make_qplanes(rng, (2, 2, HKV), 32)
    r = wide - 4
    compare_sink(cases, f"qsink_g4_s4_r{r}", dtype, ring, sink,
                 i32([4 + 3 * r - 2, 4 + 70001]), 4, r, rng, steps=2)
    del ring
    for r in (1020, 50):
        tr = -(-r // 32) * 32
        for kt in (KT, 48):
            big = make_qplanes(rng, (2, 8, HKV), tr)
            tail = make_qplanes(rng, (2, 8, HKV), kt)
            compare_sink_flush(
                cases, f"qsflush_r{r}_kt{kt}", big, tail,
                i32([r - 3, r - 1, 0, 0, 17, r - kt, 5, 0]),
                i32([0, 0, 1, 3, 0, 0, kt, 0]),
                i32([kt, kt, kt, 4, 0, kt, kt, 9]), r)
    for hkv, d, kt in FLUSH_WIDTHS:
        r = 90                                   # TR = 96 (tail <= ring)
        big = make_qplanes(rng, (2, 8, hkv), 96, d)
        tail = make_qplanes(rng, (2, 8, hkv), kt, d)
        compare_sink_flush(
            cases, f"qsflush_h{hkv}_d{d}_kt{kt}", big, tail,
            i32([r - 3, r - 1, 0, 0, 17, r - kt, 5, 0]),
            i32([0, 0, 1, 3, 0, 0, kt, 0]),
            i32([kt, kt, kt, 4, 0, kt, kt, 9]), r)


def time_ms(fn, iters, flush):
    """Mean device milliseconds of what ``fn()`` enqueues, over ``iters``
    calls: CUDA events around each call, the L2 cache emptied of the call's
    data before each one by READING a 128 MB buffer (writing it, as this
    script did before, left up to 50 MB of dirty lines whose write-back, about
    15 µs, was charged to the timed call). The card first spins for a few
    milliseconds so that the host has enqueued the whole call before the
    start event is reached; without that, an idle card waits for the host and
    the events measure Python."""
    fn()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def sdpa(q, k, v, causal):
    """One library call on contiguous K/V: [B, H, S, D] layouts."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def bound(bytes_moved, flops, dtype):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ladder_pages(tokens):
    """Page-table width the engine gives rows of ``tokens`` cached tokens:
    the smallest rung of its default window ladder that covers them."""
    rung = next(w for w in window_ladder(EngineConfig().max_seq_len)
                if w >= tokens)
    return -(-rung // PS)


def dequantized(pool, table):
    """Contiguous ``[B, H, T, D]`` bf16 K and V of ``pool`` under ``table``
    (int8 pools dequantized) for the library yardstick."""
    if len(pool) == 4:
        k, ks, v, vs = pool
        kg = pa.gather_pages(k, table).to(torch.bfloat16) * pa.gather_scales(
            ks, table).to(torch.bfloat16)[..., None]
        vg = pa.gather_pages(v, table).to(torch.bfloat16) * pa.gather_scales(
            vs, table).to(torch.bfloat16)[..., None]
    else:
        kg, vg = pa.gather_pages(pool[0], table), pa.gather_pages(pool[1], table)
    return (kg.permute(0, 2, 1, 3).contiguous(),
            vg.permute(0, 2, 1, 3).contiguous())


def pool_bytes_per_slot(pool):
    """Bytes of one (slot, kv head) of K and V together, scales included."""
    if len(pool) == 4:
        return 2 * (D + 4)
    return 2 * D * pool[0].element_size()


def launches_a_call(fn):
    """Decode attention kernels (``ATTENTION_KERNELS``) that one call of
    ``fn`` launches, as the profiler counts them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if any(n in ev.key for n in ATTENTION_KERNELS))


def flush_launches(fn):
    """The device operations (kernels, copies) of one call of the flush
    ``fn`` and how many of them are ``tail_flush_kernel``, as the profiler
    counts them; it must be that one kernel alone. The profiler drops
    records at times, so a session that saw none is profiled again (three
    at most)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
        got = {"device_ops": sum(ev.count for ev in ops),
               "tail_flush_kernel": sum(ev.count for ev in ops
                                        if "tail_flush_kernel" in ev.key)}
        if got["device_ops"]:
            break
    assert got == {"device_ops": 1, "tail_flush_kernel": 1}, got
    return got


def time_attention(out, cases, rng, flush, width, pool):
    """The decode and the ragged kernel for ``pool`` at one shape each of
    the main path, bf16 queries: decode at B=8 over 2048 cached tokens a row,
    prefill of one 2048-token prompt, the page table as wide as the engine
    makes it for such rows."""
    dtype, esz = torch.bfloat16, 2
    pname, pkernel, pplain = paged_fns(pool)
    rname, rkernel, rplain = ragged_fns(pool)
    pages = pool[0].shape[0]
    per_slot = pool_bytes_per_slot(pool)
    kind = "int8 pages" if len(pool) == 4 else "bf16 pages"

    # decode: B = 8 and B = 1 (one row must fill the card as well); int8
    # pages' B = 1 draws from a generator of its own, so that the inputs of
    # everything timed after it stay as they were
    for b in (8, 1):
        kv = 2048
        gen = (np.random.default_rng(98) if b == 1 and len(pool) == 4
               else rng)
        table = make_table(gen, b, width, pages)
        q = normal(gen, (b, 1, HQ, D), dtype)
        lens = i32([kv] * b)
        kg, vg = dequantized(pool, table)
        qh = q.permute(0, 2, 1, 3).contiguous()
        live = b * kv
        bytes_moved = (live * HKV * per_slot          # K and V slots, once
                       + 2 * q.numel() * esz          # q in, out out
                       + 2 * b * HQ * 4               # m, l
                       + table.numel() * 4 + 2 * b * 4)
        flops = 4 * live * HQ * D
        bms, by = bound(bytes_moved, flops, dtype)
        entry = {
            "shape": f"B={b} kv={kv} table={width} Hq={HQ} Hkv={HKV} D={D} PS={PS} bf16 q, {kind}",
            "max_abs_err": compare_paged(
                cases, f"{pname}_timed_b{b}", dtype, q, pool, table, lens),
            "ms": time_ms(lambda: pkernel(q, *pool, table, lens), 20, flush),
            "plain_ms": time_ms(lambda: pplain(q, *pool, table, lens), 5, flush),
            "library_ms": time_ms(lambda: sdpa(qh, kg, vg, False), 20, flush),
            "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
            "launches_a_call": launches_a_call(
                lambda: pkernel(q, *pool, table, lens)),
        }
        if b == 8:
            out[pkernel.__name__] = entry
        else:
            out[pkernel.__name__]["at_b1"] = entry
        del kg, vg

    # prefill
    s = 2048
    table1 = make_table(rng, 1, width, pages)
    q = normal(rng, (1, s, HQ, D), dtype)
    lens1, new1 = i32([s]), i32([s])
    kg, vg = dequantized(pool, table1)
    qh = q.permute(0, 2, 1, 3).contiguous()
    visible = s * (s + 1) // 2                    # causal (query, slot) pairs
    bytes_moved = (s * HKV * per_slot + 2 * q.numel() * esz
                   + table1.numel() * 4 + 3 * 4)
    flops = 4 * visible * HQ * D
    bms, by = bound(bytes_moved, flops, dtype)
    out[rkernel.__name__] = {
        "shape": f"B=1 S={s} table={width} Hq={HQ} Hkv={HKV} D={D} PS={PS} bf16 q, {kind}",
        "max_abs_err": compare_ragged(
            cases, f"{rname}_timed", dtype, q, pool, table1, lens1, new1),
        "ms": time_ms(lambda: rkernel(q, *pool, table1, lens1, new1), 5, flush),
        "plain_ms": time_ms(
            lambda: rplain(q, *pool, table1, lens1, new1), 3, flush),
        "library_ms": time_ms(lambda: sdpa(qh, kg, vg, True), 10, flush),
        "bound_ms": bms, "bound_by": by, "flops": flops,
    }


def int4_bound(rows, ind, outd):
    """Bytes and operations of one int4 matmul: the packed weight rows that
    hold x's inputs, the f32 scales, x in and the output out, bf16."""
    outp = -(-outd // 1024) * 512
    bytes_moved = ind * outp + 2 * outp * 4 + rows * (ind + outd) * 2
    return bytes_moved, 2 * rows * ind * outd


def dequantized_weight(w, layer):
    """The bf16 weight an int4 one stands for, for the yardstick."""
    full = qm.unpack_int4_split(w.q[layer])[: w.in_dim].float()
    sc = torch.cat([w.scale_lo[layer], w.scale_hi[layer]], dim=-1)
    return (full * sc)[:, : w.out_dim].to(torch.bfloat16).contiguous()


def time_int4(out, cases, flush):
    """The int4 matmuls at decode: `int4_matmul_stacked` over one layer's
    seven projections (8 rows, a stack of 2 layers, layer 1), each timed too,
    and `int4_matmul` over the 128256-wide head; then both again at 1 and 64
    rows (inputs of their own). No single PyTorch call computes a
    half-split int4 product; a bf16 `torch.matmul` on the dequantized
    weight is timed as a yardstick of its own, per projection."""
    dtype = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=DEV).manual_seed(7)
    stacks = {name: int4_weight(gen, (2, ind, outd))
              for name, (ind, outd) in PROJECTIONS.items()}
    xs = {8: {n: torch.randn((8, n), generator=gen, device=DEV).to(dtype)
              for n in (4096, 14336)}}
    other = torch.Generator(device=DEV).manual_seed(8)
    for rows in (1, 64):
        xs[rows] = {n: torch.randn((rows, n), generator=other,
                                   device=DEV).to(dtype)
                    for n in (4096, 14336)}

    def projections(rows):
        per, total = {}, {"bytes": 0, "flops": 0}
        for name, (ind, outd) in PROJECTIONS.items():
            w, x = stacks[name], xs[rows][ind]
            args = (x, w.q, w.scale_lo, w.scale_hi, 1, w.out_dim)
            err = compare_int4(cases, f"timed_{name}_r{rows}_l1", dtype, x, w, 1)
            bytes_moved, flops = int4_bound(rows, ind, outd)
            total["bytes"] += bytes_moved
            total["flops"] += flops
            wd = dequantized_weight(w, 1)
            per[name] = {
                "shape": f"rows={rows} {ind}x{outd}",
                "max_rel_err": err,
                "ms": time_ms(lambda: qm.int4_matmul_stacked(*args), 20, flush),
                "bound_ms": bound(bytes_moved, flops, dtype)[0],
                "dequantized_bf16_matmul_ms": time_ms(lambda: x @ wd, 20,
                                                      flush),
                "plan": qm.mma_plan(sms, rows, ind, w.q.shape[-1]),
            }
            del wd

        def layer(fn):
            return lambda: [fn(xs[rows][PROJECTIONS[n][0]], stacks[n].q,
                               stacks[n].scale_lo, stacks[n].scale_hi, 1,
                               stacks[n].out_dim) for n in PROJECTIONS]

        bms, by = bound(total["bytes"], total["flops"], dtype)
        return {
            "shape": f"rows={rows}, one layer's 7 projections of Llama-3-8B (wq, wk, wv, wo, wg, wu, wd), bf16 x",
            "max_abs_err": max(p["max_rel_err"] for p in per.values()),
            "error_is": "relative to max |out|",
            "ms": time_ms(layer(qm.int4_matmul_stacked), 20, flush),
            "plain_ms": time_ms(layer(qm.int4_matmul_stacked_plain), 3, flush),
            "library_ms": None,
            "dequantized_bf16_matmul_ms": sum(
                p["dequantized_bf16_matmul_ms"] for p in per.values()),
            "bound_ms": bms, "bound_by": by, "bytes": total["bytes"],
            "per_projection": per,
        }

    out["int4_matmul_stacked"] = projections(8)
    out["int4_matmul_stacked"]["at_rows"] = {r: projections(r) for r in (1, 64)}
    del stacks

    ind, outd = HEAD
    w = int4_weight(gen, (1, ind, outd))
    wd = dequantized_weight(w, 0)

    def head(rows):
        x = xs[rows][ind]
        args = (x, w.q[0], w.scale_lo[0], w.scale_hi[0], w.out_dim)
        bytes_moved, flops = int4_bound(rows, ind, outd)
        bms, by = bound(bytes_moved, flops, dtype)
        tag = "timed_head" if rows == 8 else f"timed_head_r{rows}"
        return {
            "shape": f"rows={rows} {ind}x{outd} (the lm_head), bf16 x",
            "max_abs_err": compare_int4(cases, tag, dtype, x, w),
            "error_is": "relative to max |out|",
            "ms": time_ms(lambda: qm.int4_matmul(*args), 20, flush),
            "plain_ms": time_ms(lambda: qm.int4_matmul_plain(*args), 3, flush),
            "library_ms": None,
            "dequantized_bf16_matmul_ms": time_ms(lambda: x @ wd, 20, flush),
            "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
            "plan": qm.mma_plan(sms, rows, ind, w.q.shape[-1]),
        }

    out["int4_matmul"] = head(8)
    out["int4_matmul"]["at_rows"] = {r: head(r) for r in (1, 64)}
    del wd


def fused_bytes(b, big_slots, tail_slots, g=HQ // HKV, esz=2):
    """Bytes one fused step must move: the live big-segment and tail slots
    (int8 K and V, two f32 scales a (slot, head)), the new slot written,
    q, k_new, v_new in and the output out, the per-row vectors."""
    per_slot = HKV * (2 * D + 8)
    return ((big_slots + tail_slots + b) * per_slot
            + (2 * HKV * g + 2 * HKV) * b * D * esz + 4 * b * 4 + 4)


def time_fused(out, cases, rng, flush):
    """The fused window's kernels at the shapes of the main path, bf16
    queries, B = 8, KT = 16, at the window's last step (the tail full):
    #6 over 2048 tokens a row (2032 in the pool), the table as wide as the
    engine makes it; #9 over gathered stacks of T = 640 (624 + 16), the
    widest capacity below INPLACE_CTX that the ladder reaches at page size
    64; #7 flushing one full window of all 32 layers, every row's window
    straddling a page. Library yardsticks: `scaled_dot_product_attention`
    on the dequantized, pre-gathered K/V of pool (or stacks) and tail; for
    #7 four `index_put_` calls (one per plane) of the same slots."""
    dtype, b = torch.bfloat16, 8
    q = normal(rng, (b, 1, HQ, D), dtype)
    kn = normal(rng, (b, 1, HKV, D), dtype)
    vn = normal(rng, (b, 1, HKV, D), dtype)
    qh = q.permute(0, 2, 1, 3).contiguous()

    def tail_kv(tail):
        k, ks, v, vs = (t[1] for t in tail)          # layer 1, [B, H, KT(, D)]
        return (k.to(dtype) * ks.to(dtype)[..., None],
                v.to(dtype) * vs.to(dtype)[..., None])

    for form, kv in (("inplace", 2048), ("gathered", 640), ("dense", 2048)):
        name, kernel, plain = fused_fns("gathered" if form == "dense" else form)
        base_len = kv - KT
        if form == "inplace":
            width = ladder_pages(kv)
            pages = b * width + 1
            big = make_qplanes(rng, (2, pages, HKV), PS)
            table = make_table(rng, b, width, pages)
            extra = {"page_table": table}
            kg, vg = dequantized([p[1] for p in big], table)
            kg, vg = kg[:, :, :base_len], vg[:, :, :base_len]
            shape = f"B={b} kv={kv} (pool {base_len} + tail {KT}) table={width} Hq={HQ} Hkv={HKV} D={D} PS={PS} KT={KT} bf16 q, int8 pages"
        else:
            big = make_qplanes(rng, (2, b, HKV), kv)
            extra = {}
            kg = big[0][1][:, :, :base_len].to(dtype) * big[1][1][:, :, :base_len].to(dtype)[..., None]
            vg = big[2][1][:, :, :base_len].to(dtype) * big[3][1][:, :, :base_len].to(dtype)[..., None]
            what = ("the int8 dense cache's own buffers" if form == "dense"
                    else "int8 stacks")
            shape = f"B={b} T={kv} (stacks {base_len} + tail {KT}) Hq={HQ} Hkv={HKV} D={D} KT={KT} bf16 q, {what}"
        tail = make_qplanes(rng, (2, b, HKV), KT)
        tk, tv = tail_kv(tail)
        kfull = torch.cat([kg, tk], dim=2).contiguous()
        vfull = torch.cat([vg, tv], dim=2).contiguous()
        kw = dict(layer_idx=1, step_idx=i32([KT - 1]), base_len=i32([base_len] * b),
                  tail_valid_len=i32([KT] * b), q_positions=i32([kv - 1] * b),
                  **extra)
        tail2 = [t.clone() for t in tail]
        got = kernel(q, kn, vn, *big, *tail, **kw)[0]
        want = plain(q, kn, vn, *big, *tail2, **kw)[0]
        torch.cuda.synchronize()
        err = max_err(got, want)
        cases.append((f"{name}_timed_{form}", err, TOL[dtype]))
        cases.append((f"{name}_timed_{form}_tail_bytes", max(
            max_err(a, w) for a, w in zip(tail, tail2)), 0.0))
        bytes_moved = fused_bytes(b, b * base_len, b * (KT - 1))
        if form == "inplace":
            bytes_moved += table.numel() * 4
        bms, by = bound(bytes_moved, 4 * b * kv * HQ * D, dtype)
        entry = {
            "shape": shape, "max_abs_err": err,
            "ms": time_ms(lambda: kernel(q, kn, vn, *big, *tail, **kw), 20, flush),
            "plain_ms": time_ms(lambda: plain(q, kn, vn, *big, *tail2, **kw), 3, flush),
            "library_ms": time_ms(lambda: sdpa(qh, kfull, vfull, False), 20, flush),
            "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
        }
        if form == "dense":
            # #9 at the int8 dense cache's shape, beside its T = 640 entry.
            out[kernel.__name__]["at_dense_shape"] = entry
        else:
            out[kernel.__name__] = entry
        del big, kg, vg, kfull, vfull

    # #7: one window of all 32 layers.
    layers = LLAMA3_8B.num_layers
    base_len = 2040                        # positions 2040..2055: two pages
    width = ladder_pages(base_len + KT)
    pages = b * width + 1
    pool = make_qplanes(rng, (layers, pages, HKV), PS)
    table = make_table(rng, b, width, pages)
    tail = make_qplanes(rng, (layers, b, HKV), KT)
    base, tl = i32([base_len] * b), i32([KT] * b)
    ref = [p.clone() for p in pool]
    pa.paged_tail_flush(*pool, *tail, table, base, tl)
    pa.paged_tail_flush_plain(*ref, *tail, table, base, tl)
    torch.cuda.synchronize()
    err = max(max_err(a, w) for a, w in zip(pool, ref))
    cases.append(("flush_timed", err, 0.0))
    del ref
    rows, slots, pg, offs = pa._flush_targets(pool[0], table, base, tl, KT)

    def index_put():
        for dst, src in zip(pool, tail):
            dst[:, pg, :, offs] = src[:, rows, :, slots]

    bytes_moved = 2 * layers * b * HKV * KT * (2 * D + 8) + table.numel() * 4 + 2 * b * 4
    bms, by = bound(bytes_moved, 0, dtype)
    out["paged_tail_flush"] = {
        "shape": f"L={layers} B={b} KT={KT} (each row's window over two pages) Hkv={HKV} D={D} PS={PS}, int8 + f32 scales",
        "max_abs_err": err,
        "ms": time_ms(lambda: pa.paged_tail_flush(*pool, *tail, table, base, tl), 20, flush),
        "plain_ms": time_ms(lambda: pa.paged_tail_flush_plain(*pool, *tail, table, base, tl), 3, flush),
        "library_ms": time_ms(index_put, 20, flush),
        "library": "index_put_ x4 (one per plane) of the same slots",
        "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
        "launches_a_call": flush_launches(
            lambda: pa.paged_tail_flush(*pool, *tail, table, base, tl)),
    }
    del pool, tail


def time_dense(out, cases, rng, flush):
    """The dense caches' kernels at the shapes of the main path, bf16: #3
    over one 2048-token causal prefill into a 2048-wide buffer; #8 at B = 8
    over 2048 live positions a row; #10 flushing one window (KT = 16) of
    all 32 layers at B = 8 into buffers 2400 wide (the ladder's rung for
    such rows), every row's window at position 2040 (across a 32-position
    and a 128-position boundary). Library yardsticks:
    `scaled_dot_product_attention` with the same boolean mask (#3), on the
    dequantized contiguous K/V (#8); four `index_put_` calls (#10)."""
    dtype, esz = torch.bfloat16, 2

    # #3
    s = t = 2048
    q = normal(rng, (1, s, HQ, D), dtype)
    k = normal(rng, (1, t, HKV, D), dtype)
    v = normal(rng, (1, t, HKV, D), dtype)
    mask = causal(1, s, t, [t], [0])
    err = compare_flash(cases, "flash_timed", dtype, q, k, v, mask)
    qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    visible = s * (s + 1) // 2
    flops = 4 * visible * HQ * D
    bytes_moved = (2 * q.numel() + 2 * k.numel()) * esz + mask.numel()
    bms, by = bound(bytes_moved, flops, dtype)
    out["flash_attention"] = {
        "shape": f"B=1 S={s} T={t} Hq={HQ} Hkv={HKV} D={D} bf16, causal mask",
        "max_abs_err": err,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, mask), 10, flush),
        "plain_ms": time_ms(
            lambda: fa.flash_attention_plain(q, k, v, mask), 3, flush),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask[:, None], enable_gqa=True), 10, flush),
        "bound_ms": bms, "bound_by": by, "flops": flops,
        "bound_counts": "the causal lower triangle with its diagonal: "
                        "S (S + 1) / 2 visible (query, position) pairs",
    }
    del q, k, v, qh, kh, vh, mask
    # The int8 dense cache's prefill dispatch: S = 2048 into a T = 4096
    # buffer, K/V the time-major views of its dequantized head-major copy.
    t = 4096
    q = normal(rng, (1, s, HQ, D), dtype)
    k = normal(rng, (1, HKV, t, D), dtype).transpose(1, 2)
    v = normal(rng, (1, HKV, t, D), dtype).transpose(1, 2)
    mask = causal(1, s, t, [s], [0])
    err = compare_flash(cases, "flash_timed_t4096", dtype, q, k, v, mask)
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    bytes_moved = (2 * q.numel() + 2 * s * HKV * D) * esz + mask.numel()
    bms, by = bound(bytes_moved, flops, dtype)
    out["flash_attention"]["at_path_shape"] = {
        "shape": f"B=1 S={s} T={t} Hq={HQ} Hkv={HKV} D={D} bf16, causal mask "
                 "over the first 2048 positions, head-major K/V",
        "max_abs_err": err,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, mask), 10, flush),
        "plain_ms": time_ms(
            lambda: fa.flash_attention_plain(q, k, v, mask), 3, flush),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask[:, None], enable_gqa=True), 10, flush),
        "bound_ms": bms, "bound_by": by, "flops": flops,
        "bound_counts": "the same visible pairs; K/V bytes of the 2048 "
                        "positions the mask reaches",
    }
    del q, k, v, qh, kh, vh, mask

    # #8, at B = 8 and B = 1 (from a generator of its own, as above)
    t = 2048
    for b in (8, 1):
        gen = np.random.default_rng(97) if b == 1 else rng
        planes = make_qplanes(gen, (b, HKV), t)
        q = normal(gen, (b, 1, HQ, D), dtype)
        lens = i32([t] * b)
        err = compare_qdense(cases, "qdense_timed" if b == 8
                             else "qdense_timed_b1", dtype, q, planes, lens)
        kd = (planes[0].to(dtype) * planes[1].to(dtype)[..., None]).contiguous()
        vd = (planes[2].to(dtype) * planes[3].to(dtype)[..., None]).contiguous()
        qh = q.permute(0, 2, 1, 3).contiguous()
        bytes_moved = (b * HKV * t * (2 * D + 8) + 2 * q.numel() * esz
                       + 2 * b * 4)
        bms, by = bound(bytes_moved, 4 * b * t * HQ * D, dtype)
        entry = {
            "shape": f"B={b} T={t} (all live) Hq={HQ} Hkv={HKV} D={D} bf16 q, int8 head-major buffer",
            "max_abs_err": err,
            "ms": time_ms(lambda: qa.quantized_decode_attention(q, *planes, lens), 20, flush),
            "plain_ms": time_ms(
                lambda: qa.quantized_decode_attention_plain(q, *planes, lens), 5, flush),
            "library_ms": time_ms(lambda: sdpa(qh, kd, vd, False), 20, flush),
            "library": "scaled_dot_product_attention on the dequantized contiguous K/V",
            "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
            "launches_a_call": launches_a_call(
                lambda: qa.quantized_decode_attention(q, *planes, lens)),
        }
        if b == 8:
            out["quantized_decode_attention"] = entry
        else:
            out["quantized_decode_attention"]["at_b1"] = entry
        del planes, kd, vd
    b = 8

    # #10
    layers, base_len = LLAMA3_8B.num_layers, 2040
    big = make_qplanes(rng, (layers, b, HKV), 2400)
    tail = make_qplanes(rng, (layers, b, HKV), KT)
    base, tl = i32([base_len] * b), i32([KT] * b)
    err = compare_qflush(cases, "qflush_timed", big, tail, base, tl)
    rows, slots, pos = qa._flush_targets(big[0].shape[3], base, tl, KT)

    def index_put():
        for dst, src in zip(big, tail):
            dst[:, rows, :, pos] = src[:, rows, :, slots]

    bytes_moved = 2 * layers * b * HKV * KT * (2 * D + 8) + 2 * b * 4
    bms, by = bound(bytes_moved, 0, dtype)
    out["fused_tail_flush"] = {
        "shape": f"L={layers} B={b} T=2400 KT={KT} (each row's window at 2040) Hkv={HKV} D={D}, int8 + f32 scales",
        "max_abs_err": err,
        "ms": time_ms(lambda: qa.fused_tail_flush(*big, *tail, base, tl), 20, flush),
        "plain_ms": time_ms(
            lambda: qa.fused_tail_flush_plain(*big, *tail, base, tl), 3, flush),
        "library_ms": time_ms(index_put, 20, flush),
        "library": "index_put_ x4 (one per plane) of the same slots",
        "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
        "launches_a_call": flush_launches(
            lambda: qa.fused_tail_flush(*big, *tail, base, tl)),
    }
    del big, tail


def time_sink(out, cases, rng, flush):
    """The int8 sink ring's kernels at the main path's shape, bf16: B = 8,
    window 1024 with 4 sinks (r = 1020, TR = 1024), KT = 16, mid-stream
    (every row's window starts at window + 7 = 1031 tokens, so the ring is
    full and every step evicts), at the window's last step (the tail
    full). #11
    reads what this run's data needs: the 1004 live ring slots (1020 less
    the 16 the tail has evicted), 4 sinks and 16 tail slots a (row, kv
    head); no single PyTorch call computes it (two queries, one for the
    sinks). #12 flushes one full window of all 32 layers into that ring,
    every row's window across the ring's end; its library yardstick is four
    `index_put_` calls of the same slots, as for #7 and #10."""
    dtype, esz, b, sinks, r, tr = torch.bfloat16, 2, 8, 4, 1020, 1024
    ring = make_qplanes(rng, (2, b, HKV), tr)
    sink = make_qplanes(rng, (2, b, HKV), 32)
    tail = make_qplanes(rng, (2, b, HKV), KT)
    tail2 = [t.clone() for t in tail]
    q, qs = (normal(rng, (b, 1, HQ, D), dtype) for _ in range(2))
    kn, vn = (normal(rng, (b, 1, HKV, D), dtype) for _ in range(2))
    base = i32([1031] * b)
    kw = dict(layer_idx=1, step_idx=i32([KT - 1]), ring_slots=r,
              **sink_scalars(base, i32([KT - 1] * b), i32([1] * b), sinks, r))
    got = qa.sink_fused_decode_attention(q, qs, kn, vn, *ring, *sink, *tail, **kw)[0]
    want = qa.sink_fused_decode_attention_plain(q, qs, kn, vn, *ring, *sink,
                                                *tail2, **kw)[0]
    torch.cuda.synchronize()
    err = max_err(got, want)
    cases.append(("qsink_timed", err, TOL[dtype]))
    cases.append(("qsink_timed_tail_bytes", max(
        max_err(a, w) for a, w in zip(tail, tail2)), 0.0))
    live = r - KT + sinks + KT                     # ring, sinks, tail a row
    per_slot = HKV * (2 * D + 8)
    bytes_moved = ((b * live + b) * per_slot + (3 * HQ + 2 * HKV) * b * D * esz
                   + 5 * b * 4 + 4)
    bms, by = bound(bytes_moved, 4 * b * live * HQ * D, dtype)
    out["sink_fused_decode_attention"] = {
        "shape": f"B={b} window=1024 sinks={sinks} (ring {r} in TR={tr}, tiles {qa.ring_tile_width(tr)}; live {r - KT} ring + {sinks} sinks + {KT} tail) Hq={HQ} Hkv={HKV} D={D} KT={KT} bf16 q, int8 planes",
        "max_abs_err": err,
        "ms": time_ms(lambda: qa.sink_fused_decode_attention(
            q, qs, kn, vn, *ring, *sink, *tail, **kw), 20, flush),
        "plain_ms": time_ms(lambda: qa.sink_fused_decode_attention_plain(
            q, qs, kn, vn, *ring, *sink, *tail2, **kw), 3, flush),
        "library_ms": None,
        "library": "none: no single PyTorch call computes one softmax over "
                   "segments scored with two different queries",
        "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
        "bound_counts": "the live slots only (what this run's data needs)",
    }
    del ring, sink, tail, tail2

    layers = LLAMA3_8B.num_layers
    big = make_qplanes(rng, (layers, b, HKV), tr)
    tail = make_qplanes(rng, (layers, b, HKV), KT)
    ptr, skip, tl = i32([r - 7] * b), i32([0] * b), i32([KT] * b)
    err = compare_sink_flush(cases, "qsflush_timed", big, tail, ptr, skip, tl, r)
    rows, slots, pos = qa._sink_flush_targets(ptr, skip, tl, KT, r)

    def index_put():
        for dst, src in zip(big, tail):
            dst[:, rows, :, pos] = src[:, rows, :, slots]

    bytes_moved = 2 * layers * b * HKV * KT * (2 * D + 8) + 3 * b * 4
    bms, by = bound(bytes_moved, 0, dtype)
    out["sink_tail_flush"] = {
        "shape": f"L={layers} B={b} TR={tr} r={r} KT={KT} (each row's window from slot {r - 7}, across the ring's end) Hkv={HKV} D={D}, int8 + f32 scales",
        "max_abs_err": err,
        "ms": time_ms(lambda: qa.sink_tail_flush(*big, *tail, ptr, skip, tl, r),
                      20, flush),
        "plain_ms": time_ms(lambda: qa.sink_tail_flush_plain(
            *big, *tail, ptr, skip, tl, r), 3, flush),
        "library_ms": time_ms(index_put, 20, flush),
        "library": "index_put_ x4 (one per plane) of the same slots",
        "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
        "launches_a_call": flush_launches(
            lambda: qa.sink_tail_flush(*big, *tail, ptr, skip, tl, r)),
    }
    del big, tail


# ---------------------------------------------------------------------------
# phase 2, the head widths: every attention kernel at 1 to 8 query heads a
# kv head, head_dim 64 and 128
# ---------------------------------------------------------------------------

# Every (G, D) the attention kernels take. The published groupings are
# among them: at D = 128, G = 3 (Llama-3.2-3B), 5 (Qwen2.5-14B), 6
# (Qwen2.5-1.5B), 7 (Qwen2.5-7B), 8 (Llama-3-70B); at D = 64, G = 4
# (Llama-3.2-1B), 7 (Qwen2.5-0.5B), 8 (TinyLlama); G = 2 is the JAX
# package's tests' 4 query heads over 2.
WIDTHS = [(g, d) for d in (128, 64) for g in range(1, 9)]
# The widths the kernels are timed at beside Llama-3-8B's: (label, kv
# heads, G, D).
WIDTH_SHAPES = (("qwen2.5-7b", 4, 7, 128), ("llama-3-70b", 8, 8, 128),
                ("llama-3.2-1b", 8, 4, 64))
# The ragged kernels' rows at the widths: a prompt, a chunk of 129 queries
# from position 300, a decode token, an empty row.
WIDTH_RAGGED = {"q_start": [0, 300, 990, 0], "num_new": [300, 129, 1, 0],
                "kv_len": [300, 429, 991, 0]}


def width_cases(cases, dtype, rng):
    """Every attention kernel at every (G, D) of ``WIDTHS`` over 2 kv heads,
    pages of 16, 48 and 128 in turn: #2 and #5 (B = 8: an empty row, one
    position, rows at and across a page's edge, long rows; no window, then
    a window of 37 with the query past the cache or of 300), #1 and #4 (the
    rows of ``WIDTH_RAGGED``, no window and 77), #3 (S = 256 over T = 384,
    a mask family of ``flash_masks`` in turn, and a causal window),
    #8 (T = 200, a window), #6 and #9 (four steps of a window: an empty
    row, page and piece edges; a window of 37 every other width), #11 (the
    main path's ring, 4 sinks); the three flushes (#7, #10, #12) at each
    head_dim. Each case's name carries its ``g{G}_d{D}``."""
    hkv, b = 2, 8
    masks = None
    for i, (g, d) in enumerate(WIDTHS):
        ps = (16, 48, 128)[i % 3]
        tag = f"w_g{g}_d{d}_ps{ps}"
        lens = [0, 1, ps - 1, ps, ps + 1, 300, 700, 1000]
        width = -(-(max(lens) + KT) // ps) + 1
        pages = b * width + 1
        table = make_table(rng, b, width, pages)
        kv = i32(lens)
        q = normal(rng, (b, 1, hkv * g, d), dtype)
        window, qpos = ((37, i32([n + 7 for n in lens])) if g % 2
                        else (300, None))
        rows = {k: i32(v) for k, v in WIDTH_RAGGED.items()}
        qr = normal(rng, (4, max(WIDTH_RAGGED["num_new"]), hkv * g, d), dtype)
        for pool in (make_pool(rng, pages, dtype, hkv, ps, d),
                     make_qpool(rng, pages, hkv, ps, d)):
            pname, rname = paged_fns(pool)[0], ragged_fns(pool)[0]
            for w, qp in ((None, None), (window, qpos)):
                compare_paged(cases, f"{pname}_{tag}_window_{w}", dtype, q,
                              pool, table, kv, sliding_window=w,
                              q_positions=qp)
            for w in (None, 77):
                compare_ragged(cases, f"{rname}_{tag}_window_{w}", dtype, qr,
                               pool, table[:4], rows["kv_len"],
                               rows["num_new"], q_start=rows["q_start"],
                               sliding_window=w)
            del pool
        # #3
        s, t = 256, 384
        qf = normal(rng, (2, s, hkv * g, d), dtype)
        kf, vf = (normal(rng, (2, t, hkv, d), dtype) for _ in range(2))
        if masks is None:
            masks = list(flash_masks(2, s, t, rng).items())
        name, mask = masks[i % len(masks)]
        compare_flash(cases, f"flash_{tag}_{name}", dtype, qf, kf, vf, mask)
        compare_flash(cases, f"flash_{tag}_window", dtype, qf, kf, vf,
                      causal(2, s, t, [t, 200], [t - s, 0], 100))
        # #8
        td = 200
        planes = make_qplanes(rng, (b, hkv), td, d)
        dl = [0, 1, td // 2 + 3, td - 1, 33, td, td // 3, td]
        compare_qdense(cases, f"qdense_{tag}_window_{window}", dtype,
                       normal(rng, (b, 1, hkv * g, d), dtype), planes, i32(dl),
                       sliding_window=window,
                       q_positions=i32([n + 7 for n in dl]) if g % 2 else None)
        # #6, #9
        fw = 37 if g % 2 else None
        pool = make_qplanes(rng, (2, pages, hkv), ps, d)
        compare_fused(cases, f"qfusedp_{tag}_window_{fw}", dtype, "inplace",
                      pool, i32([0, 1, ps - 1, ps, ps + 1, 300, 600, 900]),
                      rng, table=table, window=fw, g=g, hkv=hkv, d=d,
                      dead=(0,))
        stacks = make_qplanes(rng, (2, b, hkv), 640, d)
        compare_fused(cases, f"qfusedd_{tag}_window_{fw}", dtype, "gathered",
                      stacks, i32([0, 1, 63, 64, 65, 300, 600, 624]), rng,
                      window=fw, g=g, hkv=hkv, d=d, dead=(0,))
        # #11
        ring = make_qplanes(rng, (2, b, hkv), 1024, d)
        sink = make_qplanes(rng, (2, b, hkv), 32, d)
        compare_sink(cases, f"qsink_{tag}", dtype, ring, sink,
                     sink_rows(4, 1020), 4, 1020, rng, g=g, hkv=hkv, d=d)
        if g == 1:
            # The flushes take no query: one check at each head_dim.
            compare_flush(cases, f"flush_{tag}", pool, table,
                          i32([0, 1, ps - 1, ps, 60, 300, 600, 900]),
                          i32([KT, 3, KT, 0, KT, 9, KT, 1]), rng)
            compare_qflush(cases, f"qflush_{tag}", stacks,
                           make_qplanes(rng, (2, b, hkv), KT, d),
                           i32([0, 10, 30, 70, 630, 640 - KT, 640, 300]),
                           i32([KT, KT, 0, 10, KT, KT, 3, 5]))
            compare_sink_flush(cases, f"qsflush_{tag}", ring,
                               make_qplanes(rng, (2, b, hkv), KT, d),
                               i32([1017, 1019, 0, 0, 17, 1020 - KT, 5, 0]),
                               i32([0, 0, 1, 3, 0, 0, KT, 0]),
                               i32([KT, KT, KT, 4, 0, KT, KT, 9]), 1020)
        del pool, stacks, ring, sink, planes


def widths_checked(names):
    """The (G, D) of the width cases among ``names``, as "G/D" labels."""
    got = set()
    for n in names:
        if "_w_g" in n:
            g, d = n.split("_w_g")[1].split("_")[:2]
            got.add((int(g), int(d[1:])))
    return [f"{g}/{d}" for g, d in sorted(got, key=lambda x: (x[1], x[0]))]


def time_widths(flush):
    """The attention kernels at the three widths of ``WIDTH_SHAPES``, bf16,
    at the main path's sizes (as :func:`time_attention`, :func:`time_dense`,
    :func:`time_fused`, :func:`time_sink` time them at Llama-3-8B's):
    decode #2, #5 at B = 8 over 2048 cached tokens (pages of 64), #8 over a
    2048-wide buffer, #6 over 2032 + 16 and #9 over 624 + 16, #11 over the
    1024-slot ring; prefill #1, #4 of one 2048-token prompt, #3 causal over
    S = T = 2048. Each kernel's output is held to its plain version on the
    same inputs first; beside its time, the plain version's, the library
    call's (SDPA on pre-gathered, dequantized K/V; none for #11) and the
    bound. Returns ``{kernel: {label: entry}}`` and the cases."""
    dtype, esz, b = torch.bfloat16, 2, 8
    rng = np.random.default_rng(96)
    out, cases = {}, []

    def put(kernel, label, entry):
        out.setdefault(kernel, {})[label] = entry

    for label, hkv, g, d in WIDTH_SHAPES:
        hq = hkv * g
        head = f"Hq={hq} Hkv={hkv} G={g} D={d}"
        width = ladder_pages(2048)
        pages = b * width + 1
        for pool in (make_pool(rng, pages, dtype, hkv, PS, d),
                     make_qpool(rng, pages, hkv, PS, d)):
            int8 = len(pool) == 4
            per_slot = 2 * (d + 4) if int8 else 2 * d * esz
            pname, pkernel, pplain = paged_fns(pool)
            rname, rkernel, rplain = ragged_fns(pool)
            table = make_table(rng, b, width, pages)
            q = normal(rng, (b, 1, hq, d), dtype)
            lens = i32([2048] * b)
            kg, vg = dequantized(pool, table)
            qh = q.permute(0, 2, 1, 3).contiguous()
            bytes_moved = (b * 2048 * hkv * per_slot + 2 * q.numel() * esz
                           + 2 * b * hq * 4 + table.numel() * 4 + 2 * b * 4)
            bms, by = bound(bytes_moved, 4 * b * 2048 * hq * d, dtype)
            put(pkernel.__name__, label, {
                "shape": f"B={b} kv=2048 table={width} {head} PS={PS}",
                "max_abs_err": compare_paged(cases, f"{pname}_wt_{label}",
                                             dtype, q, pool, table, lens),
                "ms": time_ms(lambda: pkernel(q, *pool, table, lens), 20, flush),
                "plain_ms": time_ms(lambda: pplain(q, *pool, table, lens), 3, flush),
                "library_ms": time_ms(lambda: sdpa(qh, kg, vg, False), 20, flush),
                "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
                "launches_a_call": launches_a_call(
                    lambda: pkernel(q, *pool, table, lens))})
            del kg, vg
            s = 2048
            table1 = table[:1].contiguous()
            q = normal(rng, (1, s, hq, d), dtype)
            one = i32([s])
            kg, vg = dequantized(pool, table1)
            qh = q.permute(0, 2, 1, 3).contiguous()
            flops = 4 * (s * (s + 1) // 2) * hq * d
            bytes_moved = (s * hkv * per_slot + 2 * q.numel() * esz
                           + table1.numel() * 4 + 3 * 4)
            bms, by = bound(bytes_moved, flops, dtype)
            put(rkernel.__name__, label, {
                "shape": f"B=1 S={s} table={width} {head} PS={PS}",
                "max_abs_err": compare_ragged(cases, f"{rname}_wt_{label}",
                                              dtype, q, pool, table1, one, one),
                "ms": time_ms(lambda: rkernel(q, *pool, table1, one, one), 5, flush),
                "plain_ms": time_ms(lambda: rplain(q, *pool, table1, one, one), 2, flush),
                "library_ms": time_ms(lambda: sdpa(qh, kg, vg, True), 10, flush),
                "bound_ms": bms, "bound_by": by, "flops": flops})
            del kg, vg, pool
        # #3
        s = t = 2048
        q = normal(rng, (1, s, hq, d), dtype)
        k, v = (normal(rng, (1, t, hkv, d), dtype) for _ in range(2))
        mask = causal(1, s, t, [t], [0])
        qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        flops = 4 * (s * (s + 1) // 2) * hq * d
        bytes_moved = (2 * q.numel() + 2 * k.numel()) * esz + mask.numel()
        bms, by = bound(bytes_moved, flops, dtype)
        put("flash_attention", label, {
            "shape": f"B=1 S={s} T={t} {head}, causal mask",
            "max_abs_err": compare_flash(cases, f"flash_wt_{label}", dtype,
                                         q, k, v, mask),
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, mask), 10, flush),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, mask), 2, flush),
            "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask[:, None], enable_gqa=True), 10, flush),
            "bound_ms": bms, "bound_by": by, "flops": flops})
        del q, k, v, qh, kh, vh, mask
        # #8
        planes = make_qplanes(rng, (b, hkv), 2048, d)
        q = normal(rng, (b, 1, hq, d), dtype)
        lens = i32([2048] * b)
        kd = (planes[0].to(dtype) * planes[1].to(dtype)[..., None]).contiguous()
        vd = (planes[2].to(dtype) * planes[3].to(dtype)[..., None]).contiguous()
        qh = q.permute(0, 2, 1, 3).contiguous()
        bytes_moved = b * hkv * 2048 * (2 * d + 8) + 2 * q.numel() * esz + 2 * b * 4
        bms, by = bound(bytes_moved, 4 * b * 2048 * hq * d, dtype)
        put("quantized_decode_attention", label, {
            "shape": f"B={b} T=2048 (all live) {head}",
            "max_abs_err": compare_qdense(cases, f"qdense_wt_{label}", dtype,
                                          q, planes, lens),
            "ms": time_ms(lambda: qa.quantized_decode_attention(q, *planes, lens), 20, flush),
            "plain_ms": time_ms(lambda: qa.quantized_decode_attention_plain(q, *planes, lens), 3, flush),
            "library_ms": time_ms(lambda: sdpa(qh, kd, vd, False), 20, flush),
            "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
            "launches_a_call": launches_a_call(
                lambda: qa.quantized_decode_attention(q, *planes, lens))})
        del planes, kd, vd
        # #6, #9 at the window's last step, the tail full
        q = normal(rng, (b, 1, hq, d), dtype)
        kn, vn = (normal(rng, (b, 1, hkv, d), dtype) for _ in range(2))
        qh = q.permute(0, 2, 1, 3).contiguous()
        for form, kvn in (("inplace", 2048), ("gathered", 640)):
            _, kernel, plain = fused_fns(form)
            base_len = kvn - KT
            if form == "inplace":
                big = make_qplanes(rng, (2, pages, hkv), PS, d)
                table = make_table(rng, b, width, pages)
                extra = {"page_table": table}
                kg, vg = dequantized([p[1] for p in big], table)
                kg, vg = kg[:, :, :base_len], vg[:, :, :base_len]
            else:
                big = make_qplanes(rng, (2, b, hkv), kvn, d)
                extra = {}
                kg = big[0][1][:, :, :base_len].to(dtype) * big[1][1][:, :, :base_len].to(dtype)[..., None]
                vg = big[2][1][:, :, :base_len].to(dtype) * big[3][1][:, :, :base_len].to(dtype)[..., None]
            tail = make_qplanes(rng, (2, b, hkv), KT, d)
            tk = tail[0][1].to(dtype) * tail[1][1].to(dtype)[..., None]
            tv = tail[2][1].to(dtype) * tail[3][1].to(dtype)[..., None]
            kfull = torch.cat([kg, tk], dim=2).contiguous()
            vfull = torch.cat([vg, tv], dim=2).contiguous()
            kw = dict(layer_idx=1, step_idx=i32([KT - 1]),
                      base_len=i32([base_len] * b), tail_valid_len=i32([KT] * b),
                      q_positions=i32([kvn - 1] * b), **extra)
            tail2 = [x.clone() for x in tail]
            got = kernel(q, kn, vn, *big, *tail, **kw)[0]
            want = plain(q, kn, vn, *big, *tail2, **kw)[0]
            torch.cuda.synchronize()
            err = max_err(got, want)
            prefix = "qfusedp" if form == "inplace" else "qfusedd"
            cases.append((f"{prefix}_wt_{label}", err, TOL[dtype]))
            cases.append((f"{prefix}_wt_{label}_tail_bytes", max(
                max_err(x, w) for x, w in zip(tail, tail2)), 0.0))
            bytes_moved = ((b * kvn) * hkv * (2 * d + 8)
                           + (2 * hq + 2 * hkv) * b * d * esz + 4 * b * 4 + 4)
            if form == "inplace":
                bytes_moved += table.numel() * 4
            bms, by = bound(bytes_moved, 4 * b * kvn * hq * d, dtype)
            put(kernel.__name__, label, {
                "shape": f"B={b} kv={kvn} ({base_len} + tail {KT}) {head}"
                         + (f" PS={PS}" if form == "inplace" else ""),
                "max_abs_err": err,
                "ms": time_ms(lambda: kernel(q, kn, vn, *big, *tail, **kw), 20, flush),
                "plain_ms": time_ms(lambda: plain(q, kn, vn, *big, *tail2, **kw), 2, flush),
                "library_ms": time_ms(lambda: sdpa(qh, kfull, vfull, False), 20, flush),
                "bound_ms": bms, "bound_by": by, "bytes": bytes_moved})
            del big, kg, vg, kfull, vfull, tail, tail2
        # #11
        sinks, r, tr = 4, 1020, 1024
        ring = make_qplanes(rng, (2, b, hkv), tr, d)
        sink = make_qplanes(rng, (2, b, hkv), 32, d)
        tail = make_qplanes(rng, (2, b, hkv), KT, d)
        tail2 = [x.clone() for x in tail]
        qs = normal(rng, (b, 1, hq, d), dtype)
        kw = dict(layer_idx=1, step_idx=i32([KT - 1]), ring_slots=r,
                  **sink_scalars(i32([1031] * b), i32([KT - 1] * b),
                                 i32([1] * b), sinks, r))
        got = qa.sink_fused_decode_attention(q, qs, kn, vn, *ring, *sink, *tail, **kw)[0]
        want = qa.sink_fused_decode_attention_plain(q, qs, kn, vn, *ring, *sink, *tail2, **kw)[0]
        torch.cuda.synchronize()
        err = max_err(got, want)
        cases.append((f"qsink_wt_{label}", err, TOL[dtype]))
        live = r - KT + sinks + KT
        bytes_moved = ((b * live + b) * hkv * (2 * d + 8)
                       + (3 * hq + 2 * hkv) * b * d * esz + 5 * b * 4 + 4)
        bms, by = bound(bytes_moved, 4 * b * live * hq * d, dtype)
        put("sink_fused_decode_attention", label, {
            "shape": f"B={b} window=1024 sinks={sinks} (live {r - KT} ring + {sinks} sinks + {KT} tail) {head}",
            "max_abs_err": err,
            "ms": time_ms(lambda: qa.sink_fused_decode_attention(
                q, qs, kn, vn, *ring, *sink, *tail, **kw), 20, flush),
            "plain_ms": time_ms(lambda: qa.sink_fused_decode_attention_plain(
                q, qs, kn, vn, *ring, *sink, *tail2, **kw), 2, flush),
            "library_ms": None,
            "bound_ms": bms, "bound_by": by, "bytes": bytes_moved})
        del ring, sink, tail, tail2
    assert_cases(cases, dtype)
    return out, cases


def timed_call_floor_ms(flush, iters=50):
    """What :func:`time_ms` reads for an empty kernel (PyTorch's spin
    kernel asked for 0 cycles) behind the same spin and L2 read: the fixed
    cost of a timed call, against which a kernel's gap to its bound is
    read."""
    return time_ms(lambda: torch.cuda._sleep(0), iters, flush)


def time_kernels():
    """Every kernel in bf16 at the shapes of the main path (see
    :func:`time_attention`, :func:`time_int4`). Each kernel's output is
    first held against the plain version's on these very inputs; that error
    is the one reported beside the times. Returns the times and the timed
    call's floor (:func:`timed_call_floor_ms`)."""
    rng = np.random.default_rng(99)
    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device=DEV)
    floor = timed_call_floor_ms(flush)
    width = ladder_pages(2048)
    pages = 9 * width + 1
    out, cases = {}, []
    time_attention(out, cases, rng, flush, width,
                   make_pool(rng, pages, torch.bfloat16))
    time_attention(out, cases, rng, flush, width, make_qpool(rng, pages))
    time_int4(out, cases, flush)
    time_fused(out, cases, rng, flush)
    time_dense(out, cases, rng, flush)
    time_sink(out, cases, rng, flush)
    assert_cases(cases, torch.bfloat16)
    return out, floor


# The flushes (one kernel template, csrc/tail_flush.cuh) -> their numbers.
FLUSH_NUMBERS = {"paged_tail_flush": "#7", "fused_tail_flush": "#10",
                 "sink_tail_flush": "#12"}

# Kernel name -> the prefix of its cases in phase 2.
CASE_PREFIX = {
    "paged_attention": "paged_", "ragged_paged_attention": "ragged_",
    "quantized_paged_attention": "qpaged_",
    "quantized_ragged_paged_attention": "qragged_",
    "int4_matmul": "int4_", "int4_matmul_stacked": "int4s_",
    "quantized_paged_fused_attention": "qfusedp_",
    "quantized_fused_decode_attention": "qfusedd_",
    "paged_tail_flush": "flush_",
    "flash_attention": "flash_",
    "quantized_decode_attention": "qdense_",
    "fused_tail_flush": "qflush_",
    "sink_fused_decode_attention": "qsink_",
    "sink_tail_flush": "qsflush_",
}


def ragged_instance(mangled):
    """``ragged_kernel_wgmma<D, int8 pages>`` -> its label, else None."""
    got = re.search(r"ragged_kernel_wgmmaILi(\d+)ELb([01])E", mangled)
    if got is None:
        return None
    return f"D={got[1]} {'int8' if got[2] == '1' else 'bf16'} pages"


def flash_instance(mangled):
    """``flash_kernel_wgmma<D>`` -> its label, else None."""
    got = re.search(r"flash_kernel_wgmmaILi(\d+)E", mangled)
    return None if got is None else f"D={got[1]}"


def cluster_instance(mangled):
    """``fused::fused_cluster_kernel<T, Policy, Gp, Keep, D>`` -> its
    label, else None."""
    if "fused_cluster_kernelI" not in mangled:
        return None
    q = "bf16" if "fused_cluster_kernelI13__nv_bfloat16" in mangled else "f32"
    got = re.search(r"ELi(\d+)ELb([01])ELi(\d+)E", mangled)
    keep = "scores kept" if got[2] == "1" else "K read twice"
    return f"Gp={got[1]} D={got[3]} {q} q, {keep}"


def flush_instance(mangled):
    """``flush::tail_flush_kernel<WORDS, Dest>`` (#7, #10, #12) -> its
    label, else None."""
    if "tail_flush_kernelILi" not in mangled:
        return None
    dest = next(d for d in ("PagedDest", "DenseDest", "RingDest")
                if d in mangled)
    return f"WORDS={mangled.split('tail_flush_kernelILi')[1][0]} {dest}"


def decode_instance(mangled):
    """``pdec::paged_decode_kernel<D, KV, Rows>`` -> its label, else None."""
    got = re.search(r"paged_decode_kernelILi(\d+)E(13__nv_bfloat16)?", mangled)
    if got is None:
        return None
    rows = "dense" if "DenseRows" in mangled else "pages"
    return f"D={got[1]} {'bf16' if got[2] else 'int8'} {rows}"


def walk_instance(mangled):
    """``decode::paged_partial_kernel<T, KV, D, Gp>`` (the f32 walk of #2,
    #5, #8) -> its label, else None."""
    got = re.search(r"paged_partial_kernelIf([af])Li(\d+)ELi(\d+)E", mangled)
    if got is None:
        return None
    return f"D={got[2]} Gp={got[3]} {'int8' if got[1] == 'a' else 'f32'} rows"


def int4_instance(mangled):
    """``int4_mma_kernel<NT>`` (bf16 x, NT n-tiles of 8 rows) -> its label,
    else None."""
    if "int4_mma_kernelILi" not in mangled:
        return None
    return f"NT={mangled.split('int4_mma_kernelILi')[1].split('E')[0]}"


def sass_counts(binary, label):
    """Instructions of each kernel instance that ``label`` names in the
    SASS of ``binary`` (a built library; ``cuobjdump -sass``):
    integer-to-float conversions (I2F, I2FP), tensor-core products (HMMA)
    and all."""
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(binary)], check=True,
                          capture_output=True, text=True).stdout
    got, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = label(line.split("Function :")[1].strip())
            if name:
                got[name] = {"I2F": 0, "HMMA": 0, "instructions": 0}
            continue
        op = line.split("*/", 1)[1].split(";")[0].split() if (
            name and line.strip().startswith("/*") and ";" in line) else []
        if op and op[0].startswith("@"):
            op = op[1:]
        if op:
            got[name]["instructions"] += 1
            got[name]["I2F"] += op[0].startswith("I2F")
            got[name]["HMMA"] += op[0].startswith("HMMA")
    return got


def int4_plans():
    """The bf16 int4 kernel's launch at Llama-3-8B's projections and the
    head and at ``WIDTH_PROJECTIONS``, 1, 8 and 64 rows: the wrapper's
    ``mma_plan`` and the C side's
    occupancy (``dli_int4_mma_occupancy``: shared memory a block, blocks an
    SM, clusters the card holds at once, registers, spills, x rows staged
    at once)."""
    fn = _build.load_library("int4_matmul").dli_int4_mma_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ("smem_bytes", "blocks_an_sm", "clusters_at_once", "registers",
            "spill_bytes", "x_rows_staged")
    plans = {}
    for name, (ind, outd) in [*PROJECTIONS.items(), ("head", HEAD),
                              *WIDTH_PROJECTIONS.items()]:
        if name in ("wv", "wu", "wo"):
            continue
        outp = -(-outd // 1024) * 512
        for rows in (1, 8, 64):
            plan = qm.mma_plan(sms, rows, ind, outp)
            got = (ctypes.c_longlong * 6)()
            assert fn(rows, plan["cluster"], plan["k_block"],
                      ctypes.addressof(got)) == 0
            plans[f"{name} rows={rows}"] = {**plan, **dict(zip(keys, got))}
    return plans


def ptxas_lines(out, label, count):
    """Registers, shared memory and spills from a build's ``-Xptxas -v``
    report ``out`` (``_build.ptxas_log``) of the ``count`` kernel instances
    that ``label`` names (mangled name -> label or None)."""
    report, name = {}, None
    for line in out.splitlines():
        if "Compiling entry function" in line:
            name = label(line.split("'")[1])
        elif name and ("Used" in line or "spill" in line):
            report.setdefault(name, []).append(
                line.split("info    :")[-1].strip())
    assert len(report) == count, report
    return report


PLAN_KEYS = ("cluster_blocks", "pieces_a_block", "ring_stages", "stage_bytes",
             "smem_bytes", "clusters_at_once", "scores_kept", "piece_width")


def cluster_plan(nt, w, g, d=D):
    """The fused step's cluster launch over the pool (#6,
    ``dli_fused_cluster_plan``) at a table of ``nt - 1`` pages, ``w``-slot
    tiles, ``g`` query heads a kv head and head_dim ``d``."""
    fn = _build.load_library("paged_attention").dli_fused_cluster_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    got = (ctypes.c_longlong * 7)()
    assert fn(nt, w, g, d, ctypes.addressof(got)) == 0
    return dict(zip(PLAN_KEYS, list(got)))


def dense_plan(t, g, d=D):
    """#9's cluster launch over stacks of ``t`` positions
    (``dli_fused_dense_plan``, tiles of min(256, t), KT = 16)."""
    fn = _build.load_library("quant_attention").dli_fused_dense_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    got = (ctypes.c_longlong * 8)()
    assert fn(t, min(256, t), KT, g, d, ctypes.addressof(got)) == 0
    return dict(zip(PLAN_KEYS, list(got)))


def sink_plan(tr, kt, g, d=D):
    """#11's cluster launch over a ring of ``tr`` slots (its tiles of
    ``ring_tile_width``, pieces of ``ring_piece_width``), 32 sink slots, a
    tail of ``kt`` (``dli_sink_cluster_plan``): the plan's values, the
    pieces a row may have and the widest piece."""
    fn = _build.load_library("sink_attention").dli_sink_cluster_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    got = (ctypes.c_longlong * 9)()
    tile = qa.ring_tile_width(tr)
    assert fn(tr, 32, kt, tile, qa.ring_piece_width(tile), g, d,
              ctypes.addressof(got)) == 0
    return dict(zip(PLAN_KEYS[:7] + ("pieces_a_row", "widest_piece"),
                    list(got)))


def decode_plan(int8, d, c):
    """The decode cluster kernel's occupancy (``dli_decode_occupancy``)
    over bf16 or int8 rows of head_dim ``d`` (any G), clusters of ``c``
    blocks: shared memory a block, blocks an SM, clusters at once."""
    fn = _build.load_library("paged_attention").dli_decode_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    got = (ctypes.c_longlong * 3)()
    assert fn(int(int8), d, c, ctypes.addressof(got)) == 0
    return dict(zip(("smem_bytes", "blocks_an_sm", "clusters_at_once"),
                    list(got)))


def check_launch_plans():
    """The C side's launch of the bf16 ragged kernels against the wrapper's
    ``launch_plan`` at the shapes phase 2 uses."""
    fn = _build.load_library("ragged_attention").dli_ragged_launch_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    got = (ctypes.c_longlong * 6)()
    plans = []
    for s, g, d, ps, q8 in (
            (2048, 4, D, 64, 0), (2048, 4, D, 64, 1), (640, 1, D, 48, 1),
            (640, 4, D, 12, 0), (256, 4, D, 16, 1), (640, 1, D, 128, 0),
            (2048, 7, 128, 64, 0), (2048, 8, 128, 64, 1), (300, 3, 128, 48, 0),
            (2048, 4, 64, 64, 0), (2048, 4, 64, 64, 1), (300, 7, 64, 16, 1),
            (640, 2, 64, 12, 0)):
        assert fn(s, g, d, ps, q8, ctypes.addressof(got)) == 0
        plan = ra.launch_plan(1, s, HKV, g, d, ps, 64, bool(q8))
        want = [plan["box_rows"], plan["tiles"], plan["threads"],
                plan["smem_bytes"], plan["stage_bytes"],
                plan["rows_per_query"]]
        assert list(got) == want, (s, g, d, ps, q8, list(got), want)
        plans.append({"S": s, "G": g, "D": d, "PS": ps, "int8": bool(q8),
                      **dict(zip(("box_rows", "tiles", "threads",
                                  "smem_bytes", "stage_bytes",
                                  "rows_per_query"), want))})
    return plans


def tensor_map_host_us(calls=200):
    """Host microseconds of one call of the ragged kernels' C entry point
    on a one-token row, bf16 (three tensor maps encoded, the wgmma kernel)
    and f32 (no maps, the FMA kernel), behind a device spin: their
    difference is what encoding the maps costs a launch."""
    fn = ra._kernel(False)
    stream = torch.cuda.current_stream().cuda_stream
    rows = i32([1])
    table = i32([[1]])
    got = {}
    for dtype, code in ((torch.bfloat16, 0), (torch.float32, 1)):
        k = torch.zeros((2, HKV, PS, D), dtype=dtype, device=DEV)
        q = torch.zeros((1, 1, HQ, D), dtype=dtype, device=DEV)
        out = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), k.data_ptr(), table.data_ptr(),
                rows.data_ptr(), i32([0]).data_ptr(), rows.data_ptr(),
                out.data_ptr(), 1, 1, HKV, HQ // HKV, D, PS, 1, 0.1, 0, code,
                stream)
        assert fn(*args) == 0
        torch.cuda.synchronize()
        torch.cuda._sleep(40 * SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        got[str(dtype).split(".")[1]] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    got["maps"] = got["bfloat16"] - got["float32"]
    return got


def phase_kernels():
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_log(name) for name in built}
    resources = {
        "ragged_kernel_wgmma": ptxas_lines(
            ptxas["ragged_attention"], ragged_instance, 4),
        "flash_kernel_wgmma": ptxas_lines(
            ptxas["flash_attention"], flash_instance, 2),
        "fused_cluster_kernel (pool, #6)": ptxas_lines(
            ptxas["paged_attention"], cluster_instance, 24),
        "fused_cluster_kernel (stacks, #9)": ptxas_lines(
            ptxas["quant_attention"], cluster_instance, 24),
        "fused_cluster_kernel (sink ring, #11)": ptxas_lines(
            ptxas["sink_attention"], cluster_instance, 24),
        "tail_flush_kernel (#7)": ptxas_lines(
            ptxas["paged_attention"], flush_instance, 1),
        "tail_flush_kernel (#10)": ptxas_lines(
            ptxas["quant_attention"], flush_instance, 1),
        "tail_flush_kernel (#12)": ptxas_lines(
            ptxas["sink_attention"], flush_instance, 1),
        "paged_decode_kernel (#2, #5)": ptxas_lines(
            ptxas["paged_attention"], decode_instance, 4),
        "paged_decode_kernel (#8)": ptxas_lines(
            ptxas["quant_attention"], decode_instance, 2),
        "paged_partial_kernel (f32 #2, #5)": ptxas_lines(
            ptxas["paged_attention"], walk_instance, 16),
        "paged_partial_kernel (f32 #8)": ptxas_lines(
            ptxas["quant_attention"], walk_instance, 16),
        "int4_mma_kernel (#13, #14, bf16 x)": ptxas_lines(
            ptxas["int4_matmul"], int4_instance, 4)}
    # The bf16 int4 kernel turns nibbles into bf16 by a bit trick: no
    # conversion instruction, products on the tensor cores.
    int4_sass = sass_counts(built["int4_matmul"], int4_instance)
    assert len(int4_sass) == 4 and all(
        c["I2F"] == 0 and c["HMMA"] > 0 for c in int4_sass.values()), int4_sass
    plans = check_launch_plans()
    width = ladder_pages(2048)
    fused_plan = {f"#6 table={width} PS={PS} KT={KT} G={g}": cluster_plan(
        width + 1, max(PS, KT), g) for g in (HQ // HKV, 1)}
    for t in (640, 2048, 4096, RECOMPUTE_T):
        for g in (HQ // HKV, 1):
            fused_plan[f"#9 T={t} KT={KT} G={g}"] = dense_plan(t, g)
    for tr, kt in ((1024, KT), (1056, 48), (1024, 80)):
        for g in (HQ // HKV, 1):
            fused_plan[f"#11 TR={tr} KT={kt} G={g}"] = sink_plan(tr, kt, g)
    for _, _, g, d in WIDTH_SHAPES:
        fused_plan[f"#6 table={width} PS={PS} KT={KT} G={g} D={d}"] = (
            cluster_plan(width + 1, max(PS, KT), g, d))
        fused_plan[f"#9 T=640 KT={KT} G={g} D={d}"] = dense_plan(640, g, d)
        fused_plan[f"#11 TR=1024 KT={KT} G={g} D={d}"] = sink_plan(
            1024, KT, g, d)
    decode_plans = {
        f"{'int8' if int8 else 'bf16'} D={d} C={c}": decode_plan(int8, d, c)
        for int8 in (False, True) for d in (128, 64) for c in (2, 4, 8)}
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 stays f32
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[dtype] = check_cases(dtype)
    times, floor = time_kernels()
    width_times, width_cases_timed = time_widths(
        torch.ones(16 * 1024 * 1024, dtype=torch.int64, device=DEV))
    for name, by_width in width_times.items():
        times[name]["at_widths"] = by_width
    errs[torch.bfloat16] += width_cases_timed
    # Each flush's registers and spills beside its time.
    for name, num in FLUSH_NUMBERS.items():
        (times[name]["ptxas"],) = resources[
            f"tail_flush_kernel ({num})"].values()
        times[name]["timed_call_floor_ms"] = floor
    map_us = tensor_map_host_us()
    kernels = []
    for name, prefix in CASE_PREFIX.items():
        entry = {"name": name}
        tol = (TOL4 if name.startswith("int4")
               else {t: 0.0 for t in TOL} if name.endswith("tail_flush")
               else TOL)
        for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            mine = [(n, e, t) for n, e, t in errs[dtype] if n.startswith(prefix)]
            entry[f"max_abs_err_{label}"] = max(
                e for n, e, t in mine if not n.endswith(("_m", "_l")))
            entry[f"tolerance_{label}"] = tol[dtype]
            entry[f"cases_{label}"] = {n: e for n, e, _ in mine}
            entry[f"widths_checked_{label}"] = widths_checked(
                n for n, _, _ in mine)
        entry["timed"] = times[name]
        kernels.append(entry)
    emit({"phase": "kernels", "build_s": build_s,
          "libraries": {k: str(p.name) for k, p in built.items()},
          "wgmma_and_cluster_ptxas": resources,
          "ragged_launch_plans": plans, "fused_cluster_plans": fused_plan,
          "decode_cluster_plans": decode_plans,
          "int4_mma_sass": int4_sass, "int4_mma_plans": int4_plans(),
          "ragged_c_call_host_us": map_us,
          "timed_call_floor_ms": floor,
          "checked": kernels})
    checked = {k["name"]: {"bf16": k["widths_checked_bf16"],
                           "f32": k["widths_checked_f32"]} for k in kernels}
    return times, floor, checked


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------

class Client:
    """A streaming client of the engine's public API: ``submit`` returns a
    generation id, every ``step`` yields ``(generation_id, token, finished)``
    events (token -1 = a finish without a new token), and
    ``collect_finished`` hands back the retired sessions."""

    def __init__(self, engine):
        self.engine = engine
        self.order = []      # generation ids by submission
        self.streams = {}    # generation id -> tokens streamed so far

    def submit(self, prompt, options):
        gid = self.engine.submit(prompt, options)
        self.order.append(gid)
        self.streams[gid] = []

    def step(self):
        for gid, token, _ in self.engine.step():
            if token >= 0:
                self.streams[gid].append(token)

    def drain(self):
        """Step until the engine is idle; the streamed tokens must be what
        the retired sessions recorded. Returns streams by submission order."""
        steps = 0
        while self.engine.has_work():
            self.step()
            steps += 1
            assert steps < 10_000, "engine did not drain"
        done = self.engine.collect_finished()
        assert set(done) == set(self.order), "a session was never retired"
        for gid in self.order:
            assert done[gid].generated == self.streams[gid], (
                "streamed events and the session's record differ")
        return [self.streams[gid] for gid in self.order]


def drive(engine, vocab, seed, short_lens, long_len, new_tokens, odd=None):
    """The smoke's traffic: `short_lens` greedy prompts at once (more than
    the batch; stream i asks for `odd[i]` new tokens where `odd` names it);
    as soon as stream 2 has its first token, it is cancelled and — while
    the others decode — one long greedy prompt (`long_len`, None for none)
    and two sampled ones arrive. Returns (streams by submission order,
    index of the cancelled stream)."""
    rng = np.random.default_rng(seed)
    odd = odd or {}
    sampled = SamplingOptions(max_new_tokens=new_tokens, temperature=0.8,
                              top_p=0.9)
    client = Client(engine)
    for i, n in enumerate(short_lens):
        client.submit(rng.integers(0, vocab, size=n).tolist(),
                      SamplingOptions(max_new_tokens=odd.get(i, new_tokens)))
    greedy = SamplingOptions(max_new_tokens=new_tokens)
    cancelled = 2
    steps = 0
    while not client.streams[client.order[cancelled]]:
        client.step()
        steps += 1
        assert steps < 100, "stream 2 never started"
    assert len(client.streams[client.order[cancelled]]) < new_tokens
    engine.cancel(client.order[cancelled])
    if long_len:
        client.submit(rng.integers(0, vocab, size=long_len).tolist(), greedy)
    for n in (90, 400):
        client.submit(rng.integers(0, vocab, size=n).tolist(), sampled)
    return client.drain(), cancelled


def check_streams(streams, cancelled, new_tokens, vocab, odd=None):
    odd = odd or {}
    for i, toks in enumerate(streams):
        if i == cancelled:
            assert len(toks) < new_tokens, "cancelled stream ran to its end"
            continue
        want = odd.get(i, new_tokens)
        assert len(toks) == want, f"stream {i}: {len(toks)} tokens, not {want}"
        assert all(0 <= t < vocab for t in toks), f"stream {i} out of range"


def device_breakdown(prof, wall_ms, steps):
    """Per-step summary of a ``torch.profiler`` run over ``steps`` engine
    steps whose unprofiled wall time was ``wall_ms`` each: summed device time
    of the step's kernels, the share of the step in which the card ran
    nothing (``1 - device/wall``, not clamped: the profiled steps are not
    the timed ones, so it can fall below 0 where the card is never idle),
    the number of kernels launched, and the kernels that take most
    of the device time. The profiler's own overhead stretches the host side,
    so only its device times are used."""
    from torch.autograd import DeviceType

    def device_us(ev):
        return ev.self_device_time_total

    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and device_us(ev) > 0]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    device_ms = sum(device_us(ev) for ev in kernels) / 1e3 / steps
    top = sorted(kernels, key=device_us, reverse=True)[:10]
    attention, int4 = {}, {}
    for ev in kernels:
        for names, into in ((ATTENTION_KERNELS, attention),
                            (INT4_KERNELS, int4)):
            for name in names:
                if name in ev.key:
                    got = into.setdefault(name, {"ms": 0.0, "launches": 0.0})
                    got["ms"] += device_us(ev) / 1e3 / steps
                    got["launches"] += ev.count / steps
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernels": sum(ev.count for ev in kernels) / steps,
        "attention_kernels": attention,
        "int4_kernels": int4,
        "top_kernels": [
            {"name": ev.key[:70], "ms": device_us(ev) / 1e3 / steps,
             "launches": ev.count / steps} for ev in top],
    }


SPIN_AHEAD_CYCLES = 1_000_000_000  # about 0.5 s of device spin
# The decode attention kernels, by the names the profiler gives them: the
# one-launch forms, the split walk with its merge (the f32 instances of #2,
# #5 and #8) and, by name only, the three passes that #6, #9 and #11 took
# before their cluster kernel (PASS_KERNELS: no code defines them now, and
# a path held to one launch a call must run none).
PASS_KERNELS = ("fused_scores_kernel", "fused_sums_kernel",
                "fused_combine_kernel")
ATTENTION_KERNELS = ("fused_cluster_kernel", "paged_decode_kernel",
                     *PASS_KERNELS, "paged_partial_kernel",
                     "paged_combine_kernel", "latent_kernel",
                     "latent_merge_kernel", "latent_wgmma_kernel",
                     "latent_decode_tc_kernel")
# The int4 matmul's kernels: bf16 x (one launch a call), f32 x (the
# CUDA-core kernel, with the combine of its split partials).
INT4_KERNELS = ("int4_mma_kernel", "int4_matmul_kernel", "int4_combine_kernel")


def profile_steps(engine, before_step, steps, counters=None):
    """``steps`` engine steps on the host clock (synchronised), then ``steps``
    more under ``torch.profiler``, then ``steps`` more each enqueued behind
    a 0.5 s device spin: CUDA events around such a step time the card's
    work alone (the host has enqueued all of it before the card reaches
    it), and the host clock around ``step()`` the host's own work (for a
    decode window, which waits for nothing on the card; a prefill waits for
    its first token). ``before_step`` runs ahead of each step, outside the
    timed region. With ``counters`` (name -> (module, attribute) of a
    launch counter) the launches per step are reported too."""
    from torch.profiler import ProfilerActivity, profile

    counters = counters or {}
    before = {n: getattr(m, a) for n, (m, a) in counters.items()}
    replays = engine.metrics.get_counter("decode_graph_replays")
    wall = 0.0
    for _ in range(steps):
        before_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            before_step()
            engine.step()
        torch.cuda.synchronize()
    device = host = 0.0
    for _ in range(steps):
        before_step()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_AHEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        engine.step()
        host += time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        device += start.elapsed_time(end)
    out = device_breakdown(prof, wall * 1e3 / steps, steps)
    out["device_ms_events"] = device / steps
    # The idle share again, with the device time from the events.
    out["device_idle_share_events"] = 1.0 - device / steps / out["wall_ms"]
    out["host_ms_behind_spin"] = host * 1e3 / steps
    out["graph_replays_per_step"] = (
        engine.metrics.get_counter("decode_graph_replays") - replays
    ) / (3 * steps)
    if counters:
        out["kernel_launches_per_step"] = {
            n: (getattr(m, a) - before[n]) / (3 * steps)
            for n, (m, a) in counters.items()}
    return out


def profile_decode(cfg, params, ekw, ckw, counters, ticks=5):
    """Where a decode tick's time goes, for a full batch of 8 rows of about
    600 cached tokens each (on the sink ring, streams of window + 7 tokens
    at the start, the JAX package's `sink_1k` measurement: the ring full,
    every step evicting). With K = 16 a tick is one captured window of 16
    steps (pipelined, but synchronised around each timed step)."""
    # The table is fixed at 1024 slots, so that no widening (and no
    # capture) falls among the measured steps.
    engine = InferenceEngine(
        cfg, params,
        EngineConfig(max_batch_size=8, decode_windows=(1024,), **ekw),
        CacheConfig(num_pages=2048, **ckw),
        generator=torch.Generator().manual_seed(3), device=DEV)
    rng = np.random.default_rng(17)
    k = engine.decode_steps
    n = ckw["window_length"] + 7 if ckw.get("kind") == "sink" else 600
    for _ in range(8):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(),
                      SamplingOptions(max_new_tokens=k * (3 * ticks + 6)))
    for _ in range(4):
        engine.step()  # admission, prefill, first decode ticks (captures)
    out = profile_steps(engine, lambda: None, ticks, counters)
    out["decode_steps"] = k
    width = "table_width" if engine.allocator is not None else "buffer_width"
    out[width] = engine._span()
    out["prompt_tokens"] = n
    return out


def profile_prefill(cfg, params, ekw, ckw, counters, steps=2):
    """Where a prefill dispatch's time goes: one 2048-token greedy prompt
    admitted into an idle engine and asked for a single token, so that the
    step is exactly one [1, 2048] prefill dispatch and its sample. A dense
    cache is held at 4096 positions wide, where the prefill takes the flash
    kernel. On the sink ring the prompt is its span long (1020 tokens, the
    longest one dispatch takes), padded to the 2048 bucket."""
    n = 2048
    if ckw.get("kind") == "dense":
        ekw = {**ekw, "decode_windows": (4096,)}
    if ckw.get("kind") == "sink":
        n = ckw["window_length"] - ckw["num_sink_tokens"]
    engine = InferenceEngine(
        cfg, params, EngineConfig(max_batch_size=8, **ekw),
        CacheConfig(num_pages=2048, **ckw),
        generator=torch.Generator().manual_seed(4), device=DEV)
    rng = np.random.default_rng(19)

    def submit():
        engine.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(),
                      SamplingOptions(max_new_tokens=1))

    submit()
    engine.step()  # warm-up
    out = profile_steps(engine, submit, steps, counters)
    assert not engine.has_work()
    assert engine.metrics.get_counter("prefill_tokens") == n * (1 + 3 * steps)
    out["prompt_tokens"] = n
    return out


def projections(cfg):
    """A dense layer's projections (in, out) in the order it runs them,
    and the head's (None when tied to the embedding: no int4 head)."""
    h, d, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    hq, hkv = cfg.num_heads * d, cfg.num_kv_heads * d
    return ({"wq": (h, hq), "wk": (h, hkv), "wv": (h, hkv), "wo": (hq, h),
             "wg": (h, inter), "wu": (h, inter), "wd": (inter, h)},
            None if cfg.tie_word_embeddings else (h, cfg.vocab_size))


def int4_cases(cases, dtype, shapes, cfg):
    """The int4 kernels at a run's dispatch shapes (`AttentionPlan.
    dispatch_shapes`): decode rows at every projection shape of ``cfg``
    (`int4_matmul_stacked`), the head rows of every dispatch
    (`int4_matmul`, unless the head is tied)."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    layer, head = projections(cfg)
    decode_rows = sorted({sh[1] for sh in shapes if sh[0] == "decode"})
    for name, (ind, outd) in layer.items():
        w = int4_weight(gen, (2, ind, outd))
        for rows in decode_rows:
            x = torch.randn((rows, ind), generator=gen, device=DEV).to(dtype)
            compare_int4(cases, f"decode_{rows}_{name}", dtype, x, w, 1)
        del w
    if head is None:
        return
    w = int4_weight(gen, (1, *head))
    for rows in sorted({sh[1] for sh in shapes}):
        x = torch.randn((rows, head[0]), generator=gen, device=DEV).to(dtype)
        compare_int4(cases, f"head_{rows}", dtype, x, w)
    del w


def check_engine_shapes(cfg, shapes, table_width, quantized, int4):
    """The kernels of a run against their plain versions at every dispatch
    shape it made, in bf16 (the run's type) and f32, on mixed lengths.
    ``shapes`` is `AttentionPlan.dispatch_shapes`: ("prefill" or "chunk",
    rows, token width) reach the ragged kernel, under the table as wide as
    it grew (``table_width``); ("decode", rows, K, table width) reach the
    decode kernel and, over the int8 pool with K > 1, the fused window's
    step in the form the engine takes at that width (#6 from 768 slots,
    #9 below); the int8-page forms when ``quantized``. Each
    prefill-family shape is run twice: fresh prompts (q_start 0) and rows
    continuing a longer prompt (q_start > 0, as the later chunks of a long
    prompt are). With ``int4``: decode rows reach `int4_matmul_stacked` at
    every projection shape, and the head rows of every dispatch (its rows)
    reach `int4_matmul` (many-row prefill projections take the plain
    unpacked product, no kernel). ``cfg``: the run's model (its kv heads,
    query heads a kv head, head_dim, sliding window and int4 shapes).
    Returns per kernel and type the largest error and the number of
    comparisons."""
    out = {}
    hkv, d, window = cfg.num_kv_heads, cfg.head_dim, cfg.sliding_window
    g = cfg.num_heads // hkv
    win = {} if window is None else {"sliding_window": window}
    rows_max = max(sh[1] for sh in shapes)
    kinds = ["qpaged", "qragged"] if quantized else ["paged", "ragged"]
    if int4:
        kinds += ["int4s"] + ([] if cfg.tie_word_embeddings else ["int4"])
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rng = np.random.default_rng(4321)
        pages = rows_max * table_width + 1
        pool = (make_qpool(rng, pages, hkv, d=d) if quantized
                else make_pool(rng, pages, dtype, hkv, d=d))
        pname, rname = paged_fns(pool)[0], ragged_fns(pool)[0]
        cases = []
        for kind, rows, *rest in sorted(shapes):
            tag = "_".join(str(x) for x in (kind, rows, *rest))
            if kind == "decode":
                k_steps, width = rest
                slots = width * PS
                lens = rng.integers(1, slots + 1, size=rows)
                lens[0] = slots              # a row that fills its table
                if rows > 1:
                    lens[-1] = 0             # an inactive row
                table = make_table(rng, rows, width, pages)
                compare_paged(
                    cases, f"{pname}_{tag}", dtype,
                    normal(rng, (rows, 1, hkv * g, d), dtype), pool,
                    table, i32(lens), **win)
                if quantized and k_steps > 1:
                    # The fused window's step at this width: its form is
                    # the engine's (in place from 768 slots).
                    base = i32(np.minimum(lens, slots - 4))
                    if slots >= 768:
                        compare_fused(
                            cases, f"qfusedp_{tag}", dtype, "inplace",
                            [p[None] for p in pool], base, rng, table=table,
                            window=window, g=g, layer=0, hkv=hkv, d=d)
                    else:
                        compare_fused(
                            cases, f"qfusedd_{tag}", dtype, "gathered",
                            make_qplanes(rng, (1, rows, hkv), slots, d), base,
                            rng, window=window, g=g, layer=0, hkv=hkv, d=d)
                continue
            s, slots = rest[0], table_width * PS
            q = normal(rng, (rows, s, hkv * g, d), dtype)
            table = make_table(rng, rows, table_width, pages)
            num_new = rng.integers(1, s + 1, size=rows)
            num_new[0] = s                   # a row with no pad query
            compare_ragged(cases, f"{rname}_{tag}_fresh", dtype, q, pool,
                           table, i32(num_new), i32(num_new), **win)
            if slots > s:
                start = rng.integers(1, slots - num_new + 1)
                compare_ragged(cases, f"{rname}_{tag}_continued", dtype, q,
                               pool, table, i32(start + num_new),
                               i32(num_new), **win)
        del pool
        if int4:
            int4_cases(cases, dtype, shapes, cfg)
        assert_cases(cases, dtype)
        fused = [k for k in ("qfusedp", "qfusedd")
                 if any(n.startswith(k + "_") for n, _, _ in cases)]
        for name in kinds + fused:
            mine = [e for n, e, _ in cases
                    if n.startswith(name + "_") and not n.endswith(("_m", "_l"))]
            assert mine, f"the engine run dispatched nothing to {name}"
            out[f"{name}_{label}"] = {"max_abs_err": max(mine),
                                      "comparisons": len(mine)}
    return out


# The smoke's traffic: 12 greedy prompts of 30-1500 tokens, then one
# 3000-token greedy prompt (chunk-admitted beside live decode), two sampled
# ones and a cancel, 32 new tokens each. SHORT keeps every row under 640
# slots (prompts of 100-500 tokens, no long prompt): the int8 pool's window
# then gathers (#9) instead of reading the pool in place (#6).
_lens = np.random.default_rng(7).integers(30, 1500, size=10).tolist()
MIXED = {"short_lens": [30, 1500] + _lens, "long_len": 3000, "new_tokens": 32}
SHORT = {"short_lens": np.random.default_rng(8).integers(100, 500, size=12).tolist(),
         "long_len": None, "new_tokens": 32}


class CacheShapes:
    """Records the shapes each of the dense caches' and the sink ring's
    kernels is launched at while it is installed (the wrappers replaced by
    recording ones, the engine built inside; a call that launches nothing,
    as flash on a decode step, is not recorded): (B, S, T, G) of #3, (B, T,
    G) of #8, (B, T, KT, G) of #9, (L, B, T, KT) of #10, (B, TR, KT, G,
    ring slots) of #11, (L, B, TR, KT, ring slots) of #12."""

    TARGETS = {(fa, "flash_attention"): "launches",
               (qa, "quantized_decode_attention"): "decode_launches",
               (qa, "quantized_fused_decode_attention"): "fused_launches",
               (qa, "fused_tail_flush"): "flush_launches",
               (qa, "sink_fused_decode_attention"): "sink_launches",
               (qa, "sink_tail_flush"): "sink_flush_launches"}

    def __init__(self):
        self.shapes = set()
        self._real = {}

    def _shape(self, name, a, kw):
        if name == "flash_attention":
            q, k = a[0], a[1]
            return (q.shape[0], q.shape[1], k.shape[1], q.shape[2] // k.shape[2])
        if name == "quantized_decode_attention":
            q, k = a[0], a[1]
            return (q.shape[0], k.shape[2], q.shape[2] // k.shape[1])
        if name == "quantized_fused_decode_attention":
            q, big, tail = a[0], a[3], a[7]
            return (q.shape[0], big.shape[3], tail.shape[3],
                    q.shape[2] // big.shape[2])
        if name == "sink_fused_decode_attention":
            q, big, tail = a[0], a[4], a[12]
            return (q.shape[0], big.shape[3], tail.shape[3],
                    q.shape[2] // big.shape[2], kw["ring_slots"])
        big, tail = a[0], a[4]
        if name == "sink_tail_flush":
            return (big.shape[0], big.shape[1], big.shape[3], tail.shape[3],
                    a[11])
        return (big.shape[0], big.shape[1], big.shape[3], tail.shape[3])

    def __enter__(self):
        for (mod, name), counter in self.TARGETS.items():
            real = getattr(mod, name)
            self._real[(mod, name)] = real

            def rec(*a, _real=real, _name=name, _mod=mod, _c=counter, **kw):
                before = getattr(_mod, _c)
                out = _real(*a, **kw)
                if getattr(_mod, _c) > before:
                    self.shapes.add((_name, *self._shape(_name, a, kw)))
                return out

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name), real in self._real.items():
            setattr(mod, name, real)


def check_dense_shapes(cfg, shapes, dispatch_shapes, int4):
    """The dense caches' and the sink ring's kernels against their plain
    versions at every shape a run called them at (:class:`CacheShapes`),
    in bf16 and f32 where the queries' type matters: #3 over rows of mixed
    lengths (one prompt longer than the buffer's remaining room, as a
    padded bucket is), #8 with a full and an empty row, #9 and #11 over a
    window's steps (their tails EQUAL; #11 on the rows of
    :func:`sink_rows`), #10 and #12 at the run's depth (bytes EQUAL); with
    ``int4`` the int4 kernels at the run's ``dispatch_shapes``
    (:func:`int4_cases`). ``cfg``: the run's model (its kv heads, head_dim
    and int4 shapes). Returns per kernel and type the largest error and
    the number of comparisons."""
    out = {}
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rng = np.random.default_rng(5678)
        cases = []
        for name, *shape in sorted(shapes):
            tag = "_".join(str(x) for x in shape)
            if name == "flash_attention":
                b, s, t, g = shape
                q = normal(rng, (b, s, hkv * g, d), dtype)
                k = normal(rng, (b, t, hkv, d), dtype)
                v = normal(rng, (b, t, hkv, d), dtype)
                lens = rng.integers(1, t + 1, size=b)
                lens[0] = t
                q0 = np.maximum(lens - s, 0)
                compare_flash(cases, f"flash_{tag}", dtype, q, k, v,
                              causal(b, s, t, lens, q0))
            elif name == "quantized_decode_attention":
                b, t, g = shape
                lens = rng.integers(0, t + 1, size=b)
                lens[0] = t
                if b > 1:
                    lens[-1] = 0
                compare_qdense(cases, f"qdense_{tag}", dtype,
                               normal(rng, (b, 1, hkv * g, d), dtype),
                               make_qplanes(rng, (b, hkv), t, d), i32(lens))
            elif name == "quantized_fused_decode_attention":
                b, t, kt, g = shape
                assert kt == KT
                base = np.minimum(rng.integers(0, t + 1, size=b), t - KT)
                compare_fused(cases, f"qfusedd_{tag}", dtype, "gathered",
                              make_qplanes(rng, (1, b, hkv), t, d), i32(base),
                              rng, g=g, layer=0, hkv=hkv, d=d)
            elif name == "sink_fused_decode_attention":
                b, tr, kt, g, r = shape
                assert kt == KT and b == 8
                sinks = 4
                compare_sink(cases, f"qsink_{tag}", dtype,
                             make_qplanes(rng, (1, b, hkv), tr, d),
                             make_qplanes(rng, (1, b, hkv), 32, d),
                             sink_rows(sinks, r), sinks, r, rng, g=g, layer=0,
                             hkv=hkv, d=d)
            elif name == "sink_tail_flush":
                if dtype != torch.bfloat16:
                    continue                       # the flush moves bytes
                num_l, b, tr, kt, r = shape
                compare_sink_flush(
                    cases, f"qsflush_{tag}",
                    make_qplanes(rng, (num_l, b, hkv), tr, d),
                    make_qplanes(rng, (num_l, b, hkv), kt, d),
                    i32(rng.integers(0, r, size=b)),
                    i32(rng.integers(0, 3, size=b)),
                    i32(rng.integers(0, kt + 1, size=b)), r)
            elif dtype == torch.bfloat16:          # the flush moves bytes
                num_l, b, t, kt = shape
                base = rng.integers(0, t + 1, size=b)
                base[0] = t - kt // 2              # a window past the end
                compare_qflush(cases, f"qflush_{tag}",
                               make_qplanes(rng, (num_l, b, hkv), t, d),
                               make_qplanes(rng, (num_l, b, hkv), kt, d),
                               i32(base), i32(rng.integers(0, kt + 1, size=b)))
        if int4:
            int4_cases(cases, dtype, dispatch_shapes, cfg)
        assert_cases(cases, dtype)
        for prefix in ("flash", "qdense", "qfusedd", "qflush", "qsink",
                       "qsflush", "int4s", "int4"):
            mine = [e for n, e, _ in cases if n.startswith(prefix + "_")
                    and not n.endswith("_tail_bytes")]
            if mine:
                out[f"{prefix}_{label}"] = {"max_abs_err": max(mine),
                                            "comparisons": len(mine)}
    return out


def run_config(label, cfg, params, ekw, ckw, counters, profile=True,
               traffic=MIXED, one_launch=None, int4_launch=False,
               model="llama-3-8b widths", int4_weights=False):
    """The smoke's traffic through one engine configuration, twice with one
    seed (the streams must repeat); the launch counters in ``counters``
    (name -> (module, attribute)) are zeroed before the first run and read
    after it. Then the run's dispatch shapes go through its kernels again
    and, with ``profile``, a decode tick and a prefill dispatch are
    profiled (with ``profile="decode"`` the decode tick alone). A dense
    cache or sink ring (``ckw["kind"]`` "dense" or "sink") has no pages and
    no co-scheduled chunks (a long prompt is chunked synchronously); its
    kernels are replayed at the shapes recorded in the first run. With
    ``one_launch`` (a kernel's name), the profiled decode tick must launch
    that kernel once a call: once a layer a step. With ``int4_launch`` it
    must launch the int4 matmul's bf16 kernel once a call, the config's
    int4 projections a layer (`llama.int4_projections`: 7, or 4 for an MoE
    config) and the head, each step, and no other int4 kernel (no
    combine); a head tied to the embedding has no int4 launch. ``model``
    names the widths in the report. ``int4_weights``: ``params`` hold int4
    weights already (:func:`int4_params`), which the engine takes as they
    are. Returns (report, launches)."""
    int4 = int4_weights or ekw.get("quantization") == "int4"
    torch.cuda.reset_peak_memory_stats()
    new_tokens, odd = traffic["new_tokens"], traffic.get("odd")
    dense = ckw.get("kind") == "dense"
    sink = ckw.get("kind") == "sink"
    rows = dense or sink
    recorder = CacheShapes()
    runs = []
    for attempt in range(2):
        with recorder if rows and attempt == 0 else contextlib.nullcontext():
            t0 = time.perf_counter()
            engine = InferenceEngine(
                cfg, params, EngineConfig(max_batch_size=8, **ekw),
                CacheConfig(num_pages=2048, **ckw),
                generator=torch.Generator().manual_seed(11), device=DEV)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if not rows:
                assert engine.cache.use_kernel and engine.cache.use_ragged
            fused = engine.decode_steps > 1
            if fused:
                assert engine._pipelined and engine._fused.capture
            if attempt == 0:
                for module, attr in counters.values():
                    setattr(module, attr, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streams, cancelled = drive(
                engine, cfg.vocab_size, 5, traffic["short_lens"],
                traffic["long_len"], new_tokens, odd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if attempt == 0:
            launches = {n: getattr(m, a) for n, (m, a) in counters.items()}
            shapes = engine.plan.dispatch_shapes
            # The widest the table (or the dense buffers) grew: an idle
            # engine shrinks it again.
            table_width = max(
                [engine._span()]
                + [sh[3] for sh in shapes if sh[0] == "decode"])
        check_streams(streams, cancelled, new_tokens, cfg.vocab_size, odd)
        m = engine.metrics
        if not rows:
            assert engine.allocator.free_count == 2048 - 1, "pages leaked"
        if sink:
            span = ckw["window_length"] - ckw["num_sink_tokens"]
            assert ("chunk", 1, span) in shapes, (
                "no prompt was chunked at the ring span")
        elif traffic["long_len"] and dense:
            assert ("chunk", 1, 2048) in shapes, "the long prompt was not chunked"
        elif traffic["long_len"]:
            assert m.get_counter("attn_chunked_rows") > 0, (
                "the long prompt was not chunk-admitted beside live decode")
        # The model-dtype sink ring prefills one row at a time.
        assert (m.get_counter("batched_prefills") > 0) == engine._batch_admission
        snap = m.snapshot()
        run = {
            "streams": streams,
            "engine_init_s": build_s,
            "wall_s": wall,
            "generated_tokens": sum(len(s) for s in streams),
            "tokens_per_s": sum(len(s) for s in streams) / wall,
            "prefill_tokens": m.get_counter("prefill_tokens"),
            "prefill_dispatches": snap["prefill_count"],
            "prefill_ms_mean": snap["prefill_mean_s"] * 1e3,
            "prefill_ms_total": snap["prefill_mean_s"] * snap["prefill_count"] * 1e3,
            "decode_steps": engine.decode_steps,
            "decode_ticks": snap["decode_step_count"],
            "decode_tick_ms_mean": snap["decode_step_mean_s"] * 1e3,
            "decode_tick_ms_p50": snap["decode_step_p50_s"] * 1e3,
            "chunked_rows": m.get_counter("attn_chunked_rows"),
            "batched_prefills": m.get_counter("batched_prefills"),
            "kv_bytes_per_token": snap["kv_bytes_per_token"],
        }
        if fused:
            assert m.get_counter("decode_graph_captures") > 0
            run.update({
                "graph_captures": m.get_counter("decode_graph_captures"),
                "graph_capture_s_total": snap["decode_graph_capture_mean_s"]
                * snap["decode_graph_capture_count"],
                "graph_capture_s_max": max(
                    m._timings["decode_graph_capture"]),
                "graph_replays": m.get_counter("decode_graph_replays"),
                "graph_pool_bytes": snap["decode_graph_pool_bytes"],
                "graphs_alive_at_end": engine._fused.graph_count(),
                "admit_overlap_sessions": m.get_counter("admit_overlap_sessions"),
                "admit_sync_sessions": m.get_counter("admit_sync_sessions"),
                "decode_resolve_ms_mean": snap["decode_resolve_mean_s"] * 1e3,
            })
        runs.append(run)
        del engine
        torch.cuda.empty_cache()
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the path of {label}"
    assert runs[0]["streams"] == runs[1]["streams"], (
        "two runs with one seed gave different streams")
    report = {"phase": "engine", "config": label,
              "model": f"{model}, {cfg.num_layers} layers, random weights",
              "launches": launches, "repeatable": True,
              "max_memory_allocated": torch.cuda.max_memory_allocated()}
    for i, r in enumerate(runs):
        report[f"run{i}"] = {k: v for k, v in r.items() if k != "streams"}
    report["dispatch_shapes"] = sorted(shapes)
    if rows:
        report["buffer_width"] = table_width
        report["kernel_shapes"] = sorted(recorder.shapes)
        report["kernels_at_dispatch_shapes"] = check_dense_shapes(
            cfg, recorder.shapes, shapes, int4)
    else:
        report["table_width"] = table_width
        report["kernels_at_dispatch_shapes"] = check_engine_shapes(
            cfg, shapes, table_width, bool(ckw.get("kv_quant")), int4)
    if profile:
        report["decode_profile"] = profile_decode(cfg, params, ekw, ckw,
                                                  counters)
        # The profiler drops records now and then, never adds any: one
        # session on an H100 lost 1.1% of every kind of kernel alike
        # (506.2 of 512 a tick), most lose none. So a session that counts
        # too few is profiled again, three at most, and the last is held to
        # within 1% of one a call; two launches a call would be 100% off.
        steps = report["decode_profile"]["decode_steps"]
        want = {}
        if one_launch:
            want["attention_kernels", one_launch] = cfg.num_layers * steps
        if int4_launch:
            head = 0 if cfg.tie_word_embeddings else 1
            want["int4_kernels", "int4_mma_kernel"] = (
                (len(llama.int4_projections(cfg)) * cfg.num_layers + head)
                * steps)
        sessions = []
        while want:
            got = {name: report["decode_profile"][kind].get(
                name, {}).get("launches", 0) for kind, name in want}
            sessions.append(got)
            if all(got[name] >= 0.99 * n for (_, name), n in want.items()) or (
                    len(sessions) == 3):
                break
            report["decode_profile"] = profile_decode(
                cfg, params, ekw, ckw, counters)
        if one_launch:
            ran = [n for n in PASS_KERNELS
                   if n in report["decode_profile"]["attention_kernels"]]
            assert not ran, f"{label}: the three passes ran ({ran})"
        if want:
            report["decode_profile"]["launches_by_session"] = sessions
            for (_, name), n in want.items():
                assert abs(sessions[-1][name] - n) <= 0.01 * n, (
                    f"{name}: {sessions[-1][name]} launches a tick in the "
                    f"last of {sessions}, want one a call ({n})")
        if int4_launch:
            other = {k: v for k, v in
                     report["decode_profile"]["int4_kernels"].items()
                     if k != "int4_mma_kernel"}
            assert not other, f"bf16 int4 calls launched {other}"
        if profile != "decode":
            report["prefill_profile"] = profile_prefill(cfg, params, ekw,
                                                        ckw, counters)
    emit(report)
    return report, launches


# Each path's kernels: (module, launch counter). Slices 1 and 2 decode one
# token per dispatch (decode_steps=1); slice 3's fused window is the
# engine's default, on the int8 pool over gathered stacks (#9) below 768
# slots of table and over the pool in place (#6) from there.
RAGGED = {"ragged_paged_attention": (ra, "launches")}
QRAGGED = {"quantized_ragged_paged_attention": (ra, "quantized_launches")}
INT4 = {"int4_matmul": (qm, "launches"),
        "int4_matmul_stacked": (qm, "stacked_launches")}
SLICE1 = {"paged_attention": (pa, "launches"), **RAGGED}
SLICE2 = {"quantized_paged_attention": (pa, "quantized_launches"), **QRAGGED,
          **INT4}
MAIN_BF16 = SLICE1
MAIN_INT4 = {"quantized_paged_fused_attention": (pa, "fused_launches"),
             "paged_tail_flush": (pa, "flush_launches"), **QRAGGED, **INT4}
SHORT_INT8 = {"quantized_fused_decode_attention": (qa, "fused_launches"),
              "paged_tail_flush": (pa, "flush_launches"), **QRAGGED}
# Slice 4, the dense caches. Its main path: int4 weights over the int8
# dense cache (the fused window on the cache's own buffers, #9, its flush,
# #10; flash for the batched 2048-token prefill into the 1536-wide buffers
# of the first admission wave, #3).
FLASH = {"flash_attention": (fa, "launches")}
MAIN_DENSE = {"quantized_fused_decode_attention": (qa, "fused_launches"),
              "fused_tail_flush": (qa, "flush_launches"), **FLASH, **INT4}
QDENSE = {"quantized_decode_attention": (qa, "decode_launches"), **FLASH}
DENSE = {"kind": "dense"}
# Slice 5, the StreamingLLM sink ring at the JAX package's `sink_1k` values
# (bench.py:388-455: window 1024, 4 sinks). Its main path: int4 weights over
# the int8 ring (the fused window's step, #11, and flush, #12).
SINK = {"kind": "sink", "window_length": 1024, "num_sink_tokens": 4}
MAIN_SINK = {"sink_fused_decode_attention": (qa, "sink_launches"),
             "sink_tail_flush": (qa, "sink_flush_launches"), **INT4}
# Ten greedy prompts for 8 slots: 1 and 3 tokens (their tails flush into
# the sink planes), about 1000 (the rings wrap inside the decode windows),
# two longer than the ring span of 1020 (chunked at it); stream 5 asks for
# 37 tokens (not a multiple of K), stream 2 is cancelled, two sampled
# prompts ride along; 48 new tokens each.
SINK_TRAFFIC = {"short_lens": [1, 3, 1000, 1010, 990, 700, 1500, 2100, 400, 1020],
                "long_len": None, "new_tokens": 48, "odd": {5: 37}}


def depth(params, cfg, layers):
    """The first ``layers`` layers of ``params`` (a cut of depth)."""
    cut = dataclasses.replace(cfg, num_layers=min(layers, cfg.num_layers))
    return cut, {**params, "layers": {
        k: v[: cut.num_layers] for k, v in params["layers"].items()}}


def phase_engine():
    """The engine at Llama-3-8B widths. This slice's main path at full
    depth: int4 weights over the int8 sink ring (window 1024, 4 sinks), the
    default ``decode_steps=None`` (K = 16, captured and pipelined). Then
    the dense main path (int4 weights over the int8 dense cache) and the
    main paths of the paged pools at full depth in bf16 and with int4
    weights over int8 pages; the model-dtype sink ring at 4 layers (K = 1,
    with and without flash prefill); int8 weights over int8 pages at 4 layers on SHORT
    traffic (the gathered window, #9, and W8A8 prefill); the dense caches'
    other paths at 8 layers (the int8 cache at ``decode_steps=1``, #8, its
    decode tick profiled; the model-dtype cache with
    ``use_pallas_attention``, flash prefill and K = 1; the model-dtype
    cache at K = 16, its tail in plain PyTorch, captured); the paths of
    slices 1 and 2 (``decode_steps=1``), cut to 4 layers, slice 2's (#5)
    decode tick profiled. Each path's counters are zeroed before its first
    run and read after it. Returns launches by kernel, from the first path that runs
    it in that order."""
    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(0), torch.bfloat16, DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches = {}

    def take(got):
        for name, n in got.items():
            launches.setdefault(name, n)

    take(run_config(
        "main path: int4 weights (half-split), int8 sink ring (window 1024, "
        "4 sinks), K=16", cfg, params, {"quantization": "int4"},
        {"kv_quant": "int8", **SINK}, MAIN_SINK, traffic=SINK_TRAFFIC,
        one_launch="fused_cluster_kernel", int4_launch=True)[1])
    take(run_config(
        "dense main path: int4 weights (half-split), int8 dense KV, K=16", cfg,
        params, {"quantization": "int4"}, {"kv_quant": "int8", **DENSE},
        MAIN_DENSE, one_launch="fused_cluster_kernel", int4_launch=True)[1])
    take(run_config("paged main path: bf16 weights, bf16 pages, K=16", cfg,
                    params, {}, {}, MAIN_BF16,
                    one_launch="paged_decode_kernel")[1])
    take(run_config(
        "paged main path: int4 weights (half-split), int8 pages, K=16", cfg,
        params, {"quantization": "int4"}, {"kv_quant": "int8"}, MAIN_INT4,
        one_launch="fused_cluster_kernel", int4_launch=True)[1])
    cfg4, params4 = depth(params, cfg, 4)
    run_config("slice 5 path: bf16 weights, bf16 sink ring, K=1, 4 layers",
               cfg4, params4, {}, SINK, {}, profile=False,
               traffic=SINK_TRAFFIC)
    run_config("slice 5 path: bf16 weights, bf16 sink ring, flash, K=1, "
               "4 layers", cfg4, params4, {"use_pallas_attention": True},
               SINK, FLASH, profile=False, traffic=SINK_TRAFFIC)
    w8a8 = [0]
    real = quant.w8a8_matmul

    def counted(x, w):
        w8a8[0] += 1
        return real(x, w)

    quant.w8a8_matmul = counted
    try:
        take(run_config(
            "paged: int8 weights, int8 pages, K=16, short traffic",
            cfg4, params4, {"quantization": "int8"}, {"kv_quant": "int8"},
            SHORT_INT8, profile=False, traffic=SHORT)[1])
    finally:
        quant.w8a8_matmul = real
    assert w8a8[0] > 0, "no prefill projection took the int8 x int8 product"
    emit({"phase": "engine_int8_w8a8", "init_s": init_s,
          "w8a8_matmul_calls": w8a8[0]})
    cfg8, params8 = depth(params, cfg, 8)
    take(run_config("slice 4 path: bf16 weights, int8 dense KV, K=1, 8 layers",
                    cfg8, params8, {"decode_steps": 1},
                    {"kv_quant": "int8", **DENSE}, QDENSE, profile="decode",
                    one_launch="paged_decode_kernel")[1])
    run_config("slice 4 path: bf16 weights, bf16 dense KV, flash, K=1, 8 layers",
               cfg8, params8, {"use_pallas_attention": True}, DENSE, FLASH,
               profile=False)
    run_config("slice 4 path: bf16 weights, bf16 dense KV, K=16, 8 layers",
               cfg8, params8, {}, DENSE, {}, profile=False)
    run_config("slice 1 path: bf16, K=1, 4 layers", cfg4, params4,
               {"decode_steps": 1}, {}, SLICE1, profile=False)
    take(run_config("slice 2 path: int4 weights, int8 pages, K=1, 4 layers",
                    cfg4, params4, {"decode_steps": 1, "quantization": "int4"},
                    {"kv_quant": "int8"}, SLICE2, profile="decode",
                    one_launch="paged_decode_kernel", int4_launch=True)[1])
    captured_vs_eager(cfg, params)
    del params, params4, params8
    torch.cuda.empty_cache()
    return launches


def captured_vs_eager(cfg, params):
    """Full width and depth, bf16, K = 16: the same greedy traffic with the
    window's step replayed from CUDA graphs and run eagerly. The same
    kernels in the same order: the streams must be identical."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (30, 200, 500, 900, 60, 1200, 300, 700)]
    out = {}
    for capture in (True, False):
        engine = InferenceEngine(
            cfg, params, EngineConfig(max_batch_size=8),
            CacheConfig(num_pages=2048), device=DEV)
        engine._fused.capture = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = engine.generate(prompts, SamplingOptions(max_new_tokens=48))
        torch.cuda.synchronize()
        out[capture] = (streams, time.perf_counter() - t0,
                        engine.metrics.get_counter("decode_graph_replays"))
        del engine
    assert all(len(x) == 48 for x in out[True][0])
    assert out[True][0] == out[False][0], "captured and eager streams differ"
    emit({"phase": "captured_vs_eager",
          "model": f"llama-3-8b widths, {cfg.num_layers} layers, bf16, K=16",
          "streams": len(prompts), "tokens_each": 48, "identical": True,
          "captured_wall_s": out[True][1], "eager_wall_s": out[False][1],
          "graph_replays": out[True][2]})


# The later model families' paths (phase 3, after the Llama paths): each
# path's kernels, as for the Llama paths.
MIXTRAL_DENSE = {"quantized_fused_decode_attention": (qa, "fused_launches"),
                 "fused_tail_flush": (qa, "flush_launches"), **FLASH}
MISTRAL_INT8 = {"quantized_paged_fused_attention": (pa, "fused_launches"),
                "paged_tail_flush": (pa, "flush_launches"), **QRAGGED}
MOE_KEYS = ("router", "we_g", "we_u", "we_d")


def expert_bytes(cfg, itemsize):
    """Bytes of one layer's expert stacks (gate, up, down) at ``itemsize``
    bytes a weight."""
    return 3 * cfg.num_experts * cfg.hidden_size * cfg.intermediate_size * (
        itemsize)


def time_experts(cfg, params, quantized, rows=8):
    """One decode step's MoE MLPs: layer 0's ``moe_mlp`` on ``rows`` tokens,
    timed with CUDA events (``time_ms``), times the layers. Beside it the
    bytes of expert weights a step reads at their stored width and the
    card's bound for them; with ``quantized`` (int8 stacks, converted to
    bf16 whole at every call, as the JAX package does) also the bytes the
    conversion moves: the int8 stacks read, a bf16 copy written and read
    back."""
    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device=DEV)
    lp = {k: params["layers"][k][:1] for k in MOE_KEYS}
    if quantized:
        lp = quant.quantize_params({"layers": lp})["layers"]
    p = {k: v[0] for k, v in lp.items()}
    gen = torch.Generator(device=DEV).manual_seed(8)
    x = torch.randn((rows, 1, cfg.hidden_size), generator=gen,
                    device=DEV).to(torch.bfloat16)
    layer_ms = time_ms(lambda: moe.moe_mlp(cfg, p, x), 5, flush)
    stored = expert_bytes(cfg, 1 if quantized else 2) * cfg.num_layers
    moved = stored + (2 * expert_bytes(cfg, 2) * cfg.num_layers
                      if quantized else 0)
    bound_ms = stored / HBM_BYTES_PER_S * 1e3
    del lp, p, flush
    torch.cuda.empty_cache()
    return {"rows": rows, "weights": "int8" if quantized else "bf16",
            "layer_ms": layer_ms, "step_ms": layer_ms * cfg.num_layers,
            "expert_bytes_a_step": stored, "bound_ms_a_step": bound_ms,
            "step_over_bound": layer_ms * cfg.num_layers / bound_ms,
            "bytes_moved_a_step": moved,
            "moved_bound_ms_a_step": moved / HBM_BYTES_PER_S * 1e3}


def family_summary(label, report, experts=None):
    """A path's figures on one line, beside the card's name and power
    limit: tokens/s of both runs, the K = 16 window's wall and device ms
    and idle share (its decode profile), peak memory, launches; for an MoE
    path the experts' step time against their bound."""
    prof = report["decode_profile"]
    line = {"phase": "engine_family", "config": label, "card": CARD,
            "model": report["model"],
            "tokens_per_s": [report["run0"]["tokens_per_s"],
                             report["run1"]["tokens_per_s"]],
            "decode_steps": prof["decode_steps"],
            "window_wall_ms": prof["wall_ms"],
            "window_device_ms_profiler": prof["device_ms"],
            "window_device_ms_events": prof["device_ms_events"],
            "idle_share_profiler": prof["device_idle_share"],
            "idle_share_events": prof["device_idle_share_events"],
            "prefill_2048_wall_ms": report["prefill_profile"]["wall_ms"],
            "peak_bytes_allocated": report["max_memory_allocated"],
            "launches": report["launches"]}
    if experts is not None:
        line["experts"] = experts
    emit(line)


def phase_families():
    """Phase 3's later paths, each at full width through the smoke's
    traffic (twice, repeatable, its kernels' counters zeroed and read, its
    dispatch shapes replayed against the plain versions, a few windows and
    a prefill profiled): Mixtral-8x7B's layer at 8 layers with int8 weights
    over the int8 dense cache and in bf16 over bf16 pages; Mistral-7B
    (window 128, 32 layers) with int8 weights over int8 pages; Qwen1.5-7B
    (q/k/v biases, 32 kv heads) at 4 layers in bf16 over bf16 pages. Each
    path's summary line (`engine_family`) follows its report."""
    gen = torch.Generator(device=DEV)
    cfg = MIXTRAL_8L
    params = llama.init_params(cfg, gen.manual_seed(0), torch.bfloat16, DEV)
    model = "mixtral-8x7b widths"
    label = "mixtral8l_int8_dense: int8 weights, int8 dense KV, K=16"
    report, _ = run_config(
        label, cfg, params, {"quantization": "int8"},
        {"kv_quant": "int8", **DENSE}, MIXTRAL_DENSE,
        one_launch="fused_cluster_kernel", model=model)
    family_summary(label, report, time_experts(cfg, params, True))
    label = "mixtral8l_bf16_pages: bf16 weights, bf16 pages, K=16"
    report, _ = run_config(label, cfg, params, {}, {}, MAIN_BF16,
                           one_launch="paged_decode_kernel", model=model)
    family_summary(label, report, time_experts(cfg, params, False))
    del params
    torch.cuda.empty_cache()

    cfg = MISTRAL_7B
    params = llama.init_params(cfg, gen.manual_seed(1), torch.bfloat16, DEV)
    label = ("mistral7b_swa128_int8_pages: int8 weights, int8 pages, "
             "window 128, K=16")
    report, _ = run_config(
        label, cfg, params, {"quantization": "int8"}, {"kv_quant": "int8"},
        MISTRAL_INT8, one_launch="fused_cluster_kernel",
        model="mistral-7b widths")
    family_summary(label, report)
    del params
    torch.cuda.empty_cache()

    cfg = QWEN15_7B_4L
    params = llama.init_params(cfg, gen.manual_seed(2), torch.bfloat16, DEV)
    for name in ("bq", "bk", "bv"):   # random biases: init's are zeros
        params["layers"][name].normal_(0.0, 0.5, generator=gen)
    label = "qwen2_mha4l_bf16_pages: bf16 weights, bf16 pages, K=16"
    report, _ = run_config(label, cfg, params, {}, {}, MAIN_BF16,
                           one_launch="paged_decode_kernel",
                           model="qwen1.5-7b widths")
    family_summary(label, report)
    del params
    torch.cuda.empty_cache()


def int4_stack(gen, layers, shape):
    """``[layers, in, out]`` normal(0, 0.02) weights as ``init_params``
    draws them, int4 (the half-split layout of ``quantize_params(bits=4)``),
    drawn and quantized one ``[in, out]`` matrix at a time."""
    stacks, first = {}, None
    for i in range(layers):
        w = (torch.randn(shape, generator=gen, device=DEV) * 0.02).to(
            torch.bfloat16)
        part = quant.quantize_int4_split(w)
        if first is None:
            first = {f.name: getattr(part, f.name)
                     for f in dataclasses.fields(part)}
            stacks = {n: torch.empty((layers, *v.shape), dtype=v.dtype,
                                     device=DEV)
                      for n, v in first.items() if isinstance(v, torch.Tensor)}
        for n, v in stacks.items():
            v[i].copy_(getattr(part, n))
        del w, part
    return quant.QuantizedTensor4Split(**{**first, **stacks})


def int4_params(cfg, seed):
    """Random parameters of ``cfg`` as ``init_params`` and then
    ``quantize_params(bits=4)`` would give them (int4 projections and head,
    the embedding and norms in bf16), made one matrix at a time: a model
    whose bf16 weights do not fit the card (Llama-3-70B's 141 GB) never
    has them at once."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    layer, head = projections(cfg)
    h, n = cfg.hidden_size, cfg.num_layers
    params = {
        "embed": (torch.randn((cfg.vocab_size, h), generator=gen, device=DEV)
                  * 0.02).to(torch.bfloat16),
        "layers": {
            "attn_norm": torch.ones((n, h), dtype=torch.bfloat16, device=DEV),
            "mlp_norm": torch.ones((n, h), dtype=torch.bfloat16, device=DEV),
            **{name: int4_stack(gen, n, shape) for name, shape in layer.items()},
        },
        "final_norm": torch.ones((h,), dtype=torch.bfloat16, device=DEV),
    }
    if head is not None:
        params["lm_head"] = quant.quantize_int4_split(
            (torch.randn(head, generator=gen, device=DEV) * 0.02).to(
                torch.bfloat16))
    return params


def phase_widths():
    """Phase 3's head-width paths, each at full width through the smoke's
    traffic (as :func:`phase_families`' paths, twice, repeatable, counters
    zeroed and read, dispatch shapes replayed, a window and a prefill
    profiled, one attention launch a call): Qwen2.5-7B (G = 7, q/k/v
    biases) at its 28 layers in bf16 over bf16 pages (#1, #2); Llama-3-70B
    (G = 8) with int4 weights over int8 pages at its 80 layers, about 38 GB
    of int4 weights and heads made one matrix at a time (#4, #6, #7, #13,
    #14); Llama-3.2-1B (head_dim 64, tied head) at
    its 16 layers with int4 weights over the int8 dense cache (#3, #9, #10,
    #14) and in bf16 over bf16 pages (#1, #2). Returns launches by kernel,
    each from the first of these paths that runs it."""
    gen = torch.Generator(device=DEV)
    launches = {}

    def keep(got):
        for name, n in got.items():
            launches.setdefault(name, n)

    cfg = QWEN25_7B
    params = llama.init_params(cfg, gen.manual_seed(3), torch.bfloat16, DEV)
    for name in ("bq", "bk", "bv"):   # random biases: init's are zeros
        params["layers"][name].normal_(0.0, 0.5, generator=gen)
    label = "qwen25_7b_bf16_pages: bf16 weights, bf16 pages, K=16"
    report, got = run_config(label, cfg, params, {}, {}, MAIN_BF16,
                             one_launch="paged_decode_kernel",
                             model="qwen2.5-7b widths (G=7)")
    family_summary(label, report)
    keep(got)
    del params
    torch.cuda.empty_cache()

    cfg = LLAMA3_70B
    params = int4_params(cfg, 4)
    label = "llama3_70b_int4_int8pages: int4 weights, int8 pages, K=16"
    report, got = run_config(
        label, cfg, params, {}, {"kv_quant": "int8"}, MAIN_INT4,
        one_launch="fused_cluster_kernel", int4_launch=True,
        model="llama-3-70b widths (G=8)", int4_weights=True)
    family_summary(label, report)
    keep(got)
    del params
    torch.cuda.empty_cache()

    cfg = LLAMA32_1B
    params = llama.init_params(cfg, gen.manual_seed(5), torch.bfloat16, DEV)
    label = "llama32_1b_int4_int8dense: int4 weights, int8 dense KV, K=16"
    tied_dense = {k: v for k, v in MAIN_DENSE.items() if k != "int4_matmul"}
    report, got = run_config(
        label, cfg, params, {"quantization": "int4"},
        {"kv_quant": "int8", **DENSE}, tied_dense,
        one_launch="fused_cluster_kernel", int4_launch=True,
        model="llama-3.2-1b widths (D=64)")
    family_summary(label, report)
    keep(got)
    label = "llama32_1b_bf16_pages: bf16 weights, bf16 pages, K=16"
    report, got = run_config(label, cfg, params, {}, {}, MAIN_BF16,
                             one_launch="paged_decode_kernel",
                             model="llama-3.2-1b widths (D=64)")
    family_summary(label, report)
    keep(got)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_parity_widths():
    """Phase 4 at the new widths, 2 layers in f32, TF32 off, greedy
    streams: Qwen2.5-7B's (G = 7) on bf16 pages at K = 16, K = 1 and on the
    gather path, identical, and on int8 pages with kernels against without
    at K = 1, identical (K = 16 against K = 1 shown: the fused step rounds
    p * vs to bf16 as the TPU kernel does); Llama-3.2-1B's (D = 64) on bf16
    pages the same, and over the int8 dense cache #8 against without at
    K = 1, identical, K = 16 (#9, #10) against K = 1 shown."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gather = dict(use_pallas_attention=False, ragged_attention=False)
    k1 = {"decode_steps": 1}
    report = {"phase": "parity_widths",
              "model": "qwen2.5-7b and llama-3.2-1b widths, 2 layers, f32, "
                       "tf32 off"}
    for name, base in (("qwen25_7b", QWEN25_7B), ("llama32_1b", LLAMA32_1B)):
        cfg = dataclasses.replace(base, num_layers=2)
        params = llama.init_params(
            cfg, torch.Generator(device=DEV).manual_seed(1), torch.float32,
            DEV)
        before = (pa.launches, ra.launches)
        kern16, e16 = parity_run(cfg, params, {}, {})
        assert e16.decode_steps == 16 and e16.cache.use_kernel
        assert pa.launches > before[0] and ra.launches > before[1]
        kern1, _ = parity_run(cfg, params, k1, {})
        gath, e2 = parity_run(cfg, params, gather, {})
        assert not e2.cache.use_kernel
        assert all(len(x) == 16 for x in kern16)
        assert kern16 == kern1 == gath, (
            f"{name} bf16 pool: K=16, K=1 and gather streams differ")
        entry = {"streams": len(kern16), "tokens_each": 16,
                 "bf16_k16_equals_k1_equals_gather": True}
        if name == "qwen25_7b":
            ckw = {"kv_quant": "int8"}
            before = (pa.quantized_launches, ra.quantized_launches)
            kern1, e1 = parity_run(cfg, params, k1, ckw)
            assert e1.cache.use_kernel and e1.cache.use_ragged
            assert pa.quantized_launches > before[0]
            assert ra.quantized_launches > before[1]
            gath, e2 = parity_run(cfg, params, {**k1, **gather}, ckw)
            assert not e2.cache.use_kernel
            assert kern1 == gath, "qwen2.5-7b int8 pool: #5 and gather differ"
            entry["int8_pages_kernel_equals_gather_k1"] = True
        else:
            ckw = {"kv_quant": "int8", **DENSE}
            before = qa.decode_launches
            kern1, e1 = parity_run(cfg, params, k1, ckw)
            assert e1.cache.use_kernel and qa.decode_launches > before
            plain1, e2 = parity_run(
                cfg, params, {"use_pallas_attention": False, **k1}, ckw)
            assert not e2.cache.use_kernel
            assert kern1 == plain1, "llama-3.2-1b int8 dense: #8 and plain differ"
            entry["int8_dense_kernel_equals_plain_k1"] = True
        before = (qa.fused_launches + pa.fused_launches)
        kern16, e16 = parity_run(cfg, params, {}, ckw)
        assert e16.decode_steps == 16
        assert qa.fused_launches + pa.fused_launches > before
        share, first = shares(kern16, kern1)
        entry["int8_k16_vs_k1_equal_token_share"] = share
        entry["int8_k16_vs_k1_first_divergence"] = first
        report[name] = entry
        del params
        torch.cuda.empty_cache()
    emit(report)


def phase_parity_families():
    """Phase 4 for the later families, 2 layers of their widths in f32,
    TF32 off, greedy streams: Mixtral on bf16 pages at K = 16, K = 1 and on
    the gather path, identical; Mixtral over the int8 dense cache with #8
    against without at K = 1, identical, and K = 16 against K = 1, the
    share of equal tokens shown; `moe_mlp_dispatch` at full capacity
    against the dense combine on a 2048-token prefill, its error printed;
    Mistral (window 128, live under the 200- and 600-token prompts) on
    bf16 pages with kernels at K = 16 and K = 1 against the gather path,
    and on int8 pages with kernels against without at K = 1, identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gather = dict(use_pallas_attention=False, ragged_attention=False)
    k1 = {"decode_steps": 1}
    report = {"phase": "parity_families",
              "model": "mixtral-8x7b and mistral-7b widths, 2 layers, f32, "
                       "tf32 off"}

    cfg = dataclasses.replace(MIXTRAL_8L, num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(1), torch.float32, DEV)
    before = pa.launches
    kern16, e16 = parity_run(cfg, params, {}, {})
    assert e16.decode_steps == 16 and pa.launches > before
    kern1, _ = parity_run(cfg, params, k1, {})
    gath, e2 = parity_run(cfg, params, gather, {})
    assert e2.decode_steps == 1 and not e2.cache.use_kernel
    assert all(len(x) == 16 for x in kern16)
    assert kern16 == kern1, "mixtral bf16 pool: K=16 and K=1 streams differ"
    assert kern1 == gath, "mixtral bf16 pool: kernel and gather streams differ"
    report["mixtral_bf16_pages"] = {"streams": len(kern16), "tokens_each": 16,
                                    "k16_equals_k1": True,
                                    "kernel_equals_gather": True}
    ckw = {"kv_quant": "int8", **DENSE}
    before = qa.decode_launches
    kern1, e1 = parity_run(cfg, params, k1, ckw)
    assert e1.cache.use_kernel and qa.decode_launches > before
    plain1, e2 = parity_run(cfg, params, {"use_pallas_attention": False, **k1},
                            ckw)
    assert not e2.cache.use_kernel
    assert kern1 == plain1, "mixtral int8 dense: #8 and plain streams differ"
    before = (qa.fused_launches, qa.flush_launches)
    kern16, e16 = parity_run(cfg, params, {}, ckw)
    assert e16.decode_steps == 16
    assert qa.fused_launches > before[0] and qa.flush_launches > before[1]
    share, first = shares(kern16, kern1)
    report["mixtral_int8_dense"] = {
        "streams": len(kern1), "tokens_each": 16,
        "kernel_equals_plain_k1": True,
        "k16_vs_k1_equal_token_share": share,
        "k16_vs_k1_first_divergence": first}
    p = {k: params["layers"][k][0] for k in MOE_KEYS}
    x = torch.randn((1, 2048, cfg.hidden_size), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(5))
    dense = moe.moe_mlp(cfg, p, x.reshape(-1, 1, cfg.hidden_size)).reshape(
        x.shape)
    full = moe.moe_mlp_dispatch(cfg, p, x,
                                capacity_factor=float(cfg.num_experts))
    err = max_err(full, dense)
    assert err <= TOL[torch.float32], err
    report["moe_dispatch_full_capacity_vs_dense"] = {
        "tokens": 2048, "max_abs_err": err, "tolerance": TOL[torch.float32],
        "max_abs_out": float(dense.abs().max())}
    del params, p, x, dense, full
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(1), torch.float32, DEV)
    kern16, e16 = parity_run(cfg, params, {}, {})
    assert e16.decode_steps == 16 and e16.cache.use_kernel
    kern1, _ = parity_run(cfg, params, k1, {})
    gath, _ = parity_run(cfg, params, gather, {})
    assert kern16 == kern1 == gath, (
        "mistral window 128, bf16 pool: kernel and gather streams differ")
    ckw = {"kv_quant": "int8"}
    before = (pa.quantized_launches, ra.quantized_launches)
    kern1, e1 = parity_run(cfg, params, k1, ckw)
    assert e1.cache.use_kernel and e1.cache.use_ragged
    assert pa.quantized_launches > before[0]
    assert ra.quantized_launches > before[1]
    gath, e2 = parity_run(cfg, params, {**k1, **gather}, ckw)
    assert not e2.cache.use_kernel
    assert kern1 == gath, (
        "mistral window 128, int8 pool: kernel and gather streams differ")
    report["mistral_swa128"] = {
        "streams": len(kern1), "tokens_each": 16, "sliding_window": 128,
        "bf16_k16_equals_k1_equals_gather": True,
        "int8_kernel_equals_gather_k1": True}
    del params
    torch.cuda.empty_cache()
    emit(report)


def parity_run(cfg, params, ekw, ckw, capture=True):
    """Phase 4's traffic through one f32 engine configuration: six greedy
    prompts of 20-200 tokens, 16 new tokens each, then after four steps a
    600-token one (chunk-admitted beside live decode on the pools, chunked
    on the dense caches and rings). Returns (streams, engine)."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (20, 200, 63, 64, 65, 130)]
    long_prompt = rng.integers(0, cfg.vocab_size, size=600).tolist()
    opts = SamplingOptions(max_new_tokens=16)
    if ckw.get("kind") == "dense":
        ekw = {**ekw, "decode_windows": (384, 768, 1024)}
    engine = InferenceEngine(
        cfg, params,
        EngineConfig(max_batch_size=4, prefill_buckets=(64, 256),
                     max_seq_len=1024, dtype="float32", **ekw),
        CacheConfig(num_pages=128, max_pages_per_session=16, **ckw),
        device=DEV)
    if not capture:
        engine._fused.capture = False
    client = Client(engine)
    for p in prompts:
        client.submit(p, opts)
    for _ in range(4):
        client.step()
    client.submit(long_prompt, opts)
    streams = client.drain()
    if engine.allocator is not None:
        assert engine.allocator.free_count == 127
    return streams, engine


def shares(a, b):
    """Share of equal tokens of two stream sets, and the first (stream,
    token) where they part."""
    equal = sum(x == y for s, t in zip(a, b) for x, y in zip(s, t))
    first = next(((i, j) for i, (s, t) in enumerate(zip(a, b))
                  for j, (x, y) in enumerate(zip(s, t)) if x != y), None)
    return equal / sum(len(s) for s in b), first


def phase_parity():
    """Through the whole engine, 2 layers of the same widths in f32, TF32
    off, greedy streams: the bf16 pool at K = 16 and K = 1 and on the gather
    path, all identical; int4 weights over the int8 pool, kernels against
    the gather path at K = 1, identical, and K = 16 against K = 1, the share
    of equal tokens and the first divergence printed (the fused kernels
    round p * vs to bf16 as the TPU kernel does, #5 does not; the binding
    parity of that pool is the CPU test against the JAX package). The
    dense caches, held to rungs of 384, 768 and 1024 positions (multiples
    of 128, so that flash takes their prefills): the model-dtype cache with
    flash (K = 1) against without it at K = 1 and at K = 16, identical; the
    int8 cache at K = 1 with #8 against without it, identical, and K = 16
    (#9, #10) against K = 1, shown as above. The int8 sink ring (window
    256): its kernels (#11, #12) against their plain versions and captured
    against eager, identical; against the segments path and K = 1,
    shown. The model-dtype sink ring (window 256, K = 1): flash prefill
    against without, identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(1), torch.float32, DEV)

    def run(ekw, ckw, capture=True):
        return parity_run(cfg, params, ekw, ckw, capture)

    report = {"phase": "parity",
              "model": "llama-3-8b widths, 2 layers, f32, tf32 off"}
    gather = dict(use_pallas_attention=False, ragged_attention=False)
    k1 = {"decode_steps": 1}

    # The model-dtype pool: the kernel route at K = 16 (the default) and at
    # K = 1, and the gather path (K = 1: no tail without the kernel).
    before = pa.launches
    kern16, e16 = run({}, {})
    assert e16.decode_steps == 16 and pa.launches > before
    kern1, _ = run(k1, {})
    gath, e2 = run(gather, {})
    assert e2.decode_steps == 1 and not e2.cache.use_kernel
    assert all(len(x) == 16 for x in kern16)
    assert kern16 == kern1, "bf16 pool: K=16 and K=1 streams differ"
    assert kern1 == gath, "bf16 pool: kernel path and gather path streams differ"
    report["bf16"] = {"streams": len(kern16), "tokens_each": 16,
                      "k16_equals_k1": True, "kernel_equals_gather": True,
                      "chunked_rows_kernel_run": e16.metrics.get_counter(
                          "attn_chunked_rows")}

    # int4 weights over the int8 pool: kernels against the gather path at
    # K = 1 (#5 and the gather take p * vs in f32); the fused window (#6,
    # #9 round p * vs to bf16 as the TPU kernels do) against K = 1, shown.
    ekw, ckw = {"quantization": "int4"}, {"kv_quant": "int8"}
    before = (pa.quantized_launches, ra.quantized_launches, qm.launches,
              qm.stacked_launches)
    kern1, e1 = run({**ekw, **k1}, ckw)
    assert e1.cache.use_kernel and e1.cache.use_ragged
    mid = (pa.quantized_launches, ra.quantized_launches, qm.launches,
           qm.stacked_launches)
    assert all(m > b for m, b in zip(mid, before))
    gath, e2 = run({**ekw, **k1, **gather}, ckw)
    assert not e2.cache.use_kernel and not e2.cache.use_ragged
    assert (pa.quantized_launches, ra.quantized_launches) == mid[:2], (
        "gather path launched an attention kernel")
    assert kern1 == gath, "int4/int8: kernel path and gather path streams differ"
    fused_before = pa.fused_launches + qa.fused_launches
    kern16, e16 = run(ekw, ckw)
    assert e16.decode_steps == 16
    assert pa.fused_launches + qa.fused_launches > fused_before
    share, first = shares(kern16, kern1)
    report["int4_int8kv"] = {
        "streams": len(kern1), "tokens_each": 16,
        "kernel_equals_gather_k1": True,
        "k16_vs_k1_equal_token_share": share,
        "k16_vs_k1_first_divergence": first,
    }

    # The model-dtype dense cache: flash (K = 1) against the plain route at
    # K = 1 and at K = 16 (its tail in plain PyTorch).
    before = fa.launches
    flash, ef = run({"use_pallas_attention": True}, DENSE)
    assert ef.decode_steps == 1 and fa.launches > before
    plain1, _ = run({"use_pallas_attention": False, **k1}, DENSE)
    plain16, ep = run({"use_pallas_attention": False}, DENSE)
    assert ep.decode_steps == 16
    assert all(len(x) == 16 for x in flash)
    assert flash == plain1, "bf16 dense: flash and plain streams differ"
    assert plain1 == plain16, "bf16 dense: K=16 and K=1 streams differ"
    report["bf16_dense"] = {"streams": len(flash), "tokens_each": 16,
                            "flash_equals_plain_k1": True,
                            "k16_equals_k1": True,
                            "flash_launches": fa.launches - before}

    # The int8 dense cache: #8 against the plain int8-score path at K = 1;
    # the window (#9, #10) against K = 1, shown.
    ckw = {"kv_quant": "int8", **DENSE}
    before = qa.decode_launches
    kern1, e1 = run(k1, ckw)
    assert e1.cache.use_kernel and qa.decode_launches > before
    plain1, e2 = run({"use_pallas_attention": False, **k1}, ckw)
    assert not e2.cache.use_kernel
    assert kern1 == plain1, "int8 dense: #8 and plain streams differ"
    before = (qa.fused_launches, qa.flush_launches)
    kern16, e16 = run({}, ckw)
    assert e16.decode_steps == 16
    assert qa.fused_launches > before[0] and qa.flush_launches > before[1]
    share, first = shares(kern16, kern1)
    report["int8_dense"] = {
        "streams": len(kern1), "tokens_each": 16,
        "kernel_equals_plain_k1": True,
        "k16_vs_k1_equal_token_share": share,
        "k16_vs_k1_first_divergence": first,
    }

    # The int8 sink ring (window 256, 4 sinks: the 600-token prompt is
    # chunked at 252 and wraps the ring): the window on its kernels (#11,
    # #12, captured) against the same path through their plain versions
    # (eager) and against itself eager, identical; against the segments
    # path (use_kernel off) and K = 1, shown.
    ckw = {"kind": "sink", "kv_quant": "int8", "window_length": 256,
           "num_sink_tokens": 4}
    before = (qa.sink_launches, qa.sink_flush_launches)
    kern16, e16 = run({}, ckw)
    assert e16.decode_steps == 16 and e16.cache.use_kernel
    assert qa.sink_launches > before[0] and qa.sink_flush_launches > before[1]
    eager16, _ = run({}, ckw, capture=False)
    assert kern16 == eager16, "int8 sink: captured and eager streams differ"
    real = (qa.sink_fused_decode_attention, qa.sink_tail_flush)
    qa.sink_fused_decode_attention = qa.sink_fused_decode_attention_plain
    qa.sink_tail_flush = qa.sink_tail_flush_plain
    try:
        mid = (qa.sink_launches, qa.sink_flush_launches)
        plain16, _ = run({}, ckw, capture=False)
        assert (qa.sink_launches, qa.sink_flush_launches) == mid
    finally:
        qa.sink_fused_decode_attention, qa.sink_tail_flush = real
    assert kern16 == plain16, "int8 sink: kernel and plain streams differ"
    seg16, es = run({"use_pallas_attention": False}, ckw)
    assert es.decode_steps == 16 and not es.cache.use_kernel
    k1, e1 = run({"decode_steps": 1}, ckw)
    assert e1.decode_steps == 1
    share_seg, first_seg = shares(kern16, seg16)
    share_k1, first_k1 = shares(kern16, k1)
    report["int8_sink"] = {
        "streams": len(kern16), "tokens_each": 16,
        "kernel_equals_plain": True, "captured_equals_eager": True,
        "kernel_vs_segments_equal_token_share": share_seg,
        "kernel_vs_segments_first_divergence": first_seg,
        "k16_vs_k1_equal_token_share": share_k1,
        "k16_vs_k1_first_divergence": first_k1,
    }

    # The model-dtype sink ring (window 256, 4 sinks, K = 1): flash (#3)
    # under the ring's re-rotated keys and liveness mask against the same
    # path without it. Every prefill tiles (buckets of 64 and 256 queries
    # over 256 slots); the 600-token prompt is chunked at 252 and wraps.
    ckw = {"kind": "sink", "window_length": 256, "num_sink_tokens": 4}
    before = fa.launches
    flash, ef = run({"use_pallas_attention": True}, ckw)
    assert ef.decode_steps == 1 and fa.launches > before
    mid = fa.launches
    plain, ep = run({"use_pallas_attention": False}, ckw)
    assert ep.decode_steps == 1 and fa.launches == mid
    assert all(len(x) == 16 for x in flash)
    assert flash == plain, "bf16 sink: flash and plain streams differ"
    report["bf16_sink"] = {"streams": len(flash), "tokens_each": 16,
                           "flash_equals_plain": True,
                           "flash_launches": mid - before}
    emit(report)


# ---------------------------------------------------------------------------
# phase 5: serve — a checkpoint loaded and served through the OpenAI gateway
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
PKG = "distributed_llm_inference_tpu_torch"
SERVE_LAYERS = 2  # full width, cut depth: about 2.9 GB of bf16 files
# Our name -> (HF key suffix, stored [out, in] and transposed), spelled out
# here rather than taken from the loader under test.
HF_KEYS = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "wg": ("mlp.gate_proj.weight", True),
    "wu": ("mlp.up_proj.weight", True),
    "wd": ("mlp.down_proj.weight", True),
}
# The gateway's traffic: (prompt length, body fields, what the client
# does). The first request's window is the first one captured; the rest
# arrive while the capture is held.
SERVE_TRAFFIC = (
    (20, {}, "json"),
    (2100, {"stream": True}, "sse"),
    (700, {"stream": True}, "sse"),
    (300, {"temperature": 0.8, "top_p": 0.9}, "json"),
    (1500, {}, "json"),
    (64, {}, "json"),
    (100, {"stream": True, "max_tokens": 2000}, "disconnect"),
    (40, {"max_tokens": 2048, "timeout_s": 1.0}, "deadline"),
)
SERVE_NEW = 32
API_PROMPTS = (40, 333, 1200)  # the api subprocess's greedy prompts
API_NEW = 24


# DeepSeek-V2's latent (MLA) attention keys beside q_proj and o_proj.
MLA_HF = {"wkv_a": "self_attn.kv_a_proj_with_mqa.weight",
          "kv_norm": "self_attn.kv_a_layernorm.weight",
          "kv_b": "self_attn.kv_b_proj.weight"}
# Mixtral's per-layer MoE keys: the router, and each expert's three linears
# (``w1`` gate, ``w3`` up, ``w2`` down) -> our expert stacks.
MOE_ROUTER = "block_sparse_moe.gate.weight"
EXPERT_HF = {"we_g": ("w1", "wg"), "we_u": ("w3", "wu"), "we_d": ("w2", "wd")}


def layer_keys(cfg):
    """One layer's tensors as the HF layout stores them: (our name, expert
    index or None, HF key suffix, HF shape, stored [out, in] and
    transposed). A Mixtral layer has the router and each expert's linears
    in place of the dense MLP's."""
    h, d, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    shapes = {"attn_norm": (h,), "wq": (cfg.num_heads * d, h),
              "wk": (cfg.num_kv_heads * d, h), "wv": (cfg.num_kv_heads * d, h),
              "wo": (h, cfg.num_heads * d), "mlp_norm": (h,),
              "wg": (inter, h), "wu": (inter, h), "wd": (h, inter)}
    if cfg.use_latent:
        # DeepSeek-V2's attention: q_proj of Hq * (nope + rope), the joint
        # kv_a_proj_with_mqa and its norm, kv_b_proj (split on load into
        # wk_b and wv_b: "kv_b" here) in place of k_proj and v_proj.
        lat = cfg.latent
        dn = lat.nope_head_dim or d
        shapes["wq"] = (cfg.num_heads * (dn + lat.rope_head_dim), h)
        mla = [("wkv_a", None, MLA_HF["wkv_a"],
                (lat.rank + lat.rope_head_dim, h), True),
               ("kv_norm", None, MLA_HF["kv_norm"], (lat.rank,), False),
               ("kv_b", None, MLA_HF["kv_b"],
                (cfg.num_heads * (dn + d), lat.rank), True)]
        return [(name, None, suffix, shapes[name], transpose)
                for name, (suffix, transpose) in HF_KEYS.items()
                if name not in ("wk", "wv")] + mla
    moe_mlp = cfg.num_experts > 0
    out = [(name, None, suffix, shapes[name], transpose)
           for name, (suffix, transpose) in HF_KEYS.items()
           if not (moe_mlp and name in ("wg", "wu", "wd"))]
    if moe_mlp:
        out.append(("router", None, MOE_ROUTER, (cfg.num_experts, h), True))
        for name, (w, dense) in EXPERT_HF.items():
            out += [(name, e, f"block_sparse_moe.experts.{e}.{w}.weight",
                     shapes[dense], True) for e in range(cfg.num_experts)]
    return out


def hf_config(cfg):
    """``config.json`` of ``cfg`` as transformers writes a Llama's, a
    Mixtral's for an MoE config, or a DeepSeek-V2's (the keys the loader
    reads) for a latent one."""
    if cfg.use_latent:
        lat = cfg.latent
        return {
            "architectures": ["DeepseekV2ForCausalLM"],
            "model_type": "deepseek_v2", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "kv_lora_rank": lat.rank, "qk_rope_head_dim": lat.rope_head_dim,
            "qk_nope_head_dim": lat.nope_head_dim,
            "v_head_dim": cfg.head_dim, "q_lora_rank": None,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "max_position_embeddings": cfg.max_position_embeddings,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        }
    if cfg.num_experts > 0:
        return {
            "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "rms_norm_eps": cfg.rms_norm_eps,
            "rope_theta": cfg.rope_theta,
            "max_position_embeddings": cfg.max_position_embeddings,
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "sliding_window": None, "tie_word_embeddings": False,
            "torch_dtype": "bfloat16",
        }
    rs = cfg.rope_scaling
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": False, "torch_dtype": "bfloat16",
        "rope_scaling": {
            "rope_type": rs.rope_type, "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings":
                rs.original_max_position_embeddings,
        },
    }


def write_checkpoint(root, cfg, seed, dev):
    """A bf16 HF checkpoint of ``cfg`` drawn from a seeded generator on
    ``dev``, written by the port's writer: the embedding and the first half
    of the layers in one shard, the rest, the final norm and the head in
    another, an index and config.json. Returns the HF state (on ``dev``)
    and the seconds the writing took."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape, base=0.0):
        w = torch.randn(shape, generator=gen, device=dev) * 0.02 + base
        return w.to(torch.bfloat16)

    h = cfg.hidden_size
    state = {"model.embed_tokens.weight": draw(cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        for name, _, suffix, shape, _ in layer_keys(cfg):
            state[f"model.layers.{i}.{suffix}"] = draw(
                *shape, base=1.0 if name.endswith("norm") else 0.0)
    state["model.norm.weight"] = draw(h, base=1.0)
    if not cfg.tie_word_embeddings:
        state["lm_head.weight"] = draw(cfg.vocab_size, h)

    def shard_of(key):
        late = key in ("model.norm.weight", "lm_head.weight") or (
            key.startswith("model.layers.")
            and int(key.split(".")[2]) >= cfg.num_layers // 2)
        return f"model-0000{2 if late else 1}-of-00002.safetensors"

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weight_map = {k: shard_of(k) for k in state}
    for shard in sorted(set(weight_map.values())):
        checkpoint.save_safetensors(
            {k: v for k, v in state.items() if weight_map[k] == shard},
            str(Path(root) / shard))
    total = sum(v.numel() * v.element_size() for v in state.values())
    (Path(root) / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    (Path(root) / "config.json").write_text(json.dumps(hf_config(cfg)))
    return state, time.perf_counter() - t0


def check_info(root, cfg):
    """The ``info`` subcommand, run as a user would."""
    r = subprocess.run([sys.executable, "-m", PKG, "info", "--model", root],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    info = json.loads(r.stdout)
    want = {"family": cfg.family, "supported": True,
            "num_layers": cfg.num_layers, "hidden_size": cfg.hidden_size,
            "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "vocab_size": cfg.vocab_size, "num_experts": cfg.num_experts}
    assert {k: info[k] for k in want} == want, info
    return info


def check_loaded(params, state, cfg):
    """Every loaded tensor bitwise equal to the written one (transposed
    where HF stores ``[out, in]``; an expert's in its slot of the stack).
    Returns the number of tensors compared."""
    def same(a, b):
        return a.shape == b.shape and torch.equal(
            a.view(torch.int16), b.view(torch.int16))

    keys = layer_keys(cfg)
    for i in range(cfg.num_layers):
        for name, e, suffix, _, transpose in keys:
            w = state[f"model.layers.{i}.{suffix}"]
            if name == "kv_b":
                # [Hq * (dn + D), rank] -> wk_b [rank, Hq, dn], wv_b
                dn = cfg.latent.nope_head_dim or cfg.head_dim
                kvb = w.T.reshape(cfg.latent.rank, cfg.num_heads, -1)
                for part, want in (("wk_b", kvb[..., :dn]),
                                   ("wv_b", kvb[..., dn:])):
                    assert same(params["layers"][part][i],
                                want.contiguous()), (
                        f"layer {i} {part} differs from kv_b_proj's part")
                continue
            got = params["layers"][name][i]
            if e is not None:
                got = got[e]
            assert same(got, w.T if transpose else w), (
                f"layer {i} {name} {e} differs from the written tensor")
    names = {name for name, *_ in keys}
    if "kv_b" in names:
        names = (names - {"kv_b"}) | {"wk_b", "wv_b"}
    assert set(params["layers"]) == names
    assert same(params["embed"], state["model.embed_tokens.weight"])
    assert same(params["final_norm"], state["model.norm.weight"])
    # kv_b_proj is compared as its two parts
    per_layer = len(keys) + sum(name == "kv_b" for name, *_ in keys)
    if cfg.tie_word_embeddings:
        assert "lm_head" not in params
        return 2 + cfg.num_layers * per_layer
    assert same(params["lm_head"], state["lm_head.weight"].T)
    return 2 + cfg.num_layers * per_layer + 1


def http_post(port, body, timeout=600):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, resp.getheader("Content-Type"), resp.read())
    conn.close()
    return out


def sse_chunks(raw):
    events = [e.strip()[len(b"data: "):].decode()
              for e in raw.split(b"\n\n") if e.strip().startswith(b"data: ")]
    assert events and events[-1] == "[DONE]", "the stream did not end in [DONE]"
    return [json.loads(e) for e in events[:-1]]


def one_request(port, body, kind, vocab):
    """One client of the gateway: sends ``body`` and checks what comes
    back for its ``kind``. Returns (tokens received, wire finish reason)."""
    conn, resp = http_post(port, body)
    assert resp.status == 200, (resp.status, resp.read())
    if kind == "disconnect":
        first = resp.fp.readline()
        assert first.startswith(b"data: "), first
        tokens = json.loads(first[len(b"data: "):])["choices"][0]["token_ids"]
        resp.close()
        conn.close()  # mid-stream: the gateway must cancel the generation
        return tokens, None
    raw = resp.read()
    conn.close()
    if kind == "sse":
        assert resp.getheader("Content-Type") == "text/event-stream"
        chunks = sse_chunks(raw)
        toks = [c for c in chunks if c["choices"][0]["token_ids"]]
        assert [c["seq"] for c in toks] == list(range(len(toks)))
        assert chunks[-1]["usage"]["completion_tokens"] == len(toks)
        tokens = [c["choices"][0]["token_ids"][0] for c in toks]
        reason = chunks[-1]["choices"][0]["finish_reason"]
    else:
        doc = json.loads(raw)
        tokens = doc["choices"][0]["token_ids"]
        reason = doc["choices"][0]["finish_reason"]
        assert doc["usage"]["completion_tokens"] == len(tokens)
    assert all(0 <= t < vocab for t in tokens), "a token out of range"
    if kind == "deadline":
        assert reason == "timeout" and len(tokens) < body["max_tokens"], (
            reason, len(tokens))
    else:
        assert reason == "length" and len(tokens) == body["max_tokens"], (
            kind, reason, len(tokens))
    return tokens, reason


def serve_traffic(engine, vocab, seed):
    """``SERVE_TRAFFIC`` through ``ApiServer.start()`` over
    ``EngineBackend``, all requests at once but the first, whose window's
    capture (where the engine captures) is held until another request has
    reached the gateway: the gateway parses and submits while the driver
    captures, and a CUDA call from its thread would fail the capture. Then
    ``/metrics`` and ``/healthz``, and a drain. Returns the report."""
    rng = np.random.default_rng(seed)
    bodies = [dict({"prompt": rng.integers(0, vocab, size=n).tolist(),
                    "max_tokens": SERVE_NEW}, **fields)
              for n, fields, _ in SERVE_TRAFFIC]
    backend = EngineBackend(engine)
    server = ApiServer(backend, ServingConfig(host="127.0.0.1", port=0))
    # Every engine.step() the driver thread makes, (start, end): the
    # engine reaps a deadline only between two of them.
    ticks, step = [], engine.step

    def timed_step():
        t0 = time.monotonic()
        try:
            return step()
        finally:
            ticks.append((t0, time.monotonic()))

    engine.step = timed_step
    capturing, arrived = threading.Event(), threading.Event()
    held = []  # requests that reached the engine while the capture was held
    fused = engine._fused
    holds = fused is not None and fused.capture
    if holds:
        step_fn = fused._step_fn

        def held_step_fn(*args):
            if not capturing.is_set() and torch.cuda.is_current_stream_capturing():
                capturing.set()
                if not arrived.wait(120):
                    raise RuntimeError("no request reached the gateway "
                                       "while the first window was captured")
            return step_fn(*args)

        fused._step_fn = held_step_fn
    submit, cancel, cancelled = backend.submit, backend.cancel, []

    def watched_submit(*args):
        h = submit(*args)
        if capturing.is_set() and not arrived.is_set():
            held.append(h.gen_id)
            arrived.set()
        return h

    def watched_cancel(h):
        cancelled.append(h.gen_id)
        cancel(h)

    backend.submit, backend.cancel = watched_submit, watched_cancel
    results, errors = [None] * len(bodies), []

    def client(i):
        try:
            results[i] = one_request(server.port, bodies[i],
                                     SERVE_TRAFFIC[i][2], vocab)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((i, e))

    server.start()
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        threads[0].start()
        if holds:
            assert capturing.wait(600), "the first window was never captured"
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        assert not any(t.is_alive() for t in threads), "a client hung"
        if errors:
            raise errors[0][1]
        deadline = time.monotonic() + 60
        while backend.active_sessions() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert backend.active_sessions() == 0, "a session outlived its client"
        status, ctype, text = http_get(server.port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        text = text.decode()
        names = ["dli_ttft_seconds", "dli_gateway_tokens_total",
                 f"dli_http_requests_total {len(bodies)}",
                 "dli_queue_depth", "dli_active_sessions"]
        if holds:
            names.append("dli_decode_graph_captures_total")
        for name in names:
            assert name in text, f"/metrics lacks {name}"
        status, _, health = http_get(server.port, "/healthz")
        health = json.loads(health)
        assert status == 200 and health["status"] == "ok", health
        assert health["breaker"] == "closed", health
    finally:
        server.request_shutdown()
        server.join(timeout=120)
    assert not server._thread.is_alive(), "the gateway did not drain"
    assert backend.error is None, backend.error
    if holds:
        assert held, "no request arrived during the first capture"
    m = engine.metrics
    assert cancelled, "the disconnected stream was never cancelled"
    # The engine reaps a deadline between two steps; a step, or a gap
    # between steps, longer than the gateway's 0.5 s grace lets the
    # gateway cancel first. The deadline request is the last to finish,
    # so the driver has work from the first step to the last.
    slowest = {k: max(m._timings.get(k) or [0.0])
               for k in ("prefill", "decode_step", "decode_graph_capture")}
    slowest["step"] = max(b - a for a, b in ticks)
    slowest["gap_between_steps"] = max(
        [b[0] - a[1] for a, b in zip(ticks, ticks[1:])] or [0.0])
    assert m.get_counter("sessions_deadline_expired") >= 1, (
        "the expired request was not reaped by its deadline (the engine's "
        f"slowest calls, s: {slowest})")
    return {
        "requests": len(bodies), "wall_s": wall,
        "gateway_tokens": m.get_counter("gateway_tokens"),
        "tokens_per_s": m.get_counter("gateway_tokens") / wall,
        "ttft_p50_s": m.percentile("ttft", 50),
        "ttft_p99_s": m.percentile("ttft", 99),
        "engine_ttft_p50_s": m.percentile("engine_ttft", 50),
        "requests_held_in_capture": len(held),
        "graph_captures": m.get_counter("decode_graph_captures"),
        "cancelled_by_disconnect": len(cancelled),
        "deadline_expired": m.get_counter("sessions_deadline_expired"),
        "slowest_s": slowest,
        "by_request": [
            {"prompt": n, "kind": kind, "tokens": len(r[0]), "finish": r[1]}
            for (n, _, kind), r in zip(SERVE_TRAFFIC, results)],
    }


def read_line(proc, timeout):
    """The next stdout line of ``proc``, or None after ``timeout`` s."""
    line = []
    t = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    return line[0] if line and line[0] else None


def api_subprocess(root, cfg, dev, log):
    """``python -m distributed_llm_inference_tpu_torch api --dtype float32``
    as a subprocess: 3 greedy requests, one at a time, each equal token for
    token to ``InferenceEngine.generate`` of the same prompt (the api's
    engine configuration, one engine, the prompts in the same order) on the
    same weights loaded in this process; then SIGTERM: a drain, exit 0."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in API_PROMPTS]
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", PKG, "api", "--model", root, "--port", "0",
             "--host", "127.0.0.1", "--dtype", "float32"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        # The reference, while the subprocess loads.
        params = checkpoint.load_model_params(root, cfg, torch.float32,
                                              device=dev)
        engine = InferenceEngine(
            cfg, params, EngineConfig(max_batch_size=8, max_seq_len=2048,
                                      dtype="float32"),
            CacheConfig(), device=dev)
        path = {"decode_steps": engine.decode_steps,
                "decode_kernel": engine.cache.use_kernel}
        opts = SamplingOptions(max_new_tokens=API_NEW)
        want = [engine.generate([p], opts)[0] for p in prompts]
        del engine, params
        torch.cuda.empty_cache()
        line = read_line(proc, 600)
        assert line is not None, (
            f"api never came up: {Path(log).read_text()[-4000:]}")
        up = json.loads(line)
        assert up["event"] == "api_up", up
        up_s = time.perf_counter() - t0
        got = []
        for p in prompts:
            conn, resp = http_post(up["port"], {"prompt": p,
                                                "max_tokens": API_NEW})
            assert resp.status == 200
            doc = json.loads(resp.read())
            conn.close()
            assert doc["choices"][0]["finish_reason"] == "length"
            got.append(doc["choices"][0]["token_ids"])
        assert got == want, (
            "the api's greedy f32 completions differ from generate: "
            f"{[sum(a == b for a, b in zip(g, w)) for g, w in zip(got, want)]}"
            " equal tokens")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        assert rc == 0, f"api exited {rc}: {Path(log).read_text()[-4000:]}"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    return {"requests": len(prompts), "prompt_lens": list(API_PROMPTS),
            "tokens_each": API_NEW, "equal_to_generate": True,
            "up_s": up_s, "exit_code": rc, **path}


LOCAL_INT4 = {"int4_matmul": (qm, "launches"),
              "int4_matmul_stacked": (qm, "stacked_launches"),
              "quantized_ragged_paged_attention": (ra, "quantized_launches"),
              "quantized_paged_fused_attention": (pa, "fused_launches"),
              "paged_tail_flush": (pa, "flush_launches")}


def local_run(root, cfg, int4, counters=None, extra=()):
    """``local`` on the checkpoint in bf16, or with ``int4`` as ``local
    --quantize int4 --kv-quant int8``, in this process (so that its
    kernels' launches can be counted): a 1000-token prompt (the table past
    768 slots: the int8 window reads the pool in place), 32 new tokens.
    With int4 the head's kernel (#13) runs once for the prompt and once a
    step (a head tied to the embedding has none), and the layer-stacked one
    (#14) once a step for each of the config's int4 projections a layer
    (`llama.int4_projections`)."""
    counters = counters or (LOCAL_INT4 if int4 else MAIN_BF16)
    if int4 and cfg.tie_word_embeddings:
        counters = {k: v for k, v in counters.items() if k != "int4_matmul"}
    ids = np.random.default_rng(23).integers(
        0, cfg.vocab_size, size=1000).tolist()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    argv = ["local", "--model", root, "--prompt-ids", ",".join(map(str, ids)),
            "--max-new", "32"]
    if int4:
        argv += ["--quantize", "int4", "--kv-quant", "int8"]
    argv += list(extra)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    launches = {n: getattr(m, a) for n, (m, a) in counters.items()}
    assert rc == 0
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    assert doc["event"] == "generated" and len(doc["tokens"]) == 32
    assert all(0 <= t < cfg.vocab_size for t in doc["tokens"])
    for name, n in launches.items():
        assert n > 0, f"local never launched {name}"
    result = {"tokens": len(doc["tokens"]), "seconds": doc["seconds"],
              "launches": launches}
    if int4:
        per_step = len(llama.int4_projections(cfg)) * cfg.num_layers
        # The prompt gives the first token; the other 31 are decode steps,
        # run as whole K = 16 windows: 32 steps.
        steps = -(-31 // KT) * KT
        assert launches["int4_matmul_stacked"] == per_step * steps, (
            launches, per_step, steps)
        if "int4_matmul" in launches:
            assert launches["int4_matmul"] == 1 + steps, (launches, steps)
        result["int4_stacked_calls_a_step"] = per_step
    return result


def phase_serve():
    """A 2-layer checkpoint at Llama-3-8B widths, written, loaded and
    served (see the module docstring, phase 5)."""
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=SERVE_LAYERS)
    report = {"phase": "serve",
              "model": f"llama-3-8b widths, {SERVE_LAYERS} layers, random "
                       "bf16 weights from a checkpoint"}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        state, write_s = write_checkpoint(root, cfg, 5, DEV)
        files = sorted(p.name for p in Path(root).iterdir())
        report["checkpoint"] = {
            "files": files, "write_s": write_s,
            "bytes": sum(p.stat().st_size for p in Path(root).iterdir())}
        assert checkpoint.load_config(root) == cfg
        report["info"] = check_info(root, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = checkpoint.load_model_params(root, cfg, torch.bfloat16,
                                              device=DEV)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        report["tensors_bitwise_equal"] = check_loaded(params, state, cfg)
        del state
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        engine = InferenceEngine(cfg, params, EngineConfig(), CacheConfig(),
                                 device=DEV)
        assert engine.decode_steps == 16 and engine._pipelined
        assert engine.cache.use_kernel and engine.cache.use_ragged
        for module, attr in MAIN_BF16.values():
            setattr(module, attr, 0)
        bf16 = serve_traffic(engine, cfg.vocab_size, 29)
        bf16["launches"] = {n: getattr(m, a) for n, (m, a) in MAIN_BF16.items()}
        for name, n in bf16["launches"].items():
            assert n > 0, f"{name} was never launched while serving"
        bf16["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        report["bf16_gateway"] = bf16
        del engine, params
        torch.cuda.empty_cache()

        report["api_f32"] = api_subprocess(
            root, cfg, DEV, str(_build.BUILD_DIR / "serve_api_stderr.log"))
        assert report["api_f32"]["decode_steps"] == 16
        assert report["api_f32"]["decode_kernel"]
        report["local_int4_int8kv"] = local_run(root, cfg, True)
    emit(report)


SERVE_MOE_LAYERS = 1  # Mixtral-8x7B's widths, one layer: about 3.4 GB of bf16


def phase_serve_mixtral():
    """A 1-layer checkpoint at Mixtral-8x7B widths in the HF layout
    (``block_sparse_moe`` keys, an index, two shards), written by the port's
    writer under `build/` and deleted pass or fail: `info` must call it
    supported with its 8 experts, `load_model_params` must return each
    tensor bitwise equal to the written one (each expert in its slot of the
    `[L, E, in, out]` stacks), and `local` runs on it in bf16 and with int4
    weights over int8 pages (four int4 projections a layer)."""
    cfg = dataclasses.replace(MIXTRAL_8L, num_layers=SERVE_MOE_LAYERS)
    report = {"phase": "serve_mixtral", "card": CARD,
              "model": f"mixtral-8x7b widths, {SERVE_MOE_LAYERS} layer, "
                       "random bf16 weights from a checkpoint"}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        state, write_s = write_checkpoint(root, cfg, 6, DEV)
        report["checkpoint"] = {
            "files": sorted(p.name for p in Path(root).iterdir()),
            "write_s": write_s,
            "bytes": sum(p.stat().st_size for p in Path(root).iterdir())}
        assert checkpoint.load_config(root) == cfg
        report["info"] = check_info(root, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = checkpoint.load_model_params(root, cfg, torch.bfloat16,
                                              device=DEV)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        report["tensors_bitwise_equal"] = check_loaded(params, state, cfg)
        del state, params
        torch.cuda.empty_cache()
        report["local_bf16"] = local_run(root, cfg, False)
        report["local_int4_int8kv"] = local_run(root, cfg, True)
    emit(report)


def phase_serve_llama32():
    """A checkpoint at Llama-3.2-1B's full widths and depth in the HF layout
    (16 layers of head_dim 64, the head tied to the embedding: no
    ``lm_head.weight``), written by the port's writer under `build/` and
    deleted pass or fail: `info` must call it supported, the load must give
    each tensor bitwise, and `local --quantize int4 --kv-quant int8` serves
    it on the card (the int8 pool's kernels at head_dim 64)."""
    cfg = LLAMA32_1B
    report = {"phase": "serve_llama32", "card": CARD,
              "model": "llama-3.2-1b widths, 16 layers, tied head, random "
                       "bf16 weights from a checkpoint"}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        state, write_s = write_checkpoint(root, cfg, 7, DEV)
        report["checkpoint"] = {
            "files": sorted(p.name for p in Path(root).iterdir()),
            "write_s": write_s,
            "bytes": sum(p.stat().st_size for p in Path(root).iterdir())}
        assert checkpoint.load_config(root) == cfg
        report["info"] = check_info(root, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = checkpoint.load_model_params(root, cfg, torch.bfloat16,
                                              device=DEV)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        report["tensors_bitwise_equal"] = check_loaded(params, state, cfg)
        del state, params
        torch.cuda.empty_cache()
        report["local_int4_int8kv"] = local_run(root, cfg, True)
    emit(report)


# ---------------------------------------------------------------------------
# the latent (MLA) family: the four latent wrappers (#15a-d) on
# csrc/latent_attention.cu, the latent pools, DeepSeek-V2-Lite's widths
# ---------------------------------------------------------------------------

# deepseek-ai/DeepSeek-V2-Lite's config.json, restated (not downloaded),
# less its rope_scaling (LATENT_CUTS).
DEEPSEEK_V2_LITE_HF = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "n_routed_experts": 64, "n_shared_experts": 2,
    "num_experts_per_tok": 6, "first_k_dense_replace": 1,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "rms_norm_eps": 1e-06,
    "rope_theta": 10000, "max_position_embeddings": 163840,
    "tie_word_embeddings": False}
LATENT_CUTS = (
    "rope_scaling (yarn, factor 40) dropped: the JAX package raises on yarn",
    "no routed experts: every layer the dense SwiGLU MLP of "
    "intermediate_size 10944, as the JAX package reads the config "
    "(it reads no n_routed_experts)")
DEEPSEEK_V2_LITE = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE_HF)
LATENT_WRAPPERS = {
    "latent_ragged_paged_attention": (ra, "latent_launches"),
    "quantized_latent_ragged_paged_attention": (
        ra, "quantized_latent_launches"),
    "latent_paged_attention": (pa, "latent_launches"),
    "quantized_latent_paged_attention": (pa, "quantized_latent_launches"),
}
LATENT_F32 = {k: LATENT_WRAPPERS[k] for k in (
    "latent_ragged_paged_attention", "latent_paged_attention")}
LATENT_INT8 = {k: LATENT_WRAPPERS[k] for k in (
    "quantized_latent_ragged_paged_attention",
    "quantized_latent_paged_attention")}
# The tensor-core instances' own counts (bf16 q at lat_dim 576), beside
# their wrappers': the ragged ones' `latent_wgmma_kernel`, the decode ones'
# `latent_decode_tc_kernel`.
LATENT_TENSOR_CORES = {
    "latent_ragged_paged_attention": (ra, "latent_wgmma_launches"),
    "quantized_latent_ragged_paged_attention": (
        ra, "quantized_latent_wgmma_launches"),
    "latent_paged_attention": (pa, "latent_decode_tc_launches"),
    "quantized_latent_paged_attention": (
        pa, "quantized_latent_decode_tc_launches"),
}
# The per-head attention kernels' counters: none moves on a latent path.
PER_HEAD = {f"{m.__name__.rsplit('.', 1)[1]}.{a}": (m, a) for m, a in (
    (pa, "launches"), (pa, "quantized_launches"), (pa, "fused_launches"),
    (pa, "flush_launches"), (ra, "launches"), (ra, "quantized_launches"),
    (fa, "launches"), (qa, "decode_launches"), (qa, "fused_launches"),
    (qa, "flush_launches"), (qa, "sink_launches"),
    (qa, "sink_flush_launches"))}
# Phase 2's rows. Ragged, one B = 8 launch padded to S = 300: a prompt of
# 300, a 129-query chunk from position 1500, an empty row, one slot, two
# queries across a page edge, a decode token at 2047, 17 queries from 5, 64
# from 900. Decode: lengths of 0, 1, a page, a page and one, 1501, 2048, 777
# and 3.
LATENT_RAGGED = {"q_start": [0, 1500, 0, 0, 63, 2047, 5, 900],
                 "num_new": [300, 129, 0, 1, 2, 1, 17, 64]}
LATENT_DECODE_LENS = [0, 1, None, None, 1501, 2048, 777, 3]


def latent_pools(rng, pages, ps, d):
    """One layer's latent pool [P, 1, PS, d]: f32, and the same quantized
    per token (int8 + f32 scales) as the int8 pool stores it."""
    c = normal(rng, (pages, 1, ps, d), torch.float32)
    q8, s8 = _quantize_kv(c)
    return (c,), (q8.contiguous(), s8.contiguous())


def latent_fns(pool, kind):
    """(tag, wrapper, plain version) of the latent ``kind`` ("ragged" or
    "paged") for ``pool``: (c,) f32 or (c, cs) int8."""
    q8 = len(pool) == 2
    mod = ra if kind == "ragged" else pa
    name = (("quantized_" if q8 else "") + "latent_"
            + ("ragged_paged_attention" if kind == "ragged"
               else "paged_attention"))
    tag = ("qlat" if q8 else "lat") + ("rag" if kind == "ragged" else "dec")
    return tag, getattr(mod, name), getattr(mod, name + "_plain")


def compare_latent(cases, tag, kind, q, pool, table, lens, num_new=None,
                   **kw):
    """A latent wrapper against its plain version on the same inputs,
    appended to ``cases`` (decode: m and l too); pad queries and empty rows
    must come out as exact zeros. Returns the output's max abs error."""
    _, kernel, plain = latent_fns(pool, kind)
    tol = TOL[q.dtype]
    if kind == "ragged":
        got = kernel(q, *pool, table, lens, num_new, **kw)
        want = plain(q, *pool, table, lens, num_new, **kw)
        torch.cuda.synchronize()
        pad = torch.arange(q.shape[1], device=DEV)[None, :] >= num_new[:, None]
        if bool(pad.any()):
            assert float(got[pad].abs().max()) == 0.0, (
                "pad queries must be zero")
        err = max_err(got, want)
        cases.append((tag, err, tol))
        return err
    got, gm, gl = kernel(q, *pool, table, lens, return_stats=True, **kw)
    want, wm, wl = plain(q, *pool, table, lens, return_stats=True, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    cases.append((tag, err, tol))
    cases.append((tag + "_m", max_err(gm, wm), 1e-4))
    cases.append((tag + "_l", float(
        ((gl - wl).abs() / wl.clamp_min(1.0)).max()), 1e-4))
    empty = lens == 0
    if bool(empty.any()):
        assert float(got[empty].abs().max()) == 0.0, "empty row must be zero"
        assert float(gl[empty].max()) == 0.0
    return err


def latent_instance_of(kind, dtype, d):
    """Which instance a latent wrapper of ``kind`` launches for queries of
    ``dtype`` over lat_dim ``d``."""
    if kind == "ragged" and ra.latent_ragged_entry(dtype, d) == (
            "dli_latent_ragged_wgmma"):
        return "tensor cores"
    if kind == "paged" and pa.latent_decode_entry(dtype, d) == (
            "dli_latent_decode_tc"):
        return "tensor cores"
    return "CUDA cores"


def latent_cases(rng):
    """15a-d against their plain versions at G = 1, 8, 16 query heads over
    lat_dim 576 and 80: f32 pools with bf16 and f32 queries, int8 pools;
    ``LATENT_RAGGED`` and ``LATENT_DECODE_LENS`` in one B = 8 launch each,
    pages of 16 and 64, a window of 300 and none (at 64), and at lat_dim
    576 pages of 6 with the window (the tensor-core instance then copies
    the pool a row at a time: no page holds a whole piece). bf16 q at 576
    runs on the tensor-core instances (the ragged wrappers'
    ``latent_wgmma_kernel``, the decode ones' ``latent_decode_tc_kernel``),
    the rest on the CUDA-core kernel: each case's instance is read from
    the tensor-core counts. Returns (name, error, tolerance) cases and the
    widths each wrapper was held at, by query type and instance."""
    cases = []
    widths = {name: {"bf16": set(), "f32": set()} for name in LATENT_WRAPPERS}
    rows = {k: i32(v) for k, v in LATENT_RAGGED.items()}
    lens_r = rows["q_start"] + rows["num_new"]
    s = max(LATENT_RAGGED["num_new"])
    for d in (576, 80):
        for ps, window in ((16, None), (64, None), (64, 300),
                           *(((6, 300),) if d == 576 else ())):
            width = -(-2048 // ps) + 1
            pages = 8 * width + 1
            pools = latent_pools(rng, pages, ps, d)
            table = make_table(rng, 8, width, pages)
            lens_d = i32([ps if n is None and i == 2 else ps + 1
                          if n is None else n
                          for i, n in enumerate(LATENT_DECODE_LENS)])
            for g in (1, 8, 16):
                for dtype in (torch.bfloat16, torch.float32):
                    q = normal(rng, (8, s, g, d), dtype) * 0.1
                    qd = normal(rng, (8, 1, g, d), dtype) * 0.1
                    for pool in pools:
                        label = (f"d{d}_g{g}_ps{ps}_w{window}_"
                                 f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")
                        for kind, args in (
                                ("ragged", (q, pool, table, lens_r,
                                            rows["num_new"])),
                                ("paged", (qd, pool, table, lens_d))):
                            tag, kernel, _ = latent_fns(pool, kind)
                            tc = LATENT_TENSOR_CORES[kernel.__name__]
                            before = getattr(*tc)
                            compare_latent(
                                cases, f"{tag}_{label}", kind, args[0],
                                *args[1:], sliding_window=window)
                            instance = latent_instance_of(kind, dtype, d)
                            ran = getattr(*tc) - before  # one kernel call
                            assert ran == (instance == "tensor cores"), (
                                tag, label, instance, ran)
                            widths[kernel.__name__][label.rsplit("_", 1)[1]].add(
                                f"G={g} lat_dim={d} ({instance})")
    return cases, {k: {t: sorted(w) for t, w in v.items()}
                   for k, v in widths.items()}


# bf16 passes over the latent that f32-grade products from bf16 hi + lo
# terms need (one pass: 2 G d operations a (query, position) pair). f32
# pool: Q K_hi + Q K_lo, then p_hi V_hi + p_hi V_lo + p_lo V_hi (p_lo V_lo
# is about 2^-32 of the result: not needed, although the tensor-core
# instance runs it, its hi and lo rows meeting both terms of p in the same
# k-steps); int8 pool (exact in bf16): Q K, (p vs)_hi V + (p vs)_lo V.
LATENT_PASSES = {False: 5, True: 3}


def latent_bounds(b, s, kv, g, d, q8, causal_rows):
    """Bytes and operations of one latent call: every live latent read
    once (int8: its byte values and its f32 scale), q in and out out (bf16),
    the table; 2 products (K and V are the one latent) of G heads over each
    visible (query, slot) pair. Returns the bytes, those 2 products'
    operations (the f32 work of the CUDA-core kernel) and the bf16
    operations of the passes that f32-grade products on the tensor cores
    need (``LATENT_PASSES``)."""
    per_slot = d + 4 if q8 else 4 * d
    pairs = causal_rows if causal_rows is not None else b * kv
    bytes_moved = b * kv * per_slot + 2 * b * s * g * d * 2 + b * 64 * 4
    flops = 4 * pairs * g * d
    return bytes_moved, flops, LATENT_PASSES[q8] * 2 * pairs * g * d


def time_latent(out, cases, rng, flush):
    """15a-d at DeepSeek-V2-Lite's shapes (16 query heads over the 576-wide
    latent, pages of 64), bf16 queries as the bf16 model gives them:
    decode at B = 8 and B = 1 over 2048 cached tokens a row, the ragged
    kernel on one 2048-token prompt, each on its tensor-core instance.
    Beside the kernel: its plain version, the library call
    (``scaled_dot_product_attention`` in f32 over the gathered, dequantized
    latent, K = V broadcast to the 16 heads), the bound (the larger of the
    bytes and the bf16 passes that f32-grade products need,
    ``LATENT_PASSES``, at the tensor cores' peak), the f32 CUDA-core bound
    beside it, and the CUDA-core kernel timed at the same shape in the
    same call (its entry forced, as the wrapper no longer takes it for bf16
    q at 576); decode: the instance timed again after it, one launch a
    call."""
    g, d, ps, kv = 16, 576, 64, 2048
    width = kv // ps
    for pool in latent_pools(rng, 8 * width + 1, ps, d):
        q8 = len(pool) == 2
        kind = "int8 latent pool" if q8 else "f32 latent pool"
        c = pool[0].float() if not q8 else pool[0].float() * pool[1][..., None]
        for b in (8, 1):
            table = make_table(rng, b, width, 8 * width + 1)
            q = normal(rng, (b, 1, g, d), torch.bfloat16) * 0.1
            lens = i32([kv] * b)
            tag, kernel, plain = latent_fns(pool, "paged")
            lat = pa.gather_pages(c, table)                 # [B, T, 1, D]
            qh = q.float().permute(0, 2, 1, 3).contiguous()
            kh = lat.permute(0, 2, 1, 3).contiguous()
            bytes_moved, flops, tc_flops = latent_bounds(b, 1, kv, g, d, q8,
                                                         None)
            bms, by = bound(bytes_moved, tc_flops, torch.bfloat16)
            f32_ms, f32_by = bound(bytes_moved, flops, torch.float32)

            def call():
                return kernel(q, *pool, table, lens)

            assert latent_instance_of("paged", q.dtype, d) == "tensor cores"
            tc = LATENT_TENSOR_CORES[kernel.__name__]
            before = getattr(*tc)
            entry = {
                "shape": f"B={b} kv={kv} G={g} lat_dim={d} PS={ps} bf16 q, "
                         f"{kind}",
                "instance": "latent_decode_tc_kernel (tensor cores)",
                "cluster": pa.latent_cluster_size(q.device, b, kv, q8),
                "max_abs_err": compare_latent(
                    cases, f"{tag}_timed_b{b}", "paged", q, pool, table,
                    lens),
                "ms": time_ms(call, 20, flush),
                "plain_ms": time_ms(lambda: plain(q, *pool, table, lens), 5,
                                    flush),
                "library_ms": time_ms(lambda: sdpa(qh, kh, kh, False), 10,
                                      flush),
                # the least time of the work: its bytes against the bf16
                # passes that f32-grade products need at the tensor cores'
                # peak; beside it the two products in f32 at the CUDA
                # cores' peak (the CUDA-core kernel's work)
                "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
                "flops": tc_flops, "tensor_core_passes": LATENT_PASSES[q8],
                "bound_ms_tensor_core_passes":
                    tc_flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
                "bound_ms_f32_cuda_cores": f32_ms,
                "bound_by_f32_cuda_cores": f32_by, "flops_f32": flops,
                "launches_a_call": launches_a_call(call),
            }
            entry["tensor_core_launches_timed"] = getattr(*tc) - before
            assert entry["tensor_core_launches_timed"] > 0
            assert entry["launches_a_call"] == 1, entry["launches_a_call"]
            # The CUDA-core kernel and its merge at the same shape, in
            # the same call, then the tensor-core instance again.
            saved = pa.latent_decode_entry
            pa.latent_decode_entry = (
                lambda dtype, dim: "dli_latent_paged_attention")
            try:
                entry["cuda_core_kernel"] = {
                    "max_abs_err": compare_latent(
                        cases, f"cuda_cores_{tag}_timed_b{b}", "paged", q,
                        pool, table, lens),
                    "ms": time_ms(call, 20, flush),
                    "launches_a_call": launches_a_call(call)}
            finally:
                pa.latent_decode_entry = saved
            entry["ms_again"] = time_ms(call, 20, flush)
            if b == 8:
                out[kernel.__name__] = entry
            else:
                out[kernel.__name__]["at_b1"] = entry
            del lat, kh
        s = 2048
        table1 = make_table(rng, 1, width, 8 * width + 1)
        q = normal(rng, (1, s, g, d), torch.bfloat16) * 0.1
        lens1, new1 = i32([s]), i32([s])
        tag, kernel, plain = latent_fns(pool, "ragged")
        lat = pa.gather_pages(c, table1)
        qh = q.float().permute(0, 2, 1, 3).contiguous()
        kh = lat.permute(0, 2, 1, 3).contiguous()
        bytes_moved, flops, tc_flops = latent_bounds(1, s, s, g, d, q8,
                                                     s * (s + 1) // 2)
        bms, by = bound(bytes_moved, tc_flops, torch.bfloat16)
        f32_ms, f32_by = bound(bytes_moved, flops, torch.float32)
        call = (q, *pool, table1, lens1, new1)
        cargs = (q, pool, table1, lens1, new1)
        assert latent_instance_of("ragged", q.dtype, d) == "tensor cores"
        before = getattr(*LATENT_TENSOR_CORES[kernel.__name__])
        out[kernel.__name__] = {
            "shape": f"B=1 S={s} G={g} lat_dim={d} PS={ps} bf16 q, {kind}",
            "instance": "latent_wgmma_kernel (tensor cores)",
            "max_abs_err": compare_latent(
                cases, f"{tag}_timed", "ragged", *cargs),
            "ms": time_ms(lambda: kernel(*call), 5, flush),
            "plain_ms": time_ms(lambda: plain(*call), 3, flush),
            "library_ms": time_ms(lambda: sdpa(qh, kh, kh, True), 5, flush),
            # the least time of the work: the bf16 passes that f32-grade
            # products need at the tensor cores' peak; beside it the two
            # products in f32 at the CUDA cores' peak (the CUDA-core
            # kernel's work)
            "bound_ms": bms, "bound_by": by, "bytes": bytes_moved,
            "flops": tc_flops, "tensor_core_passes": LATENT_PASSES[q8],
            "bound_ms_tensor_cores": bms,
            "bound_ms_f32_cuda_cores": f32_ms,
            "bound_by_f32_cuda_cores": f32_by, "flops_f32": flops,
            "launches_a_call": launches_a_call(lambda: kernel(*call)),
        }
        out[kernel.__name__]["tensor_core_launches_timed"] = (
            getattr(*LATENT_TENSOR_CORES[kernel.__name__]) - before)
        # The CUDA-core kernel at the same shape, in the same call (its
        # entry still takes bf16 q at 576; the wrapper sends that to the
        # tensor-core instance).
        saved = ra.latent_ragged_entry
        ra.latent_ragged_entry = lambda dtype, dim: "dli_latent_ragged_attention"
        try:
            out[kernel.__name__]["cuda_core_kernel"] = {
                "max_abs_err": compare_latent(
                    cases, f"cuda_cores_{tag}_timed", "ragged", *cargs),
                "ms": time_ms(lambda: kernel(*call), 5, flush)}
        finally:
            ra.latent_ragged_entry = saved
        del lat, kh, c


# The tensor-core instances' precision, on data that shows it: q unscaled
# (N(0, 1)), latents N(0, 8^2) and a scale of 1/96, so scores spread by
# about 2 (a few positions carry a query) and the short rows' outputs reach
# |out| >= 4 (2-4% of all), where one bf16 step (2^-5) is past the 2e-2
# tolerance.
# (G, page size, window) over ``LATENT_RAGGED``'s rows and, for the decode
# instance, over ``LATENT_DECODE_LENS``', both pools; then the 2048-token
# prompt at 16 heads.
LATENT_PRECISION = {"q": 1.0, "latent": 8.0, "scale": 1 / 96,
                    "cases": ((16, 64, None), (16, 16, 300), (8, 64, 300),
                              (1, 16, None))}


def bf16_steps(got, want):
    """``|got - want|`` per element in bf16 steps of ``max(|want|, rms /
    16)`` (rms: the root mean square of want over its query head's row, so
    that an element near zero is held to its row's scale, not to a step
    that no f32 product can meet); rows of zeros left out. Returns the
    largest, and the largest beyond the correctly rounded value (``|got -
    want| - |bf16(want) - want|``, 0 where got is want rounded)."""
    got, want = got.double(), want.double()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    ref = torch.maximum(want.abs(), rms / 16).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(ref)) - 7)
    live = (rms > 0).expand_as(want)
    err = (got - want).abs() / step
    rounded = (want.to(torch.bfloat16).double() - want).abs() / step
    return float(err[live].max()), float((err - rounded)[live].max())


def latent_one_pass(q, pool, table, lens, num_new, scale, window):
    """What a one-pass bf16 kernel would compute: the plain version's f32
    math with each product operand rounded once to bf16 (f32 pool: the
    latent, as K and as V; both pools: p * vs before P V; l sums p). The
    control that the precision check must fail. Output in q's type."""
    b, s = q.shape[:2]
    lat = pa.gather_pages(pool[0], table).float()[:, :, 0]     # [B, T, D]
    if len(pool) == 1:
        lat = lat.to(torch.bfloat16).float()
    scores = torch.einsum("bsgd,btd->bgst", q.float(), lat)
    vs = None
    if len(pool) == 2:
        vs = pa.gather_scales(pool[1], table)[:, :, 0]         # [B, T]
        scores = scores * vs[:, None, None, :]
    scores = scores * scale
    rel = torch.arange(s, device=DEV)
    qpos = (lens - num_new)[:, None] + rel[None]
    pos = torch.arange(lat.shape[1], device=DEV)[None, None]
    valid = ((pos < lens[:, None, None]) & (pos <= qpos[:, :, None])
             & (rel[None, :, None] < num_new[:, None, None]))
    if window:
        valid = valid & (pos > qpos[:, :, None] - window)
    valid = valid[:, None]
    scores = torch.where(valid, scores, -torch.inf)
    m = scores.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    if vs is not None:
        p = p * vs[:, None, None, :]
    out = torch.einsum("bgst,btd->bsgd", p.to(torch.bfloat16).float(), lat)
    return (out / l.clamp_min(1e-20).permute(0, 2, 1, 3)).to(q.dtype)


def latent_precision(rng):
    """The tensor-core instances against the plain version's f32 output
    (f32 queries: the same math, unrounded) on ``LATENT_PRECISION``'s data,
    per element within one bf16 step (``bf16_steps``); beside it the one-pass
    control (``latent_one_pass``; decode rows as one new token each), which
    must miss that step, held against the same f32 output: the ragged
    instance, and the decode one on the same cases over decode rows.
    Returns {wrapper: report}."""
    cfg = LATENT_PRECISION
    d = 576
    rows = {k: i32(v) for k, v in LATENT_RAGGED.items()}
    lens_r = rows["q_start"] + rows["num_new"]
    s_r = max(LATENT_RAGGED["num_new"])
    out = {}
    for g, ps, window, shape in (
            *((g, ps, w, "ragged") for g, ps, w in cfg["cases"]),
            (16, 64, None, "prompt"),
            *((g, ps, w, "decode") for g, ps, w in cfg["cases"])):
        b, s = ((8, s_r) if shape == "ragged" else (1, 2048)
                if shape == "prompt" else (8, 1))
        width = -(-2048 // ps) + 1
        pages = b * width + 1
        c = normal(rng, (pages, 1, ps, d), torch.float32) * cfg["latent"]
        q8, s8 = _quantize_kv(c)
        table = make_table(rng, b, width, pages)
        if shape == "ragged":
            lens, new = lens_r, rows["num_new"]
        elif shape == "prompt":
            lens, new = i32([s]), i32([s])
        else:
            lens = i32([ps if n is None and i == 2 else ps + 1
                        if n is None else n
                        for i, n in enumerate(LATENT_DECODE_LENS)])
            new = (lens > 0).to(torch.int32)
        q = normal(rng, (b, s, g, d), torch.bfloat16) * cfg["q"]
        kind = "paged" if shape == "decode" else "ragged"
        for pool in ((c,), (q8.contiguous(), s8.contiguous())):
            tag, kernel, plain = latent_fns(pool, kind)
            assert latent_instance_of(kind, q.dtype, d) == "tensor cores"
            kw = {"scale": cfg["scale"], "sliding_window": window}
            args = (table, lens) if kind == "paged" else (table, lens, new)
            got = kernel(q, *pool, *args, **kw)
            want = plain(q.float(), *pool, *args, **kw)
            ctl = latent_one_pass(q, pool, table, lens, new, cfg["scale"],
                                  window)
            torch.cuda.synchronize()
            pad = torch.arange(s, device=DEV)[None, :] >= new[:, None]
            if bool(pad.any()):
                assert float(got[pad].abs().max()) == 0.0
            err, beyond = bf16_steps(got, want)
            ctl_err, ctl_beyond = bf16_steps(ctl, want)
            label = f"{shape}_g{g}_ps{ps}_w{window}"
            big = float((want.abs() >= 4).float().mean())
            assert big > 0, (tag, label, "no |out| >= 4")
            assert err <= 1.0, (
                f"{tag} {label}: {err} bf16 steps from the f32 output")
            assert ctl_err > 1.0 and ctl_err >= 4 * err, (
                f"{tag} {label}: the one-pass control {ctl_err} steps, the "
                f"kernel {err}: the check cannot tell them apart")
            rep = out.setdefault(kernel.__name__, {
                "data": {k: v for k, v in cfg.items() if k != "cases"},
                "limit_bf16_steps": 1.0, "cases": {}})
            rep["cases"][label] = {
                "bf16_steps": err, "beyond_rounding": beyond,
                "one_pass_bf16_steps": ctl_err,
                "one_pass_beyond_rounding": ctl_beyond,
                "share_abs_out_ge_4": big,
                "max_abs_err": max_err(got, want),
                "one_pass_max_abs_err": max_err(ctl, want)}
            del got, want, ctl
    for rep in out.values():
        cases = rep["cases"].values()
        rep["max_bf16_steps"] = max(c["bf16_steps"] for c in cases)
        rep["min_one_pass_bf16_steps"] = min(
            c["one_pass_bf16_steps"] for c in cases)
    return out


def latent_instance(mangled):
    """The latent kernels' instances by their template arguments."""
    m = re.search(r"latent_wgmma_kernelI([af])E", mangled)
    if m:
        pool = "int8" if m.group(1) == "a" else "f32"
        return f"latent_wgmma_kernel ragged {pool} D=576 (tensor cores)"
    m = re.search(r"latent_decode_tc_kernelI([af])E", mangled)
    if m:
        pool = "int8" if m.group(1) == "a" else "f32"
        return f"latent_decode_tc_kernel decode {pool} D=576 (tensor cores)"
    m = re.search(r"latent_kernelI([af])Li(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        pool = "int8" if m.group(1) == "a" else "f32"
        form = "decode" if m.group(4) == "1" else "ragged"
        return f"latent_kernel {form} {pool} D={m.group(2)} R={m.group(3)}"
    m = re.search(r"latent_merge_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"latent_merge_kernel D={m.group(1)} R={m.group(2)}"
    return None


WGMMA_PLAN_KEYS = ("query_tiles", "queries_a_block", "threads",
                   "smem_bytes", "stages", "pieces", "piece_positions",
                   "step")
DECODE_TC_PLAN_KEYS = ("threads", "smem_bytes", "raw_steps",
                       "converted_steps", "step", "converted_row_bytes",
                       "max_cluster", "columns_a_warp")


def latent_smem():
    """Dynamic shared memory of each latent block, as the C side sizes it
    (``dli_latent_smem_bytes``; the tensor-core instances' from
    ``dli_latent_wgmma_plan`` and ``dli_latent_decode_plan``, which must
    equal the wrappers' ``latent_wgmma_plan`` and ``latent_decode_plan``),
    against the 227 KB a block may have; and the clusters of each size of
    the decode instance the card holds at once (``latent_cluster_fit``,
    which sizes its clusters). Returns (shared memory bytes by block,
    clusters by size)."""
    lib = _build.load_library("latent_attention")
    fn = lib.dli_latent_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    out = {}
    for d in (576, 80):
        for q8 in (0, 1):
            for g, form in ((16, 1), (8, 1), (4, 1), (16, 0)):
                n = fn(g, d, form, q8)
                assert 0 < n <= 232448, (d, q8, g, form, n)
                out[f"{'decode' if form else 'ragged'} "
                    f"{'int8' if q8 else 'f32'} D={d} G<={g}"] = n
    plan = lib.dli_latent_wgmma_plan
    plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    for q8 in (0, 1):
        for s, g in ((2048, 16), (300, 16), (300, 8), (300, 3), (300, 1)):
            got = (ctypes.c_longlong * len(WGMMA_PLAN_KEYS))()
            assert plan(s, g, q8, ctypes.addressof(got)) == 0
            want = ra.latent_wgmma_plan(s, g, bool(q8))
            assert list(got) == [want[k] for k in WGMMA_PLAN_KEYS], (
                list(got), want)
            assert 0 < got[3] <= 232448
        out[f"ragged {'int8' if q8 else 'f32'} D=576 (tensor cores)"] = got[3]
    dplan = lib.dli_latent_decode_plan
    dplan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    dplan.restype = ctypes.c_int
    fits = {}
    for q8 in (0, 1):
        got = (ctypes.c_longlong * len(DECODE_TC_PLAN_KEYS))()
        assert dplan(q8, ctypes.addressof(got)) == 0
        want = pa.latent_decode_plan(bool(q8))
        assert list(got) == [want[k] for k in DECODE_TC_PLAN_KEYS], (
            list(got), want)
        assert 0 < got[1] <= 232448
        pool = "int8" if q8 else "f32"
        out[f"decode {pool} D=576 (tensor cores)"] = got[1]
        fits[pool] = {c: pa.latent_cluster_fit(DEV, bool(q8), c)
                      for c in range(1, 17)}
    return out, fits


def phase_latent_kernels(flush):
    """Phase 2 for the latent family: ``latent_cases`` (each wrapper against
    its plain version at every width, both pools, both query types) and
    ``time_latent`` at DeepSeek-V2-Lite's shapes, the build's ``-Xptxas
    -v`` for every latent instance and their shared memory. Returns the
    timed entries by wrapper and the widths each was checked at."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    resources = ptxas_lines(_build.ptxas_log("latent_attention"),
                            latent_instance, 26)
    for name, lines in resources.items():
        if "tensor cores" in name:
            assert any("0 bytes spill stores, 0 bytes spill loads" in x
                       for x in lines), (name, lines)
    cases, widths = latent_cases(np.random.default_rng(2468))
    precision = latent_precision(np.random.default_rng(97531))
    timed = {}
    time_latent(timed, cases, np.random.default_rng(1357), flush)
    assert_cases(cases, "latent")
    for name, entry in timed.items():
        q8, ragged = name.startswith("quantized"), "ragged" in name
        prefix = ("qlat" if q8 else "lat") + ("rag_" if ragged else "dec_")
        mine = [(n, e) for n, e, _ in cases if n.startswith(prefix)]
        entry["cases"] = {n: e for n, e in mine}
        entry["max_abs_err_cases"] = max(
            e for n, e in mine if not n.endswith(("_m", "_l")))
        form = f"{'ragged' if ragged else 'decode'} {'int8' if q8 else 'f32'}"
        entry["ptxas"] = {k: v for k, v in resources.items()
                          if form in k or (not ragged and "merge" in k)}
        entry["precision"] = precision[name]
        entry["instances"] = {
            "bf16 q, lat_dim 576":
                "latent_wgmma_kernel (tensor cores)" if ragged
                else "latent_decode_tc_kernel (tensor cores, one launch)",
            "f32 q, lat_dim 576 and 80; bf16 q, lat_dim 80":
                "latent_kernel (CUDA cores)" if ragged
                else "latent_kernel + latent_merge_kernel (CUDA cores)"}
    smem, fits = latent_smem()
    emit({"phase": "latent_kernels", "card": CARD,
          "tolerance": {"bf16 q": TOL[torch.bfloat16],
                        "f32 q": TOL[torch.float32], "m": 1e-4,
                        "l (relative)": 1e-4},
          "cases": len(cases), "ptxas": resources,
          "smem_bytes": smem, "decode_clusters_held": fits, "timed": timed,
          "seconds": time.perf_counter() - t0})
    for name, entry in timed.items():
        if "ragged" not in name:
            for e in (entry, entry["at_b1"]):
                print(f"{name} {e['shape']}: {e['ms']:.6f} ms "
                      f"(again {e['ms_again']:.6f}; C = {e['cluster']}), "
                      f"the CUDA-core kernel {e['cuda_core_kernel']['ms']:.6f}, "
                      f"bound {e['bound_ms']:.6f} ({e['bound_by']})",
                      flush=True)
    return timed, widths


def run_latent(label, cfg, params, ckw, counters, wgmma):
    """The smoke's traffic (``MIXED``: 12 greedy prompts of 30-1500 tokens,
    a 3000-token one, two sampled, a cancel, 32 new each) through the
    engine on a latent pool at its default ``decode_steps`` (1: no
    write-behind tail), the latent wrappers' counters zeroed before and
    read after; no per-head attention kernel and no plain version (nor the
    gather path) may run, and every latent wrapper's launches must all be
    its tensor-core instance's (``wgmma``: their counts). Then a decode tick
    and a prefill dispatch profiled (the device's idle share; the tick's
    decode kernel ms, one launch a layer and no merge kernel; the
    prefill's latent kernel ms, one tensor-core launch a layer). Returns
    (report, launches)."""
    watch = {**PER_HEAD, **LATENT_WRAPPERS}
    for module, attr in wgmma.values():
        setattr(module, attr, 0)
    plain_calls = {"ragged._plain": 0, "paged._plain": 0, "gather": 0}

    def counting(key, fn):
        def call(*args, **kwargs):
            plain_calls[key] += 1
            return fn(*args, **kwargs)
        return call

    patches = [(ra, "_plain", counting("ragged._plain", ra._plain)),
               (pa, "_plain", counting("paged._plain", pa._plain))]
    for cls in (LatentPagedKVCache, QuantizedLatentPagedKVCache):
        patches.append((cls, "_contiguous_view",
                        counting("gather", cls.__dict__["_contiguous_view"])))
    saved = [(obj, name, getattr(obj, name) if obj not in (
        LatentPagedKVCache, QuantizedLatentPagedKVCache)
        else obj.__dict__[name]) for obj, name, _ in patches]
    torch.cuda.reset_peak_memory_stats()
    for module, attr in watch.values():
        setattr(module, attr, 0)
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        t0 = time.perf_counter()
        engine = InferenceEngine(
            cfg, params, EngineConfig(max_batch_size=8),
            CacheConfig(num_pages=2048, **ckw),
            generator=torch.Generator().manual_seed(11), device=DEV)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        assert engine.decode_steps == 1 and engine._fused is None
        assert engine.cache.use_kernel and engine.cache.use_ragged
        t0 = time.perf_counter()
        streams, cancelled = drive(engine, cfg.vocab_size, 5,
                                   MIXED["short_lens"], MIXED["long_len"],
                                   MIXED["new_tokens"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    got = {n: getattr(m, a) for n, (m, a) in watch.items()}
    launches = {n: got[n] for n in counters}
    tensor_core = {n: getattr(m, a) for n, (m, a) in wgmma.items()}
    for name, n in tensor_core.items():
        assert n == launches[name] > 0, (
            f"{label}: {name} launched {launches[name]}, of them {n} on the "
            f"tensor-core instance")
    check_streams(streams, cancelled, MIXED["new_tokens"], cfg.vocab_size)
    assert engine.allocator.free_count == 2048 - 1, "pages leaked"
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the path of {label}"
    ran = {n: v for n, v in got.items() if n in PER_HEAD and v}
    assert not ran, f"{label}: per-head attention kernels ran: {ran}"
    assert not any(plain_calls.values()), (
        f"{label}: plain versions or the gather path ran: {plain_calls}")
    m = engine.metrics
    snap = m.snapshot()
    lat = cfg.latent.lat_dim
    want_bytes = cfg.num_layers * (lat + 4 if ckw.get("kv_quant")
                                   else 4 * lat)
    assert snap["kv_bytes_per_token"] == want_bytes, snap["kv_bytes_per_token"]
    assert m.get_counter("latent_decompress_dispatches") > 0
    assert m.get_counter("attn_chunked_rows") > 0, (
        "the long prompt was not chunk-admitted beside live decode")
    report = {
        "phase": "engine", "config": label, "card": CARD,
        "model": f"deepseek-v2-lite widths, {cfg.num_layers} layers, random "
                 f"bf16 weights",
        "cuts": LATENT_CUTS, "launches": launches,
        "tensor_core_launches": tensor_core,
        "per_head_attention_launches": 0, "plain_or_gather_calls": 0,
        "engine_init_s": build_s, "wall_s": wall,
        "generated_tokens": sum(len(s) for s in streams),
        "tokens_per_s": sum(len(s) for s in streams) / wall,
        "prefill_dispatches": snap["prefill_count"],
        "prefill_ms_mean": snap["prefill_mean_s"] * 1e3,
        "decode_steps": engine.decode_steps,
        "decode_ticks": snap["decode_step_count"],
        "decode_tick_ms_mean": snap["decode_step_mean_s"] * 1e3,
        "decode_tick_ms_p50": snap["decode_step_p50_s"] * 1e3,
        "chunked_rows": m.get_counter("attn_chunked_rows"),
        "kv_bytes_per_token": snap["kv_bytes_per_token"],
        "latent_decompress_dispatches": m.get_counter(
            "latent_decompress_dispatches"),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    del engine
    torch.cuda.empty_cache()
    report["decode_profile"] = profile_decode(cfg, params, {}, ckw, counters)
    tick = report["decode_profile"]
    assert not {"latent_kernel", "latent_merge_kernel"} & set(
        tick["attention_kernels"]), (
        f"{label}: the decode tick ran the CUDA-core kernel or its merge")
    dec = tick["attention_kernels"].get("latent_decode_tc_kernel")
    report["decode_latent_kernel"] = dec
    print(f"{label}: decode tick (8 rows of ~600) latent_decode_tc_kernel "
          f"{dec['ms'] if dec else 'not recorded'} ms "
          f"({dec['launches'] if dec else 0} launches), no merge; "
          f"{tick['kernels']} kernels, device {tick['device_ms']:.6f} ms, "
          f"wall {tick['wall_ms']:.6f} ms, idle "
          f"{tick['device_idle_share']:.6f}", flush=True)
    report["prefill_profile"] = profile_prefill(cfg, params, {}, ckw,
                                                counters)
    # The prefill's latent kernel as the profiler saw it (the counts above
    # are the proof of the route: the profiler drops records at times).
    prof = report["prefill_profile"]
    latent = prof["attention_kernels"].get("latent_wgmma_kernel")
    assert "latent_kernel" not in prof["attention_kernels"], (
        f"{label}: the prefill ran the CUDA-core kernel")
    report["prefill_latent_kernel"] = latent
    if latent is not None:
        report["prefill_latent_kernel_share"] = (
            latent["ms"] / prof["device_ms"])
        print(f"{label}: prefill [1, 2048] latent_wgmma_kernel "
              f"{latent['ms']:.6f} ms ({latent['launches']} launches) of "
              f"{prof['device_ms']:.6f} device ms", flush=True)
    emit(report)
    return report, launches


def phase_latent():
    """Phase 3's latent paths: DeepSeek-V2-Lite's config (from its
    config.json restated, ``LATENT_CUTS`` listed) at its 27 layers with
    random bf16 weights (about 2.6 B parameters), over the f32 latent pool
    (#15a, #15c) and over the int8 one (#15b, #15d). Returns launches by
    wrapper and, of the ragged ones, the tensor-core instance's."""
    cfg = DEEPSEEK_V2_LITE
    assert cfg.family == "mla" and cfg.latent.lat_dim == 576
    assert cfg.num_heads == 16 and cfg.num_experts == 0
    params = llama.init_params(cfg, torch.Generator(device=DEV).manual_seed(6),
                               torch.bfloat16, DEV)
    launches, tensor_core = {}, {}
    for label, ckw, counters in (
            ("deepseek_v2_lite_f32latent_pages: bf16 weights, f32 latent "
             "pages, K=1", {}, LATENT_F32),
            ("deepseek_v2_lite_int8latent_pages: bf16 weights, int8 latent "
             "pages, K=1", {"kv_quant": "int8"}, LATENT_INT8)):
        wgmma = {n: LATENT_TENSOR_CORES[n] for n in counters}
        report, got = run_latent(label, cfg, params, ckw, counters, wgmma)
        launches.update(got)
        tensor_core.update(report["tensor_core_launches"])
    del params
    torch.cuda.empty_cache()
    return launches, tensor_core


def phase_parity_latent():
    """Phase 4 for the latent family: DeepSeek-V2-Lite's widths at 2 layers
    in f32, TF32 off, greedy streams: over each latent pool the kernels
    against the gather path, identical at K = 1 and at an explicit K = 4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(DEEPSEEK_V2_LITE, num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(1), torch.float32, DEV)
    gather = dict(use_pallas_attention=False, ragged_attention=False)
    report = {"phase": "parity_latent", "card": CARD,
              "model": "deepseek-v2-lite widths, 2 layers, f32, tf32 off"}
    for pool, ckw, counters in (("f32", {}, LATENT_F32),
                                ("int8", {"kv_quant": "int8"}, LATENT_INT8)):
        for k in (1, 4):
            ekw = {"decode_steps": k}
            before = {n: getattr(m, a) for n, (m, a) in counters.items()}
            kern, e1 = parity_run(cfg, params, ekw, ckw)
            assert e1.decode_steps == k and e1.cache.use_kernel
            assert all(getattr(m, a) > before[n]
                       for n, (m, a) in counters.items())
            gath, e2 = parity_run(cfg, params, {**ekw, **gather}, ckw)
            assert not e2.cache.use_kernel and not e2.cache.use_ragged
            assert all(len(x) == 16 for x in kern)
            assert kern == gath, (
                f"{pool} latent pool, K={k}: kernels and gather differ")
            report[f"{pool}_k{k}_kernels_equal_gather"] = True
    report["streams"], report["tokens_each"] = len(kern), 16
    del params
    torch.cuda.empty_cache()
    emit(report)


SERVE_MLA_LAYERS = 2  # DeepSeek-V2-Lite's widths, 2 layers: about 1.2 GB


def phase_serve_deepseek():
    """A 2-layer checkpoint at DeepSeek-V2-Lite's widths in the DeepSeek-V2
    HF layout (q_proj, kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj,
    o_proj, the MLP), written by the port's writer under `build/` and
    deleted pass or fail: `info` must call it supported, the load must give
    each tensor bitwise (kv_b_proj as wk_b and wv_b), and `local` serves it
    over the f32 and the int8 latent pools."""
    cfg = dataclasses.replace(DEEPSEEK_V2_LITE, num_layers=SERVE_MLA_LAYERS)
    report = {"phase": "serve_deepseek_v2_lite", "card": CARD,
              "model": f"deepseek-v2-lite widths, {SERVE_MLA_LAYERS} layers, "
                       "random bf16 weights from a checkpoint",
              "cuts": LATENT_CUTS}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        state, write_s = write_checkpoint(root, cfg, 9, DEV)
        report["checkpoint"] = {
            "files": sorted(p.name for p in Path(root).iterdir()),
            "write_s": write_s,
            "bytes": sum(p.stat().st_size for p in Path(root).iterdir())}
        assert checkpoint.load_config(root) == cfg
        report["info"] = check_info(root, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = checkpoint.load_model_params(root, cfg, torch.bfloat16,
                                              device=DEV)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        report["tensors_bitwise_equal"] = check_loaded(params, state, cfg)
        del state, params
        torch.cuda.empty_cache()
        report["local_f32_latent"] = local_run(root, cfg, False, LATENT_F32)
        report["local_int8_latent"] = local_run(
            root, cfg, False, LATENT_INT8, ("--kv-quant", "int8"))
    emit(report)


# ---------------------------------------------------------------------------

REPLACES = {
    "paged_attention": "distributed_llm_inference_tpu/ops/paged_attention.py:154",
    "ragged_paged_attention": "distributed_llm_inference_tpu/ops/ragged_attention.py:252",
    "quantized_paged_attention": "distributed_llm_inference_tpu/ops/paged_attention.py:349",
    "quantized_ragged_paged_attention": "distributed_llm_inference_tpu/ops/ragged_attention.py:345",
    "int4_matmul": "distributed_llm_inference_tpu/ops/quant_matmul.py:126",
    "int4_matmul_stacked": "distributed_llm_inference_tpu/ops/quant_matmul.py:214",
    "quantized_paged_fused_attention": "distributed_llm_inference_tpu/ops/paged_attention.py:490",
    "quantized_fused_decode_attention": "distributed_llm_inference_tpu/ops/quant_attention.py:231",
    "paged_tail_flush": "distributed_llm_inference_tpu/ops/paged_attention.py:751",
    "flash_attention": "distributed_llm_inference_tpu/ops/flash_attention.py:97",
    "quantized_decode_attention": "distributed_llm_inference_tpu/ops/quant_attention.py:136",
    "fused_tail_flush": "distributed_llm_inference_tpu/ops/quant_attention.py:569",
    "sink_fused_decode_attention": "distributed_llm_inference_tpu/ops/quant_attention.py:710",
    "sink_tail_flush": "distributed_llm_inference_tpu/ops/quant_attention.py:1044",
    "latent_ragged_paged_attention": "distributed_llm_inference_tpu/ops/ragged_attention.py:435",
    "quantized_latent_ragged_paged_attention": "distributed_llm_inference_tpu/ops/ragged_attention.py:467",
    "latent_paged_attention": "distributed_llm_inference_tpu/ops/paged_attention.py:445",
    "quantized_latent_paged_attention": "distributed_llm_inference_tpu/ops/paged_attention.py:469",
}
SOURCES = {
    "paged_attention": "distributed_llm_inference_tpu_torch/csrc/paged_attention.cu",
    "ragged_paged_attention": "distributed_llm_inference_tpu_torch/csrc/ragged_attention.cu",
    "quantized_paged_attention": "distributed_llm_inference_tpu_torch/csrc/paged_attention.cu",
    "quantized_ragged_paged_attention": "distributed_llm_inference_tpu_torch/csrc/ragged_attention.cu",
    "int4_matmul": "distributed_llm_inference_tpu_torch/csrc/int4_matmul.cu",
    "int4_matmul_stacked": "distributed_llm_inference_tpu_torch/csrc/int4_matmul.cu",
    "quantized_paged_fused_attention": "distributed_llm_inference_tpu_torch/csrc/paged_attention.cu",
    "quantized_fused_decode_attention": "distributed_llm_inference_tpu_torch/csrc/quant_attention.cu",
    "paged_tail_flush": "distributed_llm_inference_tpu_torch/csrc/paged_attention.cu",
    "flash_attention": "distributed_llm_inference_tpu_torch/csrc/flash_attention.cu",
    "quantized_decode_attention": "distributed_llm_inference_tpu_torch/csrc/quant_attention.cu",
    "fused_tail_flush": "distributed_llm_inference_tpu_torch/csrc/quant_attention.cu",
    "sink_fused_decode_attention": "distributed_llm_inference_tpu_torch/csrc/sink_attention.cu",
    "sink_tail_flush": "distributed_llm_inference_tpu_torch/csrc/sink_attention.cu",
    **{name: "distributed_llm_inference_tpu_torch/csrc/latent_attention.cu"
       for name in LATENT_WRAPPERS},
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_device()
    timed, floor, checked = phase_kernels()
    latent_timed, latent_widths = phase_latent_kernels(
        torch.ones(16 * 1024 * 1024, dtype=torch.int64, device=DEV))
    launches = phase_engine()
    phase_families()
    width_launches = phase_widths()
    latent_launches, tensor_core_launches = phase_latent()
    phase_parity()
    phase_parity_families()
    phase_parity_widths()
    phase_parity_latent()
    timed.update(latent_timed)
    launches.update(latent_launches)
    for name, n in tensor_core_launches.items():
        timed[name]["tensor_core_launches"] = n
    checked.update(latent_widths)
    assert set(timed) == set(REPLACES) == set(launches), (
        sorted(timed), sorted(launches))
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "shape": k["shape"],
         "launches_on_the_width_paths": width_launches.get(name, 0),
         "widths_checked": checked[name],
         **{key: k[key] for key in (
             "instances", "tensor_core_launches", "bound_ms_f32_cuda_cores",
             "cuda_core_kernel", "launches_a_call", "cluster") if key in k},
         **({"at_b1": {key: k["at_b1"][key] for key in (
             "ms", "bound_ms", "bound_by", "cuda_core_kernel", "cluster")
             if key in k["at_b1"]}} if "at_b1" in k else {}),
         **({"precision_bf16_steps": {
             "max": k["precision"]["max_bf16_steps"],
             "one_pass_control_min": k["precision"][
                 "min_one_pass_bf16_steps"]}} if "precision" in k else {}),
         "at_widths": {w: {key: e[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape")} for w, e in k.get("at_widths", {}).items()}}
        for name, k in timed.items()
    ], "timed_call_floor_ms": floor, "seconds": time.perf_counter() - t0})
    phase_serve()
    phase_serve_mixtral()
    phase_serve_llama32()
    phase_serve_deepseek()
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
