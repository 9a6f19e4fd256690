#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run it from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and `nvcc`; with no device it exits non-zero and
prints no result. It imports only the port (`distributed_llm_inference_tpu_torch`),
builds both CUDA kernels from `csrc/` into `build/`, and runs four phases, one
JSON line each:

1. device   - the card's name and power limit, as `nvidia-smi` gives them.
2. kernels  - `paged_attention` and `ragged_paged_attention` at Llama-3-8B
              shapes (32 query heads, 8 kv heads, head_dim 128, page size 64),
              in bf16 and f32, against their plain PyTorch versions on the
              card, each case with its tolerance (and once as MHA, the other
              grouping the kernels are built for); then, at one decode and
              one prefill shape, each kernel's output against the plain
              version's on the same inputs and its time beside the plain
              version, one `scaled_dot_product_attention` call (a yardstick
              only) and the card's bound for the same work.
3. engine   - `InferenceEngine` at the full width and depth of Llama-3-8B in
              bf16 with random seeded weights: 12 greedy prompts queue for 8
              slots, then a 3000-token greedy prompt chunk-admits beside live
              decode, two sampled prompts ride along, one stream is cancelled.
              The run is made twice with the same seed and must repeat itself.
              The kernels' launch counters are zeroed before the first run
              and read after it. Every attention dispatch shape that run
              made (rows, token width, page-table width) is then given to
              both kernels again, in bf16 and f32 with mixed lengths, and
              held against the plain versions. A few decode ticks and
              prefill dispatches are profiled for the device's idle share
              and the kernels that take the time.
4. parity   - the same engine at 2 layers in f32 (TF32 off), once through the
              kernels and once through the gather path: identical greedy
              streams.

Then a line `{"kernels": [...]}` with one entry per kernel (the only line
with that key: phase 2 lists its results under `checked`), and the last line
`{"ok": true, "device": {...}}`. Any failing phase raises: exit code non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from distributed_llm_inference_tpu_torch.cache.base import window_ladder
from distributed_llm_inference_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    RopeScaling,
)
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions
from distributed_llm_inference_tpu_torch.models import llama
from distributed_llm_inference_tpu_torch.ops import _build
from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
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

# Published peaks of one H100 SXM (dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# bf16: the kernel and the plain version both accumulate in f32 from the same
# bf16 inputs and round once at the end, in another order of summation, so
# they differ by at most one bf16 step of an output of magnitude < 4 (2^-6).
# f32: only the order of summation differs.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}

DEV = "cuda"
SPIN_CYCLES = 10_000_000  # about 5 ms of device spin at 1.7-2 GHz


def emit(obj) -> None:
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
    name, _, limit = line.partition(",")
    emit({"phase": "device", "name": name.strip(),
          "power_limit": limit.strip(),
          "torch": torch.__version__, "cuda": torch.version.cuda})


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def normal(rng, shape, dtype):
    return torch.as_tensor(
        rng.standard_normal(shape, dtype=np.float32)).to(DEV, dtype)


def make_pool(rng, num_pages, dtype, hkv=HKV, ps=PS, d=D):
    shape = (num_pages, hkv, ps, d)
    return normal(rng, shape, dtype), normal(rng, shape, dtype)


def make_table(rng, batch, width, num_pages):
    """Distinct non-null pages per slot, in a shuffled order."""
    assert batch * width <= num_pages - 1
    ids = rng.permutation(num_pages - 1)[: batch * width] + 1
    return torch.as_tensor(ids.reshape(batch, width).astype(np.int32)).to(DEV)


def i32(values):
    return torch.as_tensor(np.asarray(values, np.int32)).to(DEV)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def ragged_plain_by_rows(q, k, v, table, kv_len, num_new, q_start=None,
                         sliding_window=None):
    """The plain version one row at a time: it materialises the whole
    [heads, S, slots] score tensor in f32, about 1 GiB a row at S = 2048 over
    4096 slots, so a batch is not given to it in one piece."""
    return torch.cat([
        ra.ragged_paged_attention_plain(
            q[i:i + 1], k, v, table[i:i + 1], kv_len[i:i + 1],
            num_new[i:i + 1], None if q_start is None else q_start[i:i + 1],
            sliding_window=sliding_window)
        for i in range(q.shape[0])])


def compare_paged(cases, tag, dtype, q, k, v, table, kv_len, **kw):
    """`paged_attention` against its plain version on the same inputs: the
    output and both softmax stats, appended to ``cases``. Returns the
    output's max abs error."""
    got, gm, gl = pa.paged_attention(q, k, v, table, kv_len,
                                     return_stats=True, **kw)
    want, wm, wl = pa.paged_attention_plain(q, k, v, table, kv_len,
                                            return_stats=True, **kw)
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


def compare_ragged(cases, tag, dtype, q, k, v, table, kv_len, num_new, **kw):
    """`ragged_paged_attention` against its plain version on the same inputs,
    appended to ``cases``; pad queries must come out as exact zeros."""
    got = ra.ragged_paged_attention(q, k, v, table, kv_len, num_new, **kw)
    want = ragged_plain_by_rows(q, k, v, table, kv_len, num_new, **kw)
    torch.cuda.synchronize()
    pad = torch.arange(q.shape[1], device=DEV)[None, :] >= num_new[:, None]
    if bool(pad.any()):
        assert float(got[pad].abs().max()) == 0.0, "pad queries must be zero"
    err = max_err(got, want)
    cases.append((tag, err, TOL[dtype]))
    return err


def assert_cases(cases, dtype):
    for name, err, limit in cases:
        assert np.isfinite(err) and err <= limit, (
            f"{name} [{dtype}]: max abs err {err} > tolerance {limit}")


def check_cases(dtype):
    """Every correctness case for one dtype: (name, error, tolerance)."""
    rng = np.random.default_rng(1234)
    cases = []

    # Ragged: a full-prompt row, a chunk row with q_start > 0, a decode row
    # and an empty row in one launch, padded to S = 256.
    pages, width, s = 160, 16, 256
    k, v = make_pool(rng, pages, dtype)
    table = make_table(rng, 4, width, pages)
    q = normal(rng, (4, s, HQ, D), dtype)
    num_new = i32([200, 128, 1, 0])
    kv_len = i32([200, 428, 777, 0])
    for window in (None, 100):
        compare_ragged(cases, f"ragged_mixed_window_{window}", dtype, q, k, v,
                       table, kv_len, num_new, sliding_window=window)
    # Explicit q_start (a chunk whose queries are not the newest tokens).
    compare_ragged(cases, "ragged_q_start", dtype, q, k, v, table, kv_len,
                   num_new, q_start=i32([0, 250, 776, 0]))

    # Paged decode: ragged lengths including 0 and page edges, stats, a
    # sliding window, and q_positions past the pool contents.
    lens = [0, 1, 64, 65, 1000, 1024, 513, 37]
    qd = normal(rng, (8, 1, HQ, D), dtype)
    table8 = make_table(rng, 8, width, pages)
    kv8 = i32(lens)
    for window, qpos in ((None, None), (200, None),
                         (200, i32([n + 7 for n in lens]))):
        tag = f"paged_window_{window}_qpos_{'past' if qpos is not None else 'default'}"
        compare_paged(cases, tag, dtype, qd, k, v, table8, kv8,
                      sliding_window=window, q_positions=qpos)

    # MHA (one query head per kv head): the other grouping the kernels are
    # built for, same pool, 8 query heads.
    compare_ragged(cases, "ragged_mha", dtype, q[:, :, :HKV].contiguous(), k,
                   v, table, kv_len, num_new, sliding_window=100)
    compare_paged(cases, "paged_mha", dtype, qd[:, :, :HKV].contiguous(), k,
                  v, table8, kv8, sliding_window=200)
    assert_cases(cases, dtype)
    return cases


def time_ms(fn, iters, flush):
    """Mean device milliseconds of what ``fn()`` enqueues, over ``iters``
    calls: CUDA events around each call, the L2 cache overwritten before each
    one. The card first spins for a few milliseconds so that the host has
    enqueued the whole call before the start event is reached; without that,
    an idle card waits for the host and the events measure Python."""
    fn()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
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


def time_kernels():
    """Both kernels in bf16 at one shape each of the main path: decode at
    B=8 over 2048 cached tokens a row, prefill of one 2048-token prompt, the
    page table as wide as the engine makes it for such rows. Each kernel's
    output is first held against the plain version's on these very inputs;
    that error is the one reported beside the times."""
    dtype = torch.bfloat16
    esz = 2
    rng = np.random.default_rng(99)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=DEV)
    width = ladder_pages(2048)
    pages = 9 * width + 1
    k, v = make_pool(rng, pages, dtype)
    out = {}
    cases = []

    # decode
    b, kv = 8, 2048
    table = make_table(rng, b, width, pages)
    q = normal(rng, (b, 1, HQ, D), dtype)
    lens = i32([kv] * b)
    kg = pa.gather_pages(k, table).permute(0, 2, 1, 3).contiguous()
    vg = pa.gather_pages(v, table).permute(0, 2, 1, 3).contiguous()
    qh = q.permute(0, 2, 1, 3).contiguous()
    live = b * kv
    bytes_moved = (2 * live * HKV * D * esz       # K and V slots, once
                   + 2 * q.numel() * esz          # q in, out out
                   + 2 * b * HQ * 4               # m, l
                   + table.numel() * 4 + 2 * b * 4)
    flops = 4 * live * HQ * D
    bms, by = bound(bytes_moved, flops, dtype)
    out["paged_attention"] = {
        "shape": f"B={b} kv={kv} table={width} Hq={HQ} Hkv={HKV} D={D} PS={PS} bf16",
        "max_abs_err": compare_paged(
            cases, "paged_timed", dtype, q, k, v, table, lens),
        "ms": time_ms(lambda: pa.paged_attention(q, k, v, table, lens), 20, flush),
        "plain_ms": time_ms(
            lambda: pa.paged_attention_plain(q, k, v, table, lens), 5, flush),
        "library_ms": time_ms(lambda: sdpa(qh, kg, vg, False), 20, flush),
        "bound_ms": bms, "bound_by": by,
    }
    del kg, vg

    # prefill
    s = 2048
    table1 = make_table(rng, 1, width, pages)
    q = normal(rng, (1, s, HQ, D), dtype)
    lens1, new1 = i32([s]), i32([s])
    kg = pa.gather_pages(k, table1).permute(0, 2, 1, 3).contiguous()
    vg = pa.gather_pages(v, table1).permute(0, 2, 1, 3).contiguous()
    qh = q.permute(0, 2, 1, 3).contiguous()
    visible = s * (s + 1) // 2                    # causal (query, slot) pairs
    bytes_moved = (2 * s * HKV * D * esz + 2 * q.numel() * esz
                   + table1.numel() * 4 + 3 * 4)
    flops = 4 * visible * HQ * D
    bms, by = bound(bytes_moved, flops, dtype)
    out["ragged_paged_attention"] = {
        "shape": f"B=1 S={s} table={width} Hq={HQ} Hkv={HKV} D={D} PS={PS} bf16",
        "max_abs_err": compare_ragged(
            cases, "ragged_timed", dtype, q, k, v, table1, lens1, new1),
        "ms": time_ms(
            lambda: ra.ragged_paged_attention(q, k, v, table1, lens1, new1),
            5, flush),
        "plain_ms": time_ms(
            lambda: ra.ragged_paged_attention_plain(
                q, k, v, table1, lens1, new1), 3, flush),
        "library_ms": time_ms(lambda: sdpa(qh, kg, vg, True), 10, flush),
        "bound_ms": bms, "bound_by": by,
    }
    assert_cases(cases, dtype)
    return out


def phase_kernels():
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 stays f32
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[dtype] = check_cases(dtype)
    times = time_kernels()
    kernels = []
    for name in ("paged_attention", "ragged_paged_attention"):
        prefix = "paged" if name == "paged_attention" else "ragged"
        entry = {"name": name}
        for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            mine = [(n, e, t) for n, e, t in errs[dtype] if n.startswith(prefix)]
            entry[f"max_abs_err_{label}"] = max(
                e for n, e, t in mine if not n.endswith(("_m", "_l")))
            entry[f"tolerance_{label}"] = TOL[dtype]
            entry[f"cases_{label}"] = {n: e for n, e, _ in mine}
        entry["timed"] = times[name]
        kernels.append(entry)
    emit({"phase": "kernels", "build_s": build_s,
          "libraries": {k: str(p.name) for k, p in built.items()},
          "checked": kernels})
    return times


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


def drive(engine, vocab, seed, short_lens, long_len, new_tokens, warm_steps):
    """The smoke's traffic: `short_lens` greedy prompts at once (more than
    the batch), then — while those decode — one long greedy prompt and two
    sampled ones, and one cancel. Returns (streams by submission order,
    index of the cancelled stream)."""
    rng = np.random.default_rng(seed)
    greedy = SamplingOptions(max_new_tokens=new_tokens)
    sampled = SamplingOptions(max_new_tokens=new_tokens, temperature=0.8,
                              top_p=0.9)
    client = Client(engine)
    for n in short_lens:
        client.submit(rng.integers(0, vocab, size=n).tolist(), greedy)
    for _ in range(warm_steps):
        client.step()
    cancelled = 2
    assert 0 < len(client.streams[client.order[cancelled]]) < new_tokens
    engine.cancel(client.order[cancelled])
    client.submit(rng.integers(0, vocab, size=long_len).tolist(), greedy)
    for n in (90, 400):
        client.submit(rng.integers(0, vocab, size=n).tolist(), sampled)
    return client.drain(), cancelled


def check_streams(streams, cancelled, new_tokens, vocab):
    for i, toks in enumerate(streams):
        if i == cancelled:
            assert len(toks) < new_tokens, "cancelled stream ran to its end"
            continue
        assert len(toks) == new_tokens, f"stream {i}: {len(toks)} tokens"
        assert all(0 <= t < vocab for t in toks), f"stream {i} out of range"


def device_breakdown(prof, wall_ms, steps):
    """Per-step summary of a ``torch.profiler`` run over ``steps`` engine
    steps whose unprofiled wall time was ``wall_ms`` each: summed device time
    of the step's kernels, the share of the step in which the card ran
    nothing, the number of kernels launched, and the kernels that take most
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
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "kernels": sum(ev.count for ev in kernels) / steps,
        "top_kernels": [
            {"name": ev.key[:70], "ms": device_us(ev) / 1e3 / steps,
             "launches": ev.count / steps} for ev in top],
    }


def profile_steps(engine, before_step, steps):
    """``steps`` engine steps on the host clock (synchronised), then ``steps``
    more under ``torch.profiler``; ``before_step`` runs ahead of each one,
    outside the timed region."""
    from torch.profiler import ProfilerActivity, profile

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
    return device_breakdown(prof, wall * 1e3 / steps, steps)


def profile_decode(cfg, params, ticks=5):
    """Where a decode tick's time goes, for a full batch of 8 rows of about
    600 cached tokens each."""
    engine = InferenceEngine(
        cfg, params, EngineConfig(max_batch_size=8),
        CacheConfig(num_pages=2048),
        generator=torch.Generator().manual_seed(3), device=DEV)
    rng = np.random.default_rng(17)
    for _ in range(8):
        engine.submit(rng.integers(0, cfg.vocab_size, size=600).tolist(),
                      SamplingOptions(max_new_tokens=64))
    for _ in range(3):
        engine.step()  # admission, prefill, first decode ticks
    return profile_steps(engine, lambda: None, ticks)


def profile_prefill(cfg, params, steps=2):
    """Where a prefill dispatch's time goes: one 2048-token greedy prompt
    admitted into an idle engine and asked for a single token, so that the
    step is exactly one [1, 2048] prefill dispatch and its sample."""
    engine = InferenceEngine(
        cfg, params, EngineConfig(max_batch_size=8),
        CacheConfig(num_pages=2048),
        generator=torch.Generator().manual_seed(4), device=DEV)
    rng = np.random.default_rng(19)

    def submit():
        engine.submit(rng.integers(0, cfg.vocab_size, size=2048).tolist(),
                      SamplingOptions(max_new_tokens=1))

    submit()
    engine.step()  # warm-up
    out = profile_steps(engine, submit, steps)
    assert not engine.has_work()
    assert engine.metrics.get_counter("prefill_tokens") == 2048 * (1 + 2 * steps)
    return out


def check_engine_shapes(shapes, table_width):
    """Both kernels against their plain versions at every attention dispatch
    shape the engine run made, in bf16 (the run's type) and f32, on mixed
    lengths. ``shapes`` is `AttentionPlan.dispatch_shapes`: ("prefill" or
    "chunk", rows, token width) reach the ragged kernel, under the table as
    wide as it grew (``table_width``); ("decode", rows, 1, table width) reach
    the decode kernel. Each prefill-family shape is run twice: fresh prompts
    (q_start 0) and rows continuing a longer prompt (q_start > 0, as the
    later chunks of a long prompt are). Returns per kernel and type the
    largest error and the number of comparisons."""
    out = {}
    rows_max = max(sh[1] for sh in shapes)
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rng = np.random.default_rng(4321)
        k, v = make_pool(rng, rows_max * table_width + 1, dtype)
        cases = []
        for kind, rows, *rest in sorted(shapes):
            tag = "_".join(str(x) for x in (kind, rows, *rest))
            if kind == "decode":
                width = rest[1]
                slots = width * PS
                lens = rng.integers(1, slots + 1, size=rows)
                lens[0] = slots              # a row that fills its table
                if rows > 1:
                    lens[-1] = 0             # an inactive row
                compare_paged(
                    cases, "paged_" + tag, dtype,
                    normal(rng, (rows, 1, HQ, D), dtype), k, v,
                    make_table(rng, rows, width, k.shape[0]), i32(lens))
                continue
            s, slots = rest[0], table_width * PS
            q = normal(rng, (rows, s, HQ, D), dtype)
            table = make_table(rng, rows, table_width, k.shape[0])
            num_new = rng.integers(1, s + 1, size=rows)
            num_new[0] = s                   # a row with no pad query
            compare_ragged(cases, f"ragged_{tag}_fresh", dtype, q, k, v,
                           table, i32(num_new), i32(num_new))
            if slots > s:
                start = rng.integers(1, slots - num_new + 1)
                compare_ragged(cases, f"ragged_{tag}_continued", dtype, q, k,
                               v, table, i32(start + num_new), i32(num_new))
        assert_cases(cases, dtype)
        for name in ("paged", "ragged"):
            mine = [e for n, e, _ in cases
                    if n.startswith(name) and not n.endswith(("_m", "_l"))]
            assert mine, f"the engine run dispatched nothing to the {name} kernel"
            out[f"{name}_{label}"] = {"max_abs_err": max(mine),
                                      "comparisons": len(mine)}
        del k, v
    return out


def phase_engine():
    cfg = LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(0), torch.bfloat16, DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    short_lens = [30, 1500] + rng.integers(30, 1500, size=10).tolist()
    new_tokens, long_len = 32, 3000

    runs = []
    for attempt in range(2):
        engine = InferenceEngine(
            cfg, params, EngineConfig(max_batch_size=8),
            CacheConfig(num_pages=2048),
            generator=torch.Generator().manual_seed(11), device=DEV)
        assert engine.cache.use_kernel and engine.cache.use_ragged
        if attempt == 0:
            pa.launches = 0
            ra.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams, cancelled = drive(
            engine, cfg.vocab_size, 5, short_lens, long_len, new_tokens,
            warm_steps=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if attempt == 0:
            launches = {"paged_attention": pa.launches,
                        "ragged_paged_attention": ra.launches}
            shapes = engine.plan.dispatch_shapes
            table_width = engine.cache.page_table.shape[1]
        check_streams(streams, cancelled, new_tokens, cfg.vocab_size)
        m = engine.metrics
        assert engine.allocator.free_count == 2048 - 1, "pages leaked"
        assert m.get_counter("attn_chunked_rows") > 0, (
            "the long prompt was not chunk-admitted beside live decode")
        assert m.get_counter("batched_prefills") > 0
        snap = m.snapshot()
        runs.append({
            "streams": streams,
            "wall_s": wall,
            "generated_tokens": sum(len(s) for s in streams),
            "tokens_per_s": sum(len(s) for s in streams) / wall,
            "prefill_tokens": m.get_counter("prefill_tokens"),
            "prefill_dispatches": snap["prefill_count"],
            "prefill_ms_mean": snap["prefill_mean_s"] * 1e3,
            "prefill_ms_total": snap["prefill_mean_s"] * snap["prefill_count"] * 1e3,
            "decode_ticks": snap["decode_step_count"],
            "decode_tick_ms_mean": snap["decode_step_mean_s"] * 1e3,
            "decode_tick_ms_p50": snap["decode_step_p50_s"] * 1e3,
            "chunked_rows": m.get_counter("attn_chunked_rows"),
            "batched_prefills": m.get_counter("batched_prefills"),
        })
        del engine
        torch.cuda.empty_cache()
    assert launches["paged_attention"] > 0, "decode kernel never launched"
    assert launches["ragged_paged_attention"] > 0, "ragged kernel never launched"
    assert runs[0]["streams"] == runs[1]["streams"], (
        "two runs with one seed gave different streams")
    report = {"phase": "engine", "model": "llama-3-8b, 32 layers, bf16, random weights",
              "init_s": init_s, "launches": launches,
              "launches_per_decode_tick": cfg.num_layers,
              "repeatable": True,
              "max_memory_allocated": torch.cuda.max_memory_allocated()}
    for i, r in enumerate(runs):
        report[f"run{i}"] = {k: v for k, v in r.items() if k != "streams"}
    report["dispatch_shapes"] = sorted(shapes)
    report["table_width"] = table_width
    report["kernels_at_dispatch_shapes"] = check_engine_shapes(
        shapes, table_width)
    report["decode_profile"] = profile_decode(cfg, params)
    report["prefill_profile"] = profile_prefill(cfg, params)
    emit(report)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_parity():
    """Kernels against the gather path through the whole engine: 2 layers of
    the same widths in f32, TF32 off, greedy streams compared exactly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device=DEV).manual_seed(1), torch.float32, DEV)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (20, 200, 63, 64, 65, 130)]
    long_prompt = rng.integers(0, cfg.vocab_size, size=600).tolist()
    opts = SamplingOptions(max_new_tokens=16)

    def run(**ekw):
        engine = InferenceEngine(
            cfg, params,
            EngineConfig(max_batch_size=4, prefill_buckets=(64, 256),
                         max_seq_len=1024, dtype="float32", **ekw),
            CacheConfig(num_pages=128, max_pages_per_session=16), device=DEV)
        client = Client(engine)
        for p in prompts:
            client.submit(p, opts)
        for _ in range(4):
            client.step()
        client.submit(long_prompt, opts)
        streams = client.drain()
        assert engine.allocator.free_count == 127
        return streams, engine

    before = (pa.launches, ra.launches)
    kern, e1 = run()
    assert e1.cache.use_kernel and e1.cache.use_ragged
    assert pa.launches > before[0] and ra.launches > before[1]
    mid = (pa.launches, ra.launches)
    gath, e2 = run(use_pallas_attention=False, ragged_attention=False)
    assert not e2.cache.use_kernel and not e2.cache.use_ragged
    assert (pa.launches, ra.launches) == mid, "gather path launched a kernel"
    assert all(len(s) == 16 for s in kern)
    assert kern == gath, "kernel path and gather path streams differ"
    emit({"phase": "parity", "model": "llama-3-8b widths, 2 layers, f32, tf32 off",
          "streams": len(kern), "tokens_each": 16, "identical": True,
          "chunked_rows_kernel_run": e1.metrics.get_counter("attn_chunked_rows")})


# ---------------------------------------------------------------------------

REPLACES = {
    "paged_attention": "distributed_llm_inference_tpu/ops/paged_attention.py:154",
    "ragged_paged_attention": "distributed_llm_inference_tpu/ops/ragged_attention.py:252",
}
SOURCES = {
    "paged_attention": "distributed_llm_inference_tpu_torch/csrc/paged_attention.cu",
    "ragged_paged_attention": "distributed_llm_inference_tpu_torch/csrc/ragged_attention.cu",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_device()
    timed = phase_kernels()
    launches = phase_engine()
    phase_parity()
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "shape": k["shape"]}
        for name, k in timed.items()
    ], "seconds": time.perf_counter() - t0})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
