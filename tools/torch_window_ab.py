"""Parent against change on the card, for the PyTorch/CUDA port, as
`chip_smoke.py` measures them, at Llama-3-8B width and depth with random
weights:

* kernels (CUDA events, L2 emptied, bf16): the int4 matmuls at 8 rows,
  `int4_matmul_stacked` (#14) over each of a Llama-3-8B layer's seven
  projections and the layer, `int4_matmul` (#13) over the 128256-wide
  head; `quantized_ragged_paged_attention` (#4, one 2048-token prompt over
  int8 pages of 64), and its error against the plain version on
  `chip_smoke.py`'s pinned case (the B = 8 launch of `RAGGED_ROWS` over
  int8 pages of 48, inputs from seed 0); `quantized_fused_decode_attention`
  (#9) over stacks of T = 640 and 2048 (B = 8, the tail full),
  `quantized_paged_fused_attention` (#6, which shares #9's kernel) over
  2032 + 16 tokens, and the decode kernels `paged_attention` (#2),
  `quantized_paged_attention` (#5) and `quantized_decode_attention` (#8)
  over 2048 tokens at B = 8 and B = 1, `sink_fused_decode_attention` (#11)
  at phase 2's shape (B = 8, window 1024 with 4 sinks, the tail full) and
  the three tail flushes over one window of 32 layers at phase 2's shapes,
  `paged_tail_flush` (#7), `fused_tail_flush` (#10) and `sink_tail_flush`
  (#12), each with its launches a call; and the timed call's floor (an
  empty kernel);
* decode windows (a captured K = 16 window over 8 rows of ~600 tokens; on
  the sink ring 8 streams of window + 7 tokens):
  int4 weights over int8 pages (#6), int4 weights over the int8 dense
  cache (#9), bf16 weights over bf16 pages (#2), int4 weights over the
  int8 sink ring (#11), each with the int4
  matmul's kernels, their milliseconds and launches a window; and K = 1 decode ticks
  over the same rows: bf16 weights over the int8 dense cache at 8 layers
  (#8), int4 weights over int8 pages at 4 layers (#5);
* the int4 weights + int8 dense cache `[1, 2048]` prefill dispatch (#3).

Usage, from the root of the change's checkout, on a machine with one GPU:

    python tools/torch_window_ab.py PARENT_DIR

PARENT_DIR is a checkout of the parent commit (for example unpacked from
`git archive` into a directory that `.gitignore` lists). Each tree runs in
a process of its own, in the order parent, change, change, parent; each
prints one JSON line: the kernels' milliseconds, and for each window,
K = 1 tick and the prefill the wall and device milliseconds (the
profiler's kernel sum and the CUDA events' span), kernels run, and the
decode attention kernels with their milliseconds and launches.
"""

import json
import os
import subprocess
import sys

# The kernels whose launches a call are counted, by the names the profiler
# gives them: the decode attention kernels, the ragged kernels, the int4
# matmul's kernels, the flushes (either tree's).
ATTENTION = ("fused_cluster_kernel", "paged_decode_kernel",
             "fused_scores_kernel", "fused_sums_kernel",
             "fused_combine_kernel", "paged_partial_kernel",
             "paged_combine_kernel", "ragged_kernel", "int4_",
             "tail_flush_kernel", "tail_scatter_kernel")


def int4_calls(smoke, calls):
    """#14 over each projection of one layer and the layer, #13 over the
    head, 8 rows of bf16 x (a stack of 2 layers, layer 1)."""
    import torch

    from distributed_llm_inference_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(7)
    stacks = {n: smoke.int4_weight(gen, (2, *shape))
              for n, shape in smoke.PROJECTIONS.items()}
    xs = {n: torch.randn((8, n), generator=gen, device="cuda").to(
        torch.bfloat16) for n in (4096, 14336)}

    def stacked(n):
        w = stacks[n]
        return lambda: qm.int4_matmul_stacked(
            xs[w.in_dim], w.q, w.scale_lo, w.scale_hi, 1, w.out_dim)

    for n in smoke.PROJECTIONS:
        calls[f"#14 {n} rows=8"] = stacked(n)
    layer = [stacked(n) for n in smoke.PROJECTIONS]
    calls["#14 layer rows=8"] = lambda: [f() for f in layer]
    head = smoke.int4_weight(gen, (1, *smoke.HEAD))
    calls["#13 head rows=8"] = lambda: qm.int4_matmul(
        xs[4096], head.q[0], head.scale_lo[0], head.scale_hi[0], head.out_dim)


def pinned_ragged_error(smoke):
    """#4 (bf16) against its plain version on the inputs of `chip_smoke.py`'s
    pinned case, drawn here as the change's smoke draws them, so that
    either tree can be held to them."""
    import numpy as np
    import torch

    from distributed_llm_inference_tpu_torch.ops import ragged_attention as ra

    rng = np.random.default_rng(0)
    rows = {k: smoke.i32(v) for k, v in smoke.RAGGED_ROWS.items()}
    s, ps = max(smoke.RAGGED_ROWS["num_new"]), 48
    q = smoke.normal(rng, (8, s, smoke.HQ, smoke.D), torch.bfloat16)
    width = -(-max(smoke.RAGGED_ROWS["kv_len"]) // ps) + 1
    pages = 8 * width + 1
    pool = smoke.make_qpool(rng, pages, ps=ps)
    table = smoke.make_table(rng, 8, width, pages)
    kw = dict(q_start=rows["q_start"], sliding_window=None)
    got = ra.quantized_ragged_paged_attention(
        q, *pool, table, rows["kv_len"], rows["num_new"], **kw)
    want = smoke.ragged_plain_by_rows(pool, q, table, rows["kv_len"],
                                      rows["num_new"], **kw)
    torch.cuda.synchronize()
    return smoke.max_err(got, want)


def sink_and_flush_calls(smoke, rng, calls):
    """#11 at `chip_smoke.py`'s timed shape (B = 8, window 1024 with 4
    sinks, mid-stream, the tail full) and #7 over one window of 32 layers
    (every row's window over two pages), #10 over one window at 2040 in a
    2400-wide buffer and #12 over one window from slot 1013 of a 1020-slot
    ring (across its end), bf16, as that script's `time_sink`,
    `time_fused` and `time_dense` draw them."""
    import torch

    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant_attention as qa

    b, kt, sinks, r, tr = 8, smoke.KT, 4, 1020, 1024
    ring = smoke.make_qplanes(rng, (2, b, smoke.HKV), tr)
    sink = smoke.make_qplanes(rng, (2, b, smoke.HKV), 32)
    tail = smoke.make_qplanes(rng, (2, b, smoke.HKV), kt)
    q, qs = (smoke.normal(rng, (b, 1, smoke.HQ, smoke.D), torch.bfloat16)
             for _ in range(2))
    kn, vn = (smoke.normal(rng, (b, 1, smoke.HKV, smoke.D), torch.bfloat16)
              for _ in range(2))
    kw = dict(layer_idx=1, step_idx=smoke.i32([kt - 1]), ring_slots=r,
              **smoke.sink_scalars(smoke.i32([1031] * b),
                                   smoke.i32([kt - 1] * b),
                                   smoke.i32([1] * b), sinks, r))
    calls["#11 TR=1024"] = lambda: qa.sink_fused_decode_attention(
        q, qs, kn, vn, *ring, *sink, *tail, **kw)
    layers, base_len = smoke.LLAMA3_8B.num_layers, 2040
    width = smoke.ladder_pages(base_len + kt)
    pages = b * width + 1
    pool = smoke.make_qplanes(rng, (layers, pages, smoke.HKV), smoke.PS)
    table = smoke.make_table(rng, b, width, pages)
    ftail = smoke.make_qplanes(rng, (layers, b, smoke.HKV), kt)
    base, tl = smoke.i32([base_len] * b), smoke.i32([kt] * b)
    calls["#7 L=32"] = lambda: pa.paged_tail_flush(*pool, *ftail, table,
                                                   base, tl)
    big = smoke.make_qplanes(rng, (layers, b, smoke.HKV), 2400)
    dtail = smoke.make_qplanes(rng, (layers, b, smoke.HKV), kt)
    calls["#10 L=32"] = lambda: qa.fused_tail_flush(*big, *dtail, base, tl)
    ring32 = smoke.make_qplanes(rng, (layers, b, smoke.HKV), tr)
    stail = smoke.make_qplanes(rng, (layers, b, smoke.HKV), kt)
    ptr, skip = smoke.i32([r - 7] * b), smoke.i32([0] * b)
    calls["#12 L=32"] = lambda: qa.sink_tail_flush(*ring32, *stail, ptr,
                                                   skip, tl, r)


def kernel_times(smoke):
    """#14, #13, #4, #9, #6, #2, #5, #8, #11, #7, #10 and #12 at phase 2's
    shapes in this tree, bf16: milliseconds a call and launches a call
    (counted by the profiler); and the timed call's floor."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant_attention as qa
    from distributed_llm_inference_tpu_torch.ops import ragged_attention as ra

    rng = np.random.default_rng(99)
    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device="cuda")
    dtype, kt, b = torch.bfloat16, smoke.KT, 8
    calls = {}
    int4_calls(smoke, calls)
    width = smoke.ladder_pages(2048)
    pool4 = smoke.make_qpool(rng, 9 * width + 1)
    table4 = smoke.make_table(rng, 1, width, 9 * width + 1)
    q4 = smoke.normal(rng, (1, 2048, smoke.HQ, smoke.D), dtype)
    lens4 = smoke.i32([2048])
    calls["#4 S=2048"] = lambda: ra.quantized_ragged_paged_attention(
        q4, *pool4, table4, lens4, lens4)
    q = smoke.normal(rng, (b, 1, smoke.HQ, smoke.D), dtype)
    kn = smoke.normal(rng, (b, 1, smoke.HKV, smoke.D), dtype)
    vn = smoke.normal(rng, (b, 1, smoke.HKV, smoke.D), dtype)
    for t in (640, 2048):
        big = smoke.make_qplanes(rng, (2, b, smoke.HKV), t)
        tail = smoke.make_qplanes(rng, (2, b, smoke.HKV), kt)
        kw = dict(layer_idx=1, step_idx=smoke.i32([kt - 1]),
                  base_len=smoke.i32([t - kt] * b),
                  tail_valid_len=smoke.i32([kt] * b),
                  q_positions=smoke.i32([t - 1] * b))
        calls[f"#9 T={t}"] = (
            lambda big=big, tail=tail, kw=kw:
            qa.quantized_fused_decode_attention(q, kn, vn, *big, *tail, **kw))
    width = smoke.ladder_pages(2048)
    pages = b * width + 1
    qpool = smoke.make_qplanes(rng, (2, pages, smoke.HKV), smoke.PS)
    tail = smoke.make_qplanes(rng, (2, b, smoke.HKV), kt)
    kw6 = dict(layer_idx=1, step_idx=smoke.i32([kt - 1]),
               base_len=smoke.i32([2048 - kt] * b),
               tail_valid_len=smoke.i32([kt] * b),
               q_positions=smoke.i32([2047] * b),
               page_table=smoke.make_table(rng, b, width, pages))
    calls["#6 kv=2048"] = lambda: pa.quantized_paged_fused_attention(
        q, kn, vn, *qpool, *tail, **kw6)
    pool = smoke.make_pool(rng, 9 * width + 1, dtype)
    for rows in (8, 1):
        table = smoke.make_table(rng, rows, width, 9 * width + 1)
        qd = smoke.normal(rng, (rows, 1, smoke.HQ, smoke.D), dtype)
        lens = smoke.i32([2048] * rows)
        calls[f"#2 B={rows}"] = (
            lambda table=table, qd=qd, lens=lens:
            pa.paged_attention(qd, *pool, table, lens))
    pool5 = smoke.make_qpool(rng, 9 * width + 1)
    for rows in (8, 1):
        table = smoke.make_table(rng, rows, width, 9 * width + 1)
        qd = smoke.normal(rng, (rows, 1, smoke.HQ, smoke.D), dtype)
        lens = smoke.i32([2048] * rows)
        calls[f"#5 B={rows}"] = (
            lambda table=table, qd=qd, lens=lens:
            pa.quantized_paged_attention(qd, *pool5, table, lens))
    for rows in (8, 1):
        planes = smoke.make_qplanes(rng, (rows, smoke.HKV), 2048)
        qd = smoke.normal(rng, (rows, 1, smoke.HQ, smoke.D), dtype)
        lens = smoke.i32([2048] * rows)
        calls[f"#8 B={rows}"] = (
            lambda planes=planes, qd=qd, lens=lens:
            qa.quantized_decode_attention(qd, *planes, lens))
    sink_and_flush_calls(smoke, rng, calls)
    out = {"floor": {"ms": smoke.time_ms(lambda: torch.cuda._sleep(0), 50,
                                         flush), "launches": 1}}
    for name, fn in calls.items():
        ms = smoke.time_ms(fn, 20, flush)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = sum(ev.count for ev in prof.key_averages()
                       if any(n in ev.key for n in ATTENTION))
        out[name] = {"ms": ms, "launches": launches}
    return out


def run_tree(root):
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke
    from distributed_llm_inference_tpu_torch.models import llama

    kernels = kernel_times(smoke)
    cfg = smoke.LLAMA3_8B
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
        "cuda")
    int4 = {"quantization": "int4"}
    windows = {
        "int8 pages": smoke.profile_decode(
            cfg, params, int4, {"kv_quant": "int8"}, smoke.MAIN_INT4),
        "int8 dense": smoke.profile_decode(
            cfg, params, int4, {"kv_quant": "int8", **smoke.DENSE},
            smoke.MAIN_DENSE),
        "bf16 pages": smoke.profile_decode(cfg, params, {}, {},
                                           smoke.MAIN_BF16),
        "int8 sink": smoke.profile_decode(
            cfg, params, int4, {"kv_quant": "int8", **smoke.SINK},
            smoke.MAIN_SINK),
    }
    cfg8, params8 = smoke.depth(params, cfg, 8)
    windows["K=1 int8 dense, 8 layers"] = smoke.profile_decode(
        cfg8, params8, {"decode_steps": 1}, {"kv_quant": "int8", **smoke.DENSE},
        smoke.QDENSE)
    cfg4, params4 = smoke.depth(params, cfg, 4)
    windows["K=1 int4 + int8 pages, 4 layers"] = smoke.profile_decode(
        cfg4, params4, {"decode_steps": 1, "quantization": "int4"},
        {"kv_quant": "int8"}, smoke.SLICE2)
    prefill = smoke.profile_prefill(
        cfg, params, int4, {"kv_quant": "int8", **smoke.DENSE},
        smoke.MAIN_DENSE)

    def attention(profile, names):
        return {k["name"][:40]: (round(k["ms"], 3), k["launches"])
                for k in profile["top_kernels"]
                if any(n in k["name"] for n in names)}

    def int4(profile):
        """The int4 matmul's kernels among the ten that take the most time
        (found by name in either tree): milliseconds and launches a window."""
        return attention(profile, ("int4_",))

    keys = ("wall_ms", "device_ms", "device_ms_events", "kernels")
    print(json.dumps({
        "tree": root,
        "kernels": kernels,
        "pinned_ragged_error_bf16": pinned_ragged_error(smoke),
        "windows": {
            name: {**{k: w[k] for k in keys},
                   "attention": w["attention_kernels"], "int4": int4(w)}
            for name, w in windows.items()},
        "prefill": {k: prefill[k] for k in keys},
        "prefill_attention": attention(prefill, ("flash", "mask_tiles")),
    }))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        run_tree(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(sys.argv[1])
    change = os.getcwd()
    script = os.path.abspath(__file__)
    for root in (parent, change, change, parent):
        proc = subprocess.run([sys.executable, script, "--tree", root],
                              cwd=root, capture_output=True, text=True)
        print(proc.stdout.strip(), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
