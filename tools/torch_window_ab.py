"""Parent against change on the card, for the PyTorch/CUDA port, as
`chip_smoke.py` measures them, at Llama-3-8B width and depth with random
weights:

* kernels (CUDA events, L2 emptied, bf16): `quantized_fused_decode_attention`
  (#9) over stacks of T = 640 and 2048 (B = 8, the tail full),
  `quantized_paged_fused_attention` (#6, which shares #9's kernel) over
  2032 + 16 tokens, and the decode kernels `paged_attention` (#2),
  `quantized_paged_attention` (#5) and `quantized_decode_attention` (#8)
  over 2048 tokens at B = 8 and B = 1, each with its launches a call;
* decode windows (a captured K = 16 window over 8 rows of ~600 tokens):
  int4 weights over int8 pages (#6), int4 weights over the int8 dense
  cache (#9), bf16 weights over bf16 pages (#2); and K = 1 decode ticks
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

# The decode attention kernels, by the names the profiler gives them.
ATTENTION = ("fused_cluster_kernel", "paged_decode_kernel",
             "fused_scores_kernel", "fused_sums_kernel",
             "fused_combine_kernel", "paged_partial_kernel",
             "paged_combine_kernel")


def kernel_times(smoke):
    """#9, #6, #2, #5 and #8 at phase 2's shapes in this tree, bf16:
    milliseconds a call and launches a call (counted by the profiler)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant_attention as qa

    rng = np.random.default_rng(99)
    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device="cuda")
    dtype, kt, b = torch.bfloat16, smoke.KT, 8
    calls = {}
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
    out = {}
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

    keys = ("wall_ms", "device_ms", "device_ms_events", "kernels")
    print(json.dumps({
        "tree": root,
        "kernels": kernels,
        "windows": {
            name: {**{k: w[k] for k in keys},
                   "attention": w["attention_kernels"]}
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
