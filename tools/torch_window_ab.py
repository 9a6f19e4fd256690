"""Parent against change on the card, for the PyTorch/CUDA port: the int4
weights + int8 pages decode window (a captured K = 16 window over 8 rows of
~600 tokens) and the int4 weights + int8 dense cache `[1, 2048]` prefill
dispatch, as `chip_smoke.py` profiles them, at Llama-3-8B width and depth
with random weights.

Usage, from the root of the change's checkout, on a machine with one GPU:

    python tools/torch_window_ab.py PARENT_DIR

PARENT_DIR is a checkout of the parent commit (for example unpacked from
`git archive` into a directory that `.gitignore` lists). Each tree runs in
a process of its own, in the order parent, change, change, parent; each
prints one JSON line: wall and device milliseconds (the profiler's kernel
sum and the CUDA events' span), kernels run, and the attention kernels
among the ten largest with their milliseconds and launches.
"""

import json
import os
import subprocess
import sys


def run_tree(root):
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke
    from distributed_llm_inference_tpu_torch.models import llama

    cfg = smoke.LLAMA3_8B
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
        "cuda")
    window = smoke.profile_decode(cfg, params, {"quantization": "int4"},
                                  {"kv_quant": "int8"}, smoke.MAIN_INT4)
    prefill = smoke.profile_prefill(
        cfg, params, {"quantization": "int4"},
        {"kv_quant": "int8", **smoke.DENSE}, smoke.MAIN_DENSE)

    def attention(profile, names):
        return {k["name"][:40]: (round(k["ms"], 3), k["launches"])
                for k in profile["top_kernels"]
                if any(n in k["name"] for n in names)}

    keys = ("wall_ms", "device_ms", "device_ms_events", "kernels")
    print(json.dumps({
        "tree": root,
        "window": {k: window[k] for k in keys},
        "window_attention": attention(window, ("fused_", "cluster")),
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
