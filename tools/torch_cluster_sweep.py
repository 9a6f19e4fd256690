"""Cluster sizes of the decode cluster kernel (``csrc/paged_decode.cuh``) on
the card, for the PyTorch/CUDA port: each bf16-query form, `paged_attention`
over bf16 pages (#2), `quantized_paged_attention` over int8 pages (#5) and
`quantized_decode_attention` over the int8 dense buffer (#8), at B = 8 and
B = 1 (32 query heads, 8 kv heads, head_dim 128, pages of 64), with rows of
2048 live positions (tables and buffers 2048 wide) and of 600 (1024 wide,
as the engine holds such rows), timed with the cluster forced to C = 1, 2,
4 and 8 blocks and with the wrappers' own rule (``cluster_size``). Then
the int8 ring's depth: the two sources rebuilt with 3, 4, 6, 8 and 12
stages of 16 KB (``-DPDEC_INT8_STAGES``; past 6 a block takes an SM of its
own), #5 and #8 timed under each at the rule's C.

Usage, from the root of a checkout, on a machine with one GPU:

    python tools/torch_cluster_sweep.py

Prints the card's name and power limit, then one JSON line per (form, B,
live length): milliseconds a call for each C (CUDA events, L2 emptied, as
`chip_smoke.py` times kernels), the rule's C and its milliseconds; then
one JSON line per count of stages: shared memory a block, blocks an SM,
and the milliseconds of #5 and #8 per (B, live length).
"""

import ctypes
import json
import os
import subprocess
import sys

STAGES = (3, 4, 6, 8, 12)
RING_SOURCES = ("paged_attention", "quant_attention")


def build_rings(build):
    """Each source of the int8 decode forms built once per count of stages,
    every ``nvcc`` started together. Returns {stages: {source: path}}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for n in STAGES:
        for name in RING_SOURCES:
            out = build.BUILD_DIR / f"lib{name}_int8stages{n}.so"
            started[n, name] = out, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, f"-DPDEC_INT8_STAGES={n}",
                 "-o", str(out), str(build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    paths = {}
    for (n, name), (out, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu at {n} stages:\n{log}")
        paths.setdefault(n, {})[name] = out
    return paths


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as smoke
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant_attention as qa

    if not torch.cuda.is_available():
        print("torch_cluster_sweep: needs one CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    rule = pa.cluster_size
    rng = np.random.default_rng(7)
    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device="cuda")
    dtype = torch.bfloat16
    hq, hkv, d, ps = smoke.HQ, smoke.HKV, smoke.D, smoke.PS
    for live, span in ((2048, 2048), (600, 1024)):
        width = span // ps
        pages = 8 * width + 1
        pools = {"#2 bf16 pages": smoke.make_pool(rng, pages, dtype),
                 "#5 int8 pages": smoke.make_qpool(rng, pages)}
        for b in (8, 1):
            q = smoke.normal(rng, (b, 1, hq, d), dtype)
            lens = smoke.i32([live] * b)
            table = smoke.make_table(rng, b, width, pages)
            planes = smoke.make_qplanes(rng, (b, hkv), span)
            calls = {
                "#2 bf16 pages": lambda: pa.paged_attention(
                    q, *pools["#2 bf16 pages"], table, lens),
                "#5 int8 pages": lambda: pa.quantized_paged_attention(
                    q, *pools["#5 int8 pages"], table, lens),
                "#8 int8 dense": lambda: qa.quantized_decode_attention(
                    q, *planes, lens),
            }
            for form, fn in calls.items():
                got = {}
                for c in (1, 2, 4, 8):
                    pa.cluster_size = lambda *a, c=c, **k: c
                    try:
                        got[c] = smoke.time_ms(fn, 20, flush)
                    finally:
                        pa.cluster_size = rule
                c = rule(q.device, b * hkv, span)
                print(json.dumps({
                    "form": form, "B": b, "live": live, "span": span,
                    "ms_by_cluster": got, "rule_cluster": c,
                    "rule_ms": smoke.time_ms(fn, 20, flush)}), flush=True)
            del planes
        del pools
    ring_sweep(smoke, pa, qa, rng, flush)
    return 0


def ring_sweep(smoke, pa, qa, rng, flush):
    """#5 and #8 (bf16 queries, the rule's C) under each count of int8
    stages, the libraries swapped into the wrappers' caches in turn."""
    import torch

    from distributed_llm_inference_tpu_torch.ops import _build

    hq, hkv, d, ps = smoke.HQ, smoke.HKV, smoke.D, smoke.PS
    dtype = torch.bfloat16
    shapes = []
    for live, span in ((2048, 2048), (600, 1024)):
        width = span // ps
        pages = 8 * width + 1
        pool = smoke.make_qpool(rng, pages)
        planes = smoke.make_qplanes(rng, (8, hkv), span)
        for b in (8, 1):
            q = smoke.normal(rng, (b, 1, hq, d), dtype)
            lens = smoke.i32([live] * b)
            table = smoke.make_table(rng, b, width, pages)
            shapes.append((f"B={b} live={live} span={span}", {
                "#5": lambda q=q, t=table, n=lens, p=pool:
                    pa.quantized_paged_attention(q, *p, t, n),
                "#8": lambda q=q, n=lens, p=planes:
                    qa.quantized_decode_attention(
                        q, *[x[: q.shape[0]] for x in p], n),
            }))
    saved = dict(_build._libs)
    try:
        for n, paths in build_rings(_build).items():
            for name, path in paths.items():
                _build._libs[name] = ctypes.CDLL(str(path))
            pa._fn.clear()
            qa._fns.clear()
            occ = _build._libs["paged_attention"].dli_decode_occupancy
            occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            got = (ctypes.c_longlong * 3)()
            assert occ(1, 4, 2, ctypes.addressof(got)) == 0
            print(json.dumps({
                "int8_stages": n, "smem_bytes": got[0],
                "blocks_an_sm": got[1], "clusters_of_2_at_once": got[2],
                "ms": {shape: {form: smoke.time_ms(fn, 20, flush)
                               for form, fn in calls.items()}
                       for shape, calls in shapes}}), flush=True)
    finally:
        _build._libs.clear()
        _build._libs.update(saved)
        pa._fn.clear()
        qa._fns.clear()


if __name__ == "__main__":
    sys.exit(main())
