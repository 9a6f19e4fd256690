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

With ``--int4``, the int4 matmul's bf16 kernel (``csrc/int4_matmul.cu``)
instead: `int4_matmul_stacked` over Llama-3-8B's projection shapes and
`int4_matmul` over the 128256-wide head, at 8 and 1 rows, timed with the
cluster forced to C = 1, 2, 4, 8 and 16 blocks (each block's input rows a
whole number of ring stages) and with the wrapper's ``mma_plan``; then the
ring's depth, the source rebuilt with 2, 3, 4 and 6 stages of 16 KB
(``-DINT4_STAGES``), each shape timed under the plan.

With ``--flush``, the three tail flushes, one kernel template under three
destination policies (``csrc/tail_flush.cuh``): `paged_tail_flush` (#7,
``csrc/paged_attention.cu``), `fused_tail_flush` (#10,
``csrc/quant_attention.cu``) and `sink_tail_flush` (#12,
``csrc/sink_attention.cu``), at `chip_smoke.py`'s timed shapes (one window
of 32 layers, B = 8, KT = 16: #7 every row's window over two pages, #10
at 2040 in a 2400-wide buffer, #12 from slot 1013 of a 1020-slot ring,
across its end): each source rebuilt with each (words a thread, kv heads
a block) of FLUSH_FORMS (``-DFLUSH_WORDS``, ``-DFLUSH_HEADS``; heads 0 is
the launch's own rule), each form's registers (``-Xptxas -v``) reported
and its bytes held EQUAL to the plain version's, each timed twice in
turn, beside the timed call's floor (an empty kernel) before and after.

With ``--sink``, `sink_fused_decode_attention` (#11) at `chip_smoke.py`'s
timed shape (B = 8, window 1024 with 4 sinks, TR = 1024, KT = 16), its
256-wide ring tiles dealt as pieces of each of SINK_PIECES
(``ring_piece_width`` replaced in turn; 64 is the rule), timed in turns
(ABBA, three rounds), each output held to the plain version's.

Usage, from the root of a checkout, on a machine with one GPU:

    python tools/torch_cluster_sweep.py [--int4 | --flush | --sink]

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
INT4_STAGES = (2, 3, 4, 6)
# The flushes' forms: (16-byte words of K and of V a thread, kv heads a
# block).
FLUSH_FORMS = ((2, 0), (1, 1), (2, 1), (4, 1), (4, 2), (4, 4), (8, 8))
# #11's ring pieces: slots of a 256-wide ring tile a piece.
SINK_PIECES = (64, 32)


def build_rings(build, stages=STAGES, sources=RING_SOURCES,
                macro="PDEC_INT8_STAGES"):
    """Each of ``sources`` built once per count of ``stages`` (the macro
    ``macro``), every ``nvcc`` started together. Returns {stages: {source:
    path}}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for n in stages:
        for name in sources:
            out = build.BUILD_DIR / f"lib{name}_{macro.lower()}{n}.so"
            started[n, name] = out, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, f"-D{macro}={n}",
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
    if sys.argv[1:] == ["--int4"]:
        int4_sweep(smoke)
        return 0
    if sys.argv[1:] == ["--flush"]:
        flush_sweep(smoke)
        return 0
    if sys.argv[1:] == ["--sink"]:
        sink_sweep(smoke)
        return 0
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
            assert occ(1, 128, 2, ctypes.addressof(got)) == 0  # D = 128
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


def int4_sweep(smoke):
    """The int4 matmul's bf16 kernel: each shape at 8 and 1 rows under
    clusters of 1 to 16 blocks and the plan's; then under each count of
    ring stages, at the plan's cluster."""
    import torch

    from distributed_llm_inference_tpu_torch.ops import _build
    from distributed_llm_inference_tpu_torch.ops import quant_matmul as qm

    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {n: smoke.PROJECTIONS[n] for n in ("wq", "wk", "wg", "wd")}
    shapes["head"] = smoke.HEAD
    weights = {n: smoke.int4_weight(gen, (1, *shape))
               for n, shape in shapes.items()}
    calls = {}
    for rows in (8, 1):
        for n, w in weights.items():
            x = torch.randn((rows, w.in_dim), generator=gen,
                            device="cuda").to(torch.bfloat16)
            calls[n, rows] = (lambda x=x, w=w: qm.int4_matmul_stacked(
                x, w.q, w.scale_lo, w.scale_hi, 0, w.out_dim))
    rule = qm.mma_plan
    for (n, rows), fn in calls.items():
        w = weights[n]
        stages = -(-w.in_dim // qm.MMA_STAGE_ROWS)
        got = {}
        for c in (1, 2, 4, 8, 16):
            if c > stages:
                continue
            qm.mma_plan = lambda *a, c=c: {
                **rule(*a), "cluster": c,
                "k_block": -(-stages // c) * qm.MMA_STAGE_ROWS}
            try:
                got[c] = smoke.time_ms(fn, 20, flush)
            finally:
                qm.mma_plan = rule
        plan = rule(sms, rows, w.in_dim, w.q.shape[-1])
        print(json.dumps({
            "shape": n, "in": w.in_dim, "out": w.out_dim, "rows": rows,
            "ms_by_cluster": got, "plan": plan,
            "plan_ms": smoke.time_ms(fn, 20, flush)}), flush=True)
    saved = dict(_build._libs)
    try:
        for n, paths in build_rings(_build, INT4_STAGES, ("int4_matmul",),
                                    "INT4_STAGES").items():
            _build._libs["int4_matmul"] = ctypes.CDLL(str(paths["int4_matmul"]))
            qm._fns.clear()
            occ = _build._libs["int4_matmul"].dli_int4_mma_occupancy
            occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            got = (ctypes.c_longlong * 6)()
            plan = rule(sms, 8, 4096, 64512)
            assert occ(8, plan["cluster"], plan["k_block"],
                       ctypes.addressof(got)) == 0
            print(json.dumps({
                "int4_stages": n, "head_rows8_smem_bytes": got[0],
                "head_rows8_blocks_an_sm": got[1],
                "ms_rows8": {shape: smoke.time_ms(calls[shape, 8], 20, flush)
                             for shape in weights}}), flush=True)
    finally:
        _build._libs.clear()
        _build._libs.update(saved)
        qm._fns.clear()


def flush_calls(smoke, rng):
    """{flush: (source, wrapper's module, its cached entry, destination
    planes, the call's other arguments, wrapper, plain version)} at
    `chip_smoke.py`'s timed shapes."""
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant_attention as qa

    b, kt, layers, hkv = 8, smoke.KT, smoke.LLAMA3_8B.num_layers, smoke.HKV
    width = smoke.ladder_pages(2040 + kt)
    pages = b * width + 1
    full = smoke.i32([kt] * b)
    return {
        "#7": ("paged_attention", pa._fn, "flush",
               smoke.make_qplanes(rng, (layers, pages, hkv), smoke.PS),
               (*smoke.make_qplanes(rng, (layers, b, hkv), kt),
                smoke.make_table(rng, b, width, pages),
                smoke.i32([2040] * b), full),
               pa.paged_tail_flush, pa.paged_tail_flush_plain),
        "#10": ("quant_attention", qa._fns, "flush",
                smoke.make_qplanes(rng, (layers, b, hkv), 2400),
                (*smoke.make_qplanes(rng, (layers, b, hkv), kt),
                 smoke.i32([2040] * b), full),
                qa.fused_tail_flush, qa.fused_tail_flush_plain),
        "#12": ("sink_attention", qa._fns, "sink_flush",
                smoke.make_qplanes(rng, (layers, b, hkv), 1024),
                (*smoke.make_qplanes(rng, (layers, b, hkv), kt),
                 smoke.i32([1013] * b), smoke.i32([0] * b), full, 1020),
                qa.sink_tail_flush, qa.sink_tail_flush_plain),
    }


def flush_sweep(smoke):
    """#7, #10 and #12 under each of FLUSH_FORMS, the rebuilt libraries
    swapped into the wrappers' caches in turn: their bytes against the
    plain versions', then two rounds of timings, the floor before and
    after."""
    import numpy as np
    import torch

    from distributed_llm_inference_tpu_torch.ops import _build

    rng = np.random.default_rng(99)
    calls = flush_calls(smoke, rng)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for source in {c[0] for c in calls.values()}:
        for words, heads in FLUSH_FORMS:
            out = _build.BUILD_DIR / f"lib{source}_flush{words}x{heads}.so"
            started[source, (words, heads)] = out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 f"-DFLUSH_WORDS={words}", f"-DFLUSH_HEADS={heads}",
                 "-o", str(out), str(_build.CSRC / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, registers = {}, {}
    for key, (out, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the flush form {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(out))
        # `-Xptxas -v`: the kernel's registers and spills a thread.
        registers[key], entry = [], ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "tail_flush_kernel" in entry and (
                    "Used" in line or "spill" in line):
                registers[key].append(line.split("info    :")[-1].strip())
    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device="cuda")
    saved = dict(_build._libs)

    def use(name, form):
        source, cache, entry = calls[name][:3]
        _build._libs[source] = libs[source, form]
        cache.pop(entry, None)

    got = {}
    try:
        for name, (source, _, _, dst, args, fn, plain) in calls.items():
            want = [p.clone() for p in dst]
            plain(*want, *args)
            for form in FLUSH_FORMS:
                use(name, form)
                mine = [p.clone() for p in dst]
                fn(*mine, *args)
                torch.cuda.synchronize()
                got[name, form] = {"max_abs_err": max(
                    smoke.max_err(a, w) for a, w in zip(mine, want)),
                    "ptxas": registers[source, form], "ms": []}
                assert got[name, form]["max_abs_err"] == 0.0, (
                    name, form, got[name, form])
        floor = [smoke.timed_call_floor_ms(flush)]
        for _ in range(2):
            for name, (_, _, _, dst, args, fn, _) in calls.items():
                for form in FLUSH_FORMS:
                    use(name, form)
                    got[name, form]["ms"].append(smoke.time_ms(
                        lambda: fn(*dst, *args), 50, flush))
        floor.append(smoke.timed_call_floor_ms(flush))
    finally:
        _build._libs.clear()
        _build._libs.update(saved)
        for source, cache, entry, *_ in calls.values():
            cache.pop(entry, None)
    for (name, (words, heads)), g in got.items():
        print(json.dumps({"flush": name, "words_a_thread": words,
                          "heads_a_block": heads or "rule", **g}), flush=True)
    print(json.dumps({"timed_call_floor_ms": floor}), flush=True)


def sink_sweep(smoke):
    """#11 with its ring pieces forced to each of SINK_PIECES, in turns;
    `time_sink` checks each output against the plain version's."""
    import numpy as np
    import torch

    from distributed_llm_inference_tpu_torch.ops import quant_attention as qa

    rule = qa.ring_piece_width
    flush = torch.ones(16 * 1024 * 1024, dtype=torch.int64, device="cuda")
    got = {pw: [] for pw in SINK_PIECES}
    try:
        for _ in range(3):
            for pw in (*SINK_PIECES, *SINK_PIECES[::-1]):
                qa.ring_piece_width = lambda tile, pw=pw: pw
                out, cases = {}, []
                smoke.time_sink(out, cases, np.random.default_rng(99), flush)
                smoke.assert_cases(cases, torch.bfloat16)
                got[pw].append(out["sink_fused_decode_attention"]["ms"])
    finally:
        qa.ring_piece_width = rule
    for pw, ms in got.items():
        print(json.dumps({"ring_piece": pw, "rule": pw == rule(256),
                          "ms": ms}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
