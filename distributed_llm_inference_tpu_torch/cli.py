"""The port's command line (counterpart of the JAX package's ``cli.py``:
its ``info``, ``local`` and ``api`` subcommands, with the same flags and
output, plus ``--device``)::

    python -m distributed_llm_inference_tpu_torch info --model /ckpt/llama
    python -m distributed_llm_inference_tpu_torch local --model /ckpt/llama \\
        --prompt-ids 1,2,3 --max-new 32
    python -m distributed_llm_inference_tpu_torch api --model /ckpt/llama \\
        --port 8000

* ``info``   inspect a checkpoint (config, layer count, entry file).
* ``local``  load a checkpoint into the continuous-batching engine and
             generate for one prompt; prints one JSON line.
* ``api``    the OpenAI-compatible HTTP gateway (``/v1/completions``,
             JSON and SSE; ``/metrics``, ``/healthz``) over the engine;
             prints ``{"event": "api_up", "port": …}`` once bound, drains
             on SIGTERM.

``--model`` is a local HF snapshot directory. ``--device`` defaults to
``cuda`` and the run fails when there is no card (``--device cpu`` runs on
the CPU). The JAX package's other subcommands (relay, serve, generate,
prefill, chaos, fleet, trace, check) wait with their features (ROADMAP.md
queue 1, items 13-17); the flags of features the port does not have yet
exit non-zero naming their queue item. The port's ``api`` runs without
request tracing (``--no-trace`` is accepted).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

# Flags of features that wait (argparse dest -> flag, ROADMAP.md queue 1
# item). Each defaults to None (or False), so "given" is "not None/False".
_WAITING_FLAGS = {
    "speculative_draft": ("--speculative-draft (speculative decoding)",
                          "item 9"),
    "profile_dir": ("--profile-dir (device and host traces)", "item 17"),
    "relay": ("--relay (the distributed tier)", "item 13"),
    "client_batch": ("--client-batch (the distributed tier)", "item 13"),
    "client_batch_window": ("--client-batch-window (the distributed tier)",
                            "item 13"),
    "disagg": ("--disagg (disaggregated prefill/decode)", "item 14"),
    "transfer_timeout": ("--transfer-timeout (disaggregation)", "item 14"),
    "kv_frame_bytes": ("--kv-frame-bytes (disaggregation)", "item 14"),
    "sched": ("--sched (the admission scheduler)", "item 15"),
    "sched_rate": ("--sched-rate (the admission scheduler)", "item 15"),
    "sched_burst": ("--sched-burst (the admission scheduler)", "item 15"),
    "sched_weight": ("--sched-weight (the admission scheduler)", "item 15"),
    "sched_batch_share": ("--sched-batch-share (the admission scheduler)",
                          "item 15"),
    "sched_shed_headroom": ("--sched-shed-headroom (the admission "
                            "scheduler)", "item 15"),
    "sched_max_lane_depth": ("--sched-max-lane-depth (the admission "
                             "scheduler)", "item 15"),
    "trace_sample_rate": ("--trace-sample-rate (request tracing)", "item 16"),
}


def _refuse_waiting(args) -> None:
    for dest, (flag, item) in _WAITING_FLAGS.items():
        if getattr(args, dest, None) not in (None, False):
            raise SystemExit(
                f"{flag} is not ported yet (ROADMAP.md queue 1, {item})"
            )


def _check_model(args) -> None:
    if args.model.startswith(("http://", "https://")):
        raise SystemExit(
            f"--model {args.model!r}: fetching a checkpoint over HTTP (the "
            "JAX package's utils/hub.py) is left out of the port; download "
            "it and pass the local directory"
        )


def _parse_ids(spec: str) -> List[int]:
    return [int(t) for t in spec.replace(" ", "").split(",") if t]


def _resolve_prompt(args) -> Tuple[List[int], Optional[object]]:
    """``(prompt_ids, tokenizer)`` from ``--prompt-ids`` or ``--prompt``
    (the latter tokenizes with the checkpoint's tokenizer via transformers,
    imported here only, and enables text detokenization of the output).
    Call BEFORE loading weights so argument errors are instant."""
    if getattr(args, "prompt", None) is not None:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(args.model)
        except Exception as e:  # noqa: BLE001 - any failure: one message
            raise SystemExit(
                f"--prompt needs a loadable tokenizer in {args.model!r}: {e}"
            )
        return tok(args.prompt)["input_ids"], tok
    if getattr(args, "prompt_ids", None) is None:
        raise SystemExit("one of --prompt / --prompt-ids is required")
    return _parse_ids(args.prompt_ids), None


def _torch_dtype(name: str):
    import torch

    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise SystemExit(f"--dtype {name!r}: not a torch dtype")
    return dtype


def cmd_local(args) -> int:
    from .config import CacheConfig, EngineConfig
    from .engine.engine import InferenceEngine
    from .engine.sampling import SamplingOptions
    from .utils import checkpoint

    _refuse_waiting(args)
    _check_model(args)
    prompt, tok = _resolve_prompt(args)
    cfg = checkpoint.load_config(args.model)
    params = checkpoint.load_model_params(
        args.model, cfg, _torch_dtype(args.dtype),
        cache_dir=args.weights_cache, device=args.device,
    )
    t0 = time.monotonic()
    engine = InferenceEngine(
        cfg, params,
        EngineConfig(
            max_batch_size=args.max_sessions, max_seq_len=args.max_seq_len,
            max_new_tokens=args.max_new, dtype=args.dtype,
            quantization=args.quantize or ("int8" if args.int8 else None),
            decode_steps=args.decode_steps,
        ),
        CacheConfig(kind=args.cache, kv_quant=args.kv_quant),
        device=args.device,
    )
    out = engine.generate(
        [prompt],
        SamplingOptions(
            temperature=args.temperature, max_new_tokens=args.max_new,
            eos_token_id=args.eos if args.eos is not None else -1,
        ),
    )[0]
    doc = {
        "event": "generated", "prompt": prompt, "tokens": out,
        "seconds": round(time.monotonic() - t0, 3),
        "metrics": engine.metrics.snapshot(),
    }
    if tok is not None:
        doc["text"] = tok.decode(out)
    print(json.dumps(doc), flush=True)
    return 0


def cmd_api(args) -> int:
    from .config import CacheConfig, EngineConfig, ServingConfig
    from .engine.engine import InferenceEngine
    from .serving import ApiServer, EngineBackend
    from .utils import checkpoint

    _refuse_waiting(args)
    _check_model(args)
    tokenizer = None
    if args.tokenizer:
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
        except Exception as e:  # noqa: BLE001 - any failure: one message
            raise SystemExit(
                f"--tokenizer {args.tokenizer!r} failed to load: {e}"
            )
    cfg = checkpoint.load_config(args.model)
    scfg = ServingConfig(
        host=args.host, port=args.port,
        max_queue_depth=args.max_queue_depth,
        default_timeout_s=args.timeout,
        drain_timeout_s=args.drain_timeout,
        model_name=args.model,
        breaker_failure_threshold=args.breaker_failures,
        breaker_recovery_s=args.breaker_recovery,
        breaker_probe_interval_s=args.breaker_probe_interval,
    )
    params = checkpoint.load_model_params(
        args.model, cfg, _torch_dtype(args.dtype),
        cache_dir=args.weights_cache, device=args.device,
    )
    engine = InferenceEngine(
        cfg, params,
        EngineConfig(
            max_batch_size=args.max_sessions,
            max_seq_len=args.max_seq_len, dtype=args.dtype,
            quantization=args.quantize,
        ),
        CacheConfig(kind=args.cache, kv_quant=args.kv_quant),
        device=args.device,
    )
    backend = EngineBackend(engine, idle_sleep_s=scfg.idle_sleep_s)
    server = ApiServer(backend, scfg, tokenizer=tokenizer)
    server.serve_forever(ready_cb=lambda port: print(
        json.dumps({"event": "api_up", "port": port}), flush=True
    ))
    if backend.error is not None:
        print(f"api: the engine driver died: {backend.error!r}",
              file=sys.stderr)
        return 1
    return 0


def cmd_info(args) -> int:
    from .models import registry
    from .utils import checkpoint

    _check_model(args)
    cfg = checkpoint.load_config(args.model, validate=False)
    try:
        registry.validate_config(cfg)
        supported = True
    except (KeyError, ValueError):
        supported = False
    entry = checkpoint.find_index(checkpoint._default_resolve(args.model))
    print(json.dumps({
        "model": args.model, "entry": entry, "family": cfg.family,
        "num_layers": cfg.num_layers, "hidden_size": cfg.hidden_size,
        "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
        "vocab_size": cfg.vocab_size, "num_experts": cfg.num_experts,
        "sliding_window": cfg.sliding_window, "supported": supported,
    }, indent=2))
    return 0


def _engine_flags(p: argparse.ArgumentParser) -> None:
    """Flags ``local`` and ``api`` share: the model, the engine, the cache
    and the device."""
    p.add_argument("--model", required=True,
                   help="local HF snapshot directory (safetensors or .bin)")
    p.add_argument("--cache", default="paged",
                   choices=("paged", "dense", "sink"))
    p.add_argument("--kv-quant", default=None, choices=("int8",),
                   help="int8 KV cache (paged/dense/sink): halves KV bytes")
    p.add_argument("--quantize", default=None,
                   choices=("int8", "int4", "int8_outlier"),
                   help="weight quantization (int8_outlier: not ported yet, "
                        "ROADMAP.md queue 1, item 6)")
    p.add_argument("--max-sessions", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--weights-cache", default=None,
                   help="directory for pre-converted weight caching")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine and its weights "
                        "(default cuda; fails when there is no card)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llm_inference_tpu_torch",
        description="PyTorch/CUDA port of the distributed LLM inference "
                    "launcher (info, local, api)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    l = sub.add_parser("local", help="single-host engine generate")
    _engine_flags(l)
    lp = l.add_mutually_exclusive_group(required=True)
    lp.add_argument("--prompt-ids", default=None)
    lp.add_argument("--prompt", default=None,
                    help="text prompt (tokenized with the model's tokenizer; "
                         "needs transformers)")
    l.add_argument("--max-new", type=int, default=16)
    l.add_argument("--eos", type=int, default=None)
    l.add_argument("--temperature", type=float, default=0.0)
    l.add_argument("--int8", action="store_true")
    l.add_argument("--decode-steps", type=int, default=None,
                   help="fused decode steps per dispatch (tokens stream "
                        "every K steps). Default: auto — 16 where the fused "
                        "tail path composes, else 1")
    l.add_argument("--speculative-draft", default=None,
                   help="not ported yet (ROADMAP.md queue 1, item 9)")
    l.add_argument("--speculative-k", type=int, default=4)
    l.add_argument("--profile-dir", default=None,
                   help="not ported yet (ROADMAP.md queue 1, item 17)")
    l.set_defaults(fn=cmd_local)

    a = sub.add_parser(
        "api",
        help="HTTP gateway: OpenAI-compatible /v1/completions (+SSE), "
             "/metrics, /healthz",
    )
    _engine_flags(a)
    a.add_argument("--host", default="0.0.0.0")
    a.add_argument("--port", type=int, default=8000,
                   help="0 = ephemeral (bound port printed in api_up)")
    a.add_argument("--tokenizer", default=None,
                   help="tokenizer checkpoint dir: enables string prompts "
                        "and decoded text in responses (needs transformers)")
    a.add_argument("--max-queue-depth", type=int, default=64,
                   help="gateway-in-flight bound; beyond it requests get "
                        "429 + Retry-After")
    a.add_argument("--timeout", type=float, default=120.0,
                   help="default per-request deadline seconds (body "
                        "timeout_s overrides)")
    a.add_argument("--drain-timeout", type=float, default=30.0,
                   help="SIGTERM drain budget before in-flight requests "
                        "are cancelled")
    a.add_argument("--breaker-failures", type=int, default=5,
                   help="consecutive backend failures that open the "
                        "circuit breaker (503 + Retry-After while open)")
    a.add_argument("--breaker-recovery", type=float, default=5.0,
                   help="seconds the breaker stays open before admitting "
                        "half-open trial traffic")
    a.add_argument("--breaker-probe-interval", type=float, default=1.0,
                   help="backend health-probe period seconds (0 disables)")
    a.add_argument("--no-trace", action="store_true",
                   help="accepted: the port's gateway runs without request "
                        "tracing (ROADMAP.md queue 1, item 16)")
    waiting = a.add_argument_group(
        "not ported yet", "each exits non-zero naming its ROADMAP.md item")
    waiting.add_argument("--relay", default=None)
    waiting.add_argument("--client-batch", type=int, default=None)
    waiting.add_argument("--client-batch-window", type=float, default=None)
    waiting.add_argument("--disagg", action="store_true")
    waiting.add_argument("--transfer-timeout", type=float, default=None)
    waiting.add_argument("--kv-frame-bytes", type=int, default=None)
    waiting.add_argument("--sched", action="store_true")
    waiting.add_argument("--sched-rate", type=float, default=None)
    waiting.add_argument("--sched-burst", type=float, default=None)
    waiting.add_argument("--sched-weight", action="append", default=None,
                         metavar="TENANT=W")
    waiting.add_argument("--sched-batch-share", type=float, default=None)
    waiting.add_argument("--sched-shed-headroom", type=float, default=None)
    waiting.add_argument("--sched-max-lane-depth", type=int, default=None)
    waiting.add_argument("--trace-sample-rate", type=float, default=None)
    a.set_defaults(fn=cmd_api)

    i = sub.add_parser("info", help="inspect a checkpoint")
    i.add_argument("--model", required=True)
    i.set_defaults(fn=cmd_info)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:
        # A feature the port does not have yet (its message names the
        # ROADMAP.md queue item): one line, not a traceback.
        print(f"{args.cmd}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
