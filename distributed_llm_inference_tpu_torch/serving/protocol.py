"""OpenAI ``/v1/completions`` request/response schemas (stdlib-only;
counterpart of the JAX package's ``serving/protocol.py``, message for
message).

Prompts are accepted natively as token-id arrays (the repo has no bundled
tokenizer weights; the engine speaks token ids) and as strings when the
server was built with a tokenizer. Responses carry the decoded ``text``
when a tokenizer is present plus a ``token_ids`` extension field either
way, so tokenizer-less deployments still stream usable output.

Gateway extensions beyond the OpenAI schema: ``timeout_s`` (per-request
deadline override, capped by ``ServingConfig.max_timeout_s``),
``top_k``, and ``lane`` (``"interactive"`` | ``"batch"``: the admission
scheduler's priority lane). The OpenAI ``user`` field and ``lane`` are
parsed and checked as the JAX gateway does; the port has no admission
scheduler yet (ROADMAP.md queue 1, item 15), so nothing reads them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from ..config import ServingConfig
from ..engine.sampling import SamplingOptions


class BadRequest(ValueError):
    """Maps to HTTP 400 with an OpenAI-style error body."""


@dataclasses.dataclass
class CompletionRequest:
    prompt: List[int]
    max_tokens: int
    stream: bool
    timeout_s: Optional[float]
    options: SamplingOptions
    echo_text: Optional[str]  # original string prompt, if one was sent
    # Tenant identity fallback (OpenAI "user" field) and admission lane
    # for the scheduler; None when the request names neither.
    user: Optional[str] = None
    lane: Optional[str] = None


def _require_number(body: Dict[str, Any], key: str, default, lo, hi):
    v = body.get(key, default)
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        raise BadRequest(f"{key!r} must be a number")
    if not (lo <= v <= hi):
        raise BadRequest(f"{key!r} must be in [{lo}, {hi}]")
    return v


def parse_completion_request(
    raw: bytes, scfg: ServingConfig, tokenizer=None
) -> CompletionRequest:
    try:
        body = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BadRequest(f"invalid JSON body: {e}")
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    if body.get("n", 1) != 1:
        raise BadRequest("only n=1 is supported")

    prompt = body.get("prompt")
    echo_text = None
    if isinstance(prompt, str):
        if tokenizer is None:
            raise BadRequest(
                "string prompts need a tokenizer (start the server with "
                "--tokenizer); send a token-id array instead"
            )
        echo_text = prompt
        prompt = list(tokenizer.encode(prompt))
    if (
        not isinstance(prompt, list)
        or not prompt
        or not all(isinstance(t, int) and not isinstance(t, bool) and t >= 0
                   for t in prompt)
    ):
        raise BadRequest(
            "'prompt' must be a non-empty array of token ids (or a string "
            "when the server has a tokenizer)"
        )

    max_tokens = int(_require_number(
        body, "max_tokens", 16, 1, scfg.max_tokens_cap
    ))
    temperature = float(_require_number(body, "temperature", 0.0, 0.0, 2.0))
    top_p = float(_require_number(body, "top_p", 1.0, 0.0, 1.0))
    top_k = int(_require_number(body, "top_k", 0, 0, 1 << 20))
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise BadRequest("'stream' must be a boolean")
    timeout_s = body.get("timeout_s")
    if timeout_s is not None:
        timeout_s = float(_require_number(
            body, "timeout_s", None, 0.001, scfg.max_timeout_s
        ))
    eos = body.get("eos_token_id", -1)
    if not isinstance(eos, int) or isinstance(eos, bool):
        raise BadRequest("'eos_token_id' must be an integer")
    user = body.get("user")
    if user is not None and (
        not isinstance(user, str) or not user or len(user) > 256
    ):
        raise BadRequest("'user' must be a non-empty string (<= 256 chars)")
    lane = body.get("lane")
    if lane is not None and lane not in ("interactive", "batch"):
        raise BadRequest("'lane' must be 'interactive' or 'batch'")

    opts = SamplingOptions(
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        max_new_tokens=max_tokens,
        eos_token_id=eos,
    )
    return CompletionRequest(
        prompt=prompt,
        max_tokens=max_tokens,
        stream=stream,
        timeout_s=timeout_s,
        options=opts,
        echo_text=echo_text,
        user=user,
        lane=lane,
    )


# finish_reason on the wire follows OpenAI: "stop" | "length" | extensions.
_FINISH_WIRE = {
    "eos": "stop",
    "length": "length",
    "capacity": "length",
    "cancelled": "cancelled",
    "deadline": "timeout",
    "timeout": "timeout",
}


def wire_finish_reason(reason: Optional[str]) -> str:
    return _FINISH_WIRE.get(reason or "stop", reason or "stop")


def _decode(tokens: List[int], tokenizer) -> str:
    if tokenizer is None or not tokens:
        return ""
    return tokenizer.decode(tokens)


def completion_response(
    req_id: str,
    created: int,
    model: str,
    tokens: List[int],
    finish_reason: str,
    prompt_len: int,
    tokenizer=None,
) -> Dict[str, Any]:
    # The JAX gateway adds "resumed" to usage for streams re-homed onto
    # another decode node; the port's streams never move.
    usage = {
        "prompt_tokens": prompt_len,
        "completion_tokens": len(tokens),
        "total_tokens": prompt_len + len(tokens),
    }
    return {
        "id": req_id,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [{
            "index": 0,
            "text": _decode(tokens, tokenizer),
            "token_ids": tokens,
            "finish_reason": wire_finish_reason(finish_reason),
            "logprobs": None,
        }],
        "usage": usage,
    }


def completion_chunk(
    req_id: str,
    created: int,
    model: str,
    token: Optional[int],
    finish_reason: Optional[str],
    tokenizer=None,
    usage: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One SSE chunk: a single fresh token, or the terminal chunk (no
    token) carrying the finish_reason — and, when provided, the final
    ``usage`` block."""
    chunk = {
        "id": req_id,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [{
            "index": 0,
            "text": _decode([token], tokenizer) if token is not None else "",
            "token_ids": [token] if token is not None else [],
            "finish_reason": (
                wire_finish_reason(finish_reason) if finish_reason else None
            ),
            "logprobs": None,
        }],
    }
    if usage is not None:
        chunk["usage"] = usage
    return chunk


def error_body(message: str, err_type: str, code: Optional[str] = None) -> bytes:
    return json.dumps({
        "error": {"message": message, "type": err_type, "code": code}
    }).encode()
