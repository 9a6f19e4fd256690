"""Server-Sent Events framing for the streaming completions path
(counterpart of the JAX package's ``serving/sse.py``, byte for byte).

The OpenAI streaming wire format: each chunk is one ``data: <json>``
event, the stream ends with the literal ``data: [DONE]`` sentinel. SSE
needs no Content-Length — the gateway closes the connection to delimit
the body (HTTP/1.1 ``Connection: close``).
"""

from __future__ import annotations

import json
from typing import Any, Optional

SSE_DONE = b"data: [DONE]\n\n"


def sse_event(data: Any, seq: Optional[int] = None) -> bytes:
    """One SSE frame: ``data: <compact json>\\n\\n``.

    ``seq`` stamps a dict payload with the token's index in the generated
    sequence, the key a client can use to detect duplicated or lost
    tokens."""
    if seq is not None and isinstance(data, dict):
        data = dict(data, seq=int(seq))
    return b"data: " + json.dumps(data, separators=(",", ":")).encode() + b"\n\n"


def sse_headers(status: str = "200 OK", extra: str = "") -> bytes:
    """``extra`` carries pre-formatted additional header lines (each
    ``Name: value\\r\\n``)."""
    return (
        f"HTTP/1.1 {status}\r\n"
        "Content-Type: text/event-stream\r\n"
        "Cache-Control: no-cache\r\n"
        "Connection: close\r\n"
        f"{extra}\r\n"
    ).encode()
