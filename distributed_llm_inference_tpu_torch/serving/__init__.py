"""HTTP serving gateway (counterpart of the JAX package's ``serving/``).

An OpenAI-compatible ``/v1/completions`` front door — JSON and SSE token
streaming — over a local :class:`~..engine.engine.InferenceEngine`
behind the :class:`Backend` protocol. Stdlib-only: raw
``asyncio.start_server`` HTTP/1.1, one request per connection.

Admission control (bounded in-flight, 429 + ``Retry-After``), per-request
deadlines that cancel the underlying generation, graceful SIGTERM drain,
``/metrics`` (Prometheus text) and ``/healthz`` — see
:class:`~..config.ServingConfig` for the policy knobs. The JAX package's
relay, disaggregated and fleet backends, its admission scheduler and its
request tracing wait (ROADMAP.md queue 1, items 13-16).
"""

from .backends import Backend, EngineBackend, Handle, TokenEvent
from .breaker import CircuitBreaker
from .server import ApiServer

__all__ = [
    "ApiServer",
    "Backend",
    "CircuitBreaker",
    "EngineBackend",
    "Handle",
    "TokenEvent",
]
