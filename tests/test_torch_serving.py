"""Port parity, the HTTP gateway: real localhost sockets over the port's
``EngineBackend`` (dense cache, float32, CPU, a tiny model). The first
seven tests of ``tests/test_serving.py`` with their assertions (OpenAI JSON,
SSE streaming, 429 backpressure, deadlines, graceful drain, ``/metrics``
names, 400s and 404), then parity with the JAX gateway on the same weights:
greedy ``/v1/completions`` bodies (``id`` and ``created`` aside) and SSE
token sequences, ``parse_completion_request``'s ``BadRequest`` messages,
``sse_event`` bytes, breaker transitions under one fake clock and
``prometheus()`` text."""

import contextlib
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu import serving as jserving
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.serving import breaker as jbreaker
from distributed_llm_inference_tpu.serving import protocol as jprotocol
from distributed_llm_inference_tpu.serving import sse as jsse
from distributed_llm_inference_tpu.utils import metrics as jmetrics
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.models import llama
from distributed_llm_inference_tpu_torch.serving import (
    ApiServer,
    EngineBackend,
    breaker,
    protocol,
    sse,
)
from distributed_llm_inference_tpu_torch.utils import metrics

pytestmark = pytest.mark.http
torch.set_num_threads(1)

MODEL = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8)
CFG = tcfg.ModelConfig(**MODEL)
JPARAMS = jllama.init_params(jcfg.ModelConfig(**MODEL), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
PARAMS = llama.params_from_numpy(
    CFG, jax.tree_util.tree_map(np.asarray, JPARAMS), torch.float32, "cpu")
ENGINE = dict(max_batch_size=2, prefill_buckets=(8, 16, 32), dtype="float32")


@contextlib.contextmanager
def serving(max_batch=2, max_seq_len=64, jax_engine=False, **scfg_kw):
    ekw = dict(ENGINE, max_batch_size=max_batch, max_seq_len=max_seq_len)
    if jax_engine:
        eng = JaxEngine(jcfg.ModelConfig(**MODEL), JPARAMS,
                        jcfg.EngineConfig(**ekw), jcfg.CacheConfig(kind="dense"))
        backend = jserving.EngineBackend(eng, idle_sleep_s=0.001)
        server = jserving.ApiServer(
            backend, jcfg.ServingConfig(host="127.0.0.1", port=0, **scfg_kw))
    else:
        eng = InferenceEngine(CFG, PARAMS, tcfg.EngineConfig(**ekw),
                              tcfg.CacheConfig(kind="dense"), device="cpu")
        backend = EngineBackend(eng, idle_sleep_s=0.001)
        server = ApiServer(
            backend, tcfg.ServingConfig(host="127.0.0.1", port=0, **scfg_kw))
    server.start()
    try:
        yield server, backend
    finally:
        server.request_shutdown()
        server.join(timeout=60.0)


def _post(port, body, timeout=60.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(
        "POST", "/v1/completions", json.dumps(body),
        {"Content-Type": "application/json"},
    )
    return conn, conn.getresponse()


def _get(port, path, timeout=10.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    return conn, conn.getresponse()


def _sse_events(resp):
    """Parse an EOF-delimited SSE body into data payloads (strings)."""
    out = []
    for raw in resp.read().split(b"\n\n"):
        raw = raw.strip()
        if raw.startswith(b"data: "):
            out.append(raw[len(b"data: "):].decode())
    return out


# ---------------------------------------------------------------------------
# tests/test_serving.py, the first seven, on the port
# ---------------------------------------------------------------------------


def test_completion_roundtrip():
    with serving() as (server, _backend):
        conn, resp = _post(server.port, {"prompt": [1, 2, 3], "max_tokens": 4})
        assert resp.status == 200
        doc = json.loads(resp.read())
        conn.close()
    choice = doc["choices"][0]
    assert len(choice["token_ids"]) == 4
    assert all(0 <= t < CFG.vocab_size for t in choice["token_ids"])
    assert choice["finish_reason"] == "length"
    assert doc["usage"] == {
        "prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7,
    }
    assert doc["object"] == "text_completion"


def test_sse_stream_yields_tokens_and_done():
    with serving() as (server, _backend):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request(
            "POST", "/v1/completions",
            json.dumps({"prompt": [5, 6], "max_tokens": 3, "stream": True}),
            {"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        first = resp.fp.readline()
        assert first.startswith(b"data: ")
        events = [first[len(b"data: "):].strip().decode()] + _sse_events(resp)
        conn.close()
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    token_chunks = [c for c in chunks if c["choices"][0]["token_ids"]]
    assert len(token_chunks) == 3
    assert all(c["choices"][0]["finish_reason"] is None for c in token_chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert [c["seq"] for c in token_chunks] == [0, 1, 2]
    assert chunks[-1]["usage"] == {
        "prompt_tokens": 2, "completion_tokens": 3, "total_tokens": 5,
        "resumed": 0,
    }


def test_queue_full_gets_429_with_retry_after():
    with serving(max_queue_depth=1) as (server, backend):
        backend.pause()  # freeze the driver: request 1 stays in flight
        c1 = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        c1.request(
            "POST", "/v1/completions",
            json.dumps({"prompt": [1], "max_tokens": 1}),
            {"Content-Type": "application/json"},
        )
        deadline = time.monotonic() + 10
        while server._inflight < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert server._inflight == 1
        c2, resp2 = _post(server.port, {"prompt": [2], "max_tokens": 1})
        assert resp2.status == 429
        assert resp2.getheader("Retry-After") is not None
        assert json.loads(resp2.read())["error"]["code"] == "queue_full"
        c2.close()
        assert backend.metrics.get_counter("http_429") == 1
        backend.resume()
        resp1 = c1.getresponse()
        assert resp1.status == 200
        assert len(json.loads(resp1.read())["choices"][0]["token_ids"]) == 1
        c1.close()


def test_expired_deadline_cancels_session():
    with serving(max_seq_len=4096) as (server, backend):
        conn, resp = _post(server.port, {"prompt": [1, 2], "max_tokens": 2})
        assert resp.status == 200
        resp.read()
        conn.close()
        conn, resp = _post(server.port, {
            "prompt": [1, 2], "max_tokens": 2048, "timeout_s": 1.0,
        })
        assert resp.status == 200
        doc = json.loads(resp.read())
        conn.close()
        assert doc["choices"][0]["finish_reason"] == "timeout"
        # Partial progress is returned, not the full ask.
        assert 0 < len(doc["choices"][0]["token_ids"]) < 2048
        deadline = time.monotonic() + 10
        while backend.active_sessions() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert backend.active_sessions() == 0


def test_graceful_drain_completes_inflight_stream():
    with serving() as (server, _backend):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request(
            "POST", "/v1/completions",
            json.dumps({"prompt": [3], "max_tokens": 48, "stream": True}),
            {"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        first = resp.fp.readline()
        assert first.startswith(b"data: ")  # stream is live
        server.request_shutdown()
        deadline = time.monotonic() + 10
        while not server._draining and time.monotonic() < deadline:
            time.sleep(0.005)
        try:
            c2, r2 = _post(server.port, {"prompt": [1], "max_tokens": 1},
                           timeout=5.0)
            assert r2.status == 503
            c2.close()
        except (ConnectionRefusedError, ConnectionResetError, OSError):
            pass
        events = _sse_events(resp)
        conn.close()
        assert events[-1] == "[DONE]"
        token_count = 1 + sum(
            1 for e in events[:-1]
            if json.loads(e)["choices"][0]["token_ids"]
        )
        assert token_count == 48
    server.join(timeout=10.0)
    assert not server._thread.is_alive()


def test_metrics_and_healthz():
    with serving() as (server, _backend):
        conn, resp = _post(server.port, {"prompt": [7, 8], "max_tokens": 2})
        assert resp.status == 200
        resp.read()
        conn.close()
        c, r = _get(server.port, "/healthz")
        assert r.status == 200
        health = json.loads(r.read())
        c.close()
        assert health["status"] == "ok"
        c, r = _get(server.port, "/metrics")
        assert r.status == 200
        assert r.getheader("Content-Type").startswith("text/plain")
        text = r.read().decode()
        c.close()
    assert "dli_ttft_seconds" in text  # summary with quantiles
    assert 'dli_ttft_seconds{quantile="0.5"}' in text
    assert "dli_gateway_tokens_total 2" in text
    assert "dli_sessions_submitted_total 1" in text
    assert "dli_queue_depth" in text
    assert "dli_active_sessions" in text
    assert "dli_http_requests_total 1" in text


def test_bad_requests_get_400():
    with serving() as (server, _backend):
        for body in (
            {"prompt": "text needs a tokenizer"},
            {"prompt": []},
            {"prompt": [1], "max_tokens": 0},
            {"prompt": [1], "n": 2},
        ):
            conn, resp = _post(server.port, body)
            assert resp.status == 400
            assert "error" in json.loads(resp.read())
            conn.close()
        conn, resp = _get(server.port, "/nope")
        assert resp.status == 404
        conn.close()


def test_client_disconnect_mid_stream_cancels_the_generation():
    with serving(max_seq_len=4096) as (server, backend):
        cancelled = []
        real_cancel = backend.cancel

        def cancel(handle):
            cancelled.append(handle.gen_id)
            real_cancel(handle)

        backend.cancel = cancel
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request(
            "POST", "/v1/completions",
            json.dumps({"prompt": [3, 4], "max_tokens": 2000, "stream": True}),
            {"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        assert resp.fp.readline().startswith(b"data: ")
        resp.close()
        conn.close()
        deadline = time.monotonic() + 20
        while (not cancelled or backend.active_sessions()) and (
                time.monotonic() < deadline):
            time.sleep(0.01)
        assert cancelled and backend.active_sessions() == 0
    assert backend.metrics.get_counter("gateway_tokens") < 2000


# ---------------------------------------------------------------------------
# Parity with the JAX gateway
# ---------------------------------------------------------------------------

REQUESTS = [
    {"prompt": [1, 2, 3], "max_tokens": 5},
    {"prompt": [9, 4, 100, 7, 33, 2, 8, 15, 61, 3], "max_tokens": 12},
    {"prompt": [77], "max_tokens": 20, "eos_token_id": 5},
]


def _session(jax_engine):
    """Each request's JSON body (``id``/``created`` dropped) and SSE token
    sequence, then the raw bodies of the routes without an engine."""
    bodies, streams = [], []
    with serving(jax_engine=jax_engine) as (server, _backend):
        for req in REQUESTS:
            conn, resp = _post(server.port, req)
            assert resp.status == 200
            doc = json.loads(resp.read())
            conn.close()
            del doc["id"], doc["created"]
            bodies.append(doc)
            conn, resp = _post(server.port, {**req, "stream": True})
            events = _sse_events(resp)
            conn.close()
            assert events[-1] == "[DONE]"
            chunks = [json.loads(e) for e in events[:-1]]
            for c in chunks:
                del c["id"], c["created"]
            streams.append(chunks)
        routes = []
        for method, path, body in (
            ("GET", "/debug/ticks", None), ("GET", "/debug/trace/abc", None),
            ("GET", "/nope", None), ("GET", "/v1/completions", None),
            ("POST", "/v1/completions", b"{not json"),
            ("POST", "/v1/completions", b'{"prompt": [1], "top_p": 3}'),
        ):
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=10)
            conn.request(method, path, body)
            resp = conn.getresponse()
            routes.append((resp.status, resp.getheader("Content-Type"),
                           resp.read()))
            conn.close()
    return bodies, streams, routes


def test_greedy_bodies_streams_and_routes_equal_the_jax_gateway():
    jax_out, port_out = _session(True), _session(False)
    assert port_out[0] == jax_out[0]
    assert port_out[1] == jax_out[1]
    assert port_out[2] == jax_out[2]
    # The SSE token sequence is the JSON body's.
    for body, chunks in zip(port_out[0], port_out[1]):
        toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
        assert toks == body["choices"][0]["token_ids"]


BAD_BODIES = [
    b"\xff\xfe", b"[1, 2]", b"{bad", b'{"prompt": [1], "n": 2}',
    b'{"prompt": "text"}', b'{"prompt": []}', b'{"prompt": [1, -2]}',
    b'{"prompt": [1, true]}', b'{"prompt": [1], "max_tokens": 0}',
    b'{"prompt": [1], "max_tokens": 4096}', b'{"prompt": [1], "max_tokens": "4"}',
    b'{"prompt": [1], "temperature": 2.5}', b'{"prompt": [1], "top_p": -1}',
    b'{"prompt": [1], "top_k": 1.5e9}', b'{"prompt": [1], "stream": 1}',
    b'{"prompt": [1], "timeout_s": 0}', b'{"prompt": [1], "timeout_s": 1e9}',
    b'{"prompt": [1], "eos_token_id": 1.0}', b'{"prompt": [1], "user": ""}',
    b'{"prompt": [1], "lane": "fast"}',
]


@pytest.mark.parametrize("raw", BAD_BODIES)
def test_bad_request_messages_equal_the_jax_ones(raw):
    def message(parse, cfg_mod, exc):
        with pytest.raises(exc) as info:
            parse(raw, cfg_mod.ServingConfig())
        return str(info.value)

    assert message(protocol.parse_completion_request, tcfg,
                   protocol.BadRequest) == message(
        jprotocol.parse_completion_request, jcfg, jprotocol.BadRequest)


def test_good_request_parses_as_the_jax_one():
    raw = (b'{"prompt": [4, 5], "max_tokens": 9, "temperature": 0.7, '
           b'"top_p": 0.9, "top_k": 5, "stream": true, "timeout_s": 3, '
           b'"eos_token_id": 2, "user": "u", "lane": "batch"}')
    got = protocol.parse_completion_request(raw, tcfg.ServingConfig())
    want = jprotocol.parse_completion_request(raw, jcfg.ServingConfig())
    assert {k: v for k, v in vars(got).items() if k != "options"} == {
        k: v for k, v in vars(want).items() if k != "options"}
    assert vars(got.options) == {
        k: v for k, v in vars(want.options).items() if k in vars(got.options)}


def test_sse_bytes_equal_the_jax_ones():
    for data, seq in (({"a": [1, 2], "b": None}, 3), ({"x": "é"}, None),
                      ([1, 2], 4), ("s", None)):
        assert sse.sse_event(data, seq) == jsse.sse_event(data, seq)
    assert sse.SSE_DONE == jsse.SSE_DONE
    assert sse.sse_headers() == jsse.sse_headers()
    assert sse.sse_headers("503 X", "A: b\r\n") == jsse.sse_headers(
        "503 X", "A: b\r\n")


def test_breaker_transitions_equal_the_jax_ones():
    script = ["fail", "fail", "allow", "fail", "allow", "tick", "allow",
              "allow", "success", "probe_fail", "tick", "probe_ok", "allow",
              "fail", "retry", "tick", "allow", "fail", "allow", "tick",
              "probe_ok", "state"]

    def run(mod, metrics_mod):
        now = [0.0]
        m = metrics_mod.Metrics()
        b = mod.CircuitBreaker(failure_threshold=3, recovery_s=2.0,
                               success_threshold=1, metrics=m,
                               clock=lambda: now[0])
        seen = []
        for op in script:
            if op == "fail":
                b.record_failure()
            elif op == "success":
                b.record_success()
            elif op == "probe_fail":
                b.record_probe(False)
            elif op == "probe_ok":
                b.record_probe(True)
            elif op == "tick":
                now[0] += 2.5
            elif op == "allow":
                seen.append(b.allow())
            elif op == "retry":
                seen.append(b.retry_after())
            seen.append(b.state)
        return seen, m.prometheus()

    assert run(breaker, metrics) == run(jbreaker, jmetrics)


def test_prometheus_text_equals_the_jax_one():
    def run(metrics_mod):
        m = metrics_mod.Metrics()
        for name, inc in (("http_requests", 1), ("gateway_tokens", 7.5),
                          ("http_requests", 2), ("breaker_open_transitions", 1)):
            m.counter(name, inc)
        for name, v in (("ttft", 0.25), ("ttft", 0.125), ("ttft", 3.0),
                        ("decode_step", 1e-4), ("kv_transfer_ms", 12.0)):
            m.observe(name, v)
        m.gauge("breaker_state", 2)
        return m.prometheus(extra_gauges={"queue_depth": 3.0,
                                          "http_inflight": 1.0})

    assert run(metrics) == run(jmetrics)


def test_a_dead_driver_fails_streams_and_the_probe():
    """An exception in engine.step() ends the driver: open and later
    requests end with an error reason, the probe reports the dead driver
    and the breaker opens."""
    with serving(breaker_failure_threshold=2,
                 breaker_probe_interval_s=0.05) as (server, backend):
        backend.pause()
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("injected step failure")

        backend.engine.step = boom
        result = {}

        def request():
            conn, resp = _post(server.port, {"prompt": [1], "max_tokens": 2})
            result["doc"] = json.loads(resp.read())
            conn.close()

        t = threading.Thread(target=request)
        t.start()
        deadline = time.monotonic() + 10
        while server._inflight < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        backend.resume()
        t.join(timeout=30)
        assert not t.is_alive() and calls == [1]
        reason = result["doc"]["choices"][0]["finish_reason"]
        assert reason.startswith("error") and "injected" in reason
        assert isinstance(backend.error, RuntimeError)
        assert not backend.probe()
        deadline = time.monotonic() + 10
        while server.breaker.state != "open" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.breaker.state == "open"
        conn, resp = _post(server.port, {"prompt": [1], "max_tokens": 2})
        assert resp.status == 503
        assert json.loads(resp.read())["error"]["code"] == "breaker_open"
        conn.close()


def test_waiting_features_raise_with_their_queue_item():
    eng = InferenceEngine(CFG, PARAMS, tcfg.EngineConfig(**ENGINE),
                          tcfg.CacheConfig(kind="dense"), device="cpu")
    backend = EngineBackend(eng)
    with pytest.raises(NotImplementedError, match="queue 1, item 15"):
        ApiServer(backend, sched_cfg=object())
    with pytest.raises(NotImplementedError, match="queue 1, item 16"):
        ApiServer(backend, trace_cfg=object())
