"""The gateway's deadline against the engine's reap, decided the same way
whichever comes first.

``serving/server.py`` cancels a request once its deadline and
``_DEADLINE_GRACE_S`` have passed with no event; the engine reaps an
expired session only at a tick boundary (``_admit``). A driver thread held
in ``engine.step()`` past the grace lets the gateway's cancel land first.
The request must still end as a deadline expiry: finish reason
``"deadline"`` in the engine, counted once in ``sessions_deadline_expired``
(the gateway answers ``"timeout"``, its own wait having run out), while a
cancel that comes before the deadline still ends ``"cancelled"``. Here the
driver thread is held deterministically: a wrapped ``step()`` sleeps past the
deadline and the grace once the request is decoding (or, paused, before it
is admitted)."""

import contextlib
import http.client
import json
import threading
import time

import pytest
import torch

from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.engine.engine import InferenceEngine
from distributed_llm_inference_tpu_torch.models import llama
from distributed_llm_inference_tpu_torch.serving import (
    ApiServer, EngineBackend, server as tserver)

pytestmark = pytest.mark.http
torch.set_num_threads(1)

CFG = tcfg.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_layers=1, num_heads=4, num_kv_heads=2, head_dim=8)
PARAMS = llama.init_params(CFG, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
TIMEOUT_S = 0.3
# Past the deadline and the gateway's grace, with room for a slow host.
HOLD_S = TIMEOUT_S + tserver._DEADLINE_GRACE_S + 0.4


@contextlib.contextmanager
def serving():
    """A tiny paged f32 engine on the CPU behind the gateway; every session
    the driver thread retires is recorded with its finish reason."""
    engine = InferenceEngine(
        CFG, PARAMS, tcfg.EngineConfig(max_batch_size=2, max_seq_len=4096,
                                       prefill_buckets=(8,), dtype="float32"),
        tcfg.CacheConfig(page_size=16, num_pages=300), device="cpu")
    retired, collect = {}, engine.collect_finished

    def recording_collect():
        done = collect()
        retired.update({g: s.finish_reason for g, s in done.items()})
        return done

    engine.collect_finished = recording_collect
    backend = EngineBackend(engine, idle_sleep_s=0.001)
    server = ApiServer(backend, tcfg.ServingConfig(host="127.0.0.1", port=0))
    server.start()
    try:
        yield server, backend, engine, retired
    finally:
        server.request_shutdown()
        server.join(timeout=60.0)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    doc = json.loads(resp.read())
    conn.close()
    return resp.status, doc


def _drained(backend, retired, n):
    deadline = time.monotonic() + 30
    while ((backend.active_sessions() or len(retired) < n)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert backend.active_sessions() == 0 and len(retired) == n


def test_deadline_holds_when_the_gateway_cancels_first():
    """A decoding request past its deadline while the driver thread is
    held in a step: the gateway's cancel comes first, the request still
    ends as a deadline expiry (the port's engine used to record it
    "cancelled" and count no expiry)."""
    with serving() as (server, backend, engine, retired):
        step, held = engine.step, threading.Event()

        def holding_step():
            out = step()
            if not held.is_set() and any(
                    g is not None for g in engine.slots):
                held.set()
                time.sleep(HOLD_S)  # held past deadline + grace
            return out

        engine.step = holding_step
        t0 = time.monotonic()
        status, doc = _post(server.port, {
            "prompt": [1, 2, 3], "max_tokens": 2048, "timeout_s": TIMEOUT_S})
        waited = time.monotonic() - t0
        assert status == 200 and held.is_set()
        assert doc["choices"][0]["finish_reason"] == "timeout"
        # The gateway answered from its own timer, before the held step
        # ended: its cancel came first.
        assert waited < HOLD_S
        _drained(backend, retired, 1)
    assert list(retired.values()) == ["deadline"]
    assert engine.metrics.get_counter("sessions_deadline_expired") == 1


def test_queued_request_past_its_deadline_is_an_expiry():
    """The same race for a request still queued: the driver thread paused,
    the gateway cancels after its grace, the reap then finds the cancel."""
    with serving() as (server, backend, engine, retired):
        backend.pause()
        result = {}

        def client():
            result["r"] = _post(server.port, {
                "prompt": [4, 5], "max_tokens": 64, "timeout_s": TIMEOUT_S})

        t = threading.Thread(target=client)
        t.start()
        t.join(timeout=60)
        status, doc = result["r"]
        assert status == 200
        assert doc["choices"][0]["finish_reason"] == "timeout"
        assert doc["choices"][0]["token_ids"] == []
        backend.resume()
        _drained(backend, retired, 1)
    assert list(retired.values()) == ["deadline"]
    assert engine.metrics.get_counter("sessions_deadline_expired") == 1


def test_a_cancel_before_the_deadline_stays_a_cancel():
    """An explicit cancel that comes before the deadline ends the session
    "cancelled" and counts no expiry, whenever the reap comes."""
    engine = InferenceEngine(
        CFG, PARAMS, tcfg.EngineConfig(max_batch_size=2, dtype="float32"),
        device="cpu")
    other = engine.submit([4, 5], deadline=time.monotonic() + 60)
    engine.step()  # decoding in a slot
    gid = engine.submit([1, 2, 3], deadline=time.monotonic() + 0.2)
    engine.cancel(gid)  # queued, cancelled before its deadline
    engine.cancel(other)
    time.sleep(0.3)  # gid's deadline passes before the reap
    events = engine.step()
    done = engine.collect_finished()
    assert {done[g].finish_reason for g in (gid, other)} == {"cancelled"}
    assert (gid, -1, True) in events and (other, -1, True) in events
    assert engine.metrics.get_counter("sessions_deadline_expired") == 0
