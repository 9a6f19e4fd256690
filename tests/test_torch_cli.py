"""Port parity, the command line: ``info`` and ``local`` print the same JSON
fields and tokens as the JAX package's ``cli.main`` on the same checkpoint;
``python -m distributed_llm_inference_tpu_torch api`` answers a request
and exits 0 on SIGTERM; every flag of a feature that waits exits non-zero
naming its ROADMAP.md queue item."""

import http.client
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import cli as jcli
from distributed_llm_inference_tpu.config import ModelConfig
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu.utils.checkpoint import save_safetensors
from distributed_llm_inference_tpu_torch import cli

torch.set_num_threads(1)
CFG = ModelConfig(
    vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=128,
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """Tiny single-shard HF-format checkpoint from the JAX package's random
    init, written by its writer (``tests/test_cli.py``'s)."""
    d = tmp_path_factory.mktemp("ckpt")
    params = jllama.init_params(CFG, jax.random.PRNGKey(0), jnp.float32)
    lp, state = params["layers"], {}
    for i in range(CFG.num_layers):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = np.asarray(lp["attn_norm"][i])
        state[p + "self_attn.q_proj.weight"] = np.asarray(lp["wq"][i]).T
        state[p + "self_attn.k_proj.weight"] = np.asarray(lp["wk"][i]).T
        state[p + "self_attn.v_proj.weight"] = np.asarray(lp["wv"][i]).T
        state[p + "self_attn.o_proj.weight"] = np.asarray(lp["wo"][i]).T
        state[p + "post_attention_layernorm.weight"] = np.asarray(lp["mlp_norm"][i])
        state[p + "mlp.gate_proj.weight"] = np.asarray(lp["wg"][i]).T
        state[p + "mlp.up_proj.weight"] = np.asarray(lp["wu"][i]).T
        state[p + "mlp.down_proj.weight"] = np.asarray(lp["wd"][i]).T
    state["model.embed_tokens.weight"] = np.asarray(params["embed"])
    state["model.norm.weight"] = np.asarray(params["final_norm"])
    state["lm_head.weight"] = np.asarray(params["lm_head"]).T
    save_safetensors(state, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "model_type": "llama", "vocab_size": CFG.vocab_size,
            "hidden_size": CFG.hidden_size,
            "intermediate_size": CFG.intermediate_size,
            "num_hidden_layers": CFG.num_layers,
            "num_attention_heads": CFG.num_heads,
            "num_key_value_heads": CFG.num_kv_heads,
            "head_dim": CFG.head_dim,
        }, f)
    return str(d)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_info_equals_the_jax_cli(model_dir, capsys):
    argv = ["info", "--model", model_dir]
    got, want = _run(cli.main, argv, capsys), _run(jcli.main, argv, capsys)
    assert got == want
    assert got["supported"] and got["num_layers"] == CFG.num_layers


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_local_equals_the_jax_cli(model_dir, capsys, cache):
    argv = ["local", "--model", model_dir, "--prompt-ids", "5,11,42",
            "--max-new", "6", "--dtype", "float32", "--cache", cache,
            "--max-seq-len", "64"]
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    want = _run(jcli.main, argv, capsys)
    assert set(got) == set(want) == {"event", "prompt", "tokens", "seconds",
                                     "metrics"}
    assert got["event"] == want["event"] and got["prompt"] == want["prompt"]
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 6
    assert got["metrics"]["decode_tokens"] >= 5


def test_api_subprocess_answers_and_drains_on_sigterm(model_dir):
    env = {**os.environ,
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch", "api",
         "--model", model_dir, "--device", "cpu", "--dtype", "float32",
         "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "64",
         "--no-trace"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO,
    )
    try:
        up = json.loads(proc.stdout.readline())
        assert up["event"] == "api_up"
        conn = http.client.HTTPConnection("127.0.0.1", up["port"], timeout=60)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [5, 11, 42], "max_tokens": 6}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        doc = json.loads(resp.read())
        conn.close()
        assert len(doc["choices"][0]["token_ids"]) == 6
        assert doc["model"] == model_dir
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.parametrize("extra,item", [
    (["local", "--profile-dir", "p"], "item 17"),
    (["api", "--relay", ":1"], "item 13"),
    (["api", "--client-batch", "4"], "item 13"),
    (["api", "--client-batch-window", "0.1"], "item 13"),
    (["api", "--disagg"], "item 14"),
    (["api", "--transfer-timeout", "3"], "item 14"),
    (["api", "--kv-frame-bytes", "64"], "item 14"),
    (["api", "--sched"], "item 15"),
    (["api", "--sched-rate", "10"], "item 15"),
    (["api", "--sched-burst", "10"], "item 15"),
    (["api", "--sched-weight", "a=2"], "item 15"),
    (["api", "--sched-batch-share", "0.5"], "item 15"),
    (["api", "--sched-shed-headroom", "1"], "item 15"),
    (["api", "--sched-max-lane-depth", "8"], "item 15"),
    (["api", "--trace-sample-rate", "0.5"], "item 16"),
])
def test_waiting_flags_exit_with_their_queue_item(model_dir, extra, item):
    argv = [extra[0], "--model", model_dir, "--device", "cpu", *extra[1:]]
    if extra[0] == "local":
        argv += ["--prompt-ids", "1,2"]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert f"ROADMAP.md queue 1, {item}" in str(e.value.code)


def test_waiting_engine_options_and_http_models_exit_non_zero(model_dir, capsys):
    # int8 weights with outlier channels are served now: the same tokens as
    # the JAX cli's.
    argv = ["local", "--model", model_dir, "--prompt-ids", "5,11,42",
            "--max-new", "6", "--dtype", "float32", "--max-seq-len", "64",
            "--quantize", "int8_outlier"]
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    want = _run(jcli.main, argv, capsys)
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 6
    with pytest.raises(SystemExit) as e:
        cli.main(["info", "--model", "https://example.invalid/llama"])
    assert "HTTP" in str(e.value.code)


def test_local_without_a_device_fails_on_a_host_without_a_gpu(model_dir):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["local", "--model", model_dir, "--prompt-ids", "1,2"])


MOE_CFG = ModelConfig(
    vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=128,
    num_experts=4, num_experts_per_tok=2, family="mixtral",
)


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    """A tiny Mixtral checkpoint in the HF layout (``block_sparse_moe``
    keys) from the JAX package's random init, the experts scaled up so
    that routing moves the logits."""
    d = tmp_path_factory.mktemp("mixtral")
    params = jllama.init_params(MOE_CFG, jax.random.PRNGKey(3), jnp.float32)
    lp, state = params["layers"], {}
    hf = {"attn_norm": "input_layernorm.weight",
          "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
          "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
          "mlp_norm": "post_attention_layernorm.weight",
          "router": "block_sparse_moe.gate.weight"}
    for i in range(MOE_CFG.num_layers):
        p = f"model.layers.{i}."
        for name, key in hf.items():
            w = np.asarray(lp[name][i])
            state[p + key] = w.T if w.ndim == 2 else w
        for name, w in (("we_g", "w1"), ("we_u", "w3"), ("we_d", "w2")):
            for e in range(MOE_CFG.num_experts):
                state[p + f"block_sparse_moe.experts.{e}.{w}.weight"] = (
                    np.asarray(lp[name][i, e]).T * 10)
    state["model.embed_tokens.weight"] = np.asarray(params["embed"])
    state["model.norm.weight"] = np.asarray(params["final_norm"])
    state["lm_head.weight"] = np.asarray(params["lm_head"]).T
    save_safetensors(state, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "model_type": "mixtral", "vocab_size": MOE_CFG.vocab_size,
            "hidden_size": MOE_CFG.hidden_size,
            "intermediate_size": MOE_CFG.intermediate_size,
            "num_hidden_layers": MOE_CFG.num_layers,
            "num_attention_heads": MOE_CFG.num_heads,
            "num_key_value_heads": MOE_CFG.num_kv_heads,
            "head_dim": MOE_CFG.head_dim, "num_local_experts": 4,
            "num_experts_per_tok": 2,
        }, f)
    return str(d)


def test_info_on_a_mixtral_checkpoint_equals_the_jax_cli(mixtral_dir, capsys):
    argv = ["info", "--model", mixtral_dir]
    got, want = _run(cli.main, argv, capsys), _run(jcli.main, argv, capsys)
    assert got == want
    assert got["supported"] and got["family"] == "mixtral"
    assert got["num_experts"] == 4


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_local_on_a_mixtral_checkpoint_equals_the_jax_cli(mixtral_dir, capsys,
                                                          quantize):
    argv = ["local", "--model", mixtral_dir, "--prompt-ids", "5,11,42,7",
            "--max-new", "6", "--dtype", "float32", "--max-seq-len", "64"]
    if quantize:
        argv += ["--quantize", quantize, "--kv-quant", "int8"]
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    want = _run(jcli.main, argv, capsys)
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 6
