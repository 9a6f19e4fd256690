"""Port parity against ``transformers``: tiny random Llama, Mistral and
Qwen2 models are built in process (as ``tests/test_llama_parity.py`` and
``tests/test_family_parity.py`` build them), saved with
``save_pretrained`` (safetensors), loaded back by the port's checkpoint
loader, and the port's prefill logits must match HF's
(``atol=2e-4, rtol=2e-3``, the JAX tests' tolerance)."""

import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu_torch.cache.dense import DenseKVCache
from distributed_llm_inference_tpu_torch.models import llama, registry
from distributed_llm_inference_tpu_torch.utils import checkpoint

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

COMMON = dict(
    vocab_size=128,
    hidden_size=64,
    intermediate_size=172,
    num_hidden_layers=3,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=256,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
)


def _build(kind):
    torch.manual_seed(0)
    if kind == "llama":
        cfg = transformers.LlamaConfig(**COMMON, attn_implementation="eager")
        return transformers.LlamaForCausalLM(cfg).eval()
    if kind == "mistral":
        cfg = transformers.MistralConfig(**COMMON, sliding_window=6,
                                         attn_implementation="eager")
        return transformers.MistralForCausalLM(cfg).eval()
    cfg = transformers.Qwen2Config(**COMMON, tie_word_embeddings=True,
                                   attn_implementation="eager")
    return transformers.Qwen2ForCausalLM(cfg).eval()


@pytest.mark.parametrize("kind", ["llama", "mistral", "qwen2"])
def test_prefill_logits_match_hf_from_a_saved_checkpoint(kind, tmp_path):
    model = _build(kind)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = checkpoint.load_config(str(tmp_path))
    assert registry.validate_config(cfg).name == kind
    params = checkpoint.load_model_params(str(tmp_path), cfg, torch.float32,
                                          device="cpu")
    if kind == "qwen2":
        assert cfg.qkv_bias and cfg.tie_word_embeddings
        assert "bq" in params["layers"] and "lm_head" not in params

    # 11 tokens > Mistral's sliding_window=6, so windowing is exercised.
    tokens = np.random.default_rng(0).integers(
        0, COMMON["vocab_size"], size=(2, 11))
    with torch.no_grad():
        expected = model(torch.from_numpy(tokens)).logits
    cache = DenseKVCache.create(cfg.num_layers, 2, 32, cfg.num_kv_heads,
                                cfg.head_dim, torch.float32, device="cpu")
    logits, _ = llama.model_apply(
        cfg, params, torch.from_numpy(tokens).to(torch.int32), cache,
        torch.full((2,), 11, dtype=torch.int32))
    torch.testing.assert_close(logits, expected, atol=2e-4, rtol=2e-3)
