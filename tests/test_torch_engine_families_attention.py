"""Port parity, the engine over Mistral's sliding window, Qwen2's q/k/v
biases and Llama's o_proj bias: the JAX ``InferenceEngine`` against the
port's (``device="cpu"``, float32), greedy streams, per-tick events and
finish reasons IDENTICAL (helpers and Mixtral's cases in
``test_torch_engine_families.py``).

* Mistral with a sliding window of 8 under prompts of 16-30 tokens (the
  window's masks live in chunked prefill, in the K-step window and its
  tail) and Qwen2 with random q/k/v biases, on bf16 pages (the decode
  kernel's route, through the port's wrappers) and the dense cache at
  K = 16 and K = 1.
* A Llama config with a random o_proj bias (``bo``), on bf16 pages at
  K = 16 and on the int8 dense cache at K = 1.
* A Llama config of 7 query heads over one kv head (Qwen2.5-7B's
  grouping), on bf16 pages (the kernels' route) at K = 16 and K = 1.
"""

import pytest

import test_torch_engine_families as fam

# (id, family, expected K, engine keywords)
CASES = [
    ("mistral-bf16_pages-k16", "mistral", 16, dict(kernels=True)),
    ("mistral-bf16_pages-k1", "mistral", 1,
     dict(kernels=True, decode_steps=1)),
    ("mistral-dense-k16", "mistral", 16, dict(kind="dense")),
    ("mistral-dense-k1", "mistral", 1, dict(kind="dense", decode_steps=1)),
    ("qwen2-bf16_pages-k16", "qwen2", 16, dict(kernels=True)),
    ("qwen2-bf16_pages-k1", "qwen2", 1, dict(kernels=True, decode_steps=1)),
    ("qwen2-dense-k16", "qwen2", 16, dict(kind="dense")),
    ("qwen2-dense-k1", "qwen2", 1, dict(kind="dense", decode_steps=1)),
    ("llama_bo-bf16_pages-k16", "llama_bo", 16, dict(kernels=True)),
    ("llama_bo-int8_dense-k1", "llama_bo", 1,
     dict(kind="dense", kv_quant="int8", decode_steps=1)),
    ("gqa7-bf16_pages-k16", "gqa7", 16, dict(kernels=True)),
    ("gqa7-bf16_pages-k1", "gqa7", 1, dict(kernels=True, decode_steps=1)),
]


@pytest.mark.parametrize("family,k_want,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_engine_matches_jax(family, k_want, kw):
    fam.check(family, k_want, **kw)
