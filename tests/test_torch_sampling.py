"""Port parity: sampling. The top-k/top-p filter and greedy selection match
the JAX package on shared logits; stochastic draws cannot (another random
number generator), so they are held to determinism and to their support."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.engine import sampling as jsamp
from distributed_llm_inference_tpu_torch.engine import sampling as tsamp

torch.set_num_threads(1)


def logits(seed=0, b=5, v=97):
    return (np.random.default_rng(seed).standard_normal((b, v)) * 3).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p", [
    ([0, 0, 0, 0, 0], [1.0] * 5),
    ([1, 5, 0, 200, 3], [1.0, 1.0, 0.5, 0.9, 0.3]),
    ([0, 0, 7, 7, 7], [0.001, 0.01, 0.99, 1.0, 0.5]),
])
def test_filter_matches_jax(top_k, top_p):
    x = logits()
    k = np.asarray(top_k, np.int32)
    p = np.asarray(top_p, np.float32)
    got = tsamp._filter_top_k_top_p(
        torch.as_tensor(x), torch.as_tensor(k), torch.as_tensor(p))
    want = jsamp._filter_top_k_top_p(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert np.all((got.numpy() > -1e29).sum(-1) >= 1), "rank 0 always survives"


def test_greedy_matches_jax_and_ignores_the_key():
    x = logits(1)
    tp = tsamp.SamplingParams.create(5)
    jp = jsamp.SamplingParams.create(5)
    assert tp.all_greedy and jp.all_greedy
    got = tsamp.sample(torch.as_tensor(x), None, tp)
    import jax
    want = jsamp.sample(jnp.asarray(x), jax.random.PRNGKey(0), jp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_stack_matches_jax_fields():
    rows = [tsamp.SamplingOptions(), tsamp.SamplingOptions(0.7, 40, 0.9)]
    jrows = [jsamp.SamplingOptions(), jsamp.SamplingOptions(0.7, 40, 0.9)]
    tp, jp = tsamp.SamplingParams.stack(rows), jsamp.SamplingParams.stack(jrows)
    assert tp.all_greedy == jp.all_greedy is False
    for name in ("temperature", "top_k", "top_p"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(tsamp.SamplingOptions)]
            == [(f.name, f.default) for f in dataclasses.fields(jsamp.SamplingOptions)])


def test_seeded_draws_repeat_and_respect_the_filter():
    x = torch.as_tensor(logits(2))
    rows = [tsamp.SamplingOptions(0.0), tsamp.SamplingOptions(0.8, 3, 1.0),
            tsamp.SamplingOptions(1.0, 0, 0.5), tsamp.SamplingOptions(1.5),
            tsamp.SamplingOptions(0.8, 1, 1.0)]
    sp = tsamp.SamplingParams.stack(rows)
    a = tsamp.sample(x, 1234, sp)
    b = tsamp.sample(x, 1234, sp)
    c = tsamp.sample(x, torch.tensor([1234]), sp, torch.tensor([0]))
    assert a.tolist() == b.tolist() == c.tolist()
    draws = torch.stack([tsamp.sample(x, seed, sp) for seed in range(200)])
    assert len(set(draws[:, 3].tolist())) > 10, "a stochastic row varies"
    greedy = x.argmax(-1)
    assert (draws[:, 0] == greedy[0]).all(), "temperature 0 is greedy"
    assert (draws[:, 4] == greedy[4]).all(), "top_k 1 is greedy"
    top3 = set(x[1].topk(3).indices.tolist())
    assert set(draws[:, 1].tolist()) <= top3
    # Nucleus of row 2 at temperature 1.
    probs = torch.softmax(x[2], -1)
    order = probs.argsort(descending=True)
    cum = probs[order].cumsum(0)
    nucleus = set(order[: int((cum - probs[order] < 0.5).sum())].tolist())
    assert set(draws[:, 2].tolist()) <= nucleus
