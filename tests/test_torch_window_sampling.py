"""The sampler's draw inside a fused decode window (``sample`` with the
step index folded in, the counterpart of ``jax.random.fold_in(key, i)``
inside the JAX engine's ``_decode_scan``):
greedy rows equal JAX's greedy on shared logits, the draw respects the same
top-k/top-p support as JAX's filter, it is a pure function of (key, step,
row, token), and its frequencies follow the softmax. Its bits cannot equal
JAX's (another generator)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.engine import sampling as jsamp
from distributed_llm_inference_tpu_torch.engine import sampling as tsamp

torch.set_num_threads(1)


def logits(seed=0, b=5, v=97):
    return (np.random.default_rng(seed).standard_normal((b, v)) * 3).astype(
        np.float32)


def key(k):
    return torch.tensor([k], dtype=torch.int64)


def step(i):
    return torch.tensor([i], dtype=torch.int32)


def test_uniforms_are_a_pure_function_in_the_open_interval():
    a = tsamp.uniforms(key(2**61 + 12345), step(3), 4, 1000)
    assert a.dtype == torch.float32 and a.shape == (4, 1000)
    assert float(a.min()) > 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, tsamp.uniforms(key(2**61 + 12345), step(3), 4, 1000))
    for other in (tsamp.uniforms(key(2**61 + 12346), step(3), 4, 1000),
                  tsamp.uniforms(key(2**61 + 12345), step(4), 4, 1000)):
        assert float((a == other).float().mean()) < 0.01
    assert float((a[0] == a[1]).float().mean()) < 0.01  # rows differ
    assert abs(float(a.mean()) - 0.5) < 0.02 and abs(float(a.std()) - 0.2887) < 0.02


def test_greedy_rows_match_jax_and_ignore_the_key():
    x = logits(1)
    sp = tsamp.SamplingParams.stack(
        [tsamp.SamplingOptions(temperature=t) for t in (0.0, 0.8, 0.0, 1.0, 0.0)])
    want = np.asarray(jsamp.sample(
        jnp.asarray(x), None,
        jsamp.SamplingParams.create(5, 0.0)))
    got = tsamp.sample(torch.as_tensor(x), key(7), sp, step(0))
    for r in (0, 2, 4):
        assert int(got[r]) == int(want[r])
    greedy = tsamp.SamplingParams.create(5, 0.0)
    assert greedy.all_greedy
    for k in (1, 2):
        assert np.array_equal(
            tsamp.sample(torch.as_tensor(x), key(k), greedy, step(5)).numpy(),
            want)


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (5, 1.0), (0, 0.3), (7, 0.9)])
def test_draws_stay_in_the_jax_filter_support(top_k, top_p):
    x = logits(2)
    kept = np.asarray(jsamp._filter_top_k_top_p(
        jnp.asarray(x), jnp.full((5,), top_k, jnp.int32),
        jnp.full((5,), top_p, jnp.float32))) > -1e29
    sp = tsamp.SamplingParams.create(5, 1.0, top_k, top_p)
    for i in range(40):
        got = tsamp.sample(torch.as_tensor(x), key(99), sp, step(i))
        assert kept[np.arange(5), got.numpy()].all()


def test_frequencies_follow_the_softmax():
    probs = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    x = torch.as_tensor(np.log(probs))[None].repeat(50, 1)
    sp = tsamp.SamplingParams.create(50, 1.0)
    counts = np.zeros(4)
    for i in range(80):
        got = tsamp.sample(x, key(5), sp, step(i)).numpy()
        counts += np.bincount(got, minlength=4)
    freq = counts / counts.sum()
    # 4000 draws: the standard error of each frequency is below 0.008.
    assert np.abs(freq - probs).max() < 0.03
