"""Port parity: the plain tensor ops of the PyTorch package against the JAX
package's functions on the same numpy inputs (f32, CPU). Tolerance 1e-5:
both sides compute in float32 and differ only in the order of summation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.ops import attention as jattn
from distributed_llm_inference_tpu.ops import norms as jnorms
from distributed_llm_inference_tpu.ops import rotary as jrot
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.ops import attention as tattn
from distributed_llm_inference_tpu_torch.ops import norms as tnorms
from distributed_llm_inference_tpu_torch.ops import rotary as trot

torch.set_num_threads(1)
ATOL = 1e-5


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=atol, rtol=0
    )


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    close(tnorms.rms_norm(t(x), t(w), 1e-5),
          jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_neg_inf_constant_is_finite_and_equal():
    assert np.isfinite(tattn._NEG_INF)
    assert tattn._NEG_INF == pytest.approx(jattn._NEG_INF, rel=1e-7)


@pytest.mark.parametrize("scaling", [
    None,
    dict(rope_type="linear", factor=4.0),
    dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
         high_freq_factor=4.0, original_max_position_embeddings=8192),
])
def test_rope_inv_freq(scaling):
    js = jcfg.RopeScaling(**scaling) if scaling else None
    ts = tcfg.RopeScaling(**scaling) if scaling else None
    got = trot.rope_inv_freq(128, 500000.0, ts)
    want = jrot.rope_inv_freq(128, 500000.0, js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_rope_inv_freq_rejects_unknown_type():
    with pytest.raises(ValueError):
        trot.rope_inv_freq(16, 1e4, tcfg.RopeScaling(rope_type="yarn"))


def test_rope_cos_sin_and_apply_rope():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    inv_t = trot.rope_inv_freq(16, 10000.0)
    inv_j = jrot.rope_inv_freq(16, 10000.0)
    cos_t, sin_t = trot.rope_cos_sin(t(pos), inv_t)
    cos_j, sin_j = jrot.rope_cos_sin(jnp.asarray(pos), inv_j)
    # cos/sin of angles up to 500 rad: float32 argument rounding dominates.
    close(cos_t, cos_j, atol=1e-4)
    close(sin_t, sin_j, atol=1e-4)
    # The rotation itself, on shared tables.
    close(trot.apply_rope(t(x), t(cos_j), t(sin_j)),
          jrot.apply_rope(jnp.asarray(x), cos_j, sin_j))
    close(trot.rotate_half(t(x)), jrot.rotate_half(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("with_valid", [False, True])
def test_causal_mask(window, with_valid):
    rng = np.random.default_rng(2)
    qp = rng.integers(0, 12, size=(2, 5)).astype(np.int32)
    kp = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    valid = rng.random((2, 12)) > 0.3 if with_valid else None
    got = tattn.causal_mask(
        t(qp), t(kp), t(valid) if with_valid else None, window)
    want = jattn.causal_mask(
        jnp.asarray(qp), jnp.asarray(kp),
        jnp.asarray(valid) if with_valid else None, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hkv", [2, 4])
@pytest.mark.parametrize("mask_ndim", [None, 3, 4])
def test_gqa_attention(hkv, mask_ndim):
    rng = np.random.default_rng(3)
    b, s, tt, hq, d = 2, 5, 9, 4, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, tt, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tt, hkv, d)).astype(np.float32)
    mask = None
    if mask_ndim is not None:
        mask = rng.random((b, s, tt)) > 0.4
        mask[0, 1] = False  # a fully masked query row gives zeros
        if mask_ndim == 4:
            mask = mask[:, None]
    got = tattn.gqa_attention(t(q), t(k), t(v), None if mask is None else t(mask))
    want = jattn.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask))
    close(got, want)
    if mask is not None:
        assert float(got[0, 1].abs().max()) == 0.0


def test_merge_softmax_segments_matches_jax_and_joint_softmax():
    rng = np.random.default_rng(4)
    b, hq, hkv, d, ta, kt = 3, 4, 2, 16, 11, 4
    g = hq // hkv
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    ka = rng.standard_normal((b, ta, hkv, d)).astype(np.float32)
    va = rng.standard_normal((b, ta, hkv, d)).astype(np.float32)
    kt_ = rng.standard_normal((b, kt, hkv, d)).astype(np.float32)
    vt_ = rng.standard_normal((b, kt, hkv, d)).astype(np.float32)
    a_valid = np.arange(ta)[None, :] < np.array([11, 5, 0])[:, None]
    t_valid = np.arange(kt)[None, :] < np.array([2, 4, 1])[:, None]
    # Segment A's normalized output and stats, by hand.
    sc = np.einsum("bskgd,btkd->bkgst", q.reshape(b, 1, hkv, g, d), ka)[..., 0, :]
    sc = sc * d**-0.5
    sc = np.where(a_valid[:, None, None, :], sc, tattn._NEG_INF)
    m_a = sc.max(-1)
    w = np.where(a_valid[:, None, None, :], np.exp(sc - m_a[..., None]), 0.0)
    l_a = w.sum(-1)
    out_a = np.einsum("bkgt,btkd->bkgd", w, va) / np.maximum(l_a, 1e-20)[..., None]
    out_a = out_a.reshape(b, 1, hq, d).astype(np.float32)
    args = (q, out_a, m_a.astype(np.float32), l_a.astype(np.float32),
            kt_, vt_, t_valid)
    got = tattn.merge_softmax_segments(*[t(a) for a in args])
    want = jattn.merge_softmax_segments(*[jnp.asarray(a) for a in args])
    close(got, want)
    # And both equal one softmax over the concatenated segments.
    joint = tattn.gqa_attention(
        t(q), t(np.concatenate([ka, kt_], 1)), t(np.concatenate([va, vt_], 1)),
        t(np.concatenate([a_valid, t_valid], 1))[:, None, :])
    close(got, joint.numpy())
