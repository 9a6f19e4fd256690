"""Port parity: ``paged_attention`` of the PyTorch package (on CPU tensors,
so its plain version) against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs. atol 2e-5: float32 on both sides, another
order of summation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops.attention import _NEG_INF

torch.set_num_threads(1)
ATOL = 2e-5


def inputs(seed, hq, hkv, lens, d=16, ps=8, width=5, pages=48):
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kp = rng.standard_normal((pages, hkv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((pages, hkv, ps, d)).astype(np.float32)
    table = (rng.permutation(pages - 1)[: b * width].reshape(b, width) + 1)
    return q, kp, vp, table.astype(np.int32), np.asarray(lens, np.int32)


def both(q, kp, vp, table, lens, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), interpret=True, **jkw)
    before = tpa.launches
    got = tpa.paged_attention(
        torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(table), torch.as_tensor(lens), **tkw)
    assert tpa.launches == before, "a CPU call must not count as a launch"
    return got, want


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (8, 1)])
def test_matches_jax_kernel_gqa_and_mha(hq, hkv):
    got, want = both(*inputs(0, hq, hkv, [40, 17, 8, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_zero_length_row_gives_zeros():
    got, want = both(*inputs(1, 4, 2, [0, 23, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("past", [0, 5])
def test_sliding_window_and_q_positions(past):
    q, kp, vp, table, lens = inputs(2, 4, 2, [40, 17, 9])
    kw = dict(sliding_window=12)
    if past:
        kw["q_positions"] = (lens - 1 + past).astype(np.int32)
    got, want = both(q, kp, vp, table, lens, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # A window that shows nothing of the pool: zeros.
    kw["q_positions"] = (lens + 100).astype(np.int32)
    got, want = both(q, kp, vp, table, lens, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(got.abs().max()) == 0.0


def test_return_stats():
    got, want = both(*inputs(3, 4, 2, [33, 0, 8]), return_stats=True)
    for g, w, name in zip(got, want, ("out", "m", "l")):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-6, err_msg=name)
    out, m, l = got
    assert m.shape == (3, 2, 2) and l.shape == (3, 2, 2)
    assert float(l[1].max()) == 0.0
    assert np.allclose(m[1].numpy(), _NEG_INF)


def test_plain_matches_gather_oracle():
    """The plain version against an independent dense computation."""
    from distributed_llm_inference_tpu_torch.ops.attention import gqa_attention

    q, kp, vp, table, lens = [torch.as_tensor(a) for a in inputs(4, 4, 2, [29, 3])]
    k = tpa.gather_pages(kp, table)
    v = tpa.gather_pages(vp, table)
    mask = (torch.arange(k.shape[1])[None, :] < lens[:, None])[:, None, :]
    want = gqa_attention(q, k, v, mask)
    got = tpa.paged_attention_plain(q, kp, vp, table, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_rejects_multi_token_queries():
    q, kp, vp, table, lens = [torch.as_tensor(a) for a in inputs(5, 4, 2, [5])]
    with pytest.raises(ValueError):
        tpa.paged_attention(q.expand(1, 2, 4, 16), kp, vp, table, lens)


def test_wrapper_never_falls_back_for_other_devices():
    """Only CPU tensors reach the plain version; any other device type
    launches or raises."""
    q, kp, vp, table, lens = [
        torch.as_tensor(a).to("meta") for a in inputs(6, 4, 2, [5])
    ]
    with pytest.raises(ValueError):
        tpa.paged_attention(q, kp, vp, table, lens)


def test_kernel_input_checks():
    q, kp, vp, table, lens = [torch.as_tensor(a) for a in inputs(7, 4, 2, [5])]
    check = tpa.check_kernel_inputs
    vec = (("kv_lengths", lens),)
    with pytest.raises(ValueError, match="head_dim"):
        check("t", q, kp, vp, table, vec)  # head_dim 16 is not a kernel width
    q2 = torch.zeros(1, 1, 8, 128)
    p2 = torch.zeros(8, 2, 8, 128)
    assert check("t", q2, p2, p2, table, vec) == 1
    assert check("t", q2[:, :, :2].contiguous(), p2, p2, table, vec) == 1  # MHA
    assert check("t", q2[:, :, :4].contiguous(), p2, p2, table, vec) == 1  # G 2
    with pytest.raises(ValueError, match="query heads per kv head"):
        check("t", torch.zeros(1, 1, 18, 128), p2, p2, table, vec)  # G 9
    assert check("t", q2.bfloat16(), p2.bfloat16(), p2.bfloat16(), table, vec) == 0
    with pytest.raises(TypeError):
        check("t", q2.half(), p2.half(), p2.half(), table, vec)
    with pytest.raises(TypeError):
        check("t", q2, p2, p2.bfloat16(), table, vec)
    with pytest.raises(TypeError):
        check("t", q2, p2, p2, table.long(), vec)
    with pytest.raises(ValueError, match="contiguous"):
        check("t", q2, p2.transpose(1, 2).contiguous().transpose(1, 2), p2, table, vec)
