"""Port parity: ``ragged_paged_attention`` of the PyTorch package (on CPU
tensors, so its plain version) against the JAX package's Pallas kernel in
interpret mode and its ``ragged_attention_reference``, on the cases of
``tests/test_attention_plan.py``. atol 2e-5: float32 on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops.ragged_attention import (
    ragged_attention_reference as jax_reference,
    ragged_paged_attention as jax_ragged,
)
from distributed_llm_inference_tpu_torch.ops import ragged_attention as tra

torch.set_num_threads(1)
ATOL = 2e-5


def mixed_phase_inputs(seed=0):
    """A decode row, a chunked row, a full prefill and a short prefill in
    one call."""
    rng = np.random.default_rng(seed)
    B, S, Hq, Hkv, D, PS, P, T = 4, 16, 4, 2, 16, 8, 32, 6
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, Hkv, PS, D)).astype(np.float32)
    vp = rng.standard_normal((P, Hkv, PS, D)).astype(np.float32)
    table = (rng.permutation(P - 1)[: B * T].reshape(B, T) + 1).astype(np.int32)
    kv_len = np.minimum(np.asarray([40, 33, 16, 5], np.int32), T * PS)
    num_new = np.asarray([1, 16, 16, 5], np.int32)
    return q, kp, vp, table, kv_len, num_new


def run_all(args, **kw):
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.as_tensor(a) for a in args]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref_kw = {k: v for k, v in jkw.items() if k != "block_q"}
    tref_kw = {k: v for k, v in tkw.items() if k != "block_q"}
    before = tra.launches
    out = {
        "torch": tra.ragged_paged_attention(*targs, **tkw).numpy(),
        "torch_reference": tra.ragged_attention_reference(*targs, **tref_kw).numpy(),
        "jax_kernel": np.asarray(jax_ragged(*jargs, interpret=True, **jkw)),
        "jax_reference": np.asarray(jax_reference(*jargs, **ref_kw)),
    }
    assert tra.launches == before, "a CPU call must not count as a launch"
    return out


@pytest.mark.parametrize("sliding_window", [None, 12])
def test_mixed_phases_match_jax(sliding_window):
    outs = run_all(mixed_phase_inputs(), sliding_window=sliding_window)
    for name in ("torch_reference", "jax_kernel", "jax_reference"):
        np.testing.assert_allclose(
            outs["torch"], outs[name], atol=ATOL, err_msg=name)


def test_several_query_tiles():
    """An odd length that spans several q blocks of the JAX kernel."""
    rng = np.random.default_rng(9)
    B, S, Hq, Hkv, D, PS, T, P = 2, 13, 4, 2, 16, 8, 4, 16
    args = (
        rng.standard_normal((B, S, Hq, D)).astype(np.float32),
        rng.standard_normal((P, Hkv, PS, D)).astype(np.float32),
        rng.standard_normal((P, Hkv, PS, D)).astype(np.float32),
        (rng.permutation(P - 1)[: B * T].reshape(B, T) + 1).astype(np.int32),
        np.asarray([25, 13], np.int32),
        np.asarray([13, 13], np.int32),
    )
    outs = run_all(args, block_q=4)
    for name in ("torch_reference", "jax_kernel", "jax_reference"):
        np.testing.assert_allclose(
            outs["torch"], outs[name], atol=ATOL, err_msg=name)


def test_pad_rows_and_empty_rows_are_zero():
    q, kp, vp, table, kv_len, num_new = mixed_phase_inputs(seed=5)
    kv_len = np.asarray([40, 33, 0, 5], np.int32)
    num_new = np.asarray([1, 16, 0, 5], np.int32)
    outs = run_all((q, kp, vp, table, kv_len, num_new))
    np.testing.assert_allclose(outs["torch"], outs["jax_kernel"], atol=ATOL)
    got = outs["torch"]
    assert np.all(got[0, 1:] == 0.0)   # decode row: one real query
    assert np.all(got[2] == 0.0)       # empty row
    assert np.all(got[3, 5:] == 0.0)   # short prefill's pad queries
    assert np.any(got[3, :5] != 0.0)


def test_explicit_q_start():
    q, kp, vp, table, kv_len, num_new = mixed_phase_inputs(seed=6)
    q_start = np.asarray([30, 10, 0, 0], np.int32)  # not the newest tokens
    outs = run_all((q, kp, vp, table, kv_len, num_new), q_start=q_start)
    for name in ("torch_reference", "jax_kernel", "jax_reference"):
        np.testing.assert_allclose(
            outs["torch"], outs[name], atol=ATOL, err_msg=name)


def test_mha_and_single_kv_head():
    rng = np.random.default_rng(11)
    for hq, hkv in ((4, 4), (4, 1)):
        B, S, D, PS, T, P = 2, 8, 16, 8, 3, 12
        args = (
            rng.standard_normal((B, S, hq, D)).astype(np.float32),
            rng.standard_normal((P, hkv, PS, D)).astype(np.float32),
            rng.standard_normal((P, hkv, PS, D)).astype(np.float32),
            (rng.permutation(P - 1)[: B * T].reshape(B, T) + 1).astype(np.int32),
            np.asarray([20, 8], np.int32),
            np.asarray([8, 8], np.int32),
        )
        outs = run_all(args)
        np.testing.assert_allclose(outs["torch"], outs["jax_kernel"], atol=ATOL)


def test_wrapper_never_falls_back_for_other_devices():
    args = [torch.as_tensor(a).to("meta") for a in mixed_phase_inputs()]
    with pytest.raises(ValueError):
        tra.ragged_paged_attention(*args)
