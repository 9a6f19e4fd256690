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


def page_size_inputs(page_size, seed):
    """Rows whose lengths are off the CUDA kernel's 128-slot step (200 and
    150 slots, a prompt of 20 and a chunk of 17 queries), a decode row and
    an empty row, over a pool of ``page_size`` slots a page."""
    rng = np.random.default_rng(seed)
    B, S, Hq, Hkv, D = 4, 20, 4, 2, 16
    kv_len = np.asarray([200, 150, 133, 0], np.int32)
    T = -(-int(kv_len.max()) // page_size) + 1
    P = B * T + 1
    return (
        rng.standard_normal((B, S, Hq, D)).astype(np.float32),
        rng.standard_normal((P, Hkv, page_size, D)).astype(np.float32),
        rng.standard_normal((P, Hkv, page_size, D)).astype(np.float32),
        (rng.permutation(P - 1)[: B * T].reshape(B, T) + 1).astype(np.int32),
        kv_len,
        np.asarray([20, 17, 1, 0], np.int32),
    )


@pytest.mark.parametrize("sliding_window", [None, 40])
@pytest.mark.parametrize("page_size", [16, 48, 128])
def test_page_sizes_match_jax(page_size, sliding_window):
    """The page sizes whose TMA boxes the CUDA kernel cuts differently
    (gcd(PS, 64) rows: 16, 16 and 64, two pages a step at 64, one at 128),
    against the Pallas kernel in interpret mode; atol 2e-5, f32 on both
    sides."""
    outs = run_all(page_size_inputs(page_size, page_size),
                   sliding_window=sliding_window)
    for name in ("torch_reference", "jax_kernel", "jax_reference"):
        np.testing.assert_allclose(
            outs["torch"], outs[name], atol=ATOL, err_msg=name)


@pytest.mark.parametrize("page_size,rows", [
    (16, 16), (48, 16), (64, 64), (128, 64), (12, 4), (100, 4), (1, 1)])
def test_box_rows_never_cross_a_page(page_size, rows):
    got = tra.box_rows(page_size)
    assert got == rows
    # A box starts at a multiple of its rows inside a 128-slot step, and a
    # step starts at a multiple of 128: the box lies inside one page.
    assert page_size % got == 0 and tra.STEP % got == 0


def test_box_rows_refuses_empty_pages():
    with pytest.raises(ValueError):
        tra.box_rows(0)


def walk_steps(tile, group, q_start, num_new, kv_len, window=None):
    """128-slot steps the bf16 kernel's block of query ``tile`` walks, as
    ``ragged_kernel_wgmma`` bounds its walk (0 for a tile of pad queries)."""
    bq = tra.BLOCK_ROWS // tra.rows_per_query(group)
    start = tile * bq
    if start >= num_new:
        return 0
    end = min(kv_len, q_start + min(start + bq, num_new))
    first = max(0, q_start + start - window + 1) if window else 0
    first -= first % tra.STEP
    return max(0, -(-(end - first) // tra.STEP))


@pytest.mark.parametrize("group", [1, 4, 3, 7, 8])
@pytest.mark.parametrize("q_start,num_new,window", [
    (0, 2048, None), (1500, 600, None), (0, 2048, 700), (0, 300, None)])
def test_tiles_launch_longest_walk_first(group, q_start, num_new, window):
    tiles = tra.launch_plan(1, num_new, 8, group, 128, 64, 512,
                            False)["grid"][2]
    order = [tra.tile_of(z, tiles) for z in range(tiles)]
    assert sorted(order) == list(range(tiles))
    walks = [walk_steps(t, group, q_start, num_new, q_start + num_new,
                        window) for t in order]
    if window is None:
        assert walks == sorted(walks, reverse=True)
    else:
        # Inside a window every later tile walks window / 128 steps, give
        # or take the one its start rounds down into.
        assert max(walks) - walks[0] <= 1


@pytest.mark.parametrize("quantized", [False, True])
def test_launch_plan_at_llama3_widths(quantized):
    plan = tra.launch_plan(2, 2048, 8, 4, 128, 64, 2049, quantized)
    assert plan["grid"] == (8, 2, 64) and plan["tiles"] == 64
    assert plan["threads"] == 384
    assert plan["stages"] == (2 if quantized else 3)
    assert plan["box_rows"] == 64
    # K and V, two boxes of 64 rows a step, two column halves in bf16.
    assert plan["boxes_per_step"] == (4 if quantized else 8)
    # q as {D, G, Hkv, S, B}: a box of the group's 4 heads of one kv head.
    assert plan["q_map"] == {
        "dims": (128, 4, 8, 2048, 2), "strides": (256, 1024, 8192, 16777216),
        "box": (64, 4, 1, 32, 1), "swizzle": 128}
    assert plan["o_box"] == (64, 4, 1, 16, 1)
    assert plan["kv_map"]["box"] == ((128, 64) if quantized else (64, 64))
    assert plan["kv_map"]["strides"] == ((128,) if quantized else (256,))
    assert plan["stage_bytes"] == (32768 if quantized else 65536)
    # Q, the stages, the barriers: under the 227 KB a block can have.
    assert plan["smem_bytes"] == (231544 if quantized else 229432)
    assert plan["smem_bytes"] <= 232448


def test_launch_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="2\\^31"):
        tra.launch_plan(1, 16, 8, 4, 128, 64, 2**22 + 1, False)
    with pytest.raises(ValueError, match="head_dim"):
        tra.launch_plan(1, 16, 8, 4, 96, 64, 10, False)
    with pytest.raises(ValueError, match="queue 1, item 18"):
        tra.launch_plan(1, 16, 8, 9, 128, 64, 10, False)
    with pytest.raises(ValueError, match="even page size"):
        tra.launch_plan(1, 16, 8, 4, 64, 15, 10, True)
    assert tra.launch_plan(1, 128, 8, 1, 128, 64, 10, False)["tiles"] == 1


@pytest.mark.parametrize("group,head_dim", [
    (1, 128), (2, 64), (3, 128), (4, 64), (5, 128), (6, 128), (7, 128),
    (7, 64), (8, 128), (8, 64)])
@pytest.mark.parametrize("quantized", [False, True])
def test_launch_plan_maps_each_score_row(group, head_dim, quantized):
    """The plan's Q box is the kernel's (query, head) map row for row: a
    block of 128 score rows holds 128 / Gp queries of Gp rows each, Gp the
    group rounded up to a power of two; rows of heads past the group are
    padding (zeros in, never written), at G = 7 one a query, 126 real rows
    of 128. Each warpgroup's 64 rows hold whole queries, as its output box
    of 64 / Gp queries says. The bytes follow the head_dim: one 64-column
    half a row at D = 64."""
    plan = tra.launch_plan(1, 300, 2, group, head_dim, 48, 40, quantized)
    gp = plan["rows_per_query"]
    rows = tra.score_rows(group)
    assert gp == 1 << (group - 1).bit_length() and 128 % gp == 0
    assert plan["q_map"]["box"] == (64, gp, 1, 128 // gp, 1)
    assert plan["o_box"] == (64, gp, 1, 64 // gp, 1)
    assert plan["q_map"]["dims"][:3] == (head_dim, group, 2)
    # The box is laid out densely, heads fastest: row r = query r // gp,
    # head r % gp; the heads the group lacks read as zeros.
    want = [(r // gp, r % gp) if r % gp < group else None for r in range(128)]
    assert rows == want
    real = [r for r in rows if r is not None]
    assert len(real) == (128 // gp) * group == len(set(real))
    assert all(q < 128 // gp and h < group for q, h in real)
    for wg in (0, 1):  # no query is split across the two warpgroups
        assert {r[0] for r in rows[64 * wg:64 * wg + 64] if r} == set(
            range(wg * 64 // gp, (wg + 1) * 64 // gp))
    assert plan["tiles"] == -(-300 // (128 // gp))
    halves = head_dim // 64
    assert plan["boxes_per_step"] == 128 // 16 * (1 if quantized else halves) * 2
    stage = 2 * 128 * head_dim if quantized else 2 * halves * tra._HALF
    assert plan["stage_bytes"] == stage
    assert plan["smem_bytes"] <= 232448
