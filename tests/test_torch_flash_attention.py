"""Port parity: ``ops/flash_attention.py:flash_attention`` (on CPU tensors,
so its plain version) against the JAX package's Pallas ``flash_attention``
in interpret mode with the same 8-wide tiles, and against the port's
``gqa_attention``, on the same numpy inputs: the cases of
``tests/test_flash_attention.py`` (1, 2 and 4 query heads per kv head,
ragged cache lengths, a sliding window, bf16, the S=1 route) plus fully
masked rows, shapes that do not tile, and K/V given as a strided view.

Tolerances: 2e-5 absolute in f32 (the same tiles, sums in another order);
in bf16 one bf16 step of the output's largest magnitude (p is rounded to
bf16 at the same running maxima on both sides; the products and the final
rounding differ in order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from distributed_llm_inference_tpu_torch.ops import flash_attention as tfa
from distributed_llm_inference_tpu_torch.ops.attention import (
    gqa_attention, rows_per_query,
)

torch.set_num_threads(1)
F32 = 2e-5


def mask_np(b, s, t, lengths=None, window=None, q0=0):
    """Causal mask ``[B, S, T]``: queries at ``q0 + i``, positions below
    ``lengths[b]`` valid, inside ``window``."""
    q = q0 + np.arange(s)[None, :, None]
    k = np.arange(t)[None, None, :]
    m = np.broadcast_to(k <= q, (b, s, t)).copy()
    if window is not None:
        m &= k > q - window
    if lengths is not None:
        m &= k < np.asarray(lengths)[:, None, None]
    return m


def inputs(seed, b, s, t, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


def both(q, k, v, mask, dtype="float32", block=8):
    """(port, JAX, port gqa) outputs as f32 numpy."""
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(jnp.asarray(q, jt), jnp.asarray(k, jt),
                     jnp.asarray(v, jt), jnp.asarray(mask), block_q=block,
                     block_k=block, interpret=True)
    args = (torch.from_numpy(q).to(tt), torch.from_numpy(k).to(tt),
            torch.from_numpy(v).to(tt), torch.from_numpy(mask))
    before = tfa.launches
    got = tfa.flash_attention(*args, block_q=block, block_k=block)
    assert tfa.launches == before, "no kernel runs on the CPU"
    oracle = gqa_attention(*args)
    return (got.float().numpy(), np.asarray(want, np.float32),
            oracle.float().numpy())


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
def test_matches_jax_gqa(hq, hkv):
    q, k, v = inputs(0, 2, 32, 32, hq, hkv, 16)
    got, want, oracle = both(q, k, v, mask_np(2, 32, 32))
    np.testing.assert_allclose(got, want, atol=F32, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=F32, rtol=0)


def test_ragged_lengths_and_window():
    """A buffer longer than the valid data, mixed rows, a sliding window."""
    q, k, v = inputs(1, 2, 16, 48, 4, 2, 8)
    mask = mask_np(2, 16, 48, lengths=[13, 7], window=5)
    got, want, oracle = both(q, k, v, mask)
    np.testing.assert_allclose(got, want, atol=F32, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=F32, rtol=0)


def test_fully_masked_rows_give_zeros():
    """Row 0 has nothing cached (every query masked); row 1's queries sit
    past its valid data, as a prefill's pad queries do."""
    q, k, v = inputs(2, 2, 16, 32, 8, 2, 16)
    mask = mask_np(2, 16, 32, lengths=[0, 9])
    mask[1, 12:] = False
    got, want, oracle = both(q, k, v, mask)
    assert (got[0] == 0).all() and (got[1, 12:] == 0).all()
    np.testing.assert_allclose(got, want, atol=F32, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=F32, rtol=0)


@pytest.mark.parametrize("block", [8, 16])
def test_bf16_within_one_step(block):
    q, k, v = inputs(3, 1, 64, 64, 8, 4, 32)
    got, want, oracle = both(q, k, v, mask_np(1, 64, 64), "bfloat16", block)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= step
    assert np.abs(got - oracle).max() <= 2 * step


def test_decode_and_untiled_shapes_take_gqa():
    """S=1 (decode), S < 8, and S or T that do not tile go to
    ``gqa_attention`` unchanged, as in the JAX wrapper."""
    for b, s, t, block in ((2, 1, 16, 128), (1, 4, 16, 128), (1, 24, 32, 16),
                           (1, 16, 40, 16)):
        q, k, v = inputs(4, b, s, t, 4, 2, 8)
        args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(mask_np(b, s, t, q0=t - s)))
        got = tfa.flash_attention(*args, block_q=block, block_k=block)
        assert torch.equal(got, gqa_attention(*args))


def test_strided_kv_view():
    """K/V as the int8 dense cache's gather path hands them: time-major
    views of head-major tensors. The same result as contiguous copies."""
    q, k, v = inputs(5, 2, 32, 64, 8, 2, 16)
    kh = torch.from_numpy(k).transpose(1, 2).contiguous()   # [B, Hkv, T, D]
    vh = torch.from_numpy(v).transpose(1, 2).contiguous()
    mask = torch.from_numpy(mask_np(2, 32, 64, lengths=[40, 64], q0=16))
    qt = torch.from_numpy(q)
    got = tfa.flash_attention(qt, kh.transpose(1, 2), vh.transpose(1, 2), mask)
    want = tfa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                               mask)
    assert torch.equal(got, want)


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 16, 4, 128), device="meta")
    k = torch.zeros((1, 16, 1, 128), device="meta")
    mask = torch.zeros((1, 16, 16), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention(q, k, k, mask)


# ---------------------------------------------------------------------------
# The bf16 kernel's first pass (``mask_tiles``): the mask bit-packed and a
# class per (query tile, 128-wide step), and the walk the kernel makes
# from them (only non-empty steps, a mask only on partial ones).
# ---------------------------------------------------------------------------

def mask_family(name, b, s, t, rng):
    """Masks the dense caches and the sink ring hand the kernel: causal over
    a longer buffer, a sliding window, sinks beside a window, random bits,
    and rows (and a whole row) that see nothing."""
    q0 = [t - s, 0][:b]
    if name == "causal":
        return mask_np(b, s, t, lengths=[t, max(1, t // 2)][:b], q0=0)
    if name == "window":
        return mask_np(b, s, t, window=max(2, s // 3), q0=t - s)
    if name == "sinks":
        m = mask_np(b, s, t, window=max(2, s // 4), q0=t - s)
        q = (t - s) + np.arange(s)[None, :, None]
        m |= (np.arange(t)[None, None, :] < 4) & (np.arange(t) <= q)
        return m
    if name == "random":
        return rng.random((b, s, t)) < 0.3
    m = mask_np(b, s, t, lengths=[0, t][:b], q0=q0[-1])
    m[-1, s // 2:] = False
    return m


FAMILIES = ["causal", "window", "sinks", "random", "empty_rows"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("s,t", [(256, 384), (40, 72)])
def test_mask_tiles_match_the_byte_mask(family, s, t):
    """Unpacking the bits gives the mask back (positions past T unset);
    every tile's class is what its bytes say, for query tiles of 32 (G = 4)
    and 128 (G = 1) queries, at S and T multiples of 128 and below 128."""
    rng = np.random.default_rng(7)
    mask = mask_family(family, 2, s, t, rng)
    for bq in (32, 128):
        bits, classes = tfa.mask_tiles(torch.from_numpy(mask), bq)
        nkt, nqt = -(-t // 128), -(-s // bq)
        assert bits.shape == (2, s, 4 * nkt) and bits.dtype == torch.int32
        assert classes.shape == (2, nqt, nkt)
        words = bits.numpy().astype(np.int64) & 0xFFFFFFFF
        unpacked = (words[..., None] >> np.arange(32)) & 1
        unpacked = unpacked.reshape(2, s, nkt * 128).astype(bool)
        np.testing.assert_array_equal(unpacked[..., :t], mask)
        assert not unpacked[..., t:].any()
        for b in range(2):
            for qt in range(nqt):
                for kt in range(nkt):
                    tile = mask[b, qt * bq:(qt + 1) * bq, kt * 128:(kt + 1) * 128]
                    whole = kt * 128 + 128 <= t
                    want = (tfa.EMPTY if not tile.any() else
                            tfa.FULL if whole and tile.all() else tfa.PARTIAL)
                    assert classes[b, qt, kt] == want, (b, qt, kt)


def walk_listed_tiles(q, k, v, mask, g):
    """The bf16 kernel's walk in f32: per (row, query tile of 128 / Gp
    queries, Gp the group rounded up to a power of two), only the steps
    ``mask_tiles`` lists, a mask applied only on partial ones, 128-wide
    steps, online softmax as the TPU kernel's."""
    b, s, hq, d = q.shape
    hkv, t = k.shape[2], k.shape[1]
    bq = 128 // rows_per_query(g)
    _, classes = tfa.mask_tiles(mask, bq)
    out = torch.zeros_like(q)
    for bi in range(b):
        for qt in range(classes.shape[1]):
            rows = slice(qt * bq, min((qt + 1) * bq, s))
            qg = q[bi, rows].reshape(-1, hkv, g, d)          # [n, Hkv, G, D]
            m = torch.full(qg.shape[:3], -0.7 * 3.4028234663852886e38)
            l = torch.zeros(qg.shape[:3])
            acc = torch.zeros(qg.shape)
            for kt in range(classes.shape[2]):
                cls = int(classes[bi, qt, kt])
                if cls == tfa.EMPTY:
                    continue
                pos = slice(kt * 128, min(kt * 128 + 128, t))
                sc = torch.einsum("nhgd,thd->nhgt", qg, k[bi, pos]) * d**-0.5
                if cls == tfa.PARTIAL:
                    vis = mask[bi, rows, pos][:, None, None, :]
                    sc = torch.where(vis, sc, float("-inf"))
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                l = torch.exp(m - m_new) * l + p.sum(-1)
                acc = acc * torch.exp(m - m_new)[..., None] + torch.einsum(
                    "nhgt,thd->nhgd", p, v[bi, pos])
                m = m_new
            out[bi, rows] = (acc / l.clamp_min(1e-20)[..., None]).reshape(
                -1, hq, d)
    return out


# (g, d, family): 4 and 1 query heads a kv head under every mask family;
# the groupings 3, 7, 8 (query tiles of 32, 16, 16) and head_dim 64 under
# one family each.
WALK_CASES = [(g, 16, family) for g in (4, 1) for family in FAMILIES] + [
    (3, 16, "window"), (7, 16, "sinks"), (8, 16, "empty_rows"),
    (4, 64, "causal"), (8, 64, "random")]


@pytest.mark.parametrize(
    "g,d,family", WALK_CASES,
    ids=[f"{g if d == 16 else f'{g}d{d}'}-{family}"
         for g, d, family in WALK_CASES])
def test_listed_walk_matches_jax(g, d, family):
    """Skipping empty tiles and masking only partial ones gives the TPU
    kernel's result (JAX in interpret mode, its 128-wide tiles), and rows
    that see nothing are exact zeros."""
    s, t = 48, 256
    q, k, v = inputs(11, 2, s, t, 2 * g, 2, d)
    mask = mask_family(family, 2, s, t, np.random.default_rng(3))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), interpret=True)
    got = walk_listed_tiles(*(torch.from_numpy(x) for x in (q, k, v, mask)), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=0)
    empty = ~mask.any(-1)
    assert (got.numpy()[empty] == 0).all()
