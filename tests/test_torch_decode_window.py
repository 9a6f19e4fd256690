"""Port parity, the fused K-step decode window: ``multi_decode_apply`` and
the paged caches' write-behind tail (``tail_init`` / ``tail_attend`` /
``tail_flush``) against the JAX package's at K = 4, on the same weights and
prompts (f32, CPU).

Three routes: the model-dtype pool with its decode kernel (the JAX cache
with ``use_kernel``, whose Pallas kernel runs in interpret mode; the port's
wrapper takes its plain version), the int8 pool on the kernel forms (the
gathered stacks under ``INPLACE_CTX``, the pool in place from it on, and
the flush kernel), and the int8 pool on the plain segments forms. Emitted
tokens must be identical and ``lengths`` equal. The f32 pool agrees to
1e-5 (the same rotated keys, another order of summation in the
projections). The int8 pool within 1 LSB and its scales to 1e-6
relative: the kernel forms quantize f32 values (equal bytes), the segments
forms quantize the bf16 tail, where XLA's jit rewrites the division of
``_quantize_kv`` and rounding ties can fall the other way. Page 0, the
null page that absorbs padding writes in both packages, is not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu import config as jcfg
from distributed_llm_inference_tpu.cache.paged import (
    PagedKVCache as JaxCache,
    QuantizedPagedKVCache as JaxQCache,
)
from distributed_llm_inference_tpu.models import llama as jllama
from distributed_llm_inference_tpu_torch import config as tcfg
from distributed_llm_inference_tpu_torch.cache.paged import (
    PagedKVCache,
    QuantizedPagedKVCache,
)
from distributed_llm_inference_tpu_torch.models import llama as tllama
from distributed_llm_inference_tpu_torch.ops import paged_attention as tpa
from distributed_llm_inference_tpu_torch.ops import quant_attention as tqa

torch.set_num_threads(1)
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
JCFG, TCFG = jcfg.ModelConfig(**MODEL), tcfg.ModelConfig(**MODEL)
JPARAMS = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
TPARAMS = tllama.params_from_numpy(
    TCFG, jax.tree_util.tree_map(np.asarray, JPARAMS), torch.float32, "cpu")
B, PS, PAGES, K = 4, 8, 40, 4
PROMPT_LENS = [5, 12, 7, 0]         # row 3 is idle: no prompt, no decode
BUDGET = np.asarray([4, 2, 4, 0], np.int32)


def setup(quantized, use_kernel, width, with_jax=True):
    """Both caches with the same pages mapped and the same prompts
    prefilled; returns (jax cache, port cache, first tokens [B, 1]); the
    JAX cache is None without ``with_jax``."""
    jcls, tcls = (JaxQCache, QuantizedPagedKVCache) if quantized else (
        JaxCache, PagedKVCache)
    args = (MODEL["num_layers"], B, PAGES, PS, width, MODEL["num_kv_heads"],
            MODEL["head_dim"])
    jc = jcls.create(*args, jnp.float32, use_kernel=use_kernel)
    tc = tcls.create(*args, torch.float32, use_kernel=use_kernel, device="cpu")
    table = np.arange(1, 1 + B * width, dtype=np.int32).reshape(B, width)
    jc = jc.replace(page_table=jnp.asarray(table))
    tc.page_table.copy_(torch.from_numpy(table))
    rng = np.random.default_rng(1)
    tokens = np.zeros((B, 16), np.int32)
    for r, n in enumerate(PROMPT_LENS):
        tokens[r, :n] = rng.integers(0, 256, size=n)
    n_new = np.asarray(PROMPT_LENS, np.int32)
    if with_jax:
        _, jc = jllama.model_apply(JCFG, JPARAMS, jnp.asarray(tokens), jc,
                                   jnp.asarray(n_new))
    else:
        jc = None
    _, tc = tllama.model_apply(TCFG, TPARAMS, torch.from_numpy(tokens), tc,
                               torch.from_numpy(n_new))
    first = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
    return jc, tc, first


def run_port(quantized, use_kernel, width):
    """The port's window alone (a free run: its tokens, which
    :func:`run_both` holds to the JAX package's)."""
    _, tc, first = setup(quantized, use_kernel, width, with_jax=False)
    active = np.asarray([n > 0 for n in PROMPT_LENS])
    budget_t = torch.from_numpy(BUDGET)

    def tstep(i, logits, alive):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        emitted = torch.where(alive, nxt, -1)
        alive = alive & (i + 1 < budget_t)
        return nxt, alive.to(torch.int32), alive, emitted

    got, _ = tllama.multi_decode_apply(
        TCFG, TPARAMS, torch.from_numpy(first), tc, K, tstep,
        torch.from_numpy(active), torch.from_numpy(active.astype(np.int32)))
    return got


def run_both(quantized, use_kernel, width, eos=-1):
    jc, tc, first = setup(quantized, use_kernel, width)
    active = np.asarray([n > 0 for n in PROMPT_LENS])
    eos_np = np.full(B, eos, np.int32)

    def jstep(i, logits, alive):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        emitted = jnp.where(alive, nxt, -1)
        alive = alive & (nxt != eos_np) & (i + 1 < BUDGET)
        return nxt, alive.astype(jnp.int32), alive, emitted

    budget_t, eos_t = torch.from_numpy(BUDGET), torch.from_numpy(eos_np)

    def tstep(i, logits, alive):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        emitted = torch.where(alive, nxt, -1)
        alive = alive & (nxt != eos_t) & (i + 1 < budget_t)
        return nxt, alive.to(torch.int32), alive, emitted

    want, jc = jllama.multi_decode_apply(
        JCFG, JPARAMS, jnp.asarray(first), jc, K, jstep,
        jnp.asarray(active), jnp.asarray(active.astype(np.int32)))
    got, tc = tllama.multi_decode_apply(
        TCFG, TPARAMS, torch.from_numpy(first), tc, K, tstep,
        torch.from_numpy(active), torch.from_numpy(active.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    planes = (("k_pages", "v_pages", "ks_pages", "vs_pages") if quantized
              else ("k_pages", "v_pages"))
    for name in planes:
        g = getattr(tc, name).numpy()[:, 1:]
        w = np.asarray(getattr(jc, name))[:, 1:]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6 if quantized else 0,
                                       atol=0 if quantized else 1e-5)
    return got


@pytest.fixture
def calls(monkeypatch):
    """Calls of the attention and flush wrappers, by name."""
    counts = {}
    for mod, name in ((tpa, "paged_attention"),
                      (tpa, "quantized_paged_fused_attention"),
                      (tpa, "paged_tail_flush"),
                      (tqa, "quantized_fused_decode_attention")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return counts


def test_model_dtype_pool_through_the_decode_kernel(calls):
    got = run_both(quantized=False, use_kernel=True, width=4)
    assert (got[:, 3] == -1).all() and (got[2:, 1] == -1).all()
    layers = MODEL["num_layers"]
    assert calls == {"paged_attention": K * layers}


# (form, table width, INPLACE_CTX): capacity 32 = 4 pages of 8 gathers
# (a multiple of 32: the kernel form); INPLACE_CTX at 32 reads in place.
FORMS = [("gathered", 4, 768), ("in_place", 4, 32)]


@pytest.mark.parametrize("form,width,ctx", FORMS, ids=[f[0] for f in FORMS])
def test_int8_pool_kernel_forms(form, width, ctx, calls, monkeypatch):
    monkeypatch.setattr(JaxQCache, "INPLACE_CTX", ctx)
    monkeypatch.setattr(QuantizedPagedKVCache, "INPLACE_CTX", ctx)
    run_both(quantized=True, use_kernel=True, width=width)
    layers = MODEL["num_layers"]
    fused = ("quantized_paged_fused_attention" if form == "in_place"
             else "quantized_fused_decode_attention")
    assert calls == {fused: K * layers, "paged_tail_flush": 1}


@pytest.mark.parametrize("use_kernel,width", [(False, 4), (True, 5)],
                         ids=["no_kernel", "capacity_not_32_aligned"])
def test_int8_pool_segments_forms(use_kernel, width, calls):
    """Without the kernel, and with it at a capacity (5 pages of 8) that
    the gathered kernel does not take: the plain segments and scatter."""
    run_both(quantized=True, use_kernel=use_kernel, width=width)
    assert calls == {}


def test_eos_stops_a_row_inside_the_window():
    free = run_port(quantized=True, use_kernel=True, width=4)
    eos = int(free[1, 0])            # row 0's second token
    got = run_both(quantized=True, use_kernel=True, width=4, eos=eos)
    assert got[1, 0] == eos and (got[2:, 0] == -1).all()
