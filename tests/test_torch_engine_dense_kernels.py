"""Port parity, the engine over the int8 dense cache on its kernel route
(``use_pallas_attention``; the JAX engine runs its Pallas kernels in
interpret mode, the port's wrappers their plain versions on CPU tensors):
the window (#9, #10) at K = 16 and 4 and the decode kernel (#8) at K = 1,
the shrink when idle, a growth that drops the window, and the kernel route
against the plain one. The scripts, helpers and tolerance (none: identical
greedy streams, events and finish reasons) are those of
``test_torch_engine_dense.py``."""

import numpy as np
import pytest

from tests.test_torch_engine_dense import (
    check_mixed,
    check_shrink,
    port_engine,
    prompts,
    spies,  # noqa: F401 (the fixture)
)
from distributed_llm_inference_tpu_torch.engine.sampling import SamplingOptions

KERNELS = [
    ("int8_kernels_k16_pipelined_overlap", dict(kv_quant="int8", kernels=True)),
    ("int8_kernels_k4_no_overlap",
     dict(kv_quant="int8", kernels=True, decode_steps=4,
          overlap_admission=False)),
    ("int8_kernels_k1", dict(kv_quant="int8", kernels=True, decode_steps=1)),
]


@pytest.mark.parametrize("kw", [m[1] for m in KERNELS],
                         ids=[m[0] for m in KERNELS])
def test_engine_kernel_routes_match_jax(kw, spies):  # noqa: F811
    check_mixed(kw, spies)


def test_shrink_when_idle_with_the_kernels():
    check_shrink(dict(kv_quant="int8", kernels=True))


def test_dense_growth_drops_the_windows():
    """A buffer growth replaces the buffers: the fused window (and, on a
    card, its graphs) built over the old ones is dropped, and a new one is
    built over the new buffers."""
    port = port_engine(kv_quant="int8", kernels=True, pipelined_ticks=False)
    fused = port._fused
    out = port.generate([prompts(1, seed=1)[0]], SamplingOptions(max_new_tokens=40))
    assert len(out[0]) == 40 and port.cache.max_len == 64
    assert list(fused._windows) == [64]
    win = fused._windows[64]
    assert win.anchor is port.cache.window_anchor
    port.cache.grow_to(96)
    with pytest.raises(RuntimeError, match="shapes changed"):
        win.begin(win.tokens, win.state, win.num_new)


def test_kernel_route_matches_plain_route():
    """The int8 cache: kernels on against off, identical greedy streams
    (the TPU kernels' f32 arithmetic, #8, and the fused window's bf16
    roundings match the plain segments path on these inputs)."""
    ps = prompts(6, lo=5, hi=30, seed=21)
    opts = SamplingOptions(max_new_tokens=25)
    outs = []
    for kernels in (True, False):
        for k in (1, None):
            port = port_engine(kv_quant="int8", kernels=kernels,
                               decode_steps=k)
            outs.append(port.generate(ps, opts))
    assert outs[0] == outs[2]
    assert outs[1] == outs[3]
