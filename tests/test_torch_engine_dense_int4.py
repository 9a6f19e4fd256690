"""Port parity, the JAX package's headline deployment through the engine:
int4 (half-split) weights over the int8 dense cache, on its kernel route
(#9 and #10 in the window, K = 16, pipelined, overlapped admission; the
int4 matmul kernels' plain versions). The scripts, helpers and tolerance (none: identical greedy streams, events and
finish reasons) are those of ``test_torch_engine_dense.py``."""

import pytest

from tests.test_torch_engine_dense import (
    check_mixed,
    spies,  # noqa: F401 (the fixture)
)

INT4 = [
    ("int4_weights_int8_kernels", dict(kv_quant="int8", kernels=True,
                                       quantization="int4")),
]


@pytest.mark.parametrize("kw", [m[1] for m in INT4], ids=[m[0] for m in INT4])
def test_int4_weights_over_the_int8_dense_cache_match_jax(kw, spies):  # noqa: F811
    check_mixed(kw, spies)
