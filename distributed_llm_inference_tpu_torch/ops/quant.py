"""Weight-only int8 / int4 quantization (counterpart of the JAX package's
``ops/quant.py``: symmetric int8 with per-output-channel scales, int4 in the
half-split layout of ``ops/quant_matmul.py``, the W8A8 prefill product, and
the ``matmul`` that takes any of them).

Quantization is a transform of the parameter dict: each projection matrix
becomes a :class:`QuantizedTensor` (int8 values + per-output-channel scales,
bf16 by default) or a :class:`QuantizedTensor4Split` (packed int4 + f32
per-channel scales). Quantized values and scales are byte-identical to the
JAX package's for the same weights.

What waits (``ROADMAP.md`` queue 1, item 6): the grouped int4 layout
(``QuantizedTensor4``, only tensor-parallel meshes take it), the
``int8_outlier`` decomposition and ``einsum`` (MoE).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from . import quant_matmul
from .quant_matmul import pack_int4_split, unpack_int4_split

__all__ = [
    "QuantizedTensor",
    "QuantizedTensor4Split",
    "QuantizedTensor4SplitView",
    "quantize_int8",
    "quantize_int4_split",
    "w8a8_matmul",
    "matmul",
    "einsum",
    "quantize_params",
    "QUANTIZED_WEIGHTS",
    "INT4_WEIGHTS",
]

# Layer-stack weights worth quantizing (the large matmuls). Norm gains and
# biases stay in the model dtype.
QUANTIZED_WEIGHTS = (
    "wq", "wk", "wv", "wo", "wg", "wu", "wd",  # dense attention + MLP
    "we_g", "we_u", "we_d",                    # MoE experts
    "lm_head",
)

# Weights eligible for int4 (plain ``x @ w`` projections).
INT4_WEIGHTS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head")


@dataclasses.dataclass
class QuantizedTensor:
    """``q``: int8 values ``[..., in, out]``; ``scale``: per-output-channel
    scales ``[..., out]`` (leading dims = layer stack)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.scale.dtype

    def __getitem__(self, i) -> "QuantizedTensor":
        return QuantizedTensor(self.q[i], self.scale[i])


@dataclasses.dataclass
class QuantizedTensor4Split:
    """int4 weight in the half-split layout of ``ops/quant_matmul.py``.

    ``q``: int8 ``[..., in_pad, out_pad // 2]`` — byte column ``j`` holds
    channel ``j`` (low nibble) and channel ``j + out_pad/2`` (high nibble);
    padded at quantization time. ``scale_lo``/``scale_hi``: f32
    ``[..., 1, out_pad // 2]`` per-output-channel scales of the two halves,
    stored pre-split. ``in_dim``/``out_dim``: the logical shape.
    """

    q: torch.Tensor
    scale_lo: torch.Tensor
    scale_hi: torch.Tensor
    in_dim: int = 0
    out_dim: int = 0

    @property
    def shape(self):
        return (*self.q.shape[:-2], self.in_dim, self.out_dim)

    @property
    def dtype(self):
        return self.scale_lo.dtype

    def full_scale(self) -> torch.Tensor:
        """``[..., out_pad]`` concatenated per-channel scales."""
        return torch.cat([self.scale_lo, self.scale_hi], dim=-1).reshape(
            *self.q.shape[:-2], -1
        )


@dataclasses.dataclass
class QuantizedTensor4SplitView:
    """One layer's int4 weight, VIEWED out of the layer-stacked tensor by a
    ``layer`` index instead of being sliced: decode hands the whole stack
    and the index to :func:`int4_matmul_stacked`, which reads the layer in
    place."""

    q: torch.Tensor         # [L, in_pad, out_pad // 2] int8
    scale_lo: torch.Tensor  # [L, 1, out_pad // 2] f32
    scale_hi: torch.Tensor  # [L, 1, out_pad // 2] f32
    layer: int
    in_dim: int = 0
    out_dim: int = 0

    @property
    def shape(self):
        return (self.in_dim, self.out_dim)

    @property
    def dtype(self):
        return self.scale_lo.dtype


def quantize_int8(w: torch.Tensor, scale_dtype=torch.bfloat16) -> QuantizedTensor:
    """Symmetric per-output-channel int8 quantization of ``[..., in, out]``."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale.squeeze(-2).to(scale_dtype))


def quantize_int4_split(w: torch.Tensor) -> QuantizedTensor4Split:
    """Symmetric per-output-channel int4 in the half-split layout. Scales are
    always f32: the kernel multiplies them in at its f32 epilogue."""
    in_dim, out = w.shape[-2:]
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    packed = pack_int4_split(q)
    out_pad = packed.shape[-1] * 2
    sc = torch.nn.functional.pad(scale.squeeze(-2), (0, out_pad - out))
    half = out_pad // 2
    return QuantizedTensor4Split(
        q=packed,
        scale_lo=sc[..., None, :half].contiguous(),
        scale_hi=sc[..., None, half:].contiguous(),
        in_dim=in_dim,
        out_dim=out,
    )


# Prefill calls (>= this many sequence positions) against int8 weights run
# int8 x int8 with dynamic per-token activation scales instead of
# converting the weight for a float product. Decode (S == 1) and short calls
# keep the weight-only path. ``EngineConfig.act_quant_prefill`` /
# ``act_quant_min_seq`` pin them per deployment.
ACT_QUANT_PREFILL = True
ACT_QUANT_MIN_SEQ = 128


def w8a8_matmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """int8 x int8 product with dynamic symmetric per-token activation
    scales: ``y = (q_x @ q_w) * x_scale * w_scale``. The int32 accumulator
    is exact (``torch._int_mm``, a library product outside any kernel of the
    port, as the JAX package leaves it to XLA) and the scales are applied in
    f32 before the one cast to the activation dtype."""
    amax = x.abs().float().amax(dim=-1, keepdim=True)
    xs = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
    y = torch._int_mm(q.reshape(-1, q.shape[-1]), w.q)
    y = y.reshape(*x.shape[:-1], w.q.shape[-1])
    return (y.float() * xs * w.scale.float()).to(x.dtype)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` that takes quantized weights as well.

    :class:`QuantizedTensor`: ``(x @ q) * scale`` in x's dtype, except
    prefill-shaped calls on a CUDA device, which take :func:`w8a8_matmul`
    (the JAX package's gate is "on a TPU"; here it is "on a CUDA device",
    the same rule ``engine/plan.py`` follows for its kernels).
    Half-split int4: decode rows and calls of at most 256 rows go through the
    CUDA kernel (``int4_matmul_stacked`` for a layer view, ``int4_matmul``
    for a 2-D weight); many-row (prefill) calls unpack the weight and take a
    plain product.
    """
    if (
        ACT_QUANT_PREFILL
        and isinstance(w, QuantizedTensor)
        and w.q.ndim == 2
        and x.ndim >= 3
        and x.shape[-2] >= ACT_QUANT_MIN_SEQ
        and x.device.type == "cuda"
    ):
        return w8a8_matmul(x, w)
    if isinstance(w, QuantizedTensor):
        y = x @ w.q.to(x.dtype)
        return y * w.scale.to(x.dtype)
    if isinstance(w, QuantizedTensor4SplitView):
        # Decode (S == 1) takes the stacked kernel at any batch; the row
        # threshold only sends genuine many-row prefill to the plain path.
        decode = x.ndim >= 3 and x.shape[-2] == 1
        if decode or math.prod(x.shape[:-1]) <= 256:
            return quant_matmul.int4_matmul_stacked(
                x, w.q, w.scale_lo, w.scale_hi, w.layer, w.out_dim
            )
        w4 = unpack_int4_split(w.q[w.layer])[: x.shape[-1]]
        y = x @ w4.to(x.dtype)
        sc = torch.cat([w.scale_lo[w.layer], w.scale_hi[w.layer]], dim=-1)
        return (y * sc.reshape(-1).to(x.dtype))[..., : w.out_dim]
    if isinstance(w, QuantizedTensor4Split):
        if w.q.ndim != 2:
            raise ValueError(
                "QuantizedTensor4Split matmul expects a per-layer 2D packed "
                f"weight, got shape {tuple(w.q.shape)}"
            )
        if math.prod(x.shape[:-1]) <= 256:
            return quant_matmul.int4_matmul(
                x, w.q, w.scale_lo, w.scale_hi, w.out_dim
            )
        w4 = unpack_int4_split(w.q)[: x.shape[-1]]
        y = x @ w4.to(x.dtype)
        return (y * w.full_scale().to(x.dtype))[..., : w.out_dim]
    return x @ w


def einsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """``torch.einsum`` that takes an int8 :class:`QuantizedTensor` too (the
    MoE expert stacks): the weight converted to x's type whole, the product,
    then its ``[..., out]`` scale, which needs the weight's non-contracted
    subscripts LAST in the output (true of the MoE einsums)."""
    if isinstance(w, QuantizedTensor):
        y = torch.einsum(spec, x, w.q.to(x.dtype))
        return y * w.scale.to(x.dtype)
    return torch.einsum(spec, x, w)


def _per_layer(fn, w: torch.Tensor):
    """``fn`` over a stacked weight one ``[in, out]`` matrix at a time (a
    layer's, or a layer's expert's), each result copied into a stack
    allocated once, so that the temporaries stay one matrix large.
    Quantization is per (layer, [expert,] output channel), so this equals
    ``fn(w)``."""
    if w.ndim == 2:
        return fn(w)
    first = _per_layer(fn, w[0])
    cls, fields = type(first), {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor):
            out = torch.empty((w.shape[0], *v.shape), dtype=v.dtype,
                              device=v.device)
            out[0].copy_(v)
            v = out
        fields[f.name] = v
    del first
    for i in range(1, w.shape[0]):
        part = _per_layer(fn, w[i])
        for name, v in fields.items():
            if isinstance(v, torch.Tensor):
                v[i].copy_(getattr(part, name))
        del part
    return cls(**fields)


def quantize_params(
    params: Dict[str, Any],
    names=QUANTIZED_WEIGHTS,
    scale_dtype=torch.bfloat16,
    bits: int = 8,
    int4_layout: str = "split",
) -> Dict[str, Any]:
    """Quantize the named weights of a parameter dict (full model or block
    only); everything else passes through unchanged. Each weight is
    quantized where it lies, one layer at a time.

    ``bits=4`` puts the dense projections (:data:`INT4_WEIGHTS`) in the
    half-split int4 layout (the single-device layout of the JAX engine);
    other named weights, and int4 weights with an odd output width, stay
    int8. ``int4_layout="grouped"`` waits (``ROADMAP.md`` queue 1, item 6).
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if int4_layout == "grouped":
        raise NotImplementedError(
            "the grouped int4 layout is not ported yet (ROADMAP.md queue 1, "
            "item 6)"
        )
    if int4_layout != "split":
        raise ValueError(f"unknown int4_layout {int4_layout!r}")

    def quantize_one(name, w):
        if bits == 4 and name in INT4_WEIGHTS and w.shape[-1] % 2 == 0:
            return _per_layer(quantize_int4_split, w)
        return _per_layer(lambda a: quantize_int8(a, scale_dtype), w)

    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {
                n: quantize_one(n, w) if n in names else w
                for n, w in v.items()
            }
        elif k in names:
            out[k] = quantize_one(k, v)
        else:
            out[k] = v
    return out
