"""int4-weight matmul for decode: CUDA kernels that read the half-split
packed weight once and unpack it in registers, and their plain PyTorch
version (counterpart of the JAX package's ``ops/quant_matmul.py``).

Replaces the TPU kernels ``_int4_kernel`` behind ``int4_matmul`` and
``_int4_stacked_kernel`` behind ``int4_matmul_stacked``. Both are one CUDA
source, ``csrc/int4_matmul.cu``: the stacked form is the flat one with the
layer index turned into an offset of the weight's rows and the scales'
base pointers, so a layer's packed weight is never sliced out or copied.
They stay two functions with two launch counters, as they are two TPU
kernels.

Packing layout ("half-split"): byte column ``j`` of the packed weight holds
output channel ``j`` in its low nibble and channel ``j + out_pad/2`` in its
high nibble. The weight is padded at quantization time, input rows to a
multiple of ``_BIN`` and output channels to a multiple of ``2 * _BOUTP``,
exactly as the JAX package pads, so that packed bytes are identical in both
packages. Nibbles are unpacked by shift and sign extension of a signed byte
(``(b << 4) >> 4`` low, ``b >> 4`` high), never by reinterpreting bits as
int4.

On this card the function is bound by bytes at decode (at most 8 rows of
activations against the whole packed weight). bf16 x takes one launch of
``int4_mma_kernel``: tensor-core products (``mma.sync``, the weight as the
A operand, its nibbles turned into bf16 by a bit trick), the packed tiles
streamed into a ring by TMA, the split over input rows summed inside a
thread-block cluster (:func:`mma_plan` sizes it). f32 x (exact-parity runs)
takes a CUDA-core kernel and, when its input rows are split, a second
kernel that adds the partials. Both accumulate in f32, multiply the
per-channel f32 scales in at the epilogue, round once to x's type, and
write both halves of the output into one ``[rows, out_dim]`` tensor (no
concatenation, no slice).

The wrappers launch a kernel for CUDA tensors and raise on anything the
kernel does not take; they use the plain version only for tensors that lie
on the CPU. ``launches`` and ``stacked_launches`` count wrapper calls that
launch (one a call, whatever the route).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "pack_int4_split",
    "unpack_int4_split",
    "int4_matmul",
    "int4_matmul_plain",
    "int4_matmul_stacked",
    "int4_matmul_stacked_plain",
    "launches",
    "stacked_launches",
]

# Kernel launches made by :func:`int4_matmul` / :func:`int4_matmul_stacked`
# in this process.
launches = 0
stacked_launches = 0

# The JAX kernel's tile sizes, kept as the padding rule of the packed layout.
_BIN = 1024
_BOUTP = 512
_DTYPES = (torch.bfloat16, torch.float32)
# The bf16 kernel (``csrc/int4_matmul.cu``): a cluster's tile of packed
# byte columns, the packed rows of a ring stage, the x rows of one pass over
# the weight, the largest cluster (16 needs the non-portable attribute).
MMA_TILE_BYTES = 128
MMA_STAGE_ROWS = 128
MMA_PASS_ROWS = 64
MMA_MAX_CLUSTER = 16
# mma_plan's targets: blocks a grid, packed bytes a block.
MMA_MIN_BLOCKS = 64
MMA_BLOCK_BYTES = 128 * 1024
_fns = {}
_sm_count = {}


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_int4_split(
    q: torch.Tensor, in_pad: Optional[int] = None, out_pad: Optional[int] = None
) -> torch.Tensor:
    """Pack int4 values ``[..., in, out]`` (int8 container, range [-7, 7])
    into half-split bytes ``[..., in_pad, out_pad // 2]``.

    Channel ``j`` → low nibble of byte column ``j``; channel
    ``j + out_pad/2`` → high nibble. Padding rows/channels are zero.
    """
    in_dim, out = q.shape[-2:]
    in_pad = in_pad or _pad_to(in_dim, _BIN)
    out_pad = out_pad or _pad_to(out, 2 * _BOUTP)
    qp = F.pad(q, (0, out_pad - out, 0, in_pad - in_dim))
    lo = qp[..., : out_pad // 2]
    hi = qp[..., out_pad // 2:]
    return (lo & 0x0F) | (hi << 4)


def unpack_int4_split(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_split` (padded shape): ``[..., in_pad,
    out_pad]`` int8 values, by arithmetic shift and sign extension."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.cat([lo, hi], dim=-1)


def int4_matmul_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale_lo: torch.Tensor,
    scale_hi: torch.Tensor,
    out_dim: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`int4_matmul`: unpack the whole
    weight, one f32 product (bf16 x int4 products are exact in f32), the
    scales at the end, one rounding to x's type."""
    *lead, in_dim = x.shape
    w = unpack_int4_split(packed)[:in_dim].float()
    sc = torch.cat([scale_lo, scale_hi], dim=-1).reshape(-1).float()
    y = (x.reshape(-1, in_dim).float() @ w) * sc
    return y[:, :out_dim].to(x.dtype).reshape(*lead, out_dim)


def int4_matmul_stacked_plain(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale_lo: torch.Tensor,
    scale_hi: torch.Tensor,
    layer_idx: int,
    out_dim: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`int4_matmul_stacked`."""
    return int4_matmul_plain(
        x, packed[layer_idx], scale_lo[layer_idx], scale_hi[layer_idx], out_dim
    )


# The C entries: f32 x (the CUDA-core kernel, its partials and their
# combine) and bf16 x (one launch of the tensor-core kernel).
_ENTRIES = {
    "dli_int4_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "dli_int4_matmul_mma": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load_library("int4_matmul"), name)
        fn.argtypes = _ENTRIES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _sms(device) -> int:
    sms = _sm_count.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device] = sms
    return sms


def split_k(sms: int, col_tiles: int, in_dim: int) -> int:
    """f32 kernel: how many blocks share the input rows of one column tile:
    enough that about two blocks per SM exist, each at least 256 rows, at
    most 16."""
    return max(1, min(16, -(-2 * sms // col_tiles), -(-in_dim // 256)))


def mma_plan(sms: int, rows: int, in_dim: int, outp: int) -> dict:
    """bf16 kernel: how one call is cut. A cluster of ``cluster`` blocks
    owns a tile of ``tile_bytes`` packed byte columns (twice as many output
    channels) for one pass of up to 64 rows of x; its blocks split the
    input rows, ``k_block`` (a multiple of the ring's 128-row stage) each,
    in rank order, and add their partial sums inside the cluster.
    ``clusters`` = tiles x passes.

    The cluster is the smallest power of two that gives the grid
    ``MMA_MIN_BLOCKS`` blocks, and one for every ``MMA_BLOCK_BYTES`` of the
    packed weight, within one wave of the card (two blocks an SM up to 16
    rows of x, one above: the kernel's registers) and at most 16 (8 where a
    block takes an SM alone) and the input's stages. A sweep on an H100
    (``tools/torch_cluster_sweep.py --int4``) put the fastest cluster of
    every Llama-3-8B projection there: larger clusters add a partial per
    output and move too few bytes a block."""
    tiles = -(-outp // MMA_TILE_BYTES)
    passes = -(-rows // MMA_PASS_ROWS)
    stages = -(-in_dim // MMA_STAGE_ROWS)
    slots = sms * (2 if rows <= 16 else 1)
    most = min(MMA_MAX_CLUSTER if rows <= 16 else 8, stages)
    want = min(slots, max(MMA_MIN_BLOCKS, -(-in_dim * outp // MMA_BLOCK_BYTES)))
    grid = tiles * passes
    cluster = 1
    while (2 * cluster <= most and grid * cluster < want
           and grid * 2 * cluster <= slots):
        cluster *= 2
    return {"tile_bytes": MMA_TILE_BYTES, "cluster": cluster,
            "clusters": grid,
            "k_block": -(-stages // cluster) * MMA_STAGE_ROWS}


def _launch(name, x, packed, scale_lo, scale_hi, layer, out_dim):
    """Checks shared by both wrappers, then one launch. ``packed`` is
    ``[L, in_pad, out_pad // 2]`` and ``scale_lo``/``scale_hi``
    ``[L, 1, out_pad // 2]`` (L = 1 for the flat form)."""
    dev = x.device
    for label, t in (("packed", packed), ("scale_lo", scale_lo),
                     ("scale_hi", scale_hi)):
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} (kernel takes bf16, f32)")
    if packed.dtype != torch.int8:
        raise TypeError(f"{name}: packed must be int8, got {packed.dtype}")
    num_l, in_pad, outp = packed.shape
    for label, t in (("scale_lo", scale_lo), ("scale_hi", scale_hi)):
        if t.dtype != torch.float32 or t.numel() != num_l * outp:
            raise ValueError(
                f"{name}: {label} must be f32 with {num_l} x {outp} values, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    in_dim = x.shape[-1]
    if in_dim > in_pad or outp % 4 or out_dim > 2 * outp:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} / out_dim {out_dim} do not fit the "
            f"packed weight {tuple(packed.shape)}"
        )
    if not 0 <= layer < num_l:
        raise ValueError(f"{name}: layer {layer} outside 0..{num_l - 1}")
    x2 = x.reshape(-1, in_dim)
    for label, t in (("x", x2), ("packed", packed), ("scale_lo", scale_lo),
                     ("scale_hi", scale_hi)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")
    if x.dtype == torch.bfloat16 and outp % 16:
        raise ValueError(
            f"{name}: the bf16 kernel takes out_pad // 2 a multiple of 16, "
            f"got {outp}")
    with torch.cuda.device(dev):
        out = _dispatch(x2, packed, scale_lo, scale_hi, layer, out_dim,
                        torch.cuda.current_stream().cuda_stream, _sms(dev))
    return out.reshape(*x.shape[:-1], out_dim)


def _dispatch(x2, packed, scale_lo, scale_hi, layer, out_dim, stream, sms):
    """One call's launch, checks done: bf16 x takes the tensor-core kernel
    (one launch, cut by :func:`mma_plan`), f32 x the CUDA-core kernel (with f32
    partials and their combine when :func:`split_k` splits the input rows).
    Returns the ``[rows, out_dim]`` output."""
    num_l, in_pad, outp = packed.shape
    rows, in_dim = x2.shape
    out = torch.empty((rows, out_dim), dtype=x2.dtype, device=x2.device)
    if x2.dtype == torch.bfloat16:
        plan = mma_plan(sms, rows, in_dim, outp)
        err = _kernel("dli_int4_matmul_mma")(
            x2.data_ptr(), packed.data_ptr(), scale_lo.data_ptr(),
            scale_hi.data_ptr(), out.data_ptr(), rows, in_dim, in_pad, outp,
            out_dim, layer, num_l, plan["cluster"], plan["k_block"], stream,
        )
    else:
        splits = split_k(sms, -(-outp // 128), in_dim)
        part = torch.empty(
            (splits if splits > 1 else 0, rows, 2 * outp),
            dtype=torch.float32, device=x2.device,
        )
        err = _kernel("dli_int4_matmul")(
            x2.data_ptr(), packed.data_ptr(), scale_lo.data_ptr(),
            scale_hi.data_ptr(), out.data_ptr(), part.data_ptr(),
            rows, in_dim, in_pad, outp, out_dim, layer, splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"int4 kernel launch failed ({err})")
    return out


def int4_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale_lo: torch.Tensor,
    scale_hi: torch.Tensor,
    out_dim: int,
) -> torch.Tensor:
    """``x @ w`` with half-split-packed int4 weights and per-channel scales.

    ``x``: ``[..., in]``; ``packed``: ``[in_pad, out_pad // 2]`` int8
    (:func:`pack_int4_split`); ``scale_lo``/``scale_hi``: f32
    ``[1, out_pad // 2]``; returns ``[..., out_dim]`` in x's dtype.
    """
    global launches
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale_lo, scale_hi, out_dim)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if packed.ndim != 2:
        raise ValueError(f"int4_matmul: packed must be 2-D, got {packed.ndim}-D")
    out = _launch("int4_matmul", x, packed[None], scale_lo, scale_hi, 0,
                  out_dim)
    launches += 1
    return out


def int4_matmul_stacked(
    x: torch.Tensor,
    packed: torch.Tensor,
    scale_lo: torch.Tensor,
    scale_hi: torch.Tensor,
    layer_idx: int,
    out_dim: int,
) -> torch.Tensor:
    """:func:`int4_matmul` over the WHOLE layer-stacked weight with a layer
    index: ``packed``: int8 ``[L, in_pad, out_pad // 2]``;
    ``scale_lo``/``scale_hi``: f32 ``[L, 1, out_pad // 2]``; ``layer_idx``:
    a host integer (the port walks its layers in a Python loop). The kernel
    reads the layer's tiles in place."""
    global stacked_launches
    layer_idx = int(layer_idx)
    if x.device.type == "cpu":
        return int4_matmul_stacked_plain(
            x, packed, scale_lo, scale_hi, layer_idx, out_dim
        )
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul_stacked: unsupported device {x.device}")
    if packed.ndim != 3:
        raise ValueError(
            f"int4_matmul_stacked: packed must be 3-D, got {packed.ndim}-D"
        )
    out = _launch("int4_matmul_stacked", x, packed, scale_lo, scale_hi,
                  layer_idx, out_dim)
    stacked_launches += 1
    return out
