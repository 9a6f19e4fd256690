"""Flash attention for prefill over contiguous K/V: a CUDA kernel and its
plain PyTorch version (counterpart of the JAX package's
``ops/flash_attention.py``).

Same signature as :func:`ops.attention.gqa_attention`: ``q`` ``[B, S, Hq,
D]``, ``k``/``v`` ``[B, T, Hkv, D]``, a boolean ``mask`` ``[B, S, T]``
(True = attend) that carries causality, cache validity, sliding window and
sink structure, so every cache policy works unchanged. The online softmax
walks the positions tile by tile and never materialises the ``[B, Hq, S,
T]`` scores; p is rounded to V's type before P V, and a fully masked row
gives zeros, as in the TPU kernel.

The shape rule is the JAX wrapper's: with ``bq = min(block_q, S)`` and
``bk = min(block_k, T)``, shapes where S or T does not tile, ``S < 8`` or a
mask that is not ``[B, S, T]`` go to :func:`gqa_attention` (the
reference's contract). Every other shape takes the kernel on a CUDA device,
or raises there for a head_dim or grouping it was not built for; CPU
tensors take :func:`flash_attention_plain`, which walks the TPU kernel's
``bk``-wide tiles.

``csrc/flash_attention.cu`` replaces the TPU kernel ``_flash_kernel``. In
bf16 a first pass reads the byte mask once (it is shared by every kv head)
into a bit-packed mask and a class per tile of 128 / Gp queries (Gp the
G query heads of a kv head rounded up to a power of two) by 128
positions (empty, full or partial, :func:`mask_tiles` is its plain
version); the main kernel then walks, per (query tile, kv head, row), only
the non-empty 128-wide steps (the TPU kernel's ``block_k``) with the
ragged kernel's Hopper design: K and V by TMA into a ring of stages, both
products on ``wgmma``, two consumer warpgroups in turn, a partial step
masked from the packed bits, the output by TMA. f32 runs FMA products over
64-wide steps (the file says what bounds it). K and V may be any strided
view whose rows of D are contiguous and whose strides are 16-byte
multiples (the int8 dense cache's gather path hands a transposed
head-major view). ``launches`` counts calls that launch the kernels (and
nothing else).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import (
    _NEG_INF, check_kernel_widths, gqa_attention, rows_per_query,
)

__all__ = ["flash_attention", "flash_attention_plain", "mask_tiles",
           "device_mask_tiles", "launches"]

# Calls of :func:`flash_attention` in this process that launched the kernels.
launches = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
STEP = 128          # kv positions a step of the bf16 kernel
MAX_STEPS = 1024    # steps a query tile can list (csrc/flash_attention.cu)
EMPTY, FULL, PARTIAL = 0, 1, 2
_fn = {}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    scale: Optional[float] = None,
    block_k: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version: the TPU kernel's online softmax over
    ``min(block_k, T)``-wide tiles of positions, scores in f32, p rounded to
    V's type before P V. Returns ``[B, S, Hq, D]`` in q's type."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, s, hkv, g, d).float()
    m = torch.full((b, hkv, g, s), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=q.device)
    bk = min(block_k, t)
    for j in range(0, t, bk):
        sc = torch.einsum("bskgd,btkd->bkgst", qg, k[:, j:j + bk].float())
        sc = sc * scale
        mk = mask[:, None, None, :, j:j + bk]
        sc = torch.where(mk, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(sc - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(v.dtype).float(), v[:, j:j + bk].float()
        )
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]            # [B, Hkv, G, S, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def mask_tiles(mask: torch.Tensor, block_q: int, step: int = STEP):
    """Plain version of the bf16 kernel's first pass: the boolean mask
    ``[B, S, T]`` bit-packed, ``bits`` int32 ``[B, S, 4 nKT]`` (bit i of
    word w of a row is position 32 w + i; nKT = ceil(T / step)), and the
    class of every tile of ``block_q`` queries by ``step`` positions,
    ``classes`` uint8 ``[B, nQT, nKT]``: EMPTY (no visible position), FULL
    (every position below T visible to every query below S) or PARTIAL.
    Positions past T are not visible."""
    b, s, t = mask.shape
    nkt, nqt = -(-t // step), -(-s // block_q)
    m = torch.zeros((b, s, nkt * step), dtype=torch.bool, device=mask.device)
    m[:, :, :t] = mask
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (m.reshape(b, s, nkt * step // 32, 32).long() * weights).sum(-1)
    bits = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    tiles = torch.zeros((b, nqt * block_q, nkt * step), dtype=torch.bool,
                        device=mask.device)
    tiles[:, :s] = m
    tiles = tiles.reshape(b, nqt, block_q, nkt, step)
    rows = (torch.arange(nqt * block_q, device=mask.device) < s).reshape(
        1, nqt, block_q, 1)
    cols = (torch.arange(nkt * step, device=mask.device) < t).reshape(
        nkt, step)
    any_ = tiles.any(dim=(2, 4))
    all_ = ((tiles | ~rows[..., None]) & cols).all(dim=(2, 4))
    classes = torch.where(any_, torch.where(all_, FULL, PARTIAL), EMPTY)
    return bits, classes.to(torch.uint8)


def _kernel(name: str = "dli_flash_attention"):
    fn = _fn.get(name)
    if fn is None:
        fn = getattr(_build.load_library("flash_attention"), name)
        if name == "dli_flash_attention":
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
                ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_int,
                                          ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn[name] = fn
    return fn


def _tile_scratch(b, s, t, block_q, device):
    """The bf16 kernel's packed mask and tile classes (see
    :func:`mask_tiles`) for query tiles of ``block_q`` queries."""
    nkt, nqt = -(-t // STEP), -(-s // block_q)
    return (torch.empty((b, s, 4 * nkt), dtype=torch.int32, device=device),
            torch.empty((b, nqt, nkt), dtype=torch.uint8, device=device))


def device_mask_tiles(mask: torch.Tensor, block_q: int):
    """The bf16 kernel's first pass alone on a CUDA ``mask``: what
    :func:`mask_tiles` computes, from the card."""
    b, s, t = mask.shape
    mask = mask.contiguous()
    bits, classes = _tile_scratch(b, s, t, block_q, mask.device)
    with torch.cuda.device(mask.device):
        err = _kernel("dli_flash_mask_tiles")(
            mask.data_ptr(), bits.data_ptr(), classes.data_ptr(), b, s, t,
            block_q, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash mask tiles: kernel launch failed ({err})")
    return bits, classes


def _launch(q, k, v, mask, scale):
    """Checks, output and one launch of the kernel."""
    name = "flash_attention"
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} (kernel takes bf16, f32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if tuple(v.shape) != tuple(k.shape) or tuple(k.shape) != (b, t, hkv, d):
        raise ValueError(f"{name}: k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{name}: {hq} query heads over {hkv} kv heads")
    check_kernel_widths(name, d, hq // hkv)
    if mask.dtype != torch.bool or tuple(mask.shape) != (b, s, t):
        raise ValueError(f"{name}: mask {mask.dtype} {tuple(mask.shape)}, "
                         f"want bool {(b, s, t)}")
    for label, x in (("k", k), ("v", v), ("mask", mask)):
        if x.device != q.device:
            raise ValueError(f"{name}: {label} on {x.device}, q on {q.device}")
    q, mask = q.contiguous(), mask.contiguous()
    align = 16 // q.element_size()
    for label, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
                st % align for st in x.stride()[:3]):
            raise ValueError(
                f"{name}: {label} rows of D must be contiguous and 16-byte "
                f"aligned, strides {x.stride()}")
    if -(-t // STEP) > MAX_STEPS:
        raise ValueError(f"{name}: T = {t} above {STEP * MAX_STEPS}")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    bits, classes = _tile_scratch(b, s, t, 128 // rows_per_query(hq // hkv),
                                  q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), bits.data_ptr(), classes.data_ptr(), b, s, t,
            hkv, hq // hkv, d, k.stride(0),
            k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Drop-in for :func:`gqa_attention` on shapes the tiling accepts; the
    others (decode steps, shapes that do not tile) take
    :func:`gqa_attention`, as in the JAX package.

    ``q``: ``[B, S, Hq, D]``; ``k``/``v``: ``[B, T, Hkv, D]``; ``mask``:
    bool ``[B, S, T]`` (True = attend)."""
    global launches
    s, t = q.shape[1], k.shape[1]
    bq, bk = min(block_q, s), min(block_k, t)
    if s % bq or t % bk or s < 8 or mask is None or mask.ndim != 3:
        return gqa_attention(q, k, v, mask, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, scale, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = _launch(q, k, v, mask, scale)
    launches += 1
    return out
