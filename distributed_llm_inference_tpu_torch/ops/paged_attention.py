"""Paged decode attention: a CUDA kernel that reads K/V in place from the
page pool, and its plain PyTorch version.

Replaces the TPU kernel ``_paged_kernel`` behind ``paged_attention`` in the
JAX package's ``ops/paged_attention.py``. On this card the function is bound
by bytes: every live K and V slot is read once for a handful of dot
products. ``csrc/paged_attention.cu`` walks only the live positions of each
row (nothing is fetched for dead table slots), gives each position to a
group of 8 lanes with 16-byte loads, keeps the online-softmax state in
f32 registers, and splits a row's positions over several blocks whose
partial results a second small kernel merges; this wrapper sizes the split
and allocates its scratch.

The wrapper launches the kernel for CUDA tensors and raises on anything the
kernel does not take; it uses the plain version only for tensors that lie on
the CPU. ``launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import _NEG_INF

__all__ = ["paged_attention", "paged_attention_plain", "launches"]

# Kernel launches made by :func:`paged_attention` in this process.
launches = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MIN_SPLIT = 256  # positions: a block is not worth less
_fn = None
_sm_count = {}


def split_plan(device, pairs: int, span: int):
    """How many blocks share one (row, kv head)'s ``span`` table positions,
    and how many positions each takes: about two blocks per SM over all
    ``pairs``, at least ``_MIN_SPLIT`` positions each, in whole 64s. Sized
    from the table width, which the host knows, not from the lengths, which
    live on the device."""
    sms = _sm_count.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device] = sms
    num = max(1, min(-(-2 * sms // pairs), -(-span // _MIN_SPLIT)))
    chunk = -(-(-(-span // num)) // 64) * 64
    return num, chunk


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("paged_attention").dli_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_kernel_inputs(name, q, k_pages, v_pages, page_table, vectors):
    """Shared argument checks of the two kernel wrappers: one CUDA device,
    bf16 or f32 throughout, contiguous, int32 indices, supported widths."""
    dev = q.device
    for label, t in (("k_pages", k_pages), ("v_pages", v_pages),
                     ("page_table", page_table), *vectors):
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} (kernel takes bf16, f32)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"{name}: q {q.dtype}, k_pages {k_pages.dtype}, v_pages "
            f"{v_pages.dtype} must agree"
        )
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError(
            f"{name}: pools must both be [P, Hkv, PS, D], got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )
    hq, d = q.shape[2], q.shape[3]
    hkv = k_pages.shape[1]
    if k_pages.shape[3] != d or hq % hkv != 0:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} does not match pools "
            f"{tuple(k_pages.shape)}"
        )
    if d != 128 or hq // hkv not in (1, 4):
        raise ValueError(
            f"{name}: the kernels are built for head_dim 128 and 1 or 4 "
            f"query heads per kv head, got head_dim {d}, group {hq // hkv}"
        )
    for label, t in (("page_table", page_table), *vectors):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    b = q.shape[0]
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)}")
    for label, t in vectors:
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name}: {label} {tuple(t.shape)}, want ({b},)")
    for label, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                     ("page_table", page_table), *vectors):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    return _DTYPE_CODE[q.dtype]


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``[P, Hkv, PS, D]`` pool + ``[B, T]`` table → the contiguous
    ``[B, T*PS, Hkv, D]`` view (slot order = position order)."""
    b, t = page_table.shape
    _, hkv, ps, d = pages.shape
    g = pages[page_table.long()]              # [B, T, Hkv, PS, D]
    return g.permute(0, 1, 3, 2, 4).reshape(b, t * ps, hkv, d)


def paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Plain PyTorch version of :func:`paged_attention`: gather the row's
    pages, mask, softmax in f32. Same arguments and results."""
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"paged_attention is decode-only (S=1), got S={s}")
    hkv = k_pages.shape[1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    if q_positions is None:
        q_positions = kv_lengths - 1

    k = gather_pages(k_pages, page_table).float()      # [B, KV, Hkv, D]
    v = gather_pages(v_pages, page_table).float()
    qr = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bthd->bhgt", qr, k) * scale
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = pos < kv_lengths[:, None]
    if sliding_window is not None:
        valid = valid & (pos > q_positions[:, None] - sliding_window)
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, _NEG_INF)
    m = scores.amax(dim=-1)                            # [B, Hkv, G]
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v) / l.clamp_min(1e-20)[..., None]
    out = out.reshape(b, 1, hq, d).to(q.dtype)
    if return_stats:
        return out, m, l
    return out


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Decode attention straight over the page pool.

    ``q``: ``[B, 1, Hq, D]`` (already rotated); ``k_pages``/``v_pages``:
    ``[P, Hkv, page_size, D]`` — one layer's pool, keys stored rotated;
    ``page_table``: ``[B, T]`` int32 physical page ids (slot order = position
    order, 0 = null page); ``kv_lengths``: ``[B]`` int32 live kv count per
    row; ``q_positions``: ``[B]`` int32 absolute query positions (defaults to
    ``kv_lengths - 1``), which only the sliding window reads. Returns
    ``[B, 1, Hq, D]``, or with ``return_stats`` a tuple ``(out, m, l)`` with
    ``m``/``l`` ``[B, Hkv, G]`` fp32 online-softmax stats for merging with
    another segment (``merge_softmax_segments``). A row with
    ``kv_lengths == 0`` gives zeros, ``m = _NEG_INF``, ``l = 0``.
    """
    global launches
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, page_table, kv_lengths, scale,
            sliding_window, q_positions, return_stats,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"paged_attention is decode-only (S=1), got S={s}")
    if q_positions is None:
        q_positions = kv_lengths - 1
    code = check_kernel_inputs(
        "paged_attention", q, k_pages, v_pages, page_table,
        (("kv_lengths", kv_lengths), ("q_positions", q_positions)),
    )
    _, hkv, page_size, _ = k_pages.shape
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    width = page_table.shape[1]
    num_splits, chunk = split_plan(q.device, b * hkv, width * page_size)
    out = torch.empty_like(q)
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    part_o = torch.empty(
        (b, hkv, num_splits, g, d), dtype=torch.float32, device=q.device
    )
    part_ml = torch.empty(
        (2, b, hkv, num_splits, g), dtype=torch.float32, device=q.device
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_lengths.data_ptr(),
            q_positions.data_ptr(), out.data_ptr(), m.data_ptr(),
            l.data_ptr(), part_o.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), b, hkv, g, d, page_size, width,
            num_splits, chunk, float(scale), int(sliding_window or 0), code,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention: kernel launch failed ({err})")
    launches += 1
    if return_stats:
        return out, m, l
    return out
