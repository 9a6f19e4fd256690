"""Fused decode step over int8 K/V with an int8 write-behind tail: a CUDA
kernel over contiguous int8 stacks, and its plain PyTorch version
(counterpart of ``quantized_fused_decode_attention`` in the JAX package's
``ops/quant_attention.py``).

One call is one (layer, step) of the fused K-step decode window
(``models/llama.py:multi_decode_apply``): it quantizes the step's new K/V
per (row, kv head) as ``cache/dense.py:_quantize_kv`` does, writes them into
tail slot ``step_idx`` of layer ``layer_idx`` for every row (a finished
row's write is garbage that its shorter ``tail_valid_len`` never reads),
and runs one online softmax over the row's live big-segment positions and
then the tail. The tail planes are updated IN PLACE (the JAX kernel aliases
them) and returned.

The arithmetic is the TPU kernel's, rounding included: ``q`` and ``p * vs``
are rounded to bf16 before the products (int8 K and V are exact in bf16),
scores are ``(q . k) * ks * scale``, and the softmax walks the same tiles
in the same order: ``min(256, T)`` positions of the stacks, then the tail
as one tile. The running max at each tile decides how ``p * vs`` rounds, so
an f32 run agrees with the JAX kernel to 2e-5 only on the same tiles.
:func:`online_softmax_tiles` is that walk, shared with the paged form in
``ops/paged_attention.py``.

``csrc/quant_attention.cu`` (the kernel, via ``csrc/fused_decode.cuh``)
replaces the TPU kernel ``_qfused_kernel``: one launch of a thread-block
cluster per (row, kv head) that deals the tiles to its blocks as pieces
of at most 64 positions (never across a tile's edge), exchanges
their maxima and sums through distributed shared memory and allocates no
scratch. ``step_idx`` is a one-element
int32 tensor on the data's device, read by the kernel from device memory,
so a CUDA graph of the step serves every step of a window; ``layer_idx``
is a host integer. The wrapper launches the kernel for CUDA tensors and
raises on anything the kernel does not take; it uses the plain version only
for tensors that lie on the CPU. ``fused_launches`` counts kernel launches
(and nothing else).

The int8 dense cache (``cache/dense.py:QuantizedDenseKVCache``, head-major
``[L, B, Hkv, T, D]`` int8 with ``[L, B, Hkv, T]`` f32 scales) adds two
kernels in the same source. ``quantized_decode_attention`` replaces
``_qdense_kernel``: one decode token a row over one layer's buffer, scores
``(q . k) * ks * scale``. For bf16 queries it is one launch of the paged
decode cluster kernel (``csrc/paged_decode.cuh``) over the buffer as one
run of ``B * Hkv * T`` rows, with no scratch, ``p * vs`` entering P V as
two bf16 terms (hi and the rest); for f32 queries the walk of
``csrc/decode_attention.cuh`` with no table, ``p * vs`` in f32.
``fused_tail_flush`` replaces the TPU kernel of that name:
the fused window's int8 tail written into the buffers at each row's
``base_len``, in place (the TPU kernel aliases them), nothing at or past T;
the bytes equal ``cache/dense.py:_tail_flush_rows``'s. It is one launch of
``csrc/tail_flush.cuh``'s kernel, which the pool's flush and the ring's
share, each a destination policy: blocks of a few kv heads of a (row,
layer), every thread's loads issued before its stores. ``decode_launches``
and ``flush_launches`` count their launches.

The int8 sink ring (``cache/sink.py:QuantizedSinkKVCache``) adds two more,
in ``csrc/sink_attention.cu``. ``sink_fused_decode_attention`` replaces
``_qsink_kernel``: the fused step as above over three segments in this
order, the ring in tiles of :func:`ring_tile_width` (its evicted slots
masked), one tile of sinks scored with a second query, the tail; one
launch of the same cluster kernel, the ring's tiles dealt as pieces of
:func:`ring_piece_width`, no scratch.
``sink_tail_flush`` replaces the TPU kernel of that name: the tail written
into the ring at slots that wrap mod ``ring_slots``, a direct scatter whose
bytes equal ``cache/sink.py``'s gather-and-select merge, one launch of the
same flush kernel. ``sink_launches``
and ``sink_flush_launches`` count their launches.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Optional, Tuple

import torch

from . import _build
from .attention import _NEG_INF, check_kernel_widths

__all__ = [
    "quantized_fused_decode_attention",
    "quantized_fused_decode_attention_plain",
    "online_softmax_tiles",
    "write_tail_slot",
    "quantized_decode_attention",
    "quantized_decode_attention_plain",
    "fused_tail_flush",
    "fused_tail_flush_plain",
    "sink_fused_decode_attention",
    "sink_fused_decode_attention_plain",
    "sink_tail_flush",
    "sink_tail_flush_plain",
    "ring_tile_width",
    "ring_piece_width",
    "fused_launches",
    "decode_launches",
    "flush_launches",
    "sink_launches",
    "sink_flush_launches",
]

# Kernel launches made by :func:`quantized_fused_decode_attention` /
# :func:`quantized_decode_attention` / :func:`fused_tail_flush` /
# :func:`sink_fused_decode_attention` / :func:`sink_tail_flush` in this
# process.
fused_launches = 0
decode_launches = 0
flush_launches = 0
sink_launches = 0
sink_flush_launches = 0

BLOCK_T = 256  # the TPU kernel's time tile over the stacks
MAX_TILE = 256  # widest tile the CUDA kernel takes (csrc/fused_decode.cuh)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_fns = {}


def _lane_order_dot(qb: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q . k`` over D summed in the CUDA kernel's order: D split into
    lanes of 16 elements, each lane adding its 16 products in turn, then
    the lanes combined pairwise (halves, quarters, ...). The products of a
    bf16 q and int8 k are exact in f32, so the score comes out bit for bit
    as the kernel's; ``p = exp(s - m)`` then does too, and so does its
    rounding to bf16 (a score one ulp apart can round ``p * vs`` to the
    neighbouring bf16 value). ``qb`` ``[B, H, G, D]``, ``k`` ``[B, H, W,
    D]`` → ``[B, H, G, W]``."""
    d = qb.shape[-1]
    prods = qb[:, :, :, None, :] * k[:, :, None, :, :].float()
    lanes = prods.reshape(*prods.shape[:-1], max(1, d // 16), min(16, d))
    acc = lanes[..., 0]
    for e in range(1, lanes.shape[-1]):
        acc = acc + lanes[..., e]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def online_softmax_tiles(q: torch.Tensor, tiles: Iterable, scale: float):
    """The fused kernels' softmax walk, tile by tile in order.

    ``q``: ``[B, Hkv, G, D]``; each tile ``(k, ks, v, vs, valid)`` with int8
    ``k``/``v`` ``[B, Hkv, W, D]``, f32 scales ``[B, Hkv, W]`` and ``valid``
    ``[B, W]``, or ``(k, ks, v, vs, valid, q_tile)`` to score that tile
    with a query of its own (the sink ring's sink tile). ``q`` and ``p *
    vs`` are rounded to bf16 before the products, as the TPU kernels do,
    and the scores are summed in the CUDA kernel's order
    (:func:`_lane_order_dot`). Returns ``[B, Hkv, G, D]`` f32; a row with
    nothing valid gives zeros."""
    b, hkv, g, d = q.shape
    qb = q.to(torch.bfloat16).float()
    m = torch.full((b, hkv, g), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for k, ks, v, vs, valid, *own in tiles:
        qt = own[0].to(torch.bfloat16).float() if own else qb
        s = _lane_order_dot(qt, k) * ks[:, :, None, :] * scale
        vmask = valid[:, None, None, :]
        s = torch.where(vmask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vmask, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(dim=-1)
        pw = (p * vs[:, :, None, :]).to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgw,bhwd->bhgd", pw, v.float()
        )
        m = m_new
    return acc / l.clamp_min(1e-20)[..., None]


def write_tail_slot(k_new, v_new, tail_k, tail_ks, tail_v, tail_vs,
                    layer_idx: int, step_idx: torch.Tensor) -> None:
    """Quantize the step's ``[B, 1, Hkv, D]`` K/V (``_quantize_kv``) into
    tail slot ``step_idx`` of layer ``layer_idx``, in place."""
    from ..cache.dense import _quantize_kv

    kq, ksc = _quantize_kv(k_new)       # [B, 1, Hkv, D], [B, 1, Hkv]
    vq, vsc = _quantize_kv(v_new)
    slot = step_idx.reshape(1).long()
    tail_k[layer_idx].index_copy_(2, slot, kq.transpose(1, 2))
    tail_v[layer_idx].index_copy_(2, slot, vq.transpose(1, 2))
    tail_ks[layer_idx].index_copy_(2, slot, ksc.transpose(1, 2))
    tail_vs[layer_idx].index_copy_(2, slot, vsc.transpose(1, 2))


def tail_tile(tail_k, tail_ks, tail_v, tail_vs, layer_idx, base_len,
              tail_valid_len, q_positions, sliding_window):
    """The tail of layer ``layer_idx`` as the walk's last tile."""
    kt = tail_k.shape[3]
    slots = torch.arange(kt, dtype=torch.int32, device=base_len.device)[None]
    valid = slots < tail_valid_len[:, None]
    if sliding_window is not None:
        valid &= base_len[:, None] + slots > q_positions[:, None] - sliding_window
    return (tail_k[layer_idx], tail_ks[layer_idx], tail_v[layer_idx],
            tail_vs[layer_idx], valid)


def _positions_valid(pos, base_len, q_positions, sliding_window):
    valid = pos[None, :] < base_len[:, None]
    if sliding_window is not None:
        valid &= pos[None, :] > q_positions[:, None] - sliding_window
    return valid


def quantized_fused_decode_attention_plain(
    q, k_new, v_new, big_k, big_ks, big_v, big_vs,
    tail_k, tail_ks, tail_v, tail_vs, layer_idx: int,
    step_idx: torch.Tensor, base_len, tail_valid_len, q_positions,
    scale: Optional[float] = None, sliding_window: Optional[int] = None,
):
    """Plain PyTorch version of :func:`quantized_fused_decode_attention`:
    the same arguments and results, the same tiles."""
    b, _, hq, d = q.shape
    hkv, t = big_k.shape[2], big_k.shape[3]
    if scale is None:
        scale = d**-0.5
    write_tail_slot(k_new, v_new, tail_k, tail_ks, tail_v, tail_vs,
                    layer_idx, step_idx)
    bt = min(BLOCK_T, t)

    def tiles():
        for j in range(0, t, bt):
            pos = torch.arange(j, min(j + bt, t), dtype=torch.int32,
                               device=q.device)
            yield (big_k[layer_idx, :, :, j:j + bt],
                   big_ks[layer_idx, :, :, j:j + bt],
                   big_v[layer_idx, :, :, j:j + bt],
                   big_vs[layer_idx, :, :, j:j + bt],
                   _positions_valid(pos, base_len, q_positions,
                                    sliding_window))
        yield tail_tile(tail_k, tail_ks, tail_v, tail_vs, layer_idx,
                        base_len, tail_valid_len, q_positions, sliding_window)

    out = online_softmax_tiles(q.reshape(b, hkv, hq // hkv, d), tiles(), scale)
    return (out.reshape(b, 1, hq, d).to(q.dtype), tail_k, tail_ks, tail_v,
            tail_vs)


def check_fused_inputs(name, q, k_new, v_new, planes, vectors, step_idx):
    """Argument checks shared by the fused kernels' wrappers: one CUDA
    device, bf16/f32 q, k_new, v_new of one type, int8 planes with f32
    scale planes, int32 ``[B]`` vectors and step, contiguous, head_dim 64
    or 128, 1 to 8 query heads per kv head. ``planes``: ``(label, tensor,
    dtype)``."""
    dev = q.device
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"{name} is decode-only (S=1), got S={s}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} (kernel takes bf16, f32)")
    hkv = k_new.shape[2]
    for label, t_ in (("k_new", k_new), ("v_new", v_new)):
        if t_.dtype != q.dtype or tuple(t_.shape) != (b, 1, hkv, d):
            raise ValueError(
                f"{name}: {label} {t_.dtype} {tuple(t_.shape)}, want "
                f"{q.dtype} {(b, 1, hkv, d)}")
    if hq % hkv:
        raise ValueError(f"{name}: {hq} query heads over {hkv} kv heads")
    check_kernel_widths(name, d, hq // hkv)
    for label, t_, dt in planes:
        if t_.dtype != dt:
            raise TypeError(f"{name}: {label} must be {dt}, got {t_.dtype}")
    for label, t_ in (*vectors, ("step_idx", step_idx)):
        if t_.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t_.dtype}")
    for label, t_ in vectors:
        if tuple(t_.shape) != (b,):
            raise ValueError(f"{name}: {label} {tuple(t_.shape)}, want ({b},)")
    if step_idx.numel() != 1:
        raise ValueError(f"{name}: step_idx must hold one value")
    every = (("q", q), ("k_new", k_new), ("v_new", v_new),
             *((lab, t_) for lab, t_, _ in planes), *vectors,
             ("step_idx", step_idx))
    for label, t_ in every:
        if t_.device != dev:
            raise ValueError(f"{name}: {label} on {t_.device}, q on {dev}")
        if not t_.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t_.data_ptr() % 16 and t_.dim() >= 4:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    return _DTYPE_CODE[q.dtype]


def _tail_planes(tail_k, tail_ks, tail_v, tail_vs, num_l, b, hkv, d):
    kt = tail_k.shape[3]
    if kt < 1 or kt > MAX_TILE:
        raise ValueError(f"tail length {kt} outside 1..{MAX_TILE}")
    for label, t_, shape in (("tail_k", tail_k, (num_l, b, hkv, kt, d)),
                             ("tail_v", tail_v, (num_l, b, hkv, kt, d)),
                             ("tail_ks", tail_ks, (num_l, b, hkv, kt)),
                             ("tail_vs", tail_vs, (num_l, b, hkv, kt))):
        if tuple(t_.shape) != shape:
            raise ValueError(f"{label} {tuple(t_.shape)}, want {shape}")
    return kt


def _kernel():
    fn = _fns.get("fused")
    if fn is None:
        fn = _build.load_library(
            "quant_attention").dli_quantized_fused_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns["fused"] = fn
    return fn


def quantized_fused_decode_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    big_k: torch.Tensor,
    big_ks: torch.Tensor,
    big_v: torch.Tensor,
    big_vs: torch.Tensor,
    tail_k: torch.Tensor,
    tail_ks: torch.Tensor,
    tail_v: torch.Tensor,
    tail_vs: torch.Tensor,
    layer_idx: int,
    step_idx: torch.Tensor,
    base_len: torch.Tensor,
    tail_valid_len: torch.Tensor,
    q_positions: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """One fused-decode attention step over contiguous int8 stacks.

    ``q``: ``[B, 1, Hq, D]`` (rotated); ``k_new``/``v_new`` ``[B, 1, Hkv,
    D]`` (k rotated); big stacks ``[L, B, Hkv, T, D]`` int8 (+ ``[L, B, Hkv,
    T]`` f32 scales); tail planes ``[L, B, Hkv, KT, D]`` (+ scales).
    ``layer_idx``: host int; ``step_idx``: one int32 on the device;
    ``base_len`` ``[B]`` live big-segment length; ``tail_valid_len`` ``[B]``
    = ``tail_len + num_new`` (valid tail slots after this write);
    ``q_positions`` ``[B]`` = ``base_len + tail_len`` anchors the sliding
    window. Returns ``(out [B, 1, Hq, D], tail_k, tail_ks, tail_v,
    tail_vs)``, the tail planes updated in place."""
    global fused_launches
    args = (q, k_new, v_new, big_k, big_ks, big_v, big_vs, tail_k, tail_ks,
            tail_v, tail_vs, layer_idx, step_idx, base_len, tail_valid_len,
            q_positions, scale, sliding_window)
    if q.device.type == "cpu":
        return quantized_fused_decode_attention_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"quantized_fused_decode_attention: device {q.device}")
    name = "quantized_fused_decode_attention"
    code = check_fused_inputs(
        name, q, k_new, v_new,
        (("big_k", big_k, torch.int8), ("big_v", big_v, torch.int8),
         ("big_ks", big_ks, torch.float32), ("big_vs", big_vs, torch.float32),
         ("tail_k", tail_k, torch.int8), ("tail_v", tail_v, torch.int8),
         ("tail_ks", tail_ks, torch.float32),
         ("tail_vs", tail_vs, torch.float32)),
        (("base_len", base_len), ("tail_valid_len", tail_valid_len),
         ("q_positions", q_positions)), step_idx)
    b, _, hq, d = q.shape
    num_l, _, hkv, t, _ = big_k.shape
    if tuple(big_k.shape) != (num_l, b, hkv, t, d) or big_v.shape != big_k.shape:
        raise ValueError(f"{name}: big stacks {tuple(big_k.shape)}")
    if tuple(big_ks.shape) != (num_l, b, hkv, t) or big_vs.shape != big_ks.shape:
        raise ValueError(f"{name}: big scales {tuple(big_ks.shape)}")
    kt = _tail_planes(tail_k, tail_ks, tail_v, tail_vs, num_l, b, hkv, d)
    if not 0 <= layer_idx < num_l:
        raise ValueError(f"{name}: layer {layer_idx} outside 0..{num_l - 1}")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            big_k.data_ptr(), big_ks.data_ptr(), big_v.data_ptr(),
            big_vs.data_ptr(), tail_k.data_ptr(), tail_ks.data_ptr(),
            tail_v.data_ptr(), tail_vs.data_ptr(), base_len.data_ptr(),
            tail_valid_len.data_ptr(), q_positions.data_ptr(),
            step_idx.data_ptr(), out.data_ptr(), b, hkv, hq // hkv, d, t,
            min(BLOCK_T, t), kt, int(layer_idx), float(scale),
            int(sliding_window or 0), code,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    fused_launches += 1
    return out, tail_k, tail_ks, tail_v, tail_vs


# ---------------------------------------------------------------------------
# The int8 dense cache: decode at one token per dispatch, and the tail flush
# ---------------------------------------------------------------------------


def quantized_decode_attention_plain(
    q: torch.Tensor,
    k_q: torch.Tensor,
    ks: torch.Tensor,
    v_q: torch.Tensor,
    vs: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_decode_attention`: one
    softmax over the row's positions, everything f32."""
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"quantized_decode_attention is decode-only (S=1), got S={s}")
    hkv, t = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    if q_positions is None:
        q_positions = kv_lengths - 1
    qr = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bhtd->bhgt", qr, k_q.float())
    scores = scores * ks[:, :, None, :] * scale
    pos = torch.arange(t, device=q.device)[None, :]
    valid = pos < kv_lengths[:, None]
    if sliding_window is not None:
        valid = valid & (pos > q_positions[:, None] - sliding_window)
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p * vs[:, :, None, :], v_q.float())
    out = out / l.clamp_min(1e-20)[..., None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def quantized_decode_attention(
    q: torch.Tensor,
    k_q: torch.Tensor,
    ks: torch.Tensor,
    v_q: torch.Tensor,
    vs: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention straight over one layer of the int8 head-major
    dense cache.

    ``q``: ``[B, 1, Hq, D]`` (rotated); ``k_q``/``v_q``: int8 ``[B, Hkv, T,
    D]`` (keys rotated); ``ks``/``vs``: f32 ``[B, Hkv, T]``; ``kv_lengths``
    ``[B]`` int32 live positions a row, this step's included;
    ``q_positions`` ``[B]`` (default ``kv_lengths - 1``) anchors the
    sliding window. Returns ``[B, 1, Hq, D]`` in q's type; a row with no
    live position gives zeros."""
    global decode_launches
    args = (q, k_q, ks, v_q, vs, kv_lengths, scale, sliding_window,
            q_positions)
    if q.device.type == "cpu":
        return quantized_decode_attention_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"quantized_decode_attention: device {q.device}")
    from . import paged_attention as pa

    name = "quantized_decode_attention"
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"{name} is decode-only (S=1), got S={s}")
    if q_positions is None:
        # Only the sliding window reads the query positions: without one
        # the kernels never do, and no kernel is launched to make them.
        q_positions = kv_lengths - 1 if sliding_window else kv_lengths
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} (kernel takes bf16, f32)")
    hkv, t = k_q.shape[1], k_q.shape[2]
    if hq % hkv:
        raise ValueError(f"{name}: {hq} query heads over {hkv} kv heads")
    check_kernel_widths(name, d, hq // hkv)
    for label, t_, dt, shape in (
            ("k_q", k_q, torch.int8, (b, hkv, t, d)),
            ("v_q", v_q, torch.int8, (b, hkv, t, d)),
            ("ks", ks, torch.float32, (b, hkv, t)),
            ("vs", vs, torch.float32, (b, hkv, t)),
            ("kv_lengths", kv_lengths, torch.int32, (b,)),
            ("q_positions", q_positions, torch.int32, (b,))):
        if t_.dtype != dt or tuple(t_.shape) != shape:
            raise ValueError(f"{name}: {label} {t_.dtype} {tuple(t_.shape)}, "
                             f"want {dt} {shape}")
        if t_.device != q.device or not t_.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous on {q.device}")
    q = q.contiguous()
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    planes = (q.data_ptr(), k_q.data_ptr(), ks.data_ptr(), v_q.data_ptr(),
              vs.data_ptr(), kv_lengths.data_ptr(), q_positions.data_ptr(),
              out.data_ptr())
    if q.dtype == torch.bfloat16:
        # One launch of the cluster kernel (csrc/paged_decode.cuh), no
        # scratch: its TMA maps name the buffer's B * Hkv * T rows by 32-bit
        # coordinates, 16-byte aligned.
        if b * hkv * t >= 2**31:
            raise ValueError(f"{name}: {b} x {hkv} x {t} rows is 2^31 or more")
        if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
            raise ValueError(f"{name}: k_q and v_q must be 16-byte aligned")
        with torch.cuda.device(q.device):
            err = _decode_fn("bf16")(
                *planes, None, None, b, hkv, g, d, t,
                pa.cluster_size(q.device, b * hkv, t),
                float(scale), int(sliding_window or 0),
                torch.cuda.current_stream().cuda_stream)
    else:
        num_splits, chunk = pa.split_plan(q.device, b * hkv, t)
        ml = torch.empty((2, b, hkv, g), dtype=torch.float32, device=q.device)
        part_o = torch.empty((b, hkv, num_splits, g, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((2, b, hkv, num_splits, g), dtype=torch.float32,
                              device=q.device)
        with torch.cuda.device(q.device):
            err = _decode_fn("f32")(
                *planes, ml[0].data_ptr(), ml[1].data_ptr(),
                part_o.data_ptr(), part_ml[0].data_ptr(),
                part_ml[1].data_ptr(), b, hkv, g, d, t, num_splits, chunk,
                float(scale), int(sliding_window or 0), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    decode_launches += 1
    return out


# C entry of each form of quantized_decode_attention: (symbol, pointer
# arguments, int arguments before the scale, int arguments after it).
_DECODE_ENTRIES = {
    "bf16": ("dli_quantized_decode_attention_bf16", 10, 6, 1),
    "f32": ("dli_quantized_decode_attention", 13, 7, 2),
}


def _decode_fn(form: str):
    """The C entry of ``quantized_decode_attention``: "bf16" queries (the
    cluster kernel) or "f32" (the split walk)."""
    fn = _fns.get(("decode", form))
    if fn is None:
        symbol, pointers, ints, after = _DECODE_ENTRIES[form]
        fn = getattr(_build.load_library("quant_attention"), symbol)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
            ctypes.c_float, *[ctypes.c_int] * after, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[("decode", form)] = fn
    return fn


def _flush_targets(t: int, base_len, tail_len, kt: int):
    """``(rows, tail slots, positions)`` of every tail slot ``i <
    tail_len`` whose position ``base_len + i`` lies below ``t``."""
    i = torch.arange(kt, device=base_len.device)[None, :]
    pos = base_len[:, None].long() + i
    keep = (i < tail_len[:, None]) & (pos < t)
    rows, slots = keep.nonzero(as_tuple=True)
    return rows, slots, pos[rows, slots]


def fused_tail_flush_plain(big_k, big_ks, big_v, big_vs, tail_k, tail_ks,
                           tail_v, tail_vs, base_len, tail_len):
    """Plain PyTorch version of :func:`fused_tail_flush`: the same
    arguments and results."""
    rows, slots, pos = _flush_targets(big_k.shape[3], base_len, tail_len,
                                      tail_k.shape[3])
    # [N, L, Hkv(, D)] values of the kept slots on both sides.
    big_k[:, rows, :, pos] = tail_k[:, rows, :, slots]
    big_v[:, rows, :, pos] = tail_v[:, rows, :, slots]
    big_ks[:, rows, :, pos] = tail_ks[:, rows, :, slots]
    big_vs[:, rows, :, pos] = tail_vs[:, rows, :, slots]
    return big_k, big_ks, big_v, big_vs


def fused_tail_flush(
    big_k: torch.Tensor,
    big_ks: torch.Tensor,
    big_v: torch.Tensor,
    big_vs: torch.Tensor,
    tail_k: torch.Tensor,
    tail_ks: torch.Tensor,
    tail_v: torch.Tensor,
    tail_vs: torch.Tensor,
    base_len: torch.Tensor,
    tail_len: torch.Tensor,
):
    """Merge the fused window's int8 tail into the dense buffers, in place.

    ``big_*``: ``[L, B, Hkv, T, D]`` int8 / ``[L, B, Hkv, T]`` f32;
    ``tail_*``: ``[L, B, Hkv, KT, D]`` / ``[L, B, Hkv, KT]``;
    ``base_len``/``tail_len`` ``[B]`` int32, ``tail_len`` in ``[0, KT]``.
    Tail slot ``i < tail_len[b]`` of row ``b`` goes to position
    ``base_len[b] + i``; nothing is written at or past T. Returns the four
    big planes ``(k, ks, v, vs)``."""
    global flush_launches
    args = (big_k, big_ks, big_v, big_vs, tail_k, tail_ks, tail_v, tail_vs,
            base_len, tail_len)
    if big_k.device.type == "cpu":
        return fused_tail_flush_plain(*args)
    if big_k.device.type != "cuda":
        raise ValueError(f"fused_tail_flush: device {big_k.device}")
    num_l, b, hkv, t, d = big_k.shape
    kt = tail_k.shape[3]
    for label, t_, dt, shape in (
            ("big_k", big_k, torch.int8, (num_l, b, hkv, t, d)),
            ("big_v", big_v, torch.int8, (num_l, b, hkv, t, d)),
            ("big_ks", big_ks, torch.float32, (num_l, b, hkv, t)),
            ("big_vs", big_vs, torch.float32, (num_l, b, hkv, t)),
            ("tail_k", tail_k, torch.int8, (num_l, b, hkv, kt, d)),
            ("tail_v", tail_v, torch.int8, (num_l, b, hkv, kt, d)),
            ("tail_ks", tail_ks, torch.float32, (num_l, b, hkv, kt)),
            ("tail_vs", tail_vs, torch.float32, (num_l, b, hkv, kt)),
            ("base_len", base_len, torch.int32, (b,)),
            ("tail_len", tail_len, torch.int32, (b,))):
        if t_.dtype != dt or tuple(t_.shape) != shape:
            raise ValueError(f"fused_tail_flush: {label} {t_.dtype} "
                             f"{tuple(t_.shape)}, want {dt} {shape}")
        if t_.device != big_k.device or not t_.is_contiguous():
            raise ValueError(f"fused_tail_flush: {label} must be contiguous "
                             f"on {big_k.device}")
    if d % 16:
        raise ValueError(f"fused_tail_flush: head_dim {d} not a multiple of 16")
    fn = _fns.get("flush")
    if fn is None:
        fn = _build.load_library("quant_attention").dli_fused_tail_flush
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["flush"] = fn
    with torch.cuda.device(big_k.device):
        err = fn(big_k.data_ptr(), big_ks.data_ptr(), big_v.data_ptr(),
                 big_vs.data_ptr(), tail_k.data_ptr(), tail_ks.data_ptr(),
                 tail_v.data_ptr(), tail_vs.data_ptr(), base_len.data_ptr(),
                 tail_len.data_ptr(), num_l, b, hkv, t, kt, d,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tail_flush: kernel launch failed ({err})")
    flush_launches += 1
    return big_k, big_ks, big_v, big_vs


# ---------------------------------------------------------------------------
# The int8 sink ring: the fused decode step (#11) and the mod-ring flush (#12)
# ---------------------------------------------------------------------------


def ring_tile_width(tr: int) -> int:
    """The sink step's tile over the ring: the largest multiple of 32 up to
    ``BLOCK_T`` that divides ``tr`` (the ring pads its span to a multiple
    of 32), so that no tile straddles the planes' end; 32 at worst. Window
    1024 with 4 sinks: 256; ``tr`` 1056: 96."""
    for cand in range(min(BLOCK_T, tr), 31, -32):
        if tr % cand == 0:
            return cand
    return 32


def ring_piece_width(tile: int) -> int:
    """The cluster kernel's piece of a ring tile (``csrc/sink_attention.cu``):
    64 slots where 64 divides the tile, else 32 (tiles are multiples of 32),
    so that no piece crosses a tile's edge. 256-wide tiles: 64; 96: 32."""
    return 64 if tile % 64 == 0 else 32


def sink_fused_decode_attention_plain(
    q, q_sink, k_new, v_new, big_k, big_ks, big_v, big_vs,
    sink_k, sink_ks, sink_v, sink_vs, tail_k, tail_ks, tail_v, tail_vs,
    layer_idx: int, step_idx: torch.Tensor, ring_len, ring_ptr, evict_len,
    sink_len, tail_valid_len, ring_slots: int, scale: Optional[float] = None,
):
    """Plain PyTorch version of :func:`sink_fused_decode_attention`: the
    same arguments and results, the same tiles in the same order (the ring
    in :func:`ring_tile_width` tiles, the sink tile scored with
    ``q_sink``, the tail)."""
    b, _, hq, d = q.shape
    hkv, t = big_k.shape[2], big_k.shape[3]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    write_tail_slot(k_new, v_new, tail_k, tail_ks, tail_v, tail_vs,
                    layer_idx, step_idx)
    bt = ring_tile_width(t)
    dev = q.device

    def tiles():
        for j in range(0, t, bt):
            slot = torch.arange(j, j + bt, dtype=torch.int32, device=dev)[None]
            dd = slot - ring_ptr[:, None]
            dd = dd + torch.where(dd < 0, ring_slots, 0)
            valid = (slot < ring_len[:, None]) & (dd >= evict_len[:, None])
            yield (big_k[layer_idx, :, :, j:j + bt],
                   big_ks[layer_idx, :, :, j:j + bt],
                   big_v[layer_idx, :, :, j:j + bt],
                   big_vs[layer_idx, :, :, j:j + bt], valid)
        sp = sink_k.shape[3]
        sslot = torch.arange(sp, dtype=torch.int32, device=dev)[None]
        yield (sink_k[layer_idx], sink_ks[layer_idx], sink_v[layer_idx],
               sink_vs[layer_idx], sslot < sink_len[:, None],
               q_sink.reshape(b, hkv, g, d))
        kt = tail_k.shape[3]
        tslot = torch.arange(kt, dtype=torch.int32, device=dev)[None]
        yield (tail_k[layer_idx], tail_ks[layer_idx], tail_v[layer_idx],
               tail_vs[layer_idx], tslot < tail_valid_len[:, None])

    out = online_softmax_tiles(q.reshape(b, hkv, g, d), tiles(), scale)
    return (out.reshape(b, 1, hq, d).to(q.dtype), tail_k, tail_ks, tail_v,
            tail_vs)


def sink_fused_decode_attention(
    q: torch.Tensor,
    q_sink: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    big_k: torch.Tensor,
    big_ks: torch.Tensor,
    big_v: torch.Tensor,
    big_vs: torch.Tensor,
    sink_k: torch.Tensor,
    sink_ks: torch.Tensor,
    sink_v: torch.Tensor,
    sink_vs: torch.Tensor,
    tail_k: torch.Tensor,
    tail_ks: torch.Tensor,
    tail_v: torch.Tensor,
    tail_vs: torch.Tensor,
    layer_idx: int,
    step_idx: torch.Tensor,
    ring_len: torch.Tensor,
    ring_ptr: torch.Tensor,
    evict_len: torch.Tensor,
    sink_len: torch.Tensor,
    tail_valid_len: torch.Tensor,
    ring_slots: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, ...]:
    """One fused decode step over the int8 sink ring: one softmax over the
    ring, the sinks and the write-behind tail.

    ``q`` ``[B, 1, Hq, D]`` rotated at the absolute query position,
    ``q_sink`` the same query rotated at its window-relative position;
    ``k_new``/``v_new`` ``[B, 1, Hkv, D]`` (k rotated); ring planes ``[L,
    B, Hkv, TR, D]`` int8 (+ ``[L, B, Hkv, TR]`` f32 scales); sink planes
    ``[L, B, Hkv, SP, D]`` (+ scales); tail planes ``[L, B, Hkv, KT, D]``
    (+ scales), updated IN PLACE. ``layer_idx`` a host int, ``step_idx``
    one int32 on the device. Per row (int32 ``[B]``): ring slots below
    ``ring_len`` are live, except the ``evict_len`` slots from
    ``ring_ptr`` on (mod ``ring_slots``), which the in-flight tail has
    evicted; sink slots below ``sink_len``; tail slots below
    ``tail_valid_len``. Returns ``(out [B, 1, Hq, D], tail_k, tail_ks,
    tail_v, tail_vs)``."""
    global sink_launches
    args = (q, q_sink, k_new, v_new, big_k, big_ks, big_v, big_vs, sink_k,
            sink_ks, sink_v, sink_vs, tail_k, tail_ks, tail_v, tail_vs,
            layer_idx, step_idx, ring_len, ring_ptr, evict_len, sink_len,
            tail_valid_len, ring_slots, scale)
    if q.device.type == "cpu":
        return sink_fused_decode_attention_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"sink_fused_decode_attention: device {q.device}")
    name = "sink_fused_decode_attention"
    vectors = (("ring_len", ring_len), ("ring_ptr", ring_ptr),
               ("evict_len", evict_len), ("sink_len", sink_len),
               ("tail_valid_len", tail_valid_len))
    code = check_fused_inputs(
        name, q, k_new, v_new,
        (("big_k", big_k, torch.int8), ("big_v", big_v, torch.int8),
         ("big_ks", big_ks, torch.float32), ("big_vs", big_vs, torch.float32),
         ("sink_k", sink_k, torch.int8), ("sink_v", sink_v, torch.int8),
         ("sink_ks", sink_ks, torch.float32),
         ("sink_vs", sink_vs, torch.float32),
         ("tail_k", tail_k, torch.int8), ("tail_v", tail_v, torch.int8),
         ("tail_ks", tail_ks, torch.float32),
         ("tail_vs", tail_vs, torch.float32)),
        vectors, step_idx)
    if (q_sink.dtype != q.dtype or q_sink.shape != q.shape
            or q_sink.device != q.device or not q_sink.is_contiguous()):
        raise ValueError(f"{name}: q_sink {q_sink.dtype} {tuple(q_sink.shape)} "
                         f"must match q {q.dtype} {tuple(q.shape)}, contiguous")
    b, _, hq, d = q.shape
    num_l, _, hkv, t, _ = big_k.shape
    sp = sink_k.shape[3]
    for label, t_, shape in (
            ("big_k", big_k, (num_l, b, hkv, t, d)),
            ("big_v", big_v, (num_l, b, hkv, t, d)),
            ("big_ks", big_ks, (num_l, b, hkv, t)),
            ("big_vs", big_vs, (num_l, b, hkv, t)),
            ("sink_k", sink_k, (num_l, b, hkv, sp, d)),
            ("sink_v", sink_v, (num_l, b, hkv, sp, d)),
            ("sink_ks", sink_ks, (num_l, b, hkv, sp)),
            ("sink_vs", sink_vs, (num_l, b, hkv, sp))):
        if tuple(t_.shape) != shape:
            raise ValueError(f"{name}: {label} {tuple(t_.shape)}, want {shape}")
    kt = _tail_planes(tail_k, tail_ks, tail_v, tail_vs, num_l, b, hkv, d)
    if t % 32 or not 0 < ring_slots <= t or not 1 <= sp <= MAX_TILE:
        raise ValueError(f"{name}: ring of {ring_slots} slots in planes {t} "
                         f"wide (a multiple of 32), {sp} sink slots")
    if not 0 <= layer_idx < num_l:
        raise ValueError(f"{name}: layer {layer_idx} outside 0..{num_l - 1}")
    if scale is None:
        scale = d**-0.5
    tile = ring_tile_width(t)
    out = torch.empty_like(q)
    fn = _fns.get("sink")
    if fn is None:
        fn = _build.load_library(
            "sink_attention").dli_sink_fused_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["sink"] = fn
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), q_sink.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), big_k.data_ptr(), big_ks.data_ptr(),
            big_v.data_ptr(), big_vs.data_ptr(), sink_k.data_ptr(),
            sink_ks.data_ptr(), sink_v.data_ptr(), sink_vs.data_ptr(),
            tail_k.data_ptr(), tail_ks.data_ptr(), tail_v.data_ptr(),
            tail_vs.data_ptr(), ring_len.data_ptr(), ring_ptr.data_ptr(),
            evict_len.data_ptr(), sink_len.data_ptr(),
            tail_valid_len.data_ptr(), step_idx.data_ptr(), out.data_ptr(),
            b, hkv, hq // hkv, d, t, sp, kt, tile, ring_piece_width(tile),
            int(layer_idx), int(ring_slots), float(scale), code,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    sink_launches += 1
    return out, tail_k, tail_ks, tail_v, tail_vs


def _sink_flush_targets(ring_ptr, skip, tail_len, kt: int, ring_slots: int):
    """``(rows, tail slots, ring slots)`` of every tail slot ``skip <= i <
    tail_len``: ring slot ``(ring_ptr + i - skip) % ring_slots``."""
    i = torch.arange(kt, device=tail_len.device)[None, :]
    keep = (i >= skip[:, None]) & (i < tail_len[:, None])
    rows, slots = keep.nonzero(as_tuple=True)
    return rows, slots, torch.remainder(
        ring_ptr[rows].long() + slots - skip[rows], ring_slots)


def sink_tail_flush_plain(big_k, big_ks, big_v, big_vs, tail_k, tail_ks,
                          tail_v, tail_vs, ring_ptr, skip, tail_len,
                          ring_slots: int):
    """Plain PyTorch version of :func:`sink_tail_flush`: the same arguments
    and results."""
    rows, slots, pos = _sink_flush_targets(ring_ptr, skip, tail_len,
                                           tail_k.shape[3], ring_slots)
    big_k[:, rows, :, pos] = tail_k[:, rows, :, slots]
    big_v[:, rows, :, pos] = tail_v[:, rows, :, slots]
    big_ks[:, rows, :, pos] = tail_ks[:, rows, :, slots]
    big_vs[:, rows, :, pos] = tail_vs[:, rows, :, slots]
    return big_k, big_ks, big_v, big_vs


def sink_tail_flush(
    big_k: torch.Tensor,
    big_ks: torch.Tensor,
    big_v: torch.Tensor,
    big_vs: torch.Tensor,
    tail_k: torch.Tensor,
    tail_ks: torch.Tensor,
    tail_v: torch.Tensor,
    tail_vs: torch.Tensor,
    ring_ptr: torch.Tensor,
    skip: torch.Tensor,
    tail_len: torch.Tensor,
    ring_slots: int,
):
    """Merge the fused window's int8 tail into the sink ring's planes, in
    place: tail token ``i`` of row ``b``, for ``skip[b] <= i <
    tail_len[b]``, goes to ring slot ``(ring_ptr[b] + i - skip[b]) %
    ring_slots``; the first ``skip`` tokens are sink-bound and the caller
    merges them. ``big_*`` ``[L, B, Hkv, TR, D]`` int8 / ``[L, B, Hkv,
    TR]`` f32, ``tail_*`` ``[L, B, Hkv, KT(, D)]``; ``ring_ptr``, ``skip``,
    ``tail_len`` ``[B]`` int32 with ``0 <= ring_ptr < ring_slots`` and
    ``tail_len - skip <= ring_slots`` (no two tokens share a slot).
    Slots at or past ``ring_slots`` are never written. Returns the four
    ring planes ``(k, ks, v, vs)``."""
    global sink_flush_launches
    args = (big_k, big_ks, big_v, big_vs, tail_k, tail_ks, tail_v, tail_vs,
            ring_ptr, skip, tail_len, ring_slots)
    if big_k.device.type == "cpu":
        return sink_tail_flush_plain(*args)
    if big_k.device.type != "cuda":
        raise ValueError(f"sink_tail_flush: device {big_k.device}")
    num_l, b, hkv, t, d = big_k.shape
    kt = tail_k.shape[3]
    for label, t_, dt, shape in (
            ("big_k", big_k, torch.int8, (num_l, b, hkv, t, d)),
            ("big_v", big_v, torch.int8, (num_l, b, hkv, t, d)),
            ("big_ks", big_ks, torch.float32, (num_l, b, hkv, t)),
            ("big_vs", big_vs, torch.float32, (num_l, b, hkv, t)),
            ("tail_k", tail_k, torch.int8, (num_l, b, hkv, kt, d)),
            ("tail_v", tail_v, torch.int8, (num_l, b, hkv, kt, d)),
            ("tail_ks", tail_ks, torch.float32, (num_l, b, hkv, kt)),
            ("tail_vs", tail_vs, torch.float32, (num_l, b, hkv, kt)),
            ("ring_ptr", ring_ptr, torch.int32, (b,)),
            ("skip", skip, torch.int32, (b,)),
            ("tail_len", tail_len, torch.int32, (b,))):
        if t_.dtype != dt or tuple(t_.shape) != shape:
            raise ValueError(f"sink_tail_flush: {label} {t_.dtype} "
                             f"{tuple(t_.shape)}, want {dt} {shape}")
        if t_.device != big_k.device or not t_.is_contiguous():
            raise ValueError(f"sink_tail_flush: {label} must be contiguous "
                             f"on {big_k.device}")
    if d % 16 or not 0 < ring_slots <= t:
        raise ValueError(f"sink_tail_flush: head_dim {d} (a multiple of 16), "
                         f"ring of {ring_slots} slots in {t}")
    fn = _fns.get("sink_flush")
    if fn is None:
        fn = _build.load_library("sink_attention").dli_sink_tail_flush
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["sink_flush"] = fn
    with torch.cuda.device(big_k.device):
        err = fn(big_k.data_ptr(), big_ks.data_ptr(), big_v.data_ptr(),
                 big_vs.data_ptr(), tail_k.data_ptr(), tail_ks.data_ptr(),
                 tail_v.data_ptr(), tail_vs.data_ptr(), ring_ptr.data_ptr(),
                 skip.data_ptr(), tail_len.data_ptr(), num_l, b, hkv, t, kt,
                 d, int(ring_slots), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sink_tail_flush: kernel launch failed ({err})")
    sink_flush_launches += 1
    return big_k, big_ks, big_v, big_vs
