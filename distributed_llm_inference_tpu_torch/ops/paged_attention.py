"""Paged decode attention: a CUDA kernel that reads K/V in place from the
page pool, and its plain PyTorch version; the same over int8 pages; and the
int8 pool's fused decode window: the fused step over the pool in place and
the flush of its write-behind tail into the pages.

Replaces the TPU kernels ``_paged_kernel`` behind ``paged_attention`` and
``_qpaged_kernel`` behind ``quantized_paged_attention`` in the JAX package's
``ops/paged_attention.py``. On this card the function is bound
by bytes: every live K and V slot is read once for a handful of dot
products. For bf16 queries, over bf16 pages or int8 pages (per-(slot,
head) f32 scale planes beside them), it is one launch of
``csrc/paged_decode.cuh``: a thread-block cluster per (row, kv head) whose
blocks take the row's live 64-position steps in turn, a producer warp
bringing them by TMA into a ring (over int8 its lanes bring the steps'
scales beside them), the scores and P V on the tensor cores with one max a
head per 16 positions, and the blocks' states merged through distributed
shared memory, with no scratch; this wrapper sizes the cluster
(:func:`cluster_size`). Over int8 pages the kernel reads half the bytes:
the K scale multiplies the score and the V scale the probability before P
V (as two bf16 terms, hi and the rest), so the pages are never dequantized
into a copy.
For f32 queries (the engine's exact-parity runs), the walk of
``csrc/decode_attention.cuh`` gives each position to a group of 8 lanes
with 16-byte loads, keeps the online-softmax state and ``p * vs`` in f32,
and splits a row's positions over several blocks whose partial results a
second small kernel merges; this wrapper sizes the split and allocates its
scratch.

The fused window (``models/llama.py:multi_decode_apply``) adds two kernels.
``quantized_paged_fused_attention`` replaces ``_qpaged_fused_kernel``: one
(layer, step) over the whole int8 pool in place, the step's K/V quantized
into the int8 tail, the tail the last online-softmax tile, in one launch:
a thread-block cluster per (row, kv head) deals the row's live tiles to its
blocks and exchanges their maxima and sums through distributed shared
memory, with no scratch in device memory (``csrc/fused_decode.cuh``, which
says what bounds it; its rounding and tiles are the TPU kernel's, see
``ops/quant_attention.py``).
The latent decode wrappers (``latent_paged_attention``,
``quantized_latent_paged_attention``) call ``_paged_kernel`` /
``_qpaged_kernel`` in JAX with K = V = the latent pool; here they have
kernels of their own in ``csrc/latent_attention.cu``: for bf16 queries at
lat_dim 576 one launch of a thread-block cluster a row over the latent
pool in place, products on the tensor cores; else a split kernel and its
merge on the CUDA cores.
``paged_tail_flush`` replaces the TPU kernel of the same name: it writes
each row's ``tail_len`` tail slots to positions ``base_len + i`` of its
pages, a direct scatter (the TPU kernel's whole-page read-modify-write with
clamped visits is a VMEM device that has no use here), nothing on the null
page 0 or past the table: one launch of blocks of a few kv heads of a
(row, layer) each, every thread's loads issued before its stores
(``csrc/tail_flush.cuh``, shared with the dense cache's and the sink
ring's flushes; the destination policy in ``csrc/paged_attention.cu``).

The wrappers launch the kernel for CUDA tensors and raise on anything the
kernel does not take; they use the plain version only for tensors that lie
on the CPU. ``launches``, ``quantized_launches``, ``fused_launches``,
``flush_launches``, ``latent_launches`` and ``quantized_latent_launches``
count kernel calls (and nothing else); ``latent_decode_tc_launches`` and
``quantized_latent_decode_tc_launches`` those of them on the tensor-core
decode instance.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import (
    _NEG_INF, check_kernel_widths, check_latent_widths, int8_pages_error)

__all__ = [
    "paged_attention",
    "paged_attention_plain",
    "quantized_paged_attention",
    "quantized_paged_attention_plain",
    "quantized_paged_fused_attention",
    "quantized_paged_fused_attention_plain",
    "paged_tail_flush",
    "paged_tail_flush_plain",
    "launches",
    "quantized_launches",
    "fused_launches",
    "flush_launches",
    "latent_paged_attention",
    "latent_paged_attention_plain",
    "quantized_latent_paged_attention",
    "quantized_latent_paged_attention_plain",
    "latent_launches",
    "quantized_latent_launches",
    "latent_decode_tc_launches",
    "quantized_latent_decode_tc_launches",
    "latent_split_plan",
    "latent_decode_entry",
    "latent_decode_plan",
    "latent_cluster_size",
]

# Kernel launches made by :func:`paged_attention` /
# :func:`quantized_paged_attention` / :func:`quantized_paged_fused_attention`
# / :func:`paged_tail_flush` in this process.
launches = 0
quantized_launches = 0
fused_launches = 0
flush_launches = 0
# ... and by :func:`latent_paged_attention` /
# :func:`quantized_latent_paged_attention`.
latent_launches = 0
quantized_latent_launches = 0
# ... of them on the tensor-core decode instance (bf16 q at lat_dim 576).
latent_decode_tc_launches = 0
quantized_latent_decode_tc_launches = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MIN_SPLIT = 256  # positions: a block is not worth less
_fn = {}
_sm_count = {}


def _sms(device) -> int:
    """The SM count of ``device``, asked once."""
    sms = _sm_count.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device] = sms
    return sms


def split_plan(device, pairs: int, span: int):
    """How many blocks share one (row, kv head)'s ``span`` table positions,
    and how many positions each takes: about two blocks per SM over all
    ``pairs``, at least ``_MIN_SPLIT`` positions each, in whole 64s. Sized
    from the table width, which the host knows, not from the lengths, which
    live on the device."""
    sms = _sms(device)
    num = max(1, min(-(-2 * sms // pairs), -(-span // _MIN_SPLIT)))
    chunk = -(-(-(-span // num)) // 64) * 64
    return num, chunk


def cluster_size(device, pairs: int, span: int) -> int:
    """Blocks of the cluster kernel (``csrc/paged_decode.cuh``, bf16
    queries, over bf16 or int8 rows) for one (row, kv head): about one
    block an SM over all ``pairs`` (more only add merges), at most 8 (the
    portable cluster), and no more than the 64-position steps of ``span``
    positions (a table's, or a dense buffer's width). The steps a block
    takes follow the live length at run time."""
    return max(1, min(8, _sms(device) // pairs, -(-span // 64)))


# C entry of each decode form: (symbol, pointer arguments, int arguments
# before the scale, int arguments after it).
_ENTRIES = {
    "bf16": ("dli_paged_attention_bf16", 9, 7, 1),
    "int8_bf16": ("dli_quantized_paged_attention_bf16", 11, 7, 1),
    "f32": ("dli_paged_attention", 12, 8, 2),
    "int8_f32": ("dli_quantized_paged_attention", 14, 8, 2),
}


def _kernel(form: str):
    """The C entry of the decode ``form``: bf16 queries over bf16 or int8
    pages ("bf16", "int8_bf16": the cluster kernel), f32 queries over f32
    or int8 pages ("f32", "int8_f32": the split walk)."""
    fn = _fn.get(form)
    if fn is None:
        symbol, pointers, ints, after = _ENTRIES[form]
        fn = getattr(_build.load_library("paged_attention"), symbol)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
            ctypes.c_float, *[ctypes.c_int] * after, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn[form] = fn
    return fn


def check_kernel_inputs(name, q, k_pages, v_pages, page_table, vectors,
                        scales=()):
    """Shared argument checks of the kernel wrappers: one CUDA device,
    bf16 or f32 queries, contiguous, int32 indices, supported widths (head
    dim 64 or 128, 1 to 8 query heads a kv head). Pools have q's type, or
    with ``scales`` (``(("ks_pages", ks), ("vs_pages", vs))``) are int8 with
    f32 ``[P, Hkv, PS]`` scale planes."""
    dev = q.device
    for label, t in (("k_pages", k_pages), ("v_pages", v_pages),
                     ("page_table", page_table), *vectors, *scales):
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} (kernel takes bf16, f32)")
    pool_dtype = torch.int8 if scales else q.dtype
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise TypeError(
            f"{name}: q {q.dtype}, k_pages {k_pages.dtype}, v_pages "
            f"{v_pages.dtype}: pools must be {pool_dtype}"
        )
    for label, t in scales:
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(k_pages.shape[:3]):
            raise ValueError(
                f"{name}: {label} must be f32 {tuple(k_pages.shape[:3])}, got "
                f"{t.dtype} {tuple(t.shape)}"
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
    check_kernel_widths(name, d, hq // hkv)
    why = int8_pages_error(d, k_pages.shape[2])
    if scales and q.dtype == torch.bfloat16 and why is not None:
        raise ValueError(f"{name}: {why}")
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
                     ("page_table", page_table), *vectors, *scales):
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


def gather_scales(scales: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``[P, Hkv, PS]`` scale plane + ``[B, T]`` table → ``[B, T*PS, Hkv]``."""
    b, t = page_table.shape
    _, hkv, ps = scales.shape
    g = scales[page_table.long()]             # [B, T, Hkv, PS]
    return g.permute(0, 1, 3, 2).reshape(b, t * ps, hkv)


def _plain(q, k_pages, v_pages, page_table, kv_lengths, scale,
           sliding_window, q_positions, return_stats, ks_pages=None,
           vs_pages=None):
    """Gather the row's pages, mask, softmax in f32. With scale planes the
    pages are int8: the K scale multiplies the score, the V scale the
    probability before P V, as the TPU kernel does."""
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
    scores = torch.einsum("bhgd,bthd->bhgt", qr, k)
    if ks_pages is not None:
        ks = gather_scales(ks_pages, page_table)       # [B, KV, Hkv]
        scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    scores = scores * scale
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = pos < kv_lengths[:, None]
    if sliding_window is not None:
        valid = valid & (pos > q_positions[:, None] - sliding_window)
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, _NEG_INF)
    m = scores.amax(dim=-1)                            # [B, Hkv, G]
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    pw = p
    if vs_pages is not None:
        vs = gather_scales(vs_pages, page_table)
        pw = p * vs.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhgt,bthd->bhgd", pw, v) / l.clamp_min(1e-20)[..., None]
    out = out.reshape(b, 1, hq, d).to(q.dtype)
    if return_stats:
        return out, m, l
    return out


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
    return _plain(q, k_pages, v_pages, page_table, kv_lengths, scale,
                  sliding_window, q_positions, return_stats)


def quantized_paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    ks_pages: torch.Tensor,
    v_pages: torch.Tensor,
    vs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Plain PyTorch version of :func:`quantized_paged_attention`."""
    return _plain(q, k_pages, v_pages, page_table, kv_lengths, scale,
                  sliding_window, q_positions, return_stats, ks_pages,
                  vs_pages)


def _launch(name, q, k_pages, v_pages, page_table, kv_lengths, scale,
            sliding_window, q_positions, return_stats, scales=()):
    """Checks and the launch: bf16 queries take the one-launch cluster
    kernel over bf16 pools or (with ``scales``) int8 pools; f32 queries the
    split kernel and its merge, over scratch allocated here."""
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"{name} is decode-only (S=1), got S={s}")
    if q_positions is None:
        # Only the sliding window reads the query positions: without one
        # the kernels never do, and no kernel is launched to make them.
        q_positions = kv_lengths - 1 if sliding_window else kv_lengths
    code = check_kernel_inputs(
        name, q, k_pages, v_pages, page_table,
        (("kv_lengths", kv_lengths), ("q_positions", q_positions)), scales,
    )
    _, hkv, page_size, _ = k_pages.shape
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    width = page_table.shape[1]
    out = torch.empty_like(q)
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if scales:
        pools = (k_pages.data_ptr(), scales[0][1].data_ptr(),
                 v_pages.data_ptr(), scales[1][1].data_ptr())
    else:
        pools = (k_pages.data_ptr(), v_pages.data_ptr())
    if q.dtype == torch.bfloat16:
        # One launch of the cluster kernel (csrc/paged_decode.cuh): no
        # scratch. Its TMA maps name pool rows by 32-bit coordinates.
        if k_pages.shape[0] * hkv * page_size >= 2**31:
            raise ValueError(f"{name}: pool of {k_pages.shape[0]} pages "
                             f"has 2^31 rows or more")
        with torch.cuda.device(q.device):
            err = _kernel("int8_bf16" if scales else "bf16")(
                q.data_ptr(), *pools, page_table.data_ptr(),
                kv_lengths.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
                m.data_ptr(), l.data_ptr(), b, hkv, g, d, page_size, width,
                cluster_size(q.device, b * hkv, width * page_size),
                float(scale), int(sliding_window or 0),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed ({err})")
        return (out, m, l) if return_stats else out
    num_splits, chunk = split_plan(q.device, b * hkv, width * page_size)
    part_o = torch.empty(
        (b, hkv, num_splits, g, d), dtype=torch.float32, device=q.device
    )
    part_ml = torch.empty(
        (2, b, hkv, num_splits, g), dtype=torch.float32, device=q.device
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("int8_f32" if scales else "f32")(
            q.data_ptr(), *pools, page_table.data_ptr(),
            kv_lengths.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), part_o.data_ptr(),
            part_ml[0].data_ptr(), part_ml[1].data_ptr(), b, hkv, g, d,
            page_size, width, num_splits, chunk, float(scale),
            int(sliding_window or 0), code, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
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
    out = _launch("paged_attention", q, k_pages, v_pages, page_table,
                  kv_lengths, scale, sliding_window, q_positions,
                  return_stats)
    launches += 1
    return out


def quantized_paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    ks_pages: torch.Tensor,
    v_pages: torch.Tensor,
    vs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """As :func:`paged_attention` over int8 pages with per-(slot, head)
    scale planes (``ks_pages``/``vs_pages``: ``[P, Hkv, page_size]`` f32)."""
    global quantized_launches
    if q.device.type == "cpu":
        return quantized_paged_attention_plain(
            q, k_pages, ks_pages, v_pages, vs_pages, page_table, kv_lengths,
            scale, sliding_window, q_positions, return_stats,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"quantized_paged_attention: unsupported device {q.device}"
        )
    out = _launch("quantized_paged_attention", q, k_pages, v_pages,
                  page_table, kv_lengths, scale, sliding_window, q_positions,
                  return_stats, (("ks_pages", ks_pages), ("vs_pages", vs_pages)))
    quantized_launches += 1
    return out


# ---------------------------------------------------------------------------
# The latent (MLA) pool: K = V = the stored [c ; k_rope] latent
# ---------------------------------------------------------------------------

# Positions a block of the latent decode kernel takes at least: two of its
# 32-position tiles, each a (row, split) block loads once for K and V.
_MIN_LATENT_SPLIT = 128
_LATENT_TILE = 32
_MAX_LATENT_SPLITS = 256  # the merge kernel's shared weights


def latent_split_plan(device, batch: int, span: int):
    """How many blocks share one row's ``span`` table positions in the
    CUDA-core latent decode kernel (``csrc/latent_attention.cu``: f32
    queries and lat_dim 80), and how many
    positions each takes: about two blocks per SM over the ``batch`` rows
    (one latent head: a row is one block unless split), at least
    ``_MIN_LATENT_SPLIT`` positions each, in whole 32-position tiles, at
    most ``_MAX_LATENT_SPLITS`` blocks a row."""
    sms = _sms(device)
    splits = max(1, min(-(-2 * sms // batch), -(-span // _MIN_LATENT_SPLIT),
                        _MAX_LATENT_SPLITS))
    chunk = -(-(-(-span // splits)) // _LATENT_TILE) * _LATENT_TILE
    return -(-span // chunk), chunk


# The tensor-core decode instance (``latent_decode_tc_kernel``): bf16
# queries at this lat_dim (DeepSeek-V2/V3's 512 + 64).
DECODE_TC_LAT_DIM = 576
_DECODE_TC_MAX_CLUSTER = 16
_DECODE_TC_STEP = 16
_cluster_fit = {}


def latent_decode_entry(dtype: torch.dtype, lat_dim: int) -> str:
    """The C entry of ``csrc/latent_attention.cu`` that takes decode
    latent attention for queries of ``dtype`` over a latent of ``lat_dim``:
    the tensor-core instance for bf16 at lat_dim 576, else the CUDA-core
    kernel and its merge (f32 queries, which the engine's exact-stream
    checks need, and lat_dim 80). Widths neither takes are refused before
    this is asked."""
    if dtype == torch.bfloat16 and lat_dim == DECODE_TC_LAT_DIM:
        return "dli_latent_decode_tc"
    return "dli_latent_paged_attention"


def latent_decode_plan(quantized: bool) -> dict:
    """The tensor-core decode instance's block as ``csrc/latent_attention.cu``
    lays it out (its ``dli_latent_decode_plan`` reports the same numbers):
    three consumer warps, 192 of the 576 columns each (their third of Q
    K^T's depth and of P V's columns), four converter warps and a producer
    warp; a step of 16 positions. The shared memory is Q, the ring of
    converted steps (bf16 rows of 576 + 8 values, a stride of 4 mod 32
    words so that ldmatrix reads free of bank conflicts; the f32 pool a hi
    and a lo tile a step), the ring of raw steps (pool rows as the bulk
    copies land them), two buffers of partial scores, the int8 scales and
    the barriers; after the walk the converted ring's first bytes hold the
    block's (O, m, l) for the cluster's merge."""
    d, warps, step = DECODE_TC_LAT_DIM, 4, _DECODE_TC_STEP
    row = d * 2 + 16
    tile = step * row
    raw_bytes = step * d * (1 if quantized else 4)
    raws, convs = (8, 6) if quantized else (2, 3)
    conv_bytes = (1 if quantized else 2) * tile
    x_bytes = 2 * warps * 2 * 32 * 16
    smem = (16 * row + convs * conv_bytes + raws * raw_bytes + x_bytes
            + ((raws + convs) * step * 4 if quantized else 0)
            + 2 * (raws + convs) * 8)
    return {"threads": (warps + 4 + 1) * 32, "smem_bytes": smem,
            "raw_steps": raws, "converted_steps": convs, "step": step,
            "converted_row_bytes": row,
            "max_cluster": _DECODE_TC_MAX_CLUSTER,
            "columns_a_warp": d // warps, "state_bytes": 16 * d * 4 + 128,
            "converted_ring_bytes": convs * conv_bytes}


def latent_cluster_fit(device, quantized: bool, cluster: int) -> int:
    """How many clusters of ``cluster`` blocks of the tensor-core decode
    instance the card holds at once (``cudaOccupancyMaxActiveClusters``,
    asked once a width): a cluster's blocks share one GPC."""
    key = (device, quantized, cluster)
    n = _cluster_fit.get(key)
    if n is None:
        fn = _build.load_library("latent_attention").dli_latent_decode_clusters
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            n = fn(cluster, int(quantized))
        if n < 0:
            raise RuntimeError(
                f"latent decode: cluster occupancy query failed ({n})")
        _cluster_fit[key] = n
    return n


def latent_cluster_size(device, batch: int, span: int,
                        quantized: bool) -> int:
    """Blocks of the tensor-core decode instance's cluster for one row:
    about one block an SM over the ``batch`` rows (B x C near the SM
    count), at most 16 (the non-portable cluster) and the 16-position steps
    of ``span`` table positions, and no more than lets the card hold the
    batch's clusters at once. The steps each block takes follow the live
    length at run time."""
    c = max(1, min(_DECODE_TC_MAX_CLUSTER, _sms(device) // batch,
                   -(-span // _DECODE_TC_STEP)))
    while c > 1 and latent_cluster_fit(device, quantized, c) < batch:
        c -= 1
    return c


def latent_kernel(symbol: str):
    """A C entry of ``csrc/latent_attention.cu``, its argument types set."""
    fn = _fn.get(symbol)
    if fn is None:
        fn = getattr(_build.load_library("latent_attention"), symbol)
        pointers, ints, after = {
            "dli_latent_ragged_attention": (8, 6, 2),
            "dli_latent_ragged_wgmma": (8, 6, 2),
            "dli_latent_paged_attention": (12, 7, 2),
            "dli_latent_decode_tc": (9, 6, 2),
        }[symbol]
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
            ctypes.c_float, *[ctypes.c_int] * after, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn[symbol] = fn
    return fn


def check_latent_inputs(name, q, c_pages, page_table, vectors, cs_pages=None):
    """Argument checks of the latent wrappers: one CUDA device, bf16 or f32
    absorbed queries ``[B, S, G, D]``, a pool ``[P, 1, PS, D]`` of f32
    latents (or int8 with f32 ``cs_pages [P, 1, PS]``), contiguous, int32
    indices, widths a latent kernel takes (``check_latent_widths``).
    Returns q's dtype code."""
    dev = q.device
    extra = () if cs_pages is None else (("cs_pages", cs_pages),)
    for label, t in (("c_pages", c_pages), ("page_table", page_table),
                     *vectors, *extra):
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} (kernel takes bf16, f32)")
    pool_dtype = torch.float32 if cs_pages is None else torch.int8
    if c_pages.dtype != pool_dtype:
        raise TypeError(f"{name}: c_pages {c_pages.dtype}, must be "
                        f"{pool_dtype}")
    if c_pages.ndim != 4 or c_pages.shape[1] != 1:
        raise ValueError(f"{name}: c_pages must be [P, 1, PS, D], got "
                         f"{tuple(c_pages.shape)}")
    if cs_pages is not None and (
            cs_pages.dtype != torch.float32
            or tuple(cs_pages.shape) != tuple(c_pages.shape[:3])):
        raise ValueError(
            f"{name}: cs_pages must be f32 {tuple(c_pages.shape[:3])}, got "
            f"{cs_pages.dtype} {tuple(cs_pages.shape)}")
    if q.ndim != 4 or q.shape[3] != c_pages.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the "
                         f"pool {tuple(c_pages.shape)}")
    check_latent_widths(name, q.shape[3], q.shape[2])
    for label, t in (("page_table", page_table), *vectors):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    b = q.shape[0]
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)}")
    for label, t in vectors:
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name}: {label} {tuple(t.shape)}, want ({b},)")
    for label, t in (("q", q), ("c_pages", c_pages),
                     ("page_table", page_table), *vectors, *extra):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t in (("q", q), ("c_pages", c_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    return _DTYPE_CODE[q.dtype]


def latent_paged_attention_plain(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Plain PyTorch version of :func:`latent_paged_attention`: the plain
    paged decode with ``K = V = c_pages`` (f32 math, output in q's
    type)."""
    return _plain(q, c_pages, c_pages, page_table, kv_lengths, scale,
                  sliding_window, q_positions, return_stats)


def quantized_latent_paged_attention_plain(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    cs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Plain PyTorch version of :func:`quantized_latent_paged_attention`:
    the scale multiplies the score (K) and the probability before P V (V),
    in f32."""
    return _plain(q, c_pages, c_pages, page_table, kv_lengths, scale,
                  sliding_window, q_positions, return_stats, cs_pages,
                  cs_pages)


def _latent_launch(name, q, c_pages, cs_pages, page_table, kv_lengths, scale,
                   sliding_window, q_positions, return_stats):
    """Checks and the launch of the latent decode kernel: for bf16 q at
    lat_dim 576 one launch of the tensor-core instance (a cluster a row,
    no scratch); else the CUDA-core kernel's two (the split positions,
    then their merge), over scratch allocated here."""
    global latent_decode_tc_launches, quantized_latent_decode_tc_launches
    b, s, g, d = q.shape
    if s != 1:
        raise ValueError(f"{name} is decode-only (S=1), got S={s}")
    if q_positions is None:
        # Only the sliding window reads the query positions.
        q_positions = kv_lengths - 1 if sliding_window else kv_lengths
    code = check_latent_inputs(
        name, q, c_pages, page_table,
        (("kv_lengths", kv_lengths), ("q_positions", q_positions)), cs_pages)
    page_size, width = c_pages.shape[2], page_table.shape[1]
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    m = torch.empty((b, 1, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if latent_decode_entry(q.dtype, d) == "dli_latent_decode_tc":
        quantized = cs_pages is not None
        if quantized and cs_pages.data_ptr() % 16:
            # a step's 16 scales come by one bulk copy
            raise ValueError(f"{name}: cs_pages must be 16-byte aligned")
        cluster = latent_cluster_size(q.device, b, width * page_size,
                                      quantized)
        with torch.cuda.device(q.device):
            err = latent_kernel("dli_latent_decode_tc")(
                q.data_ptr(), c_pages.data_ptr(),
                None if cs_pages is None else cs_pages.data_ptr(),
                page_table.data_ptr(), kv_lengths.data_ptr(),
                q_positions.data_ptr(), out.data_ptr(), m.data_ptr(),
                l.data_ptr(), b, g, d, page_size, width, cluster,
                float(scale), int(sliding_window or 0), code,
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed ({err})")
        if quantized:
            quantized_latent_decode_tc_launches += 1
        else:
            latent_decode_tc_launches += 1
        return (out, m, l) if return_stats else out
    splits, chunk = latent_split_plan(q.device, b, width * page_size)
    rows = 4 if g <= 4 else 8 if g <= 8 else 16  # the kernel's decode_rows
    part_o = torch.empty((b, splits, rows, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((2, b, splits, rows), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        err = latent_kernel("dli_latent_paged_attention")(
            q.data_ptr(), c_pages.data_ptr(),
            None if cs_pages is None else cs_pages.data_ptr(),
            page_table.data_ptr(), kv_lengths.data_ptr(),
            q_positions.data_ptr(), out.data_ptr(), m.data_ptr(),
            l.data_ptr(), part_o.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), b, g, d, page_size, width, splits, chunk,
            float(scale), int(sliding_window or 0), code,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    return (out, m, l) if return_stats else out


def latent_paged_attention(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Absorbed-MLA decode attention over the latent pool, in place.

    ``q``: the absorbed query ``[B, 1, Hq, lat_dim]`` (bf16 or f32);
    ``c_pages``: ``[P, 1, page_size, lat_dim]`` f32, one layer's fused
    ``[c ; k_rope]`` latents (rope already on the rope slice); ``K = V =``
    the stored latent, over one latent head (G = Hq). Otherwise as
    :func:`paged_attention`: ``(out, m, l)`` with ``return_stats``, ``m``
    and ``l`` ``[B, 1, Hq]``. All the arithmetic is f32; the output is
    rounded to q's type. On the card, ``csrc/latent_attention.cu``
    (lat_dim 576 or 80, 1 to 16 query heads): bf16 queries at lat_dim 576
    on the tensor cores, one cluster launch a call with f32-grade products
    from bf16 hi + lo terms (:func:`latent_decode_plan`,
    :func:`latent_cluster_size`); f32 queries and lat_dim 80 on the CUDA
    cores, a split kernel and its merge (:func:`latent_decode_entry`)."""
    global latent_launches
    if q.device.type == "cpu":
        return latent_paged_attention_plain(
            q, c_pages, page_table, kv_lengths, scale, sliding_window,
            q_positions, return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"latent_paged_attention: unsupported device "
                         f"{q.device}")
    out = _latent_launch("latent_paged_attention", q, c_pages, None,
                         page_table, kv_lengths, scale, sliding_window,
                         q_positions, return_stats)
    latent_launches += 1
    return out


def quantized_latent_paged_attention(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    cs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    q_positions: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """As :func:`latent_paged_attention` over the int8 latent pool with
    per-token f32 scales (``cs_pages``: ``[P, 1, page_size]``)."""
    global quantized_latent_launches
    if q.device.type == "cpu":
        return quantized_latent_paged_attention_plain(
            q, c_pages, cs_pages, page_table, kv_lengths, scale,
            sliding_window, q_positions, return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"quantized_latent_paged_attention: unsupported "
                         f"device {q.device}")
    out = _latent_launch("quantized_latent_paged_attention", q, c_pages,
                         cs_pages, page_table, kv_lengths, scale,
                         sliding_window, q_positions, return_stats)
    quantized_latent_launches += 1
    return out


# ---------------------------------------------------------------------------
# The int8 pool's fused decode window
# ---------------------------------------------------------------------------


def quantized_paged_fused_attention_plain(
    q, k_new, v_new, pool_k, pool_ks, pool_v, pool_vs,
    tail_k, tail_ks, tail_v, tail_vs, layer_idx: int,
    step_idx: torch.Tensor, page_table, base_len, tail_valid_len,
    q_positions, scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
):
    """Plain PyTorch version of :func:`quantized_paged_fused_attention`:
    the same arguments and results, one tile per table slot (page) in
    order, then the tail."""
    from .quant_attention import online_softmax_tiles, tail_tile, write_tail_slot

    b, _, hq, d = q.shape
    hkv, ps = pool_k.shape[2], pool_k.shape[3]
    if scale is None:
        scale = d**-0.5
    write_tail_slot(k_new, v_new, tail_k, tail_ks, tail_v, tail_vs,
                    layer_idx, step_idx)
    table = page_table.long()

    def tiles():
        for j in range(table.shape[1]):
            page = table[:, j]
            pos = j * ps + torch.arange(ps, dtype=torch.int32, device=q.device)
            valid = pos[None, :] < base_len[:, None]
            if sliding_window is not None:
                valid &= pos[None, :] > q_positions[:, None] - sliding_window
            yield (pool_k[layer_idx, page], pool_ks[layer_idx, page],
                   pool_v[layer_idx, page], pool_vs[layer_idx, page], valid)
        yield tail_tile(tail_k, tail_ks, tail_v, tail_vs, layer_idx,
                        base_len, tail_valid_len, q_positions, sliding_window)

    out = online_softmax_tiles(q.reshape(b, hkv, hq // hkv, d), tiles(), scale)
    return (out.reshape(b, 1, hq, d).to(q.dtype), tail_k, tail_ks, tail_v,
            tail_vs)


def _fused_kernel():
    fn = _fn.get("fused")
    if fn is None:
        fn = _build.load_library(
            "paged_attention").dli_quantized_paged_fused_attention
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn["fused"] = fn
    return fn


def quantized_paged_fused_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pool_k: torch.Tensor,
    pool_ks: torch.Tensor,
    pool_v: torch.Tensor,
    pool_vs: torch.Tensor,
    tail_k: torch.Tensor,
    tail_ks: torch.Tensor,
    tail_v: torch.Tensor,
    tail_vs: torch.Tensor,
    layer_idx: int,
    step_idx: torch.Tensor,
    page_table: torch.Tensor,
    base_len: torch.Tensor,
    tail_valid_len: torch.Tensor,
    q_positions: torch.Tensor,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
):
    """One fused-decode attention step over the int8 page pool in place.

    As ``ops/quant_attention.py:quantized_fused_decode_attention``, with the
    big segment the WHOLE pool, ``[L, P, Hkv, PS, D]`` int8 (+ ``[L, P, Hkv,
    PS]`` f32 scales), read through ``page_table`` ``[B, T]`` int32.
    Returns ``(out [B, 1, Hq, D], tail_k, tail_ks, tail_v, tail_vs)``, the
    tail planes updated in place."""
    global fused_launches
    args = (q, k_new, v_new, pool_k, pool_ks, pool_v, pool_vs, tail_k,
            tail_ks, tail_v, tail_vs, layer_idx, step_idx, page_table,
            base_len, tail_valid_len, q_positions, scale, sliding_window)
    if q.device.type == "cpu":
        return quantized_paged_fused_attention_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"quantized_paged_fused_attention: device {q.device}")
    from .quant_attention import MAX_TILE, _tail_planes, check_fused_inputs

    name = "quantized_paged_fused_attention"
    code = check_fused_inputs(
        name, q, k_new, v_new,
        (("pool_k", pool_k, torch.int8), ("pool_v", pool_v, torch.int8),
         ("pool_ks", pool_ks, torch.float32),
         ("pool_vs", pool_vs, torch.float32),
         ("tail_k", tail_k, torch.int8), ("tail_v", tail_v, torch.int8),
         ("tail_ks", tail_ks, torch.float32),
         ("tail_vs", tail_vs, torch.float32)),
        (("base_len", base_len), ("tail_valid_len", tail_valid_len),
         ("q_positions", q_positions)), step_idx)
    b, _, hq, d = q.shape
    num_l, num_p, hkv, ps, _ = pool_k.shape
    if pool_v.shape != pool_k.shape or d != pool_k.shape[4]:
        raise ValueError(f"{name}: pools {tuple(pool_k.shape)}")
    if (tuple(pool_ks.shape) != (num_l, num_p, hkv, ps)
            or pool_vs.shape != pool_ks.shape):
        raise ValueError(f"{name}: pool scales {tuple(pool_ks.shape)}")
    if ps > MAX_TILE:
        raise ValueError(f"{name}: page size {ps} above {MAX_TILE}")
    if (page_table.dtype != torch.int32 or page_table.ndim != 2
            or page_table.shape[0] != b or not page_table.is_contiguous()
            or page_table.device != q.device):
        raise ValueError(f"{name}: page_table {page_table.dtype} "
                         f"{tuple(page_table.shape)} on {page_table.device}")
    kt = _tail_planes(tail_k, tail_ks, tail_v, tail_vs, num_l, b, hkv, d)
    if not 0 <= layer_idx < num_l:
        raise ValueError(f"{name}: layer {layer_idx} outside 0..{num_l - 1}")
    if scale is None:
        scale = d**-0.5
    width = page_table.shape[1]
    nt, w = width + 1, max(ps, kt)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fused_kernel()(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            pool_k.data_ptr(), pool_ks.data_ptr(), pool_v.data_ptr(),
            pool_vs.data_ptr(), tail_k.data_ptr(), tail_ks.data_ptr(),
            tail_v.data_ptr(), tail_vs.data_ptr(), page_table.data_ptr(),
            base_len.data_ptr(), tail_valid_len.data_ptr(),
            q_positions.data_ptr(), step_idx.data_ptr(), out.data_ptr(),
            b, hkv, hq // hkv, d, num_p, ps, width, kt,
            int(layer_idx), nt, w, float(scale), int(sliding_window or 0),
            code, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    fused_launches += 1
    return out, tail_k, tail_ks, tail_v, tail_vs


def _flush_targets(pool_k, page_table, base_len, tail_len, kt):
    """Where each tail slot lands: ``(rows, slots i, pages, offsets)`` of
    the slots ``i < tail_len`` whose position ``base_len + i`` has a table
    slot holding a page other than the null page 0."""
    ps = pool_k.shape[3]
    width = page_table.shape[1]
    i = torch.arange(kt, device=base_len.device)[None, :]
    pos = base_len[:, None].long() + i
    slot = torch.div(pos, ps, rounding_mode="floor")
    page = torch.gather(page_table.long(), 1, slot.clamp(0, width - 1))
    keep = (i < tail_len[:, None]) & (slot < width) & (page != 0)
    rows, slots = keep.nonzero(as_tuple=True)
    return rows, slots, page[rows, slots], (pos % ps)[rows, slots]


def paged_tail_flush_plain(pool_k, pool_ks, pool_v, pool_vs, tail_k, tail_ks,
                           tail_v, tail_vs, page_table, base_len, tail_len):
    """Plain PyTorch version of :func:`paged_tail_flush`: the same
    arguments and results."""
    rows, slots, pages, offs = _flush_targets(
        pool_k, page_table, base_len, tail_len, tail_k.shape[3])
    # [L, N, Hkv(, D)] values of the kept slots, into [L, P, Hkv, PS(, D)].
    pool_k[:, pages, :, offs] = tail_k[:, rows, :, slots]
    pool_v[:, pages, :, offs] = tail_v[:, rows, :, slots]
    pool_ks[:, pages, :, offs] = tail_ks[:, rows, :, slots]
    pool_vs[:, pages, :, offs] = tail_vs[:, rows, :, slots]
    return pool_k, pool_ks, pool_v, pool_vs


def paged_tail_flush(
    pool_k: torch.Tensor,
    pool_ks: torch.Tensor,
    pool_v: torch.Tensor,
    pool_vs: torch.Tensor,
    tail_k: torch.Tensor,
    tail_ks: torch.Tensor,
    tail_v: torch.Tensor,
    tail_vs: torch.Tensor,
    page_table: torch.Tensor,
    base_len: torch.Tensor,
    tail_len: torch.Tensor,
):
    """Merge the fused window's int8 tail into the page pool, in place.

    ``pool_*``: ``[L, P, Hkv, PS, D]`` int8 / ``[L, P, Hkv, PS]`` f32;
    ``tail_*``: ``[L, B, Hkv, KT, D]`` / ``[L, B, Hkv, KT]``; ``page_table``
    ``[B, T]``, ``base_len``/``tail_len`` ``[B]`` int32. Tail slot ``i <
    tail_len[b]`` of row ``b`` goes to position ``base_len[b] + i``; nothing
    is written past the table or on the null page. Returns the four pool
    planes."""
    global flush_launches
    args = (pool_k, pool_ks, pool_v, pool_vs, tail_k, tail_ks, tail_v,
            tail_vs, page_table, base_len, tail_len)
    if pool_k.device.type == "cpu":
        return paged_tail_flush_plain(*args)
    if pool_k.device.type != "cuda":
        raise ValueError(f"paged_tail_flush: device {pool_k.device}")
    num_l, num_p, hkv, ps, d = pool_k.shape
    b, width = page_table.shape
    kt = tail_k.shape[3]
    for label, t_, dt, shape in (
            ("pool_k", pool_k, torch.int8, (num_l, num_p, hkv, ps, d)),
            ("pool_v", pool_v, torch.int8, (num_l, num_p, hkv, ps, d)),
            ("pool_ks", pool_ks, torch.float32, (num_l, num_p, hkv, ps)),
            ("pool_vs", pool_vs, torch.float32, (num_l, num_p, hkv, ps)),
            ("tail_k", tail_k, torch.int8, (num_l, b, hkv, kt, d)),
            ("tail_v", tail_v, torch.int8, (num_l, b, hkv, kt, d)),
            ("tail_ks", tail_ks, torch.float32, (num_l, b, hkv, kt)),
            ("tail_vs", tail_vs, torch.float32, (num_l, b, hkv, kt)),
            ("page_table", page_table, torch.int32, (b, width)),
            ("base_len", base_len, torch.int32, (b,)),
            ("tail_len", tail_len, torch.int32, (b,))):
        if t_.dtype != dt or tuple(t_.shape) != shape:
            raise ValueError(f"paged_tail_flush: {label} {t_.dtype} "
                             f"{tuple(t_.shape)}, want {dt} {shape}")
        if t_.device != pool_k.device or not t_.is_contiguous():
            raise ValueError(f"paged_tail_flush: {label} must be contiguous "
                             f"on {pool_k.device}")
    if d % 16:
        raise ValueError(f"paged_tail_flush: head_dim {d} not a multiple of 16")
    fn = _fn.get("flush")
    if fn is None:
        fn = _build.load_library("paged_attention").dli_paged_tail_flush
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn["flush"] = fn
    with torch.cuda.device(pool_k.device):
        err = fn(pool_k.data_ptr(), pool_ks.data_ptr(), pool_v.data_ptr(),
                 pool_vs.data_ptr(), tail_k.data_ptr(), tail_ks.data_ptr(),
                 tail_v.data_ptr(), tail_vs.data_ptr(), page_table.data_ptr(),
                 base_len.data_ptr(), tail_len.data_ptr(), num_l, b, num_p,
                 hkv, ps, width, kt, d,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_tail_flush: kernel launch failed ({err})")
    flush_launches += 1
    return pool_k, pool_ks, pool_v, pool_vs
