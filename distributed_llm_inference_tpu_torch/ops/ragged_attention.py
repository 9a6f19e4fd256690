"""Ragged mixed-phase paged attention: a CUDA kernel that serves prefill,
chunked-prefill and decode rows in one launch, and its plain PyTorch version.

Replaces the TPU kernels ``_ragged_kernel`` behind ``ragged_paged_attention``
and ``_qragged_kernel`` behind ``quantized_ragged_paged_attention`` (the same
over int8 pages with per-(slot, head) f32 scale planes) in the JAX package's
``ops/ragged_attention.py``. On this card the function
is bound by operations (the products Q K^T and P V), so
``csrc/ragged_attention.cu`` cuts the work to what the data needs: a block
per (query tile, kv head, row) stops at its tile's causal frontier, tiles of
pad queries exit at once, and pages are read in place (no contiguous
gather copy). For bf16 queries a block holds 128 score rows in two
warpgroups that run ``wgmma``, fed by a producer warpgroup that keeps a ring
of K/V tiles in flight by TMA, in boxes of ``box_rows(page_size)`` rows,
the heaviest query tiles launched first (:func:`launch_plan`); a query
takes ``rows_per_query(G)`` rows, the G query heads of its kv head padded
to a power of two, whose padding rows are zeros never written
(:func:`score_rows`). Head_dim 64 and 128, 1 to 8 query heads a kv head.
For f32
the products are register-tiled FMAs, which the engine's exact-parity
checks need. Over int8 pages K and V are converted to the working type in
shared memory and the scales apply to the scores (K) and to the
probabilities before P V (V).

The wrappers launch the kernel for CUDA tensors and raise on anything the
kernel does not take; they use the plain version only for tensors that lie
on the CPU. ``launches`` and ``quantized_launches`` count kernel launches
(and nothing else).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .attention import (
    _NEG_INF, check_kernel_widths, int8_pages_error, rows_per_query)
from .paged_attention import (
    check_kernel_inputs, check_latent_inputs, gather_pages, gather_scales,
    latent_kernel)

__all__ = [
    "ragged_paged_attention",
    "ragged_paged_attention_plain",
    "quantized_ragged_paged_attention",
    "quantized_ragged_paged_attention_plain",
    "ragged_attention_reference",
    "launches",
    "quantized_launches",
    "box_rows",
    "tile_of",
    "rows_per_query",
    "score_rows",
    "launch_plan",
    "latent_ragged_paged_attention",
    "latent_ragged_paged_attention_plain",
    "quantized_latent_ragged_paged_attention",
    "quantized_latent_ragged_paged_attention_plain",
    "latent_launches",
    "quantized_latent_launches",
    "latent_ragged_entry",
    "latent_wgmma_plan",
    "latent_wgmma_launches",
    "quantized_latent_wgmma_launches",
]

# Kernel launches made by :func:`ragged_paged_attention` /
# :func:`quantized_ragged_paged_attention` in this process.
launches = 0
quantized_launches = 0
# ... and by :func:`latent_ragged_paged_attention` /
# :func:`quantized_latent_ragged_paged_attention`.
latent_launches = 0
quantized_latent_launches = 0
# ... of them, those of the tensor-core instance (bf16 q at lat_dim 576).
latent_wgmma_launches = 0
quantized_latent_wgmma_launches = 0

_fn = {}

# The bf16 kernel's tiles (csrc/ragged_attention.cu): score rows a block
# (two warpgroups of 64), kv slots a ring step, the most pool rows one TMA
# box brings.
BLOCK_ROWS = 128
STEP = 128
MAX_BOX_ROWS = 64
_HALF = STEP * 128  # one 64-column bf16 half (or one int8 plane) of a step


def box_rows(page_size: int) -> int:
    """Pool rows one TMA box of the bf16 kernel brings: ``gcd(page_size,
    64)``, so that a box never crosses a page whatever the page size."""
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    return math.gcd(page_size, MAX_BOX_ROWS)


def score_rows(group: int):
    """The (query of the block, head of the group) of each of the bf16
    kernel's ``BLOCK_ROWS`` score rows, as ``ragged_kernel_wgmma`` reads
    them (row r: query ``r >> shift``, head ``r & (Gp - 1)``), with None
    for a padding row (a head past the group: a zero query whose output
    the 5-D tensor map does not write)."""
    gp = rows_per_query(group)
    return [(r // gp, r % gp) if r % gp < group else None
            for r in range(BLOCK_ROWS)]


def tile_of(z: int, tiles: int) -> int:
    """The query tile that the bf16 kernel's blocks at grid index ``z``
    serve: the last tile first. A later tile's causal walk is never
    shorter, so the longest walks start in the first wave and the short
    ones fill in behind."""
    return tiles - 1 - z


def launch_plan(batch: int, seq: int, num_kv_heads: int, group: int,
                head_dim: int, page_size: int, num_pages: int,
                quantized: bool) -> dict:
    """The bf16 kernel's launch as ``csrc/ragged_attention.cu`` makes it
    (its ``dli_ragged_launch_plan`` reports the same numbers): the grid
    ``(Hkv, B, query tiles)`` (tiles launched in :func:`tile_of`'s order),
    the tensor maps (dimensions innermost first, byte strides of the outer
    dimensions, box; q and out as ``{D, G, Hkv, S, B}``, a box of
    :func:`rows_per_query` heads), the bytes each ring stage receives and
    the dynamic shared memory. The pools are viewed as rows
    ``[P * Hkv * PS, D]``; the map's row extent is 2^31, so every row a
    page table can name must lie below it. Raises ``ValueError`` on what
    the launch cannot take."""
    hq = num_kv_heads * group
    check_kernel_widths("ragged_paged_attention", head_dim, group)
    why = int8_pages_error(head_dim, page_size)
    if quantized and why is not None:
        raise ValueError(why)
    gp = rows_per_query(group)
    halves = head_dim // 64
    rows = box_rows(page_size)
    tiles = -(-seq // (BLOCK_ROWS // gp))
    pool_rows = num_pages * num_kv_heads * page_size
    if pool_rows > 2**31:
        raise ValueError(
            f"the pool's {pool_rows} rows exceed the tensor map's 2^31")
    if tiles > 65535:
        raise ValueError(f"{tiles} query tiles exceed the grid's 65535")
    esz = 1 if quantized else 2
    # Q, then bf16 pages: a ring of 3 stages of K and V; int8 pages: 2
    # converted bf16 stages, 2 int8 stages and their K and V scales. Then
    # one barrier for Q and 2 (bf16) or 7 (int8) a stage. A bf16 tile is
    # D / 64 halves; an int8 plane is STEP rows of D bytes.
    stages = 2 if quantized else 3
    stage_tx = 2 * STEP * head_dim if quantized else 2 * halves * _HALF
    smem = halves * _HALF + stages * 2 * halves * _HALF
    if quantized:
        smem += stages * (stage_tx + 2 * STEP * 4)
    smem += (1 + (7 if quantized else 2) * stages) * 8
    return {
        "grid": (num_kv_heads, batch, tiles),
        "tiles": tiles,
        # two consumer warpgroups and a producer one: the TMA warp, and 3
        # converter warps for int8 pages
        "threads": 384,
        "stages": stages,
        "box_rows": rows,
        "rows_per_query": gp,
        "boxes_per_step": STEP // rows * (1 if quantized else halves) * 2,
        "q_map": {"dims": (head_dim, group, num_kv_heads, seq, batch),
                  "strides": (head_dim * 2, group * head_dim * 2,
                              hq * head_dim * 2, seq * hq * head_dim * 2),
                  "box": (64, gp, 1, BLOCK_ROWS // gp, 1), "swizzle": 128},
        "o_box": (64, gp, 1, 64 // gp, 1),
        "kv_map": {"dims": (head_dim, 2**31), "strides": (head_dim * esz,),
                   "box": (head_dim if quantized else 64, rows),
                   "swizzle": 0 if quantized else 128},
        "stage_bytes": stage_tx,
        "smem_bytes": smem,
    }


def _kernel(quantized: bool = False):
    fn = _fn.get(quantized)
    if fn is None:
        lib = _build.load_library("ragged_attention")
        if quantized:
            fn = lib.dli_quantized_ragged_paged_attention
            pointers = 10
        else:
            fn = lib.dli_ragged_paged_attention
            pointers = 8
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn[quantized] = fn
    return fn


def _plain(q, k_pages, v_pages, page_table, kv_lengths, num_new, q_start,
           scale, sliding_window, ks_pages=None, vs_pages=None):
    """Gather the row's pages, mask per (query, slot), softmax in f32; pad
    queries and empty rows give zeros. With scale planes the pages are int8:
    the K scale multiplies the score, the V scale the probability before
    P V, as the TPU kernel does."""
    b, s, hq, d = q.shape
    hkv = k_pages.shape[1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    if q_start is None:
        q_start = kv_lengths - num_new

    k = gather_pages(k_pages, page_table).float()      # [B, KV, Hkv, D]
    v = gather_pages(v_pages, page_table).float()
    qr = q.reshape(b, s, hkv, g, d).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qr, k)
    if ks_pages is not None:
        ks = gather_scales(ks_pages, page_table)       # [B, KV, Hkv]
        scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    scores = scores * scale

    q_rel = torch.arange(s, device=q.device)[None, :]            # [1, S]
    q_pos = q_start[:, None] + q_rel                             # [B, S]
    pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    valid = (
        (pos < kv_lengths[:, None, None])
        & (pos <= q_pos[:, :, None])
        & (q_rel < num_new[:, None])[:, :, None]
    )                                                            # [B, S, KV]
    if sliding_window is not None:
        valid = valid & (pos > q_pos[:, :, None] - sliding_window)
    valid = valid[:, None, None]
    scores = torch.where(valid, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if vs_pages is not None:
        vs = gather_scales(vs_pages, page_table)
        p = p * vs.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgst,bthd->bshgd", p / l.clamp_min(1e-20), v)
    return out.reshape(b, s, hq, d).to(q.dtype)


def ragged_paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
):
    """Plain PyTorch version of :func:`ragged_paged_attention`: gather the
    row's pages, mask per (query, slot), softmax in f32; pad queries and
    empty rows give zeros. Same arguments and result."""
    return _plain(q, k_pages, v_pages, page_table, kv_lengths, num_new,
                  q_start, scale, sliding_window)


def quantized_ragged_paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    ks_pages: torch.Tensor,
    v_pages: torch.Tensor,
    vs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
):
    """Plain PyTorch version of :func:`quantized_ragged_paged_attention`."""
    return _plain(q, k_pages, v_pages, page_table, kv_lengths, num_new,
                  q_start, scale, sliding_window, ks_pages, vs_pages)


def _launch(name, q, k_pages, v_pages, page_table, kv_lengths, num_new,
            q_start, scale, sliding_window, scales=()):
    if q_start is None:
        q_start = kv_lengths - num_new
    code = check_kernel_inputs(
        name, q, k_pages, v_pages, page_table,
        (("kv_lengths", kv_lengths), ("num_new", num_new),
         ("q_start", q_start)), scales,
    )
    b, s, hq, d = q.shape
    num_pages, hkv, page_size, _ = k_pages.shape
    if q.dtype == torch.bfloat16:  # raises on what the launch cannot take
        launch_plan(b, s, hkv, hq // hkv, d, page_size, num_pages,
                    bool(scales))
    if scale is None:
        scale = d**-0.5
    if scales:
        pools = (k_pages.data_ptr(), scales[0][1].data_ptr(),
                 v_pages.data_ptr(), scales[1][1].data_ptr())
    else:
        pools = (k_pages.data_ptr(), v_pages.data_ptr())
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(bool(scales))(
            q.data_ptr(), *pools, page_table.data_ptr(),
            kv_lengths.data_ptr(), q_start.data_ptr(), num_new.data_ptr(),
            out.data_ptr(), b, s, hkv, hq // hkv, d, page_size,
            page_table.shape[1], float(scale), int(sliding_window or 0),
            code, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    return out


def ragged_paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    block_q: Optional[int] = None,
):
    """Ragged mixed-phase attention straight over the page pool.

    ``q``: ``[B, S, Hq, D]`` (already rotated; row ``b``'s first
    ``num_new[b]`` tokens are real, the rest pad); ``k_pages``/``v_pages``:
    ``[P, Hkv, page_size, D]`` one layer's pool, keys stored rotated;
    ``page_table``: ``[B, T]`` int32 physical page ids (0 = null page);
    ``kv_lengths``: ``[B]`` int32 live kv per row INCLUDING this call's
    scattered tokens; ``num_new``: ``[B]`` int32 valid query count per row
    (1 = decode row, a chunk, or a full prompt); ``q_start``: ``[B]`` int32
    absolute position of each row's first query (defaults to
    ``kv_lengths - num_new``). Returns ``[B, S, Hq, D]`` with pad query rows
    zeroed. ``block_q`` is accepted for signature parity with the JAX
    function; the CUDA kernel fixes its own query tile (128 score rows for
    bf16, 64 for f32).
    """
    global launches
    del block_q
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, page_table, kv_lengths, num_new, q_start,
            scale, sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device {q.device}")
    out = _launch("ragged_paged_attention", q, k_pages, v_pages, page_table,
                  kv_lengths, num_new, q_start, scale, sliding_window)
    launches += 1
    return out


def quantized_ragged_paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    ks_pages: torch.Tensor,
    v_pages: torch.Tensor,
    vs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    block_q: Optional[int] = None,
):
    """As :func:`ragged_paged_attention` over int8 pages with per-(slot,
    head) scale planes (``ks_pages``/``vs_pages``: ``[P, Hkv, page_size]``
    f32)."""
    global quantized_launches
    del block_q
    if q.device.type == "cpu":
        return quantized_ragged_paged_attention_plain(
            q, k_pages, ks_pages, v_pages, vs_pages, page_table, kv_lengths,
            num_new, q_start, scale, sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"quantized_ragged_paged_attention: unsupported device {q.device}"
        )
    out = _launch("quantized_ragged_paged_attention", q, k_pages, v_pages,
                  page_table, kv_lengths, num_new, q_start, scale,
                  sliding_window,
                  (("ks_pages", ks_pages), ("vs_pages", vs_pages)))
    quantized_launches += 1
    return out


# ---------------------------------------------------------------------------
# The latent (MLA) pool: K = V = the stored [c ; k_rope] latent
# ---------------------------------------------------------------------------


def latent_ragged_paged_attention_plain(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
):
    """Plain PyTorch version of :func:`latent_ragged_paged_attention`: the
    plain ragged attention with ``K = V = c_pages`` (f32 math, output in
    q's type)."""
    return _plain(q, c_pages, c_pages, page_table, kv_lengths, num_new,
                  q_start, scale, sliding_window)


def quantized_latent_ragged_paged_attention_plain(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    cs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
):
    """Plain PyTorch version of
    :func:`quantized_latent_ragged_paged_attention`: the scale multiplies
    the score (K) and the probability before P V (V), in f32."""
    return _plain(q, c_pages, c_pages, page_table, kv_lengths, num_new,
                  q_start, scale, sliding_window, cs_pages, cs_pages)


# The tensor-core instance (``latent_wgmma_kernel``): bf16 queries at this
# lat_dim (DeepSeek-V2/V3's 512 + 64), 64 score rows a block.
WGMMA_LAT_DIM = 576
_WGMMA_ROWS, _WGMMA_WGS, _WGMMA_TILE_ROWS = 64, 3, 32


def latent_ragged_entry(dtype: torch.dtype, lat_dim: int) -> str:
    """The C entry of ``csrc/latent_attention.cu`` that takes ragged
    latent attention for queries of ``dtype`` over a latent of ``lat_dim``:
    the tensor-core instance for bf16 at lat_dim 576, else the CUDA-core
    kernel (f32 queries, which the engine's exact-stream checks need, and
    lat_dim 80). Widths neither takes are refused before this is asked."""
    if dtype == torch.bfloat16 and lat_dim == WGMMA_LAT_DIM:
        return "dli_latent_ragged_wgmma"
    return "dli_latent_ragged_attention"


def latent_wgmma_plan(seq: int, group: int, quantized: bool) -> dict:
    """The tensor-core instance's launch as ``csrc/latent_attention.cu``
    makes it (its ``dli_latent_wgmma_plan`` reports the same numbers): a
    block holds 64 score rows, ``64 >> gshift`` queries of
    ``rows_per_query(group)`` rows each (padding heads are zeros, never
    written); the grid's x is the query tiles, launched last tile first;
    three consumer warpgroups own 192 of the 576 columns each (their third
    of Q K^T's depth and of P V's columns) and a producer warpgroup feeds
    them a tile of 32 rows a step: 32 positions of the int8 pool, or 16 of
    the f32 pool as a hi and a lo row each. The shared memory is Q, the
    ring of converted tiles, the raw ring the bulk copies land in (pieces
    of 9216 bytes), the partial scores, the int8 scales (each converted
    stage's K and V scales, each raw piece's) and the barriers."""
    gshift = (group - 1).bit_length()
    per = _WGMMA_ROWS >> gshift
    d = WGMMA_LAT_DIM
    step = _WGMMA_TILE_ROWS if quantized else _WGMMA_TILE_ROWS // 2
    stages = 3
    piece, pieces = (16, 2) if quantized else (4, 3)
    row_bytes = d * (1 if quantized else 4)
    smem = (_WGMMA_ROWS * d * 2 + stages * _WGMMA_TILE_ROWS * d * 2
            + pieces * piece * row_bytes
            + _WGMMA_WGS * 128 * 2 * (step // 4) * 4
            + ((2 * stages * step + pieces * piece) * 4 if quantized else 0)
            + (2 * pieces + 2 * stages) * 8)
    return {"query_tiles": -(-seq // per), "queries_a_block": per,
            "threads": (_WGMMA_WGS + 1) * 128, "smem_bytes": smem,
            "stages": stages, "pieces": pieces, "piece_positions": piece,
            "step": step, "rows_per_query": 1 << gshift,
            "columns_a_warpgroup": d // _WGMMA_WGS}


def _latent_launch(name, q, c_pages, cs_pages, page_table, kv_lengths,
                   num_new, q_start, scale, sliding_window):
    global latent_wgmma_launches, quantized_latent_wgmma_launches
    if q_start is None:
        q_start = kv_lengths - num_new
    code = check_latent_inputs(
        name, q, c_pages, page_table,
        (("kv_lengths", kv_lengths), ("num_new", num_new),
         ("q_start", q_start)), cs_pages)
    b, s, g, d = q.shape
    entry = latent_ragged_entry(q.dtype, d)
    if entry == "dli_latent_ragged_wgmma" and c_pages.data_ptr() % 16:
        # the bulk copies read pool rows from 16-byte aligned addresses
        raise ValueError(f"{name}: c_pages must be 16-byte aligned")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = latent_kernel(entry)(
            q.data_ptr(), c_pages.data_ptr(),
            None if cs_pages is None else cs_pages.data_ptr(),
            page_table.data_ptr(), kv_lengths.data_ptr(), q_start.data_ptr(),
            num_new.data_ptr(), out.data_ptr(), b, s, g, d,
            c_pages.shape[2], page_table.shape[1], float(scale),
            int(sliding_window or 0), code,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed ({err})")
    if entry == "dli_latent_ragged_wgmma":
        if cs_pages is None:
            latent_wgmma_launches += 1
        else:
            quantized_latent_wgmma_launches += 1
    return out


def latent_ragged_paged_attention(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    block_q: Optional[int] = None,
):
    """Absorbed-MLA ragged attention reading the latent pool in place.

    ``c_pages``: ``[P, 1, page_size, lat_dim]`` f32, one layer's fused
    ``[c ; k_rope]`` latents (rope already on the rope slice); ``q``: the
    absorbed query ``[B, S, Hq, lat_dim]`` (bf16 or f32). Attention runs
    with ``K = V =`` the stored latent over one latent head (G = Hq);
    otherwise the arguments are :func:`ragged_paged_attention`'s. Output
    ``[B, S, Hq, lat_dim]`` in q's type, pad queries zeroed; all the
    arithmetic is f32. On the card, ``csrc/latent_attention.cu`` (lat_dim
    576 or 80, 1 to 16 query heads): bf16 queries at lat_dim 576 on the
    tensor cores, with f32-grade products from bf16 hi + lo terms
    (:func:`latent_wgmma_plan`), f32 queries and lat_dim 80 on the CUDA
    cores (:func:`latent_ragged_entry`). ``block_q`` is accepted for
    signature parity with the JAX function."""
    global latent_launches
    del block_q
    if q.device.type == "cpu":
        return latent_ragged_paged_attention_plain(
            q, c_pages, page_table, kv_lengths, num_new, q_start, scale,
            sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"latent_ragged_paged_attention: unsupported "
                         f"device {q.device}")
    out = _latent_launch("latent_ragged_paged_attention", q, c_pages, None,
                         page_table, kv_lengths, num_new, q_start, scale,
                         sliding_window)
    latent_launches += 1
    return out


def quantized_latent_ragged_paged_attention(
    q: torch.Tensor,
    c_pages: torch.Tensor,
    cs_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    block_q: Optional[int] = None,
):
    """As :func:`latent_ragged_paged_attention` over the int8 latent pool
    (``cs_pages``: ``[P, 1, page_size]`` per-token f32 scales)."""
    global quantized_latent_launches
    del block_q
    if q.device.type == "cpu":
        return quantized_latent_ragged_paged_attention_plain(
            q, c_pages, cs_pages, page_table, kv_lengths, num_new, q_start,
            scale, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"quantized_latent_ragged_paged_attention: "
                         f"unsupported device {q.device}")
    out = _latent_launch("quantized_latent_ragged_paged_attention", q,
                         c_pages, cs_pages, page_table, kv_lengths, num_new,
                         q_start, scale, sliding_window)
    quantized_latent_launches += 1
    return out


def ragged_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    num_new: torch.Tensor,
    q_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    ks_pages: Optional[torch.Tensor] = None,
    vs_pages: Optional[torch.Tensor] = None,
):
    """Oracle as the JAX file has it: contiguous gather, masked
    ``softmax`` over every slot, pad query rows zeroed afterwards; int8
    pools are dequantized when scale planes are given (keyword arguments
    here, positional after ``num_new`` in the JAX function)."""
    b, s, hq, d = q.shape
    hkv = k_pages.shape[1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    if q_start is None:
        q_start = kv_lengths - num_new

    k = gather_pages(k_pages, page_table).float()
    v = gather_pages(v_pages, page_table).float()
    if ks_pages is not None:
        k = k * gather_scales(ks_pages, page_table)[..., None]
        v = v * gather_scales(vs_pages, page_table)[..., None]
    qr = q.reshape(b, s, hkv, g, d).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qr, k) * scale

    q_pos = q_start[:, None] + torch.arange(s, device=q.device)[None, :]
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = (kv_pos[:, None, :] <= q_pos[:, :, None]) & (
        kv_pos[:, None, :] < kv_lengths[:, None, None]
    )
    if sliding_window is not None:
        valid = valid & (kv_pos[:, None, :] > q_pos[:, :, None] - sliding_window)
    scores = torch.where(valid[:, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    q_valid = torch.arange(s, device=q.device)[None, :] < num_new[:, None]
    out = torch.where(q_valid[..., None, None, None], out, 0.0)
    return out.reshape(b, s, hq, d).to(q.dtype)
