"""The bf16 instance of the port's int4 matmul (``csrc/int4_matmul.cu``,
``int4_mma_kernel``) as a plain model, held to the JAX package's
``int4_matmul`` and ``int4_matmul_stacked`` (Pallas, interpret mode) on the
same numpy inputs; its split plan (``ops/quant_matmul.py:mma_plan``); and
the wrappers' choice of kernel entry.

The model follows the kernel step by step: the plan's clusters and their
split over input rows, the 128-row TMA boxes as the 128-byte swizzle lays
them out in shared memory (rows past the stack read as zeros), x staged in
the order of the B fragments (in windows), each lane's four words read at
the kernel's offsets, paired by ``prmt`` and turned into bf16 by the nibble
bit trick, the ``mma.sync`` m16n8k16 fragments, the k warps' sums in their
fixed order, the cluster's sum in rank order, the scales and one rounding
to bf16. The products are exact (bf16 x and int4 w), so the model and the
JAX kernel (f32 x that bf16 represents, f32 sums) differ only in the order
of f32 sums: 2e-5 of max |out| before the rounding, one bf16 step (2^-8 of
max |out|, under the kernel's 1e-2) after it.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inference_tpu.ops import quant_matmul as jqm
from distributed_llm_inference_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)
RTOL_F32 = 2e-5  # of max |out|: f32 sums in another order
RTOL_BF16 = 1e-2  # of max |out|: one bf16 step of the output (chip_smoke TOL4)
TILE, STAGE, PASS = 128, 128, 64  # the kernel's tile bytes, stage rows, pass rows
KW = 2  # consumer warps along k


def bf16_bits_to_f32(bits):
    """bf16 bit patterns (uint16) as float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def bf16_round(a):
    """float32 to the nearest bf16 (ties to even), as float32."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def prmt(a, b, sel):
    """PTX prmt.b32 (default mode) on uint32 arrays."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF
                                                       for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def nibble_pairs(p):
    """The kernel's ``nibble_pairs``: four bf16 pairs (as [4, ..., 2] f32,
    low half first) from a word of paired packed bytes, by integer ops on
    the bits: ((p >> 4i) & 0x000F000F) ^ 0x43084308 is bf16 136 + n, and
    136 is subtracted (exact)."""
    out = []
    for i in range(4):
        v = ((p >> (4 * i)) & 0x000F000F) ^ 0x43084308
        pair = np.stack([bf16_bits_to_f32(v & 0xFFFF),
                         bf16_bits_to_f32(v >> 16)], axis=-1)
        out.append(pair - np.float32(136.0))
    return out


def lane_offsets(cw):
    """Byte offsets of rows 2t and 2t + 1 of a 16-row step for the 32 lanes
    of column warp ``cw`` in a 128-byte-swizzled stage (chunk c of row r at
    c ^ (r & 7))."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    col = 32 * cw + 4 * g
    off_e = 2 * t * TILE + ((((col >> 4) ^ (2 * t)) << 4) | (col & 15))
    off_o = (2 * t + 1) * TILE + ((((col >> 4) ^ (2 * t + 1)) << 4) | (col & 15))
    return off_e, off_o


def swizzled_stage(flat, row0, col0):
    """One TMA box: 128 packed rows from ``row0`` and 128 byte columns from
    ``col0`` of the stack viewed as [L * in_pad, outp] (zeros outside), in
    the 128-byte swizzle's layout."""
    box = np.zeros((STAGE, TILE), np.uint8)
    rows = flat[row0:row0 + STAGE, col0:col0 + TILE]
    box[:rows.shape[0], :rows.shape[1]] = rows.view(np.uint8)
    smem = np.zeros(STAGE * TILE, np.uint8)
    r = np.arange(STAGE)[:, None]
    c = np.arange(TILE)[None, :]
    smem[r * TILE + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)] = box
    return smem


def staged_x(x, row0, nt, k0, k_end, n):
    """x rows row0.. (8 nt of them), inputs k0 .. k0 + n - 1, as the kernel
    stages them: [n / 16, nt, 32 lanes, 4] values, zeros past the rows and
    past k_end."""
    rows = x.shape[0]
    xs = np.zeros((n // 16, nt, 32, 4), np.float32)
    for q in range(n // 16):
        for j in range(nt):
            for lane in range(32):
                r = row0 + 8 * j + (lane >> 2)
                for e, dk in enumerate((0, 1, 8, 9)):
                    k = k0 + 16 * q + 2 * (lane & 3) + dk
                    if r < rows and k < k_end:
                        xs[q, j, lane, e] = x[r, k]
    return xs


def x_window(nt, k_block):
    most = 56 * 1024 // (nt * 16) // STAGE * STAGE
    return min(k_block, most)


def model_bf16_instance(x, packed, scale_lo, scale_hi, layer, out_dim, sms):
    """The bf16 kernel's arithmetic on numpy: ``x`` [rows, in_dim] f32
    holding bf16 values, ``packed`` int8 [L, in_pad, outp], scales f32
    [L, outp]. Returns (f32 sums times the scales, before the rounding;
    the bf16 output as f32)."""
    rows, in_dim = x.shape
    num_l, in_pad, outp = packed.shape
    flat = packed.reshape(num_l * in_pad, outp)
    plan = tqm.mma_plan(sms, rows, in_dim, outp)
    c, k_block = plan["cluster"], plan["k_block"]
    nt = 1 if rows <= 8 else 2 if rows <= 16 else 4 if rows <= 32 else 8
    window = x_window(nt, k_block)
    tiles = -(-outp // TILE)
    out = np.zeros((rows, 2 * outp), np.float32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for tile in range(tiles):
        for row0 in range(0, rows, PASS):
            red = []  # each rank's partial [8 nt, 256]
            for rank in range(c):
                k_begin = rank * k_block
                k_end = min(in_dim, k_begin + k_block)
                steps = -(-(k_end - k_begin) // STAGE) if k_end > k_begin else 0
                # acc[kw, cw, m, j] as [16 channels, 8 rows] matrices
                acc = np.zeros((KW, 4, 4, nt, 16, 8), np.float32)
                xs, xk = None, window
                for i in range(steps):
                    kk = i * STAGE
                    if xk == window:
                        xs = staged_x(x, row0, nt, k_begin + kk, k_end,
                                      min(window, steps * STAGE - kk))
                        xk = 0
                    smem = swizzled_stage(flat, layer * in_pad + k_begin + kk,
                                          tile * TILE)
                    xq = xk >> 4
                    xk += STAGE
                    for kw in range(KW):
                        for qq in range(STAGE // 16 // KW):
                            q = KW * qq + kw
                            base = q * 16 * TILE
                            for cw in range(4):
                                off_e, off_o = lane_offsets(cw)

                                def word(at):
                                    b = smem[at[:, None] + np.arange(4)].astype(np.uint32)
                                    return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24

                                w0, w1 = word(base + off_e), word(base + off_o)
                                w8 = word(base + 8 * TILE + off_e)
                                w9 = word(base + 8 * TILE + off_o)
                                c01 = nibble_pairs(prmt(w0, w1, 0x5410))
                                c01_8 = nibble_pairs(prmt(w8, w9, 0x5410))
                                c23 = nibble_pairs(prmt(w0, w1, 0x7632))
                                c23_8 = nibble_pairs(prmt(w8, w9, 0x7632))
                                frags = [(c01[0], c01[2], c01_8[0], c01_8[2]),
                                         (c01[1], c01[3], c01_8[1], c01_8[3]),
                                         (c23[0], c23[2], c23_8[0], c23_8[2]),
                                         (c23[1], c23[3], c23_8[1], c23_8[3])]
                                for m, (a0, a1, a2, a3) in enumerate(frags):
                                    a = np.zeros((16, 16), np.float32)
                                    a[g, 2 * t], a[g, 2 * t + 1] = a0[:, 0], a0[:, 1]
                                    a[g + 8, 2 * t], a[g + 8, 2 * t + 1] = a1[:, 0], a1[:, 1]
                                    a[g, 2 * t + 8], a[g, 2 * t + 9] = a2[:, 0], a2[:, 1]
                                    a[g + 8, 2 * t + 8], a[g + 8, 2 * t + 9] = a3[:, 0], a3[:, 1]
                                    for j in range(nt):
                                        e = xs[xq + q, j]  # [32 lanes, 4]
                                        b = np.zeros((16, 8), np.float32)
                                        b[2 * t, g], b[2 * t + 1, g] = e[:, 0], e[:, 1]
                                        b[2 * t + 8, g], b[2 * t + 9, g] = e[:, 2], e[:, 3]
                                        acc[kw, cw, m, j] += a @ b
                # The block's partial: the last k warp's, then each lower
                # k warp's added to it; slot = 128 * high + byte column.
                part = np.zeros((8 * nt, 2 * TILE), np.float32)
                for kw in reversed(range(KW)):
                    for cw in range(4):
                        for m in range(4):
                            for j in range(nt):
                                for r16 in range(16):
                                    slot = ((m & 1) * TILE + 32 * cw + 4 * (r16 & 7)
                                            + 2 * (m >> 1) + (r16 >> 3))
                                    rr = slice(8 * j, 8 * j + 8)
                                    part[rr, slot] = (acc[kw, cw, m, j, r16]
                                                      + (part[rr, slot] if kw < KW - 1
                                                         else 0))
                red.append(part)
            total = np.zeros_like(red[0])
            for part in red:  # rank order
                total = total + part
            n = min(8 * nt, rows - row0)
            for slot in range(2 * TILE):
                bc = tile * TILE + (slot & (TILE - 1))
                if bc >= outp:
                    continue
                ch = (outp if slot >= TILE else 0) + bc
                sc = (scale_hi if slot >= TILE else scale_lo)[layer, bc]
                out[row0:row0 + n, ch] = total[:n, slot] * sc
    f32 = out[:, :out_dim]
    return f32, bf16_round(f32)


def inputs(seed, num_l, in_dim, out_dim, rows):
    """Packed bytes over all 256 values (every nibble, -8 included), f32
    scales, and x holding bf16 values; the packing's padding as the
    quantizer pads (in to 1024, out to 1024 channels)."""
    rng = np.random.default_rng(seed)
    in_pad = -(-in_dim // 1024) * 1024
    outp = -(-out_dim // 1024) * 512
    packed = rng.integers(-128, 128, (num_l, in_pad, outp)).astype(np.int8)
    packed[:, in_dim:] = 0
    scale_lo = (rng.random((num_l, outp)) * 0.02 + 0.001).astype(np.float32)
    scale_hi = (rng.random((num_l, outp)) * 0.02 + 0.001).astype(np.float32)
    x = bf16_round(rng.standard_normal((rows, in_dim)))
    return x, packed, scale_lo, scale_hi


def max_rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def test_nibble_trick_is_exact_for_every_nibble():
    """(u ^ 8) | 0x4300 as bf16, minus 136, is the signed nibble u for all
    16 values; and on words of packed bytes holding every byte value, the
    kernel's prmt pairing and nibble_pairs give unpack_int4_split's values."""
    u = np.arange(16, dtype=np.uint32)
    n = np.where(u >= 8, u.astype(np.int64) - 16, u.astype(np.int64))
    got = bf16_bits_to_f32(0x4300 | (u ^ 8)) - np.float32(136.0)
    np.testing.assert_array_equal(got, n.astype(np.float32))

    byte = np.arange(256, dtype=np.uint32)
    rng = np.random.default_rng(0)
    w0 = byte | rng.permutation(byte) << 8 | rng.permutation(byte) << 16 | rng.permutation(byte) << 24
    w1 = rng.permutation(byte) | rng.permutation(byte) << 8 | rng.permutation(byte) << 16 | rng.permutation(byte) << 24
    as_int8 = lambda w, i: ((w >> (8 * i)) & 0xFF).astype(np.uint8).view(np.int8)  # noqa: E731
    ref = {i: tqm.unpack_int4_split(torch.as_tensor(
        np.stack([as_int8(w0, i), as_int8(w1, i)], axis=-1)[:, :, None])).numpy()
        for i in range(4)}  # [256, 2 rows (w0, w1), 2 (lo, hi)]
    for sel, cols in ((0x5410, (0, 1)), (0x7632, (2, 3))):
        pairs = nibble_pairs(prmt(w0, w1, sel))
        for slot, (col, half) in enumerate(((cols[0], 0), (cols[0], 1),
                                            (cols[1], 0), (cols[1], 1))):
            np.testing.assert_array_equal(pairs[slot], ref[col][:, :, half])


CASES = [  # rows, in_dim, out_dim, layers, layer, sms
    (1, 72, 24, 1, 0, 132),
    (3, 300, 1030, 2, 1, 132),
    (8, 1030, 40, 3, 2, 132),
    (20, 1030, 600, 1, 0, 132),
    (64, 1030, 40, 2, 1, 4),  # one block a cluster: three x windows
    (8, 2100, 520, 1, 0, 2),  # clusters of one over 17 stages
]


@pytest.mark.parametrize("rows,in_dim,out_dim,num_l,layer,sms", CASES)
def test_model_of_bf16_instance_matches_jax_kernels(rows, in_dim, out_dim,
                                                   num_l, layer, sms):
    x, packed, s_lo, s_hi = inputs(rows + in_dim, num_l, in_dim, out_dim, rows)
    f32, bf16 = model_bf16_instance(x, packed, s_lo, s_hi, layer, out_dim, sms)
    args = (jnp.asarray(packed), jnp.asarray(s_lo[:, None]),
            jnp.asarray(s_hi[:, None]))
    want = np.asarray(jqm.int4_matmul_stacked(
        jnp.asarray(x), *args, jnp.int32(layer), out_dim, interpret=True))
    assert want.shape == f32.shape == (rows, out_dim)
    assert max_rel(f32, want) <= RTOL_F32
    assert max_rel(bf16, want) <= RTOL_BF16
    if num_l == 1:
        flat = np.asarray(jqm.int4_matmul(
            jnp.asarray(x), jnp.asarray(packed[0]), jnp.asarray(s_lo),
            jnp.asarray(s_hi), out_dim, interpret=True))
        assert max_rel(f32, flat) <= RTOL_F32
    # The port's plain version in bf16: one rounding of f32 sums as well.
    plain = tqm.int4_matmul_stacked_plain(
        torch.as_tensor(x).to(torch.bfloat16), torch.as_tensor(packed),
        torch.as_tensor(s_lo[:, None]), torch.as_tensor(s_hi[:, None]),
        layer, out_dim).float().numpy()
    assert max_rel(bf16, plain) <= RTOL_BF16


PLAN_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
               "wo": (4096, 4096), "wg": (4096, 14336), "wu": (4096, 14336),
               "wd": (14336, 4096), "head": (4096, 128256)}


@pytest.mark.parametrize("rows", [1, 8, 16, 64, 256])
@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_mma_plan_covers_k_once_and_fills_the_card(name, rows):
    in_dim, out_dim = PLAN_SHAPES[name]
    outp = -(-out_dim // 1024) * 512
    sms = 132
    plan = tqm.mma_plan(sms, rows, in_dim, outp)
    c, k_block = plan["cluster"], plan["k_block"]
    per_sm = 2 if rows <= 16 else 1
    most = min(16 if per_sm == 2 else 8, -(-in_dim // STAGE))
    assert c & (c - 1) == 0 and 1 <= c <= most <= 16
    assert k_block % STAGE == 0
    # The ranks' ranges [r k_block, (r + 1) k_block) cover [0, in_dim) once,
    # and every rank but those past the end holds rows.
    covered = np.zeros(in_dim, np.int64)
    for rank in range(c):
        covered[rank * k_block:min(in_dim, (rank + 1) * k_block)] += 1
    assert (covered == 1).all()
    assert (c - 1) * k_block < in_dim
    tiles = -(-outp // TILE)
    passes = -(-rows // PASS)
    assert plan["clusters"] == tiles * passes
    blocks = plan["clusters"] * c
    slots = sms * per_sm
    want = min(slots, max(tqm.MMA_MIN_BLOCKS,
                          -(-in_dim * outp // tqm.MMA_BLOCK_BYTES)))
    # One wave at most (a grid of more clusters than the card holds takes
    # clusters of one), and no smaller cluster would give the blocks wanted.
    assert blocks <= max(slots, plan["clusters"])
    assert c == 1 or plan["clusters"] * c // 2 < want
    # No larger cluster was left that would still fit and is wanted.
    assert c == most or blocks >= want or 2 * blocks > slots


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@contextlib.contextmanager
def _fake_card(monkeypatch, sms=132):
    rec = _Recorder()
    monkeypatch.setattr(tqm, "_kernel", rec)
    monkeypatch.setattr(tqm, "_sms", lambda device: sms)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    yield rec


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stacked", [False, True])
def test_wrapper_takes_mma_entry_for_bf16_and_old_one_for_f32(
        monkeypatch, dtype, stacked):
    """The launch path with the library lookup replaced by a stub: a bf16
    call takes ``dli_int4_matmul_mma`` once with the plan's cluster and
    k_block and no scratch; an f32 call takes ``dli_int4_matmul`` with its
    splits and the f32 partials."""
    x, packed, s_lo, s_hi = inputs(5, 3, 300, 1030, 8)
    xt = torch.as_tensor(x).to(dtype).reshape(2, 4, 300)
    pk = torch.as_tensor(packed)
    lo, hi = torch.as_tensor(s_lo[:, None]), torch.as_tensor(s_hi[:, None])
    layer = 2 if stacked else 0
    if not stacked:
        pk, lo, hi = pk[:1], lo[:1], hi[:1]
    with _fake_card(monkeypatch) as rec:
        out = tqm._launch("int4", xt, pk, lo, hi, layer, 1030)
    assert out.shape == (2, 4, 1030) and out.dtype == dtype
    assert len(rec.calls) == 1
    name, args = rec.calls[0]
    num_l, in_pad, outp = pk.shape
    if dtype == torch.bfloat16:
        plan = tqm.mma_plan(132, 8, 300, outp)
        assert name == "dli_int4_matmul_mma"
        assert args[5:] == (8, 300, in_pad, outp, 1030, layer, num_l,
                            plan["cluster"], plan["k_block"], 7)
    else:
        splits = tqm.split_k(132, -(-outp // 128), 300)
        assert name == "dli_int4_matmul"
        assert args[6:] == (8, 300, in_pad, outp, 1030, layer, splits, 7)
    assert args[0] == xt.data_ptr() and args[1] == pk.data_ptr()


def test_wrapper_raises_for_outp_the_mma_kernel_does_not_take(monkeypatch):
    pk = torch.zeros((1, 1024, 36), dtype=torch.int8)
    sc = torch.ones((1, 1, 36))
    x = torch.zeros((1, 40), dtype=torch.bfloat16)
    with _fake_card(monkeypatch) as rec:
        with pytest.raises(ValueError, match="multiple of 16"):
            tqm._launch("int4", x, pk, sc, sc, 0, 40)
    assert rec.calls == []
