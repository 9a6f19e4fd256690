"""Safetensors reader and writer in pure Python (counterpart of the JAX
package's ``utils/streader.py``, which drives a native C++ reader and falls
back on the ``safetensors`` wheel).

The port needs neither: the format is an 8-byte little-endian header length,
a JSON header that maps each tensor's name to its ``dtype`` tag, ``shape``
and ``data_offsets`` (begin, end) into the data section, plus an optional
``__metadata__`` map of strings, then the raw little-endian bytes. A file is
read through one ``mmap`` and each tensor is a ``torch.frombuffer`` view of
its bytes: bf16 goes to ``torch.bfloat16`` by its bits, nothing passes
through numpy or float32, and a caller that copies a tensor to the card
keeps no host copy of it. The writer lays files out as the ``safetensors``
wheel does (tensors by dtype in the wheel's order, then by name; the
header padded with spaces to 8 bytes): its files are the wheel's, byte for
byte.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from typing import Dict, List, Mapping, Optional, Tuple

import torch

__all__ = ["DTYPES", "SafetensorsFile", "load_file", "save_file"]

# safetensors dtype tag -> torch dtype (the JAX package's tags,
# ``utils/streader.py:37-48``), in the order the wheel's writer lays tensors
# out: this list's order, then by name.
DTYPES = {
    "I64": torch.int64,
    "F64": torch.float64,
    "F32": torch.float32,
    "I32": torch.int32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TAGS = {v: k for k, v in DTYPES.items()}
_RANK = {v: i for i, v in enumerate(DTYPES.values())}
# The header's length field is 8 bytes; a header longer than this is not a
# checkpoint (the wheel's own limit).
_MAX_HEADER = 100_000_000


class SafetensorsFile:
    """One safetensors file, mapped read-only; tensors by name.

    ``get(name)`` is a view of the mapping (no copy), valid while the
    tensor lives even after :meth:`close` drops this object's handle, and
    while the file is not rewritten in place. Usage::

        with SafetensorsFile(path) as f:
            w = f.get("model.norm.weight").to("cuda")
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            head = fh.read(8)
            if len(head) != 8:
                raise ValueError(f"{path!r}: not a safetensors file (truncated)")
            (hlen,) = struct.unpack("<Q", head)
            if hlen > _MAX_HEADER:
                raise ValueError(f"{path!r}: header length {hlen} is too large")
            raw = fh.read(hlen)
            if len(raw) != hlen:
                raise ValueError(f"{path!r}: header truncated")
            try:
                header = json.loads(raw)
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{path!r}: header is not JSON: {e}")
            if not isinstance(header, dict):
                raise ValueError(f"{path!r}: header is not a JSON object")
            size = fh.seek(0, 2)
            # A private (copy-on-write) mapping: torch.frombuffer wants a
            # writable buffer, and nothing ever writes to it.
            self._mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: Optional[Dict[str, str]] = header.pop("__metadata__", None)
        self._base = 8 + hlen
        self._data_len = size - self._base
        self._specs: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for name, m in header.items():
            self._specs[name] = self._spec(name, m)

    def _spec(self, name, m):
        try:
            dtype = DTYPES[m["dtype"]]
            shape = tuple(int(s) for s in m["shape"])
            begin, end = (int(o) for o in m["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{self.path!r}: bad header entry {name!r}")
        nbytes = math.prod(shape) * dtype.itemsize
        if end - begin != nbytes or begin < 0 or end > self._data_len:
            raise ValueError(f"{self.path!r}: corrupt tensor entry {name!r}")
        return dtype, shape, begin, end

    def keys(self) -> List[str]:
        return list(self._specs)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a view of the mapped file."""
        dtype, shape, begin, end = self._specs[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        offset = self._base + begin
        if offset % dtype.itemsize:
            # Misaligned for its type: go through an aligned byte copy.
            raw = torch.frombuffer(
                self._mm, dtype=torch.uint8, count=end - begin, offset=offset
            ).clone()
            return raw.view(dtype).view(shape)
        return torch.frombuffer(
            self._mm, dtype=dtype, count=math.prod(shape), offset=offset
        ).view(shape)

    def close(self) -> None:
        # Views handed out by get() keep the mapping alive by reference;
        # the mapping closes when the last of them goes.
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, each a copy of its own."""
    with SafetensorsFile(path) as f:
        return {name: f.get(name).clone() for name in f.keys()}


def save_file(
    tensors: Mapping[str, torch.Tensor],
    path: str,
    metadata: Optional[Mapping[str, str]] = None,
) -> None:
    """Write ``tensors`` (on any device, any strides) as one safetensors
    file. Each tensor is copied to the host and written one at a time, so
    the host holds at most one of them."""
    for name, t in tensors.items():
        if t.dtype not in _TAGS:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors tag")
    order = sorted(tensors, key=lambda k: (_RANK[tensors[k].dtype], k))
    header: Dict[str, object] = {}
    if metadata is not None:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in metadata.items()):
            raise ValueError("metadata must map strings to strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _TAGS[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for name in order:
            t = tensors[name]
            if t.numel() == 0:
                continue
            host = t.detach().to("cpu").contiguous().reshape(-1)
            fh.write(host.view(torch.uint8).numpy().data)
