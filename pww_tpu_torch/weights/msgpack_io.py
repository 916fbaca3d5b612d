"""Read flax's msgpack checkpoints (``params.msgpack``) with numpy and torch
alone.

``flax.serialization.to_bytes`` writes a msgpack map tree. An array is ext
type 1 holding a packed ``(shape, dtype name, raw C-order bytes)``; a numpy
scalar is ext type 3 with the same payload; a Python complex is ext type 2,
a packed ``(real, imag)``. An array larger than flax's ``MAX_CHUNK_SIZE``
becomes a map ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat array, ...}}`` (``flax/serialization.py:324-389``).
This decoder covers msgpack's maps, arrays, strings, bins, ints, floats,
bools and nil, and those ext types; arrays come back as CPU tensors of their
own type, ``bfloat16`` read as int16 and viewed as ``torch.bfloat16`` (no
``ml_dtypes`` needed).
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"

_NUMPY = {"float64": np.float64, "float32": np.float32, "float16": np.float16,
          "bfloat16": np.int16, "int64": np.int64, "int32": np.int32, "int16": np.int16,
          "int8": np.int8, "uint64": np.uint64, "uint32": np.uint32, "uint16": np.uint16,
          "uint8": np.uint8, "bool": np.bool_}
# fixed-size scalars: format byte → (struct format, size)
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
            0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
            0xd2: (">i", 4), 0xd3: (">q", 8)}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data):
        self.view = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError(f"msgpack data ends at byte {len(self.view)}; an object "
                             f"needs bytes {self.pos}..{self.pos + n}")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, n: int) -> int:
        return self.unpack(_LENGTHS[n], n)

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
            return self.take(self.length(1 << (b - 0xc4)))
        if b in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
            n = self.length(1 << (b - 0xc7))
            return self.ext(self.unpack(">b", 1), self.take(n))
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if 0xd4 <= b <= 0xd8:  # fixext 1/2/4/8/16
            code = self.unpack(">b", 1)
            return self.ext(code, self.take(1 << (b - 0xd4)))
        if b in (0xd9, 0xda, 0xdb):  # str 8/16/32
            return str(self.take(self.length(1 << (b - 0xd9))), "utf-8")
        if b in (0xdc, 0xdd):  # array 16/32
            return [self.obj() for _ in range(self.length(2 if b == 0xdc else 4))]
        if b in (0xde, 0xdf):  # map 16/32
            return self.map(self.length(2 if b == 0xde else 4))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, code: int, payload: memoryview):
        if code in (1, 3):  # ndarray, numpy scalar
            shape, dtype, buf = _Reader(payload).obj()
            if dtype not in _NUMPY:
                raise ValueError(f"array of dtype {dtype!r}; this reader takes "
                                 f"{sorted(_NUMPY)}")
            # a copy: the payload sits at any offset, unaligned for its type
            arr = np.frombuffer(buf, dtype=_NUMPY[dtype]).reshape(shape).copy()
            t = torch.from_numpy(arr)
            return t.view(torch.bfloat16) if dtype == "bfloat16" else t
        if code == 2:  # complex
            real, imag = _Reader(payload).obj()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data) -> Any:
    """One msgpack object from the bytes-like ``data``, chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.view):
        raise ValueError(f"{len(reader.view) - reader.pos} bytes left after the msgpack object")
    return _unchunk(tree)


def load_file(path: str) -> Any:
    """The tree a flax ``to_bytes`` wrote to ``path``."""
    with open(path, "rb") as f:
        return loads(f.read())
