"""Read and write ``.safetensors`` files with numpy and torch alone.

The format: an 8-byte little-endian header length n, n bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` map of strings), then the tensors' raw
little-endian bytes, each at its offsets from the end of the header. F32,
F16, BF16, I64, I32, I16, I8, U8 and BOOL are read and written in
their own torch types (real SD-1.x files store ``position_ids`` as I64, and
LDM files with EMA weights ``model_ema.num_updates`` as I32); numpy has no
bfloat16, so BF16 bytes are read as uint16 and viewed as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping

import numpy as np
import torch

# safetensors dtype name → (numpy storage type, torch type)
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a file, as CPU tensors of the stored type (the
    header's ``__metadata__`` is skipped). Each tensor is read into a buffer
    of its own, so that no copy of the whole file is held at once."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size - 8 - n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                                 f"this reader takes {sorted(_DTYPES)}")
            np_type, torch_type = _DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = int(np.prod(shape))
            if not 0 <= begin <= end <= size or \
                    end - begin != count * np.dtype(np_type).itemsize:
                raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} that do "
                                 f"not fit its shape {shape} or the file's {size} bytes")
            f.seek(8 + n + begin)
            t = torch.from_numpy(np.fromfile(f, dtype=np_type, count=count).reshape(shape))
            out[name] = t.view(torch.bfloat16) if torch_type is torch.bfloat16 else t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (of a supported type, on any device) to ``path``;
    the header is padded with spaces to a multiple of 8 bytes, and larger
    element types come first, so that every tensor's data is aligned to
    its type."""
    ts = dict(tensors)
    for name, t in ts.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; this writer takes "
                             f"{sorted(_NAMES.values())}")
    order = sorted(ts, key=lambda k: (-ts[k].element_size(), k))
    header: Dict = {}
    offset = 0
    for name in order:
        t = ts[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = ts[name].detach().to("cpu").contiguous()
            if t.dtype is torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes() if t.numel() else b"")
