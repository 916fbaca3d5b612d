"""The native host-ops library: color-map masks, the apps' color tools and
prompt token matching, in C++ through ctypes.

Port of :mod:`pww_tpu.native`. ``host_ops.cpp`` (the port's own copy) is
built with ``g++ -O3 -shared -fPIC`` at first use into
``build/pww_tpu_torch/libpww_host.so`` at the repository root (a directory
git ignores), and built again when the source is newer than the library. A
failed build raises with the compiler's message: there is no silent
fallback. The numpy versions are in :mod:`pww_tpu_torch.native.plain`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "host_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "pww_tpu_torch")
SO = os.path.join(BUILD_DIR, "libpww_host.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(src: str = SRC, out: str = SO, compiler: str = "g++") -> str:
    """Compile ``src`` into the shared library ``out`` (written to a
    temporary file and moved into place, so that concurrent builds never
    see half a library); returns ``out``. Raises ``RuntimeError`` with the
    compiler's output if it fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        proc = subprocess.run([compiler, "-O3", "-shared", "-fPIC", src, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native host library: cannot run {compiler}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native host library: {compiler} exit {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built first where it is missing or older than its source."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SO) or os.path.getmtime(SRC) > os.path.getmtime(SO):
            build()
        lib = ctypes.CDLL(SO)
        i64, f32, u8 = ctypes.c_int64, ctypes.c_float, ctypes.c_uint8
        P = ctypes.POINTER
        lib.color_masks.argtypes = [P(u8), i64, i64, P(u8), P(f32), i64, P(f32), P(i64)]
        lib.color_mask_sqdist.argtypes = [P(u8), i64, i64, P(u8), i64, P(u8)]
        lib.unique_colors.restype = i64
        lib.unique_colors.argtypes = [P(u8), i64, i64, i64, P(u8), P(i64), i64]
        lib.token_match_row.restype = i64
        lib.token_match_row.argtypes = [P(i64), i64, P(i64), i64, P(f32)]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def color_masks(
    img: np.ndarray, colors: np.ndarray, strengths: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(N,H,W) strength-scaled exact-match masks + per-color pixel counts."""
    img = np.ascontiguousarray(img[..., :3], np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    strengths = np.ascontiguousarray(strengths, np.float32)
    h, w = img.shape[:2]
    n = len(colors)
    out = np.empty((n, h, w), np.float32)
    counts = np.empty((n,), np.int64)
    load().color_masks(
        _ptr(img, ctypes.c_uint8), h, w, _ptr(colors, ctypes.c_uint8),
        _ptr(strengths, ctypes.c_float), n, _ptr(out, ctypes.c_float),
        _ptr(counts, ctypes.c_int64),
    )
    return out, counts


def color_mask_sqdist(img: np.ndarray, color, threshold: int = 30) -> np.ndarray:
    """(H, W) bool: pixels within squared RGB distance ``threshold`` of ``color``."""
    img = np.ascontiguousarray(img[..., :3], np.uint8)
    h, w = img.shape[:2]
    c = np.ascontiguousarray(color, np.uint8)
    out = np.empty((h, w), np.uint8)
    load().color_mask_sqdist(
        _ptr(img, ctypes.c_uint8), h, w, _ptr(c, ctypes.c_uint8),
        int(threshold), _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def unique_colors(img: np.ndarray, min_fraction: float = 0.01,
                  max_out: int = 8) -> List[Tuple[Tuple[int, int, int], int]]:
    """Up to ``max_out`` (color, pixel count) pairs, most common first, of the
    colors covering more than ``min_fraction`` of the image."""
    img = np.ascontiguousarray(img[..., :3], np.uint8)
    h, w = img.shape[:2]
    min_count = max(1, int(min_fraction * h * w) + 1)
    out_c = np.empty((max_out, 3), np.uint8)
    out_n = np.empty((max_out,), np.int64)
    got = load().unique_colors(
        _ptr(img, ctypes.c_uint8), h, w, min_count,
        _ptr(out_c, ctypes.c_uint8), _ptr(out_n, ctypes.c_int64), max_out,
    )
    return [(tuple(int(x) for x in out_c[i]), int(out_n[i])) for i in range(got)]


def token_match_row(ids, sub) -> Tuple[np.ndarray, int]:
    """Occurrence-count row over prompt positions (overlap-additive). An
    empty ``sub`` occurs at each of the len(ids) + 1 positions and adds
    nothing to the row, as the numpy version counts it."""
    ids = np.ascontiguousarray(ids, np.int64)
    sub = np.ascontiguousarray(sub, np.int64)
    row = np.zeros((len(ids),), np.float32)
    if len(sub) == 0:
        return row, len(ids) + 1
    hits = load().token_match_row(
        _ptr(ids, ctypes.c_int64), len(ids), _ptr(sub, ctypes.c_int64),
        len(sub), _ptr(row, ctypes.c_float),
    )
    return row, int(hits)
