"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

Every ``csrc/*.cu`` has a plain C interface. :func:`build` compiles each
source to an object with one nvcc process per source, all at once, and links
the objects into one library, ``build/pww_tpu_torch/pww_kernels-<hash>.so``
at the repository root (a directory git ignores). The hash covers every
source, the shared headers and the flags, so an edited source builds anew.
A first use or ``chip_smoke.py`` calls it. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "pww_tpu_torch")
SOURCES = ("pww_reduce", "pww_cross_attention", "flash_attention", "group_norm",
           "layer_norm", "library")
HEADERS = ("common.cuh", "hopper.cuh", "attention_tile.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build pww_tpu_torch's kernels")
    return path


def library_path() -> str:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in (*(s + ".cu" for s in SOURCES), *HEADERS):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"pww_kernels-{digest.hexdigest()[:16]}.so")


def build() -> Dict[str, str]:
    """Compile and link the library unless it exists already.

    Returns {source: ptxas report} for the sources compiled now (empty if the
    library was there). Raises with nvcc's output if a step fails.
    """
    out = library_path()
    if os.path.exists(out):
        return {}
    tmp = os.path.join(BUILD_DIR, f"tmp-{os.getpid()}-{threading.get_ident()}")
    os.makedirs(tmp, exist_ok=True)
    try:
        procs = {
            name: subprocess.Popen(
                [_nvcc(), *COMPILE_FLAGS, "-o", os.path.join(tmp, name + ".o"),
                 os.path.join(CSRC_DIR, name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in SOURCES
        }
        reports, failed = {}, []
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            reports[name] = log
        if not failed:
            link = subprocess.run(
                [_nvcc(), *ARCH, "-shared", "-o", os.path.join(tmp, "lib.so"),
                 *(os.path.join(tmp, name + ".o") for name in SOURCES)],
                capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"--- link (nvcc exit {link.returncode})\n"
                              f"{link.stdout}{link.stderr}")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        os.replace(os.path.join(tmp, "lib.so"), out)
        return reports
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = ctypes.CDLL(library_path())
        return _lib


def function(name: str, argtypes):
    """A C entry point of the library returning ``int`` (a ``cudaError_t``)."""
    if name not in _fns:
        f = getattr(library(), name)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[name] = f
    return _fns[name]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        f = library().pww_error_string
        f.argtypes = [ctypes.c_int]
        f.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err}: {f(err).decode()}")


def records_grad(*tensors) -> bool:
    """Whether autograd would record a gradient through an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


# The device types whose tensors the norm sites send to K4 and K5
NORM_KERNEL_DEVICES = ("cuda",)


def norm_site_takes_kernel(x: torch.Tensor, *params) -> bool:
    """The norm sites' rule (``ops/group_norm.py:group_norm_site``,
    ``ops/layer_norm.py:layer_norm_site``): K4 or K5 runs a site whose input
    is a non-empty bf16 tensor on the card through which autograd records
    no gradient (neither ``x`` nor ``params`` requires one under grad mode);
    the CPU, other dtypes and training take the f32 composition."""
    return (x.device.type in NORM_KERNEL_DEVICES and x.dtype == torch.bfloat16
            and x.numel() > 0 and not records_grad(x, *params))


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would be launched on inputs
    that require a gradient: its output would carry no ``grad_fn``, and the
    gradient through it would be dropped without a word."""
    if records_grad(*tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel has no backward (ROADMAP.md §B), so it cannot run "
            "under autograd on inputs that require a gradient; call it under "
            "torch.no_grad(), or keep the knob that sends this site to it off")
