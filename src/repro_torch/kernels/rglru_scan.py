"""RG-LRU diagonal recurrence on Hopper — the port of the recurrentgemma
scan (B4).

The CUDA kernel in ``csrc/rglru_scan.cu`` runs h_t = a_t·h_{t-1} + b_t
with one thread per (batch row, channel) and the carry in a float32
register, and writes each h_t in a's dtype.  This module is its wrapper:
it checks the inputs, allocates y with ``torch.empty`` and launches on the
current stream.  Dispatch by device, the plain version for CPU tensors and
the backward pass live in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.library("rglru_scan")
        lib.rglru_scan_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.rglru_scan_launch.restype = ctypes.c_int
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(a, b) -> None:
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"want a, b of one shape (B, S, W); got a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must lie on a's CUDA device "
                             f"({a.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape[0] > 65535:
        raise ValueError(f"rglru_scan kernel takes B <= 65535, got "
                         f"{a.shape[0]}")


def rglru_scan(a, b):
    """y (B, S, W) in a's dtype, computed by the CUDA kernel.  a and b
    share one shape and dtype (float32 or bfloat16), contiguous, on one
    CUDA device; B <= 65535."""
    _check(a, b)
    lib = _library()
    Bsz, S, W = a.shape
    y = torch.empty_like(a)
    rc = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), y.data_ptr(), Bsz, S, W,
        DTYPE_CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: "
                           f"{lib.rglru_scan_error_string(rc).decode()} "
                           f"({rc})")
    return y
