"""Fused linear-model loss/gradient on Hopper — the port of the paper's
convex hot spot (B1).

Each inner-optimizer iteration on a window of n points computes
    m = Xw  →  r = ℓ'(y·m)·y  →  g = Xᵀr,  L = Σℓ(y·m).
Two separate GEMV passes read X twice from device memory; the CUDA kernel
in ``csrc/linear_grad.cu`` streams it once, in bulk copies of contiguous
row tiles into shared memory, and uses each tile for both the forward dot
and the transposed accumulation; the blocks' partials are summed by a
fixed-order tree of two levels, each summer the last block to arrive.
This module is its wrapper: it checks the inputs, allocates the output
and the per-call scratch (the partials and the tickets, which the launch
zeroes on the call's stream) with ``torch.empty``, and launches on the
current stream.  Dispatch by
device (and the plain version for CPU tensors) lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LOSS_CODES = {"squared_hinge": 0, "logistic": 1}

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.library("linear_grad")
        lib.lvg_max_d.argtypes = []
        lib.lvg_max_d.restype = ctypes.c_int
        lib.lvg_grid.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.lvg_grid.restype = ctypes.c_int
        lib.lvg_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lvg_scratch_bytes.restype = ctypes.c_longlong
        lib.lvg_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.lvg_launch.restype = ctypes.c_int
        lib.lvg_error_string.argtypes = [ctypes.c_int]
        lib.lvg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(X, y, w) -> None:
    if X.dim() != 2 or y.dim() != 1 or w.dim() != 1:
        raise ValueError(f"want X (n, d), y (n,), w (d,); got "
                         f"{tuple(X.shape)}, {tuple(y.shape)}, {tuple(w.shape)}")
    n, d = X.shape
    if y.shape[0] != n or w.shape[0] != d:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, "
                         f"y {tuple(y.shape)}, w {tuple(w.shape)}")
    for name, t in (("X", X), ("y", y), ("w", w)):
        if t.device.type != "cuda" or t.device != X.device:
            raise ValueError(f"{name} must lie on X's CUDA device "
                             f"({X.device}), got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def linear_value_grad(X, y, w, *, loss: str = "squared_hinge"):
    """Returns (Σ loss_i, ∇_w Σ loss_i) computed by the CUDA kernel.
    X (n, d), y (n,), w (d,): float32, contiguous, on one CUDA device,
    1 <= d <= the kernel's limit (2048)."""
    if loss not in LOSS_CODES:
        raise ValueError(f"unknown loss {loss!r}; available: "
                         f"{sorted(LOSS_CODES)}")
    _check(X, y, w)
    lib = _library()
    n, d = X.shape
    dev = X.device
    grid = lib.lvg_grid(n, d, _num_sms(dev.index if dev.index is not None
                                       else torch.cuda.current_device()))
    if grid < 1:
        raise ValueError(f"linear_value_grad kernel takes 1 <= d <= "
                         f"{lib.lvg_max_d()}, got d={d}")
    scratch = torch.empty((lib.lvg_scratch_bytes(d, grid),),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((d + 1,), dtype=torch.float32, device=dev)
    rc = lib.lvg_launch(X.data_ptr(), y.data_ptr(), w.data_ptr(),
                        scratch.data_ptr(), out.data_ptr(), n, d,
                        LOSS_CODES[loss], grid,
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"linear_value_grad launch failed: "
                           f"{lib.lvg_error_string(rc).decode()} ({rc})")
    return out[d], out[:d]
