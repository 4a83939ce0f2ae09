"""Mamba selective scan on Hopper — the port of the falcon-mamba hot spot
(B3).

The CUDA kernel in ``csrc/ssm_scan.cu`` runs the time recurrence with one
thread per (batch row, channel), the N-wide state in registers, one SFU
``ex2`` per state and step and tiles of u, delta, B and C loaded a tile
ahead, and writes y = h·C + u·D in u's dtype.  This module is its
wrapper: it checks the inputs, allocates y with ``torch.empty`` and
launches on the current stream.  Dispatch by device, the plain version
for CPU tensors and the backward pass live in ``ops.py``.
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
        lib = build.library("ssm_scan")
        lib.ssm_scan_max_state.argtypes = []
        lib.ssm_scan_max_state.restype = ctypes.c_int
        lib.ssm_scan_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ssm_scan_launch.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(u, delta, B_ssm, C_ssm, A_log, D) -> None:
    if u.dim() != 3 or B_ssm.dim() != 3:
        raise ValueError(f"want u, delta (B, S, di) and B, C (B, S, N); got "
                         f"u {tuple(u.shape)}, B {tuple(B_ssm.shape)}")
    Bsz, S, di = u.shape
    N = B_ssm.shape[-1]
    want = {"delta": (delta, (Bsz, S, di)), "B_ssm": (B_ssm, (Bsz, S, N)),
            "C_ssm": (C_ssm, (Bsz, S, N)), "A_log": (A_log, (di, N)),
            "D": (D, (di,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for u "
                             f"{tuple(u.shape)} and N={N}, got "
                             f"{tuple(t.shape)}")
    if u.dtype not in DTYPE_CODES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    tensors = {"u": u, "delta": delta, "B_ssm": B_ssm, "C_ssm": C_ssm,
               "A_log": A_log, "D": D}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"{name} must lie on u's CUDA device "
                             f"({u.device}), got {t.device}")
        want_dtype = torch.float32 if name in ("A_log", "D") else u.dtype
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssm_scan(u, delta, B_ssm, C_ssm, A_log, D):
    """y (B, S, di) in u's dtype, computed by the CUDA kernel.  u, delta
    (B, S, di) and B_ssm, C_ssm (B, S, N) share one dtype (float32 or
    bfloat16); A_log (di, N) and D (di,) are float32; all contiguous, on
    one CUDA device; 1 <= N <= 16, B <= 65535."""
    _check(u, delta, B_ssm, C_ssm, A_log, D)
    lib = _library()
    Bsz, S, di = u.shape
    N = B_ssm.shape[-1]
    if not 1 <= N <= lib.ssm_scan_max_state() or Bsz > 65535:
        raise ValueError(f"ssm_scan kernel takes 1 <= N <= "
                         f"{lib.ssm_scan_max_state()} and B <= 65535, got "
                         f"N={N}, B={Bsz}")
    y = torch.empty_like(u)
    rc = lib.ssm_scan_launch(
        u.data_ptr(), delta.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
        A_log.data_ptr(), D.data_ptr(), y.data_ptr(), Bsz, S, di, N,
        DTYPE_CODES[u.dtype], torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed: "
                           f"{lib.ssm_scan_error_string(rc).decode()} ({rc})")
    return y
