"""Blocked online-softmax attention on Hopper — the port of the local
attention of recurrentgemma (B2).

The CUDA kernels in ``csrc/flash_attention.cu`` take the model's layout,
q (B, S, H, hd) and k, v (B, S, KV, hd), read KV head h // (H/KV) for
query head h instead of materializing the GQA repeat, mask a ragged
sequence tail instead of padding it, and walk only the key tiles a
causal (and windowed) query tile can reach: bfloat16 on the tensor cores
(``wgmma`` fed by TMA loads behind a producer warpgroup), float32 on the
CUDA cores.  This module is its wrapper: it checks the inputs, allocates
the output with ``torch.empty`` and launches on the current stream (the
bfloat16 kernel's tensor maps are encoded on the host at each launch).  Dispatch by device, the plain version
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
        lib = build.library("flash_attention")
        lib.flash_attention_supports_head_dim.argtypes = [ctypes.c_int]
        lib.flash_attention_supports_head_dim.restype = ctypes.c_int
        lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"want q (B, S, H, hd) and k, v (B, S, KV, hd); "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, S, KV, hd) = "
                         f"{(B, S, KV, hd)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"query heads {H} must be a multiple of KV heads "
                         f"{KV}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention kernel takes B, H <= 65535, got "
                         f"B={B}, H={H}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """o (B, S, H, hd) in q's dtype, computed by the CUDA kernel.  q
    (B, S, H, hd) and k, v (B, S, KV, hd) share one dtype (float32 or
    bfloat16), contiguous, on one CUDA device; H a multiple of KV; hd in
    32, 64, 128, 256; ``window`` 0 (none) or the local window."""
    _check(q, k, v)
    lib = _library()
    B, S, H, hd = q.shape
    if not lib.flash_attention_supports_head_dim(hd):
        raise ValueError(f"flash_attention kernel takes hd in 32, 64, 128, "
                         f"256, got {hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    o = torch.empty_like(q)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        k.shape[2], hd, int(causal), int(window), hd ** -0.5,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()} "
                           f"({rc})")
    return o
