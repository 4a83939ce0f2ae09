"""The port's device rule: every entry point runs on the card unless the
caller asks for the CPU.

``resolve_device("cuda")`` raises when no CUDA device is present — an
entry point never moves to the CPU quietly; tests pass ``device="cpu"``
and get the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asked for a CUDA card but none is "
                f"available; pass device='cpu' to run the plain PyTorch "
                f"path")
        # float32 GEMMs (line search, HVPs, f̂ evals) must stay full
        # float32: TF32 keeps about 3 digits.  It is the default; say so.
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: the port "
                         f"runs on 'cuda' or 'cpu'")
    return dev
