"""The benchmark's inputs, made from ``--seed`` on the device.

``classification`` follows the recipe of the program's generator
(``src/repro_torch/data/synthetic.py:59-88``, ``classification_arrays``):
X ~ N(0, diag(geomspace(1, 1/condition, d))²), w* ~ N(0, 1/d),
y = sign(X w* + noise·N(0, 1)), zeros mapped to +1, float32, rows already
in a random order.  The numbers come from a ``torch.Generator`` on the
device in a few large calls, not from numpy's stream, so they are not
the program's arrays: the same seed gives the same tensors, which the
harness hands to the program and to the reference alike.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number) and an
    independent ``stream`` of it."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def classification(cfg: dict, seed: int, device):
    """(X (n, d), y (n,)) float32 on ``device``."""
    n, d = int(cfg["n"]), int(cfg["d"])
    gen = generator(seed, device)
    scales = torch.logspace(0.0, -math.log10(float(cfg["condition"])), d,
                            dtype=torch.float64, device=device).float()
    X = torch.randn((n, d), generator=gen, dtype=torch.float32,
                    device=device)
    X.mul_(scales)
    w_star = torch.randn((d,), generator=gen, dtype=torch.float32,
                         device=device) / math.sqrt(d)
    margins = X @ w_star
    margins += float(cfg["noise"]) * torch.randn(
        (n,), generator=gen, dtype=torch.float32, device=device)
    y = torch.sign(margins)
    y[y == 0] = 1.0
    return X, y
