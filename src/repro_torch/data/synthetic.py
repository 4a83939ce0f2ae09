"""Synthetic dataset generators.

LIBSVM corpora (w8a, rcv1, real-sim, webspam, SUSY) are not available
offline, so we generate binary-classification problems with controllable
size, dimensionality, conditioning and label noise, matched to the *scale
regimes* of the paper's datasets (Table 2).

Generation is numpy, exactly as in the reference (``repro.data.synthetic``):
the arrays are then placed on ``device`` as float32 tensors, so the port's
inputs are bit-identical to the reference's for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    X: torch.Tensor       # (n, d) float32
    y: torch.Tensor       # (n,) float32 in {-1, +1}
    X_test: torch.Tensor
    y_test: torch.Tensor
    # the DataSpec dict this dataset was built from (repro_torch.api
    # attaches it so drivers can rebuild the exact workload declaratively)
    spec: dict | None = dataclasses.field(default=None, compare=False,
                                          repr=False)

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]

    def window(self, n_t: int):
        """Prefix window of the (already permuted) training set — BET's
        fundamental data-access primitive.  Row views, not copies."""
        return self.X[:n_t], self.y[:n_t]


_CHUNK_ROWS = 1 << 16


def classification_arrays(n: int, d: int, *, seed: int = 0,
                          test_n: int | None = None, noise: float = 0.1,
                          condition: float = 10.0, sparsity: float = 0.0
                          ) -> tuple:
    """The numpy arrays ``(X, y, X_test, y_test)`` of ``make_classification``
    (float32): what the streaming plane's shard stores hold."""
    rng = np.random.default_rng(seed)
    test_n = test_n if test_n is not None else max(n // 4, 1)
    total = n + test_n
    # anisotropic covariance via diagonal eigen-spectrum
    scales = np.geomspace(1.0, 1.0 / condition, d).astype(np.float32)
    # drawn in chunks of rows: the generator's stream is the same as one
    # draw of the whole array (the reference's), without its float64 copy
    X = np.empty((total, d), np.float32)
    for lo in range(0, total, _CHUNK_ROWS):
        hi = min(total, lo + _CHUNK_ROWS)
        X[lo:hi] = rng.standard_normal((hi - lo, d)).astype(np.float32) \
            * scales
    if sparsity > 0:
        for lo in range(0, total, _CHUNK_ROWS):
            hi = min(total, lo + _CHUNK_ROWS)
            mask = rng.random((hi - lo, d)) >= sparsity
            X[lo:hi] = X[lo:hi] * mask / max(1e-6, np.sqrt(1 - sparsity))
    w_star = rng.standard_normal(d).astype(np.float32) / np.sqrt(d)
    margins = X @ w_star + noise * rng.standard_normal(total).astype(np.float32)
    y = np.sign(margins).astype(np.float32)
    y[y == 0] = 1.0
    return tuple(np.ascontiguousarray(a, np.float32)
                 for a in (X[:n], y[:n], X[n:], y[n:]))


def make_classification(name: str, n: int, d: int, *, seed: int = 0,
                        test_n: int | None = None, noise: float = 0.1,
                        condition: float = 10.0, sparsity: float = 0.0,
                        device="cuda") -> Dataset:
    """Linearly-separable-ish binary task: X ~ N(0, Σ) with eigen-spread
    ``condition``; y = sign(Xw* + noise).  Rows are pre-permuted (generation
    is i.i.d., so the identity permutation is already uniformly random —
    matching the paper's random-permutation assumption)."""
    dev = resolve_device(device)
    arrays = classification_arrays(n, d, seed=seed, test_n=test_n,
                                   noise=noise, condition=condition,
                                   sparsity=sparsity)
    return Dataset(name, *(torch.from_numpy(a).to(dev) for a in arrays))


# Scale-matched stand-ins for the paper's Table 2 (shrunk to container scale;
# relative regimes preserved: w8a-like = small-n dense, rcv1-like = wide,
# susy-like = tall narrow).
PAPER_LIKE = {
    "w8a_like": dict(n=8192, d=300, condition=30.0, noise=0.2),
    "rcv1_like": dict(n=4096, d=2048, condition=100.0, noise=0.05, sparsity=0.9),
    "realsim_like": dict(n=8192, d=1024, condition=50.0, noise=0.1, sparsity=0.8),
    "webspam_like": dict(n=16384, d=1024, condition=300.0, noise=0.05, sparsity=0.9),
    "susy_like": dict(n=65536, d=18, condition=5.0, noise=0.3),
}


def load(name: str, *, seed: int = 0, scale: float = 1.0,
         device="cuda") -> Dataset:
    cfg = dict(PAPER_LIKE[name])
    cfg["n"] = max(64, int(cfg["n"] * scale))
    return make_classification(name, seed=seed, device=device, **cfg)
