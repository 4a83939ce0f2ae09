"""The control at the cell's own size, on the card: the reference one
precision below the configuration's (TF32 for the convex cell's
float32), put in the program's place, fails the cell's committed limits
on three seeds.  Skips without a card."""
from __future__ import annotations

import types

import pytest
import torch

from perfbench import loader
from perfbench.paths import convex_solve
from perfbench.yardstick import data

SEEDS = [2147483905, 2147483906, 2147483907]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["w8a_batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_perfbench_convex_control_fails_at_cell_size(cell, seed):
    _card()
    c = loader.cell(cell)
    ctx = types.SimpleNamespace(torch=torch, config=c.config,
                                traffic=c.traffic, limits=c.limits,
                                seed=seed)
    X, y = data.classification(c.config, seed, "cuda")
    checks = convex_solve.control(ctx, X, y)
    assert any(ch["value"] > ch["limit"] for ch in checks), checks
