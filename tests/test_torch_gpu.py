"""Tests of the port that need a CUDA card: the hand-written kernel
against its float64 plain version, and the main path on the card against
the CPU.  They skip (deciding inside each test) where there is no card.

This file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.api as P
from repro_torch.kernels import linear_grad, ops, ref

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    y[y == 0] = 1.0
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (X, y, w))


@pytest.mark.parametrize("n,d", [(200, 32), (49189, 300), (4096, 2048),
                                 (1000, 18), (3, 1)])
@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_cuda_kernel_matches_float64_plain_version(n, d, loss):
    _need_card()
    X, y, w = _inputs(n, d, seed=n + d)
    ops.reset_calls()
    L, g = ops.linear_value_grad(X, y, w, loss=loss)
    assert ops.CALLS["linear_value_grad"] == 1
    L2, g2 = ops.linear_value_grad(X, y, w, loss=loss)
    # fixed-order cross-block reduction: bit-reproducible
    assert torch.equal(L, L2) and torch.equal(g, g2)
    L64, g64 = ref.linear_value_grad(X.double(), y.double(), w.double(),
                                     loss=loss)
    # float32 accumulation against float64 (chip_smoke.py states the bound)
    assert abs(float(L) - float(L64)) <= 1e-5 * abs(float(L64))
    assert float((g.double() - g64).abs().max()) <= \
        1e-4 * max(1.0, float(g64.abs().max()))


def test_cuda_kernel_takes_row_views_of_the_window():
    _need_card()
    X, y, w = _inputs(1000, 300, seed=1)
    L, g = ops.linear_value_grad(X[:333], y[:333], w)
    Lc, gc = ops.linear_value_grad(X[:333].clone(), y[:333].clone(), w)
    assert torch.equal(L, Lc) and torch.equal(g, gc)


def test_cuda_kernel_refuses_what_it_does_not_take():
    _need_card()
    X = torch.zeros((8, 4096), device="cuda")
    with pytest.raises(ValueError, match="d <= 2048"):
        linear_grad.linear_value_grad(X, torch.ones(8, device="cuda"),
                                      torch.zeros(4096, device="cuda"))
    Xs = torch.zeros((8, 6), device="cuda")[:, ::2]     # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        linear_grad.linear_value_grad(Xs, torch.ones(8, device="cuda"),
                                      torch.zeros(3, device="cuda"))
    with pytest.raises(TypeError, match="float32"):
        linear_grad.linear_value_grad(X[:, :4].contiguous().double(),
                                      torch.ones(8, device="cuda").double(),
                                      torch.zeros(4, device="cuda").double())


def test_main_path_on_card_matches_cpu():
    _need_card()
    spec = P.RunSpec(
        data=P.DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3),
        policy=P.PolicySpec("fixed_steps", {"inner_steps": 4,
                                            "final_steps": 8}),
        optimizer=P.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=P.ScheduleSpec(n0=32))
    ops.reset_calls()
    gpu = P.build(spec, device="cuda").run()
    assert ops.CALLS["linear_value_grad"] == len(gpu.points)
    cpu = P.build(spec, device="cpu").run()
    for col in ("step", "stage", "window", "time", "accesses"):
        assert gpu.column(col) == cpu.column(col), col
    # the bound chip_smoke.py states for the card-vs-CPU main path
    np.testing.assert_allclose(gpu.column("f_full"), cpu.column("f_full"),
                               rtol=1e-4)
