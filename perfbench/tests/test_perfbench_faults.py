"""A whole run of the convex path on the CPU at a tiny size, past the
harness's look for a card: sound, it comes out correct; with the timed
path broken underneath, once for each fault the cell can have,
``correct`` comes out false; and the control (the reference one
precision below the configuration's, in the program's place) fails the
limits.

The limits here are this size's own (a tiny problem's readings differ
from the cell's), set like the cell's from the sound and the control
readings at this size, which the comments give."""
from __future__ import annotations

import time
import types

import pytest
import torch

from perfbench import loader, run
from perfbench.paths import convex_solve
from perfbench.yardstick import data

# readings at this size on the CPU, seeds 3-5: sound grad_rel <= 1.5e-8,
# hvp_rel <= 2.5e-7, subopt <= 1.4e-7; the control's grad_rel >= 4.2e-5
# and hvp_rel >= 2.1e-4 (the cell's subopt limit is its configuration's
# d/n, which at 8,192 rows would be 0.037: this size takes 1e-4)
CONVEX_LIMITS = {"grad_rel": 3e-6, "hvp_rel": 3e-6, "subopt": 1e-4}


def _convex_cell(name="w8a_batch"):
    cell = loader.cell(name)
    cell.config = dict(cell.config, n=8192)
    cell.limits = CONVEX_LIMITS
    return cell


def _measure(cell, seed=3):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run.measure(cell, seed=seed, seconds=0.3, trace=False,
                           device="cpu", t0=time.perf_counter())
    finally:               # the worker's later tests run at their own count
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["w8a_batch"])
def test_perfbench_convex_run_sound(name):
    out = _measure(_convex_cell(name))
    assert out["correct"], out["checks"]
    assert out["metrics"]["solve_s"]["value"] > 0


def _unchanged_step(monkeypatch):
    from repro_torch.optim.newton_cg import NewtonCG

    def step(self, params, state, objective, data):
        f = objective(params, data)
        return params, {"t": state["t"] + 1}, {"f": f}
    monkeypatch.setattr(NewtonCG, "step", step)


def _half_batch(monkeypatch):
    from repro_torch.kernels import ops
    plain = ops.linear_value_grad

    def half(X, y, w, *, loss="squared_hinge"):
        n, h = X.shape[0], max(1, X.shape[0] // 2)
        L, g = plain(X[:h], y[:h], w, loss=loss)
        return L * n / h, g * n / h
    monkeypatch.setattr(ops, "linear_value_grad", half)


def _altered_answer(monkeypatch):
    from repro_torch.core.engine import BetEngine
    plain = BetEngine.run

    def altered(self, *a, **kw):
        trace = plain(self, *a, **kw)
        trace.params = trace.params.clone()
        trace.params[0] += 0.05
        return trace
    monkeypatch.setattr(BetEngine, "run", altered)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch,
                                   _altered_answer])
def test_perfbench_convex_fault_comes_out_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    assert not _measure(_convex_cell())["correct"]


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_perfbench_convex_control_fails(seed):
    cell = _convex_cell()
    ctx = types.SimpleNamespace(torch=torch, config=cell.config,
                                traffic=cell.traffic, limits=cell.limits,
                                seed=seed)
    X, y = data.classification(cell.config, seed, "cpu")
    checks = convex_solve.control(ctx, X, y)
    assert any(c["value"] > c["limit"] for c in checks), checks
