"""Common interface for inner batch optimizers.

The paper (§3.1) works with *linear optimizers*: linearly-convergent methods
whose per-iteration cost is linear in the window size.  Every optimizer here
implements

    state  = opt.init(params)
    params, state, aux = opt.step(params, state, objective, data)
    state  = opt.reset_memory(state)      # called at every batch expansion

where ``objective`` is a ``models.linear.LinearObjective`` on the window
``data = (X, y)``: ``objective(w, data)`` is f̂, and ``value_and_grad`` /
``hvp_operator`` give what the reference took from autodiff.

Steps are free of host syncs: every data-dependent choice (CG's guarded
divisions, the descent safeguard, the Armijo step) is a ``torch.where`` on
the device, so a stage's steps queue back to back on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Objective = Any          # models.linear.LinearObjective


# ------------------------------------------------------------- tree helpers
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (the
    reference's ``jax.tree_util.tree_map``); ``rest`` are trees of the same
    structure whose leaves are passed alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# ------------------------------------------------ tree math (on one tensor)
def tree_dot(a, b):
    return torch.sum(a * b)


def tree_add(a, b):
    """a + b, leaf by leaf (a tensor is a tree of one leaf)."""
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_norm(a):
    """‖a‖₂ over every leaf, summed in float32 as the reference's
    ``tree_dot`` does."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float())
                          for x in tree_leaves(a)))


def tree_axpy(c, x, y):
    """y + c*x."""
    return y + c * x


def tree_scale(a, c):
    return c * a


def tree_zeros_like(a):
    return torch.zeros_like(a)


# ------------------------------------------------------------- line searches
def armijo_line_search(objective: Objective, params, data, direction, g,
                       *, f0=None, alpha0: float = 1.0, c1: float = 1e-4,
                       shrink: float = 0.5, max_steps: int = 25):
    """Backtracking Armijo search along ``direction``, without host syncs.

    Returns (alpha, f_new, n_evals) as the reference's while-loop does:
    the first α_k = α₀·shrinkᵏ (k < ``max_steps``) with
    f(w + α_k d) <= f0 + c1·α_k·gᵀd, or α = 0 and f_new = f0 when none
    passes.  All ``max_steps`` candidates are scored with one
    X @ [w + α_k d] product; with ``shrink=0.5`` the α_k are exact powers
    of two, so the choice is the reference loop's."""
    if f0 is None:
        f0 = objective(params, data)
    slope = tree_dot(g, direction)
    # made on the device (no host copy); float64 then rounded, so powers
    # of two come out exact
    k = torch.arange(max_steps, dtype=torch.float64, device=params.device)
    alphas = (alpha0 * shrink ** k).to(params.dtype)
    W = params[:, None] + alphas[None, :] * direction[:, None]
    f_new = objective.values(W, data)
    ok = f_new <= f0 + c1 * alphas * slope
    passed = ok.any()
    first = torch.argmax(ok.to(torch.int32))      # first passing k (0 if none)
    # gathered by a device index: indexing with a 0-d tensor reads it back
    idx = first.view(1)
    alpha = torch.where(passed, alphas.index_select(0, idx)[0], 0.0)
    f_new = torch.where(passed, f_new.index_select(0, idx)[0], f0)
    n = torch.where(passed, first + 1, max_steps)
    return alpha, f_new, n


def quadratic_exact_step(objective: Objective, params, data, direction, g):
    """Exact line search assuming the objective restricted to the ray is
    (approximately) quadratic: alpha* = -gᵀd / dᵀHd via one Hessian-vector
    product."""
    hvp = hessian_vector_product(objective, params, data, direction)
    dHd = tree_dot(direction, hvp)
    gd = tree_dot(g, direction)
    alpha = torch.where(dHd > 1e-12, -gd / torch.clamp(dHd, min=1e-12), 0.0)
    return torch.clamp(alpha, 0.0, 1e3)


def hessian_vector_product(objective: Objective, params, data, v):
    """∇²f̂(params)·v in closed form (the reference: forward-over-reverse)."""
    return objective.hvp(params, data, v)


@dataclasses.dataclass(frozen=True)
class BatchOptimizer:
    """Base class; concrete optimizers are frozen dataclasses of hyperparams."""
    name: str = "base"

    def init(self, params):
        raise NotImplementedError

    def step(self, params, state, objective: Objective, data):
        raise NotImplementedError

    def reset_memory(self, state):
        return state

    def run(self, params, state, objective: Objective, data, num_steps: int,
            *, collect: Callable | None = None):
        """``num_steps`` inner iterations on fixed ``data``.

        ``collect(params, aux)`` customizes the per-step record (default:
        the scalar objective ``aux["f"]``); it returns a tensor or a dict
        of tensors, which come back stacked along the step axis (still on
        the device)."""
        outs = []
        for _ in range(num_steps):
            params, state, aux = self.step(params, state, objective, data)
            outs.append(aux["f"] if collect is None else collect(params, aux))
        if outs and isinstance(outs[0], dict):
            stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        else:
            stacked = torch.stack(outs) if outs else torch.empty(0)
        return params, state, stacked
