"""Collectives: the global objective as a sum of per-host partials, and
the once-per-stage record flush as an all-gather — the port of
``repro.dist.collectives``.

The objective is written once, against a small communicator protocol,
and runs under two implementations:

  * ``StackedCollectives`` (simulated, the default) — every lane of the
    stacked window (``HostWindows``) is in this process: ``map_hosts`` is a
    loop over the lanes in lane order (the reference's ``vmap``), ``psum``
    a sum over them in lane order, and the stage-record all-gather the
    identity.
  * ``ProcessCollectives`` — one process per host (``torch.distributed``,
    NCCL on the card, gloo on the CPU; the counterpart of the reference's
    ``AxisCollectives``): ``map_hosts`` runs this process's own lane,
    ``psum`` is an ``all_reduce`` and records go through
    ``all_gather_object``.

Either way the global regularized objective over the stage window is

    f̂_t(w) = Σ_h Σ_{i < m_h} ℓ(w; x_{h,i}) / Σ_h m_h + (λ/2)‖w‖²

— per-host partial sums over each lane's valid prefix, because lanes are
padded to a common capacity and per-host ``m_h`` differ.  The reference
masks the padded lanes and takes ``jax.grad`` of this; the port slices
each lane to its host count (the views carry them on the host) and gives
the gradient and Hessian-vector product in closed form, as
``models/linear.py``'s ``LinearObjective`` does for one host.  Nothing
here syncs per step: the only host transfer stays the engine's
once-per-stage flush."""
from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Callable

import torch

from ..data import device_window as _dw
from ..data.device_window import HostWindows, as_host_windows
from ..kernels import ops
from ..models.linear import _CURVATURE, LOSSES, make_example_losses


# ------------------------------------------------------------- communicators
class Collectives:
    """How per-host code maps and reduces across hosts."""

    def map_hosts(self, fn: Callable, num_lanes: int) -> list:
        """``fn(h)`` for each lane h of a ``num_lanes``-lane view that this
        program holds, in lane order."""
        raise NotImplementedError

    def psum(self, parts: list, num_lanes: int) -> torch.Tensor:
        """The sum over every lane of a ``num_lanes``-lane view of the
        per-lane ``parts`` that ``map_hosts`` gave (at least one)."""
        raise NotImplementedError

    def all_gather_records(self, records: list) -> list:
        """Once-per-stage flush of host-side record dicts: every host ends
        up with all hosts' records."""
        raise NotImplementedError


class StackedCollectives(Collectives):
    """Simulated multi-host: every lane is in this process."""

    def map_hosts(self, fn, num_lanes):
        return [fn(h) for h in range(num_lanes)]

    def psum(self, parts, num_lanes):
        return functools.reduce(operator.add, parts)    # in lane order

    def all_gather_records(self, records):
        return list(records)


class ProcessCollectives(Collectives):
    """One process per host over the default ``torch.distributed`` process
    group.  A view whose lanes are the processes' hosts (the distributed
    dataset's) holds this process's lane alone: ``map_hosts`` runs it and
    ``psum`` all-reduces.  Any other view (a host-resident eval set) is
    whole in every process: it is mapped and summed here, with no
    collective."""

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessCollectives needs an initialized "
                               "torch.distributed process group")
        self._dist = dist
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()

    def _spread(self, num_lanes: int) -> bool:
        return num_lanes == self.world_size

    def map_hosts(self, fn, num_lanes):
        if self._spread(num_lanes):
            return [fn(self.rank)]
        return [fn(h) for h in range(num_lanes)]

    def psum(self, parts, num_lanes):
        local = functools.reduce(operator.add, parts)
        if self._spread(num_lanes):
            self._dist.all_reduce(local)
        return local

    def all_gather_records(self, records):
        out = [None] * self.world_size
        self._dist.all_gather_object(out, list(records))
        return [r for host in out for r in host]


# --------------------------------------------------------- global objective
def masked_partial_sum(example_losses: Callable, w, fields, count: int):
    """One host's contribution: Σ_{i<count} ℓ_i over its padded lane."""
    losses = example_losses(w, tuple(f[:count] for f in fields))
    return torch.sum(losses.to(torch.float32), dim=0)


def l2_regularizer(lam: float) -> Callable:
    return lambda w: 0.5 * lam * torch.sum(w * w, dim=0)


@dataclasses.dataclass(frozen=True, eq=False)
class DistributedObjective:
    """The global objective f̂ over ``HostWindows`` — the counterpart of the
    reference's ``distributed_objective`` — with what the port's
    optimizers call beside the value, as ``LinearObjective`` gives it:

      * ``value_and_grad`` launches the ``linear_value_grad`` kernel (B1)
        once for each non-empty lane on its valid rows, sums the (L_h,
        g_h) partials in lane order, divides by Σ m_h and adds λw; a lane
        with m_h = 0 contributes 0 and launches nothing;
      * ``values`` (the batched Armijo search) and ``__call__``;
      * ``hvp_operator``: the curvature ℓ″ of each lane computed once, then
        Σ_h X_hᵀ(c_h ⊙ X_h v) / Σ m_h + λv.

    There is no ``example_grads``: the per-example variance policies stay
    refused on ``HostWindows``, as in the reference.  Any stage view goes
    through ``as_host_windows``: a host-resident eval set is one fully
    valid lane, on which every value is the single-host one.  Summing per
    lane re-associates the reduction, so values agree with the single-host
    objective to float32 rounding, not bit for bit."""
    loss: str = "squared_hinge"
    lam: float = 1e-4
    comm: Collectives = dataclasses.field(default_factory=StackedCollectives)

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; available: "
                             f"{sorted(LOSSES)}")

    def _lanes(self, data):
        """(non-empty lanes' (X_h, y_h) row views this program holds, Σ m_h
        over every lane at least 1, the view's lane count)."""
        hw = as_host_windows(data)
        if hw.host_counts is None:
            raise ValueError("the distributed objective slices lanes by "
                             "their host counts; this view has none")
        lanes = [lane for lane in self.comm.map_hosts(hw.lane, hw.num_hosts)
                 if lane[0].shape[0]]
        return lanes, max(1, sum(hw.host_counts)), hw.num_hosts

    def _psum(self, parts: list, num_lanes: int, shape: tuple, device):
        """The lanes' sum; a zero of ``shape`` when no lane here has a row."""
        if not parts:
            parts = [torch.zeros(shape, dtype=torch.float32, device=device)]
        return self.comm.psum(parts, num_lanes)

    def __call__(self, w, data):
        return self.values(w[:, None], data)[0]

    def values(self, W, data):
        """f̂ at each column of a (d, K) stack W, as a (K,) tensor."""
        lanes, n, H = self._lanes(data)
        losses = make_example_losses(self.loss)
        total = self._psum([masked_partial_sum(losses, W, lane, len(lane[0]))
                            for lane in lanes], H, W.shape[1:], W.device)
        return total / n + l2_regularizer(self.lam)(W)

    def value_and_grad(self, w, data):
        """(f̂(w), ∇f̂(w)): B1 once per non-empty lane."""
        lanes, n, H = self._lanes(data)
        parts = [ops.linear_value_grad(X, y, w, loss=self.loss)
                 for X, y in lanes]
        L = self._psum([p[0] for p in parts], H, (), w.device)
        g = self._psum([p[1] for p in parts], H, w.shape, w.device)
        return L / n + 0.5 * self.lam * torch.sum(w * w), g / n + self.lam * w

    def hvp_operator(self, w, data) -> Callable:
        """v -> ∇²f̂(w) v, the curvature weights computed once per lane."""
        lanes, n, H = self._lanes(data)
        curv = [_CURVATURE[self.loss](y * ops.linear_forward(X, w))
                for X, y in lanes]

        def hvp(v):
            parts = [X.T @ (c * (X @ v)) for (X, _), c in zip(lanes, curv)]
            return self._psum(parts, H, v.shape, v.device) / n \
                + self.lam * v
        return hvp

    def hvp(self, w, data, v):
        return self.hvp_operator(w, data)(v)


# -------------------------------------------------------------- LM gathers
def rotation_batch(hw: HostWindows, per_host: int, t):
    """The LM inner step's global mini-batch under data parallelism: each
    host contributes ``per_host`` rows rotating through *its own* lane
    (``data.device_window.rotation_rows``).  Every lane must be non-empty:
    callers keep windows at or above
    ``ShardOwnership.min_full_participation_window()``."""
    return _dw.rotation_rows(hw, per_host * hw.num_hosts, t)


def probe_rows(hw: HostWindows, rows: int):
    """A deterministic ``rows``-row measurement probe
    (``data.device_window.probe_rows``), under the same precondition."""
    return _dw.probe_rows(hw, rows)
