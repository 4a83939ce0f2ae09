"""LM workload adapters — the port of ``repro.api.lm``: the train step
behind the BatchOptimizer protocol, the probe objective, and the
host-slice token dataset."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..data.device_window import probe_rows, rotation_rows
from ..models import transformer as T
from ..optim.api import BatchOptimizer


@dataclasses.dataclass(frozen=True)
class LMStepOptimizer(BatchOptimizer):
    """The LM train step as a BatchOptimizer over token windows.

    ``data`` is the resident (n_t, seq_len+1) token window; the step gathers
    a rotating mini-batch from it on the device (its counter ``t`` is a
    device tensor), so a stage's steps queue without host round-trips.
    ``reset_memory`` is inherited as the identity: Adam moments survive
    batch expansions."""
    train_step: Callable = None
    init_opt: Callable = None
    batch_size: int = 8
    name: str = "adamw_lm"

    def init(self, params):
        opt = self.init_opt(params)
        return {"opt": opt, "t": torch.zeros_like(opt["t"])}

    def step(self, params, state, objective, data):
        rows = rotation_rows(data, self.batch_size, state["t"])
        batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        params, opt, metrics = self.train_step(params, state["opt"], batch)
        return params, {"opt": opt, "t": state["t"] + 1}, {"f": metrics["loss"]}


@dataclasses.dataclass
class TokenWindows:
    """Host-slice view of a pre-permuted token corpus: nested prefix windows
    of one permutation (§3.3's data-access contract)."""
    tokens: Any                    # (N, seq_len+1) int32, on the device

    @property
    def n(self) -> int:
        return int(self.tokens.shape[0])

    def window(self, n_t: int):
        return self.tokens[:n_t]


def make_lm_objective(cfg, eval_rows: int = 64, *, impl: str = "xla"):
    """loss(params, token block) on a fixed-size probe of the block: always
    ``eval_rows`` rows of the block's prefix, wrapping when the block is
    smaller, so the two-track condition (3) compares at a constant sample
    size.  ``impl`` is the train step's, so the probe measures the function
    the optimizer descends."""
    def objective(params, toks):
        probe = probe_rows(toks, eval_rows)
        batch = {"tokens": probe[:, :-1], "labels": probe[:, 1:]}
        with torch.no_grad():
            return T.loss_fn(cfg, params, batch, impl=impl)[0]
    return objective
