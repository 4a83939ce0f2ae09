"""Per-device cost accounting for the dry run's roofline — the port of
``repro.launch.hlo``.

The port has no HLO: nothing is compiled, a step runs eagerly.  So this
module keeps the reference's name and the keys of its ``analyze`` result
that have a meaning here, and counts them by running the step itself,
on fake or meta tensors, under ``obs/profile.py``'s operation counter in
its per-device mode:

  * ``flops``         — the matrix products' FLOPs (2·M·N·K per product,
                        ``FlopCounterMode``'s formulas) of the operations
                        one device runs: DTensor's operations on the local
                        shards, never the global shapes;
  * ``traffic_bytes`` — every local operation's tensor inputs and outputs
                        (views excepted): eager PyTorch fuses nothing, so
                        this is the unfused count, where the reference's is
                        fusion-optimistic;
  * ``wire_bytes``    — per-device collective traffic of each collective
                        DTensor issued, with the reference's ring factors
                        (``_wire_bytes``, copied verbatim);
  * ``collectives``   — count, output bytes and wire bytes per kind;
  * ``loops``         — the reference lists while-loop trip counts; here,
                        the repeated bodies the dry run traced once and
                        multiplied (``launch/dryrun.py``).

``C10D_KINDS`` ties the ``_c10d_functional`` ops DTensor issues to the
reference's collective names.  Each collective carries its provenance:
the model file:line whose operation made DTensor redistribute, or in the
backward pass the autograd node (and the forward line that made it).

Per-device wire bytes (shapes are already per device):
    all-gather          out × (n-1)/n
    all-reduce          out × 2(n-1)/n
    reduce-scatter      out × (n-1)          (input = out × n)
    all-to-all          out × (n-1)/n
    collective-permute  out × 1
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys

import torch
from torch.overrides import TorchFunctionMode

from ..obs.profile import _C10D_KINDS as C10D_KINDS  # noqa: F401
from ..obs.profile import _OpCounter

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def _wire_bytes(kind: str, out_bytes: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (n - 1) / n
    if kind == "all-reduce":
        return out_bytes * 2 * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-to-all":
        return out_bytes * (n - 1) / n
    return float(out_bytes)  # collective-permute


# ------------------------------------------------------------- provenance
_PKG = "repro_torch"
_MODELS = os.path.join(_PKG, "models")
_HERE = os.path.join(_PKG, "launch", "hlo.py")
# the layout helpers' frames: a site is the model line that called them
_LAYOUT = os.path.join(_MODELS, "shard_ctx.py")


def _frame_site(models_only: bool) -> str | None:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(_LAYOUT) and (
                _MODELS in fn or (not models_only and _PKG in fn
                                  and not fn.endswith(_HERE)
                                  and os.path.join("obs", "profile") not in fn
                                  and "shardings" not in fn)):
            return f"{fn[fn.index(_PKG):]}:{f.f_lineno}"
        f = f.f_back
    return None


def current_site() -> str:
    """Where the running operation comes from: the innermost frame in the
    port's models (a forward pass, or a rematerialized one inside the
    backward); in the backward pass, the autograd node and the forward
    line that made it; else the innermost frame in the port."""
    site = _frame_site(models_only=True)
    if site is not None:
        return site
    node = torch._C._current_autograd_node()
    if node is not None:
        fwd = node.metadata.get("site")
        return f"{node.name()} of {fwd}" if fwd else node.name()
    return _frame_site(models_only=False) or "?"


class _SiteStamp(TorchFunctionMode):
    """Stamps each autograd node made in the forward pass with the model
    line that made it, for the backward's collectives."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        node = getattr(out, "grad_fn", None) \
            if isinstance(out, torch.Tensor) else None
        if node is not None and "site" not in node.metadata:
            site = _frame_site(models_only=True)
            if site is not None:
                node.metadata["site"] = site
        return out


# --------------------------------------------------------------- counting
@contextlib.contextmanager
def _paused_in_propagation(counter):
    """DTensor's sharding propagation runs an operation on meta tensors to
    learn its output's shape, once per operation and layout (then it is
    cached).  That is planning, not the step's work: the counter is paused
    there, so a trace counts the same whether the cache was warm or
    not."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    names = ("propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")
    saved = {n: getattr(ShardingPropagator, n) for n in names}

    def paused(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            counter.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                counter.paused -= 1
        return run

    for n, fn in saved.items():
        setattr(ShardingPropagator, n, paused(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def analyze(fn, *args, device=None, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under the per-device counter: (the
    counts, ``fn``'s result).  With ``device`` only the operations on that
    device count (the dry run's meta tensors).  The counts are linear in
    repeated work, so ``combine`` can add and scale them."""
    counter = _OpCounter(local=True, site=current_site, device=device)
    with _paused_in_propagation(counter), _SiteStamp(), counter:
        out = fn(*args, **kwargs)
    sites: dict = {}
    for c in counter.collectives:
        key = (c["kind"], c["out_bytes"], c["group_size"], c["site"])
        sites[key] = sites.get(key, 0.0) + 1.0
    counts = {"flops": float(counter.products + counter.vector_products),
              "pointwise_flops": float(counter.pointwise),
              "traffic_bytes": float(counter.bytes),
              "peak_bytes": float(counter.peak_bytes), "sites": sites}
    return counts, out


def combine(terms) -> dict:
    """Σ coef·counts over ``terms`` = [(coef, counts), ...]: the counts of
    a step made of repeated traced bodies.  A site whose multiplicity
    comes to ~0 is dropped."""
    out = {"flops": 0.0, "pointwise_flops": 0.0, "traffic_bytes": 0.0,
           "peak_bytes": 0.0, "sites": {}}
    for coef, c in terms:
        for k in ("flops", "pointwise_flops", "traffic_bytes", "peak_bytes"):
            out[k] += coef * c[k]
        for key, m in c["sites"].items():
            out["sites"][key] = out["sites"].get(key, 0.0) + coef * m
    out["sites"] = {k: m for k, m in out["sites"].items() if m > 1e-6}
    return out


def summarize(counts: dict, loops=()) -> dict:
    """The reference's ``analyze`` keys from counts: ``flops``,
    ``traffic_bytes``, ``wire_bytes``, ``collectives`` and ``loops``."""
    totals = {"flops": counts["flops"],
              "pointwise_flops": counts["pointwise_flops"],
              "traffic_bytes": counts["traffic_bytes"], "wire_bytes": 0.0,
              "collectives": {}, "loops": list(loops)}
    for (kind, ob, n, _), mult in counts["sites"].items():
        wb = mult * _wire_bytes(kind, ob, n)
        totals["wire_bytes"] += wb
        k = totals["collectives"].setdefault(
            kind, {"count": 0.0, "out_bytes": 0.0, "wire_bytes": 0.0})
        k["count"] += mult
        k["out_bytes"] += mult * ob
        k["wire_bytes"] += wb
    return totals
