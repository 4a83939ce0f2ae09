"""Model-family adapters — the port of ``repro.workloads.families``.

A family is the trio of factories the session builder needs for an LM
run — ``build_params`` / ``step`` / ``objective`` — and the layer ``impl``
that carries its training traffic, the reference's four:

- ``transformer`` — dense, vlm and audio attention stacks, and ``moe`` —
  mixture-of-experts stacks: ``impl="xla"``, plain PyTorch layers (the
  chunked einsum attention, the grouped einsum experts), no kernel, as
  in the reference;
- ``mamba`` — ``impl="pallas"`` routes the selective scan through the
  hand-written Hopper kernel (``kernels/ops.py::ssm_scan``);
- ``rglru`` — ``impl="pallas"`` routes the RG-LRU recurrence and the
  local attention through theirs (``rglru_scan``, ``flash_attention``).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

from .. import configs
from ..api.lm import LMStepOptimizer, make_lm_objective
from ..api.specs import ModelSpec, SpecError
from ..launch import steps
from ..models import transformer as T
from ..models.common import ModelConfig


@runtime_checkable
class ModelFamily(Protocol):
    """What building a session needs from a workload family: parameter
    init, a ``BatchOptimizer`` wrapping the family's train step, and the
    probe objective, all from the same ``ModelConfig`` (the reference's
    protocol; parameters come from a seed on a device here, from a PRNG
    key there)."""
    name: str
    impl: str                       # layer implementation: "xla" | "pallas"
    kernels: tuple                  # ops.CALLS keys training routes through

    def build_params(self, cfg: ModelConfig, seed: int, *, device): ...
    def step(self, cfg: ModelConfig, *, lr: float,
             batch_size: int) -> LMStepOptimizer: ...
    def objective(self, cfg: ModelConfig, eval_rows: int): ...


@dataclasses.dataclass(frozen=True)
class LMFamily:
    """Every architecture shares the assembly in ``models/transformer.py``,
    so families differ only in which config families they accept and
    which layer ``impl`` carries the training traffic (and so which
    kernels run)."""
    name: str
    config_families: tuple          # accepted ModelConfig.family values
    impl: str = "xla"
    kernels: tuple = ()             # ops.CALLS keys training routes through

    def build_params(self, cfg: ModelConfig, seed: int, *, device):
        return T.init_params(cfg, seed, device=device)

    def step(self, cfg: ModelConfig, *, lr: float,
             batch_size: int) -> LMStepOptimizer:
        return LMStepOptimizer(
            train_step=steps.make_train_step(cfg, lr=lr, impl=self.impl),
            init_opt=steps.init_opt_state, batch_size=batch_size)

    def objective(self, cfg: ModelConfig, eval_rows: int):
        return make_lm_objective(cfg, eval_rows, impl=self.impl)


FAMILIES: dict[str, LMFamily] = {
    "transformer": LMFamily("transformer",
                            config_families=("dense", "vlm", "audio")),
    "mamba": LMFamily("mamba", config_families=("ssm",), impl="pallas",
                      kernels=("ssm_scan",)),
    "rglru": LMFamily("rglru", config_families=("hybrid",), impl="pallas",
                      kernels=("rglru_scan", "flash_attention")),
    "moe": LMFamily("moe", config_families=("moe",)),
}

# ModelConfig.family -> adapter name (the "auto" derivation)
_AUTO = {cf: fam.name for fam in FAMILIES.values()
         for cf in fam.config_families}


def family_of_config(cfg: ModelConfig) -> str:
    """The adapter name an architecture derives to under ``family="auto"``."""
    try:
        return _AUTO[cfg.family]
    except KeyError:
        raise SpecError(
            f"architecture {cfg.name!r} has config family {cfg.family!r} "
            f"with no workload adapter; adapters cover "
            f"{sorted(_AUTO)}") from None


def resolve_family(model: ModelSpec, cfg: ModelConfig | None = None
                   ) -> LMFamily:
    """``ModelSpec`` -> family adapter, validated against the arch: an
    explicit family must exist and accept the architecture's config
    family, and mismatches fail here, eagerly."""
    cfg = configs.get(model.arch) if cfg is None else cfg
    if model.family == "auto":
        return FAMILIES[family_of_config(cfg)]
    if model.family not in FAMILIES:
        raise SpecError(
            f"unknown model family {model.family!r}; available: "
            f"{sorted(FAMILIES)} (or 'auto')")
    fam = FAMILIES[model.family]
    if cfg.family not in fam.config_families:
        raise SpecError(
            f"family {fam.name!r} cannot adapt arch {model.arch!r} "
            f"(config family {cfg.family!r}, accepted: "
            f"{sorted(fam.config_families)}); use family='auto' or "
            f"{family_of_config(cfg)!r}")
    return fam
