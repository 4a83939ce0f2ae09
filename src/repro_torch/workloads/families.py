"""Model-family adapters — the port of ``repro.workloads.families``.

A family is the trio of factories the session builder needs for an LM
run — ``build_params`` / ``step`` / ``objective`` — and the layer ``impl``
that carries its training traffic.  This port carries ``mamba``, whose
``impl="pallas"`` routes the selective scan through the hand-written
Hopper kernel (``kernels/ops.py::ssm_scan``), and ``rglru``, whose
``impl="pallas"`` routes the RG-LRU recurrence and the local attention
through theirs (``rglru_scan``, ``flash_attention``); the reference's
other families raise a ``SpecError`` that names the slice that brings
them.
"""
from __future__ import annotations

import dataclasses

from .. import configs
from ..api.lm import LMStepOptimizer, make_lm_objective
from ..api.specs import ModelSpec, SpecError
from ..launch import steps
from ..models import transformer as T
from ..models.common import ModelConfig


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
    "mamba": LMFamily("mamba", config_families=("ssm",), impl="pallas",
                      kernels=("ssm_scan",)),
    "rglru": LMFamily("rglru", config_families=("hybrid",), impl="pallas",
                      kernels=("rglru_scan", "flash_attention")),
}

# the reference's other adapters: name -> (config families, the slice)
PENDING: dict[str, tuple] = {
    "transformer": (("dense", "vlm", "audio"),
                    "the transformer slice (ROADMAP queue A)"),
    "moe": (("moe",), "the moe slice (ROADMAP queue A)"),
}

# ModelConfig.family -> adapter name (the "auto" derivation)
_AUTO = {cf: fam.name for fam in FAMILIES.values()
         for cf in fam.config_families}
_AUTO.update({cf: name for name, (cfs, _) in PENDING.items() for cf in cfs})


def _family(name: str) -> LMFamily:
    if name in PENDING:
        raise SpecError(f"model family {name!r} is not yet ported to "
                        f"repro_torch; it comes with {PENDING[name][1]}")
    return FAMILIES[name]


def pending_slice(config_family: str) -> str:
    """The slice that brings the adapter of a config family not yet
    ported (the refusal ``configs.get`` gives such an architecture)."""
    return next(sl for cfs, sl in PENDING.values() if config_family in cfs)


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
        return _family(family_of_config(cfg))
    if model.family not in FAMILIES and model.family not in PENDING:
        raise SpecError(
            f"unknown model family {model.family!r}; available: "
            f"{sorted(set(FAMILIES) | set(PENDING))} (or 'auto')")
    accepted = (FAMILIES[model.family].config_families
                if model.family in FAMILIES else PENDING[model.family][0])
    if cfg.family not in accepted:
        raise SpecError(
            f"family {model.family!r} cannot adapt arch {model.arch!r} "
            f"(config family {cfg.family!r}, accepted: "
            f"{sorted(accepted)}); use family='auto' or "
            f"{family_of_config(cfg)!r}")
    return _family(model.family)
