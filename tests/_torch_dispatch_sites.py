"""Which operations a step dispatches on DTensors, and where: the
helpers of the layout tests (``test_torch_embed_split.py``,
``test_torch_head_split.py``, ``test_torch_loss_split.py``,
``test_torch_rglru_split.py``).  A step is built by the dry run
(``launch/dryrun.build_step``) on a 2×2 fake world of meta tensors and
run under ``launch/hlo``'s site stamp, so an operation in the backward
pass is named by its autograd node and the forward line that made it."""
import inspect

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hlo
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models import shard_ctx


def source_lines(module, text: str) -> set:
    """``hlo.current_site``'s names of the lines of ``module`` that hold
    ``text``."""
    lines, _ = inspect.getsourcelines(module)
    path = module.__file__[module.__file__.index("repro_torch"):]
    return {f"{path}:{i}" for i, line in enumerate(lines, 1)
            if text in line}


class _DTensorOps(TorchDispatchMode):
    """Records (op, site) of every operation dispatched on a DTensor."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.ops.append((str(func), hlo.current_site()))
        return func(*args, **(kwargs or {}))


def dtensor_ops(arch: str, shape: str, policy: str, notes=None,
                batch_size: int = 2, **overrides) -> list:
    """(op, site) of each DTensor operation of the reduced ``arch``'s step
    of ``shape`` (batch ``batch_size``, 64 tokens) on a 2×2 fake world;
    ``notes`` (a list) collects the ops run replicated."""
    cfg = configs.reduced(configs.get(arch)).with_(**overrides)
    seen = _DTensorOps()
    with fake_world(4):
        try:
            fn, args = tdry.build_step(cfg, shape, make_host_mesh(model=2),
                                       policy,
                                       notes=[] if notes is None else notes,
                                       seq_len=64, batch_size=batch_size)
            with hlo._SiteStamp(), seen:
                fn(*args)
        finally:
            shard_ctx.set_sharder(None)
    return seen.ops
