"""Mesh construction — the port of ``repro.launch.mesh``.

The reference lays out a TPU pod: ``(16, 16)`` chips as ``("data",
"model")``, two pods as ``(2, 16, 16)`` with a ``"pod"`` axis.  Here the
same shapes and axis names are ``torch.distributed`` ``DeviceMesh``es,
meshes of 256 or 512 H100s that the dry run (``launch/dryrun.py``) lays
out; nothing here says such a cluster exists.  The dry run builds them
inside ``fake_world(n)``: a process group of ``n`` ranks over the
``fake`` backend, whose collectives move nothing, the counterpart of the
reference's ``--xla_force_host_platform_device_count``.  On a real
group (gloo on the CPU, NCCL on a card) the same functions give a real
mesh.

Functions, never module-level constants: importing this module touches
no process group.  ``axis_size`` and ``dp_axes`` also take a plain
description of a mesh, ``MeshShape``, so the sharding rules run with no
process group at all, as the reference's ``FakeMesh`` does in its tests.
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping

import torch
import torch.distributed as dist


class MeshShape:
    """Axis names and sizes, and nothing else: ``MeshShape({"data": 16,
    "model": 16})``."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(getattr(mesh, "shape", None), Mapping):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def mesh_label(mesh) -> str:
    """"16x16", "2x16x16", "2x2", ...: the sizes in axis order."""
    return "x".join(str(n) for n in axis_sizes(mesh).values())


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    """The device type of the live group's tensors: "cuda" under NCCL,
    "cpu" under gloo and the fake backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) as ("data", "model"), or (2, 16, 16) as ("pod", "data",
    "model") with ``multi_pod``, over the first 256 or 512 ranks of the
    live group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have} — run inside "
            f"launch.mesh.fake_world({n}) (dry run) or on a group of {n} "
            f"real ranks")
    return _mesh(shape, names)


def make_host_mesh(*, model: int = 1):
    """Small ("data", "model") mesh over the ranks of the live group (CPU
    tests, examples)."""
    n = _world_size()
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if model > n:
        # without this, data = 0 and the mesh would have no ranks
        raise ValueError(
            f"model={model} exceeds the {n} available rank(s): the data "
            f"axis would be empty. Run with more ranks (e.g. inside "
            f"fake_world({model})) or shrink the model axis.")
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a live process group "
                           "(torch.distributed.init_process_group or "
                           "fake_world)")
    return _mesh((n // model, model), ("data", "model"))


def make_hosts_mesh(num_hosts: int):
    """A 1-D ``("hosts",)`` mesh, one rank per logical host.  The port's
    multi-host runtime keeps every lane in one process (ROADMAP queue
    A13), so nothing in it builds this mesh yet."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    have = _world_size() if dist.is_initialized() else 0
    if have < num_hosts:
        raise RuntimeError(
            f"need {num_hosts} ranks for a {num_hosts}-host mesh, have "
            f"{have} — run inside fake_world({num_hosts}) (simulated "
            f"hosts) or on a group of real ranks")
    return _mesh((num_hosts,), ("hosts",))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (everything except 'model')."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on the ``fake`` backend, this
    process being rank 0, torn down on exit.  Its collectives move no
    data, so only shapes mean anything under it: run the dry run on meta
    or fake tensors.  A process has one default group, so this refuses
    to start while one is live."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group ({dist.get_backend()}, world size "
            f"{dist.get_world_size()}) is live: fake_world({n}) cannot nest "
            f"inside it; destroy it first or run the dry run in a child "
            f"process")
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
