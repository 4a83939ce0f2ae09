"""Helpers of the port's dry-run tests (``tests/test_torch_dryrun*.py``):
the reference's per-device argument bytes from its own specs, and the
port's dry run of a reduced config on a 2×2 fake world."""
import os

import jax
import numpy as np

from repro import configs as jconfigs
from repro.launch import shardings as jsh
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh

# the reference's dryrun module sets XLA_FLAGS (512 host devices) when
# imported; keep that from reaching this worker's JAX backend
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import steps as jsteps  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

# the keys of the reference's dry_run result that the port keeps
# (lower_s/compile_s became trace_s; the XLA:CPU upcast correction and
# the generated code size have no counterpart)
REF_KEYS = {"arch", "shape", "kind", "mesh", "policy", "chips",
            "flops_per_device", "bytes_per_device",
            "collective_wire_bytes_per_device", "collectives", "loops",
            "cost_analysis_raw", "memory", "roofline", "model_flops_total",
            "model_flops_per_device", "useful_flops_ratio", "bottleneck"}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def _spec_bytes(leaves_specs, mesh) -> int:
    n = 0
    for leaf, spec in leaves_specs:
        div = 1
        for entry in tuple(spec):
            if entry is not None:
                div *= jsh.axis_size(mesh, entry)
        n += int(np.prod(leaf.shape)) // div * np.dtype(leaf.dtype).itemsize
    return n


def _pairs(tree, specs):
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(sp)
    return list(zip(leaves, sp))


def reference_argument_bytes(jcfg, shape: str, policy: str, mesh_shape):
    """Per-device bytes of the reference step's arguments, from its specs:
    parameters (and Adam moments and step count for training), the batch,
    and the cache for decoding."""
    mesh = FakeMesh(mesh_shape)
    base = policy.split("+")[0]
    dp = tuple(mesh.axis_names) if base == "fsdp" else None
    S, B, kind = jspecs.INPUT_SHAPES[shape]
    pshape = JT.param_specs(jcfg)
    batch = jspecs.batch_specs(jcfg, shape)
    n = _spec_bytes(_pairs(batch, jsh.batch_partition(jcfg, batch, mesh,
                                                      dp=dp)), mesh)
    if kind == "train":
        pspec = jsh.param_specs_tree(jcfg, pshape, mesh, base)
        opt = jsteps.opt_state_specs(pshape)
        n += _spec_bytes(_pairs(pshape, pspec), mesh)
        for k in ("m", "v"):
            n += _spec_bytes(_pairs(opt[k], pspec), mesh)
        n += np.dtype(opt["t"].dtype).itemsize
        return n
    serve = "tp" if base == "fsdp_tp" else base
    n += _spec_bytes(_pairs(pshape, jsh.param_specs_tree(jcfg, pshape, mesh,
                                                         serve)), mesh)
    cache = jspecs.cache_specs(jcfg, shape)
    n += _spec_bytes(_pairs(cache, jsh.cache_partition(jcfg, cache, mesh)),
                     mesh)
    return n


def reduced_dry_run(arch: str, shape: str, policy: str) -> dict:
    cfg = tconfigs.reduced(tconfigs.get(arch))
    with tmesh.fake_world(4):
        return tdry.dry_run(arch, shape, policy=policy, cfg=cfg,
                            mesh=tmesh.make_host_mesh(model=2))


def check_reduced(arch: str, shape: str, policy: str) -> dict:
    """The dry run of ``arch``'s reduced config on 2×2: the reference's
    keys, per-device argument bytes equal to the reference's specs' sum
    (the decode position is a host integer in the port: 4 bytes less),
    finite positive counts."""
    res = reduced_dry_run(arch, shape, policy)
    assert REF_KEYS <= set(res), REF_KEYS - set(res)
    assert res["mesh"] == "2x2" and res["chips"] == 4
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    if jspecs.INPUT_SHAPES[shape][2] == "decode":
        jcfg = jspecs.serve_config(jcfg, shape)
    want = reference_argument_bytes(jcfg, shape, policy,
                                     {"data": 2, "model": 2})
    if jspecs.INPUT_SHAPES[shape][2] == "decode":
        want -= 4
    assert res["memory"]["argument_size_in_bytes"] == want
    for k in ("flops_per_device", "bytes_per_device"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert res["memory"]["temp_size_in_bytes"] > 0
    assert res["bottleneck"] in res["roofline"]
    assert res["trace_s"] >= 0 and isinstance(res["notes"], list)
    return res
