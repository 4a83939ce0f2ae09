"""The port's launch tooling against the reference, on the CPU, with no
process group unless a test makes one: the sharding rules leaf by leaf
(``param_specs_tree``, ``batch_partition``, ``cache_partition``, the
activation sharder's choice) on the reference's production mesh shapes,
the meta parameter and input specs, the parameter counts and
``model_flops``, the mesh constructors and ``fake_world``, the shard
hook's sequence in each family's forward, and the cost counter's
arithmetic against the reference's ``hlo.analyze``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import hlo as jhlo
from repro.launch import shardings as jsh
from repro.launch import specs as jspecs
from repro.models import shard_ctx as jshard_ctx
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import hlo as thlo
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models import shard_ctx as tshard_ctx
from repro_torch.models import transformer as TT

# the reference's dryrun module sets XLA_FLAGS (512 host devices) when
# imported; keep that from reaching this worker's JAX backend
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

from repro_torch.launch import dryrun as tdry  # noqa: E402

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)

SHAPES = list(jspecs.INPUT_SHAPES)
DECODE = ["decode_32k", "long_500k"]


class FakeMesh:
    """The reference tests' mesh stand-in (``tests/test_sharding.py``)."""
    def __init__(self, multi_pod=False):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


def _meshes(multi_pod):
    ref = FakeMesh(multi_pod)
    return ref, tmesh.MeshShape(ref.shape)


def _ref_flat(tree) -> dict:
    """path -> spec tuple of the reference's PartitionSpec tree."""
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _port_flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, f"{pre}['{k}']"))
        else:
            out[f"{pre}['{k}']"] = v
    return out


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): l for p, l in
            jax.tree_util.tree_leaves_with_path(tree)}


def _dt(x) -> str:
    return str(np.dtype(x.dtype)) if not isinstance(x, torch.Tensor) \
        else str(x.dtype).replace("torch.", "")


# ------------------------------------------------------------ spec parity
@pytest.mark.parametrize("policy", ["tp", "fsdp_tp", "fsdp"])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_tree_matches_reference(arch, multi_pod, policy):
    ref_mesh, mesh = _meshes(multi_pod)
    want = _ref_flat(jsh.param_specs_tree(
        jconfigs.get(arch), JT.param_specs(jconfigs.get(arch)), ref_mesh,
        policy))
    got = _port_flat(tsh.param_specs_tree(
        tconfigs.get(arch), TT.param_specs(tconfigs.get(arch)), mesh,
        policy))
    assert got == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_batch_partition_matches_reference(arch, shape, multi_pod):
    ref_mesh, mesh = _meshes(multi_pod)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    if jspecs.INPUT_SHAPES[shape][2] == "decode":
        jcfg = jspecs.serve_config(jcfg, shape)
        tcfg = tspecs.serve_config(tcfg, shape)
    want = _ref_flat(jsh.batch_partition(
        jcfg, jspecs.batch_specs(jcfg, shape), ref_mesh))
    got = _port_flat(tsh.batch_partition(
        tcfg, tspecs.batch_specs(tcfg, shape), mesh))
    assert got == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_partition_matches_reference(arch, shape, multi_pod):
    ref_mesh, mesh = _meshes(multi_pod)
    jcfg = jspecs.serve_config(jconfigs.get(arch), shape)
    tcfg = tspecs.serve_config(tconfigs.get(arch), shape)
    want = _ref_flat(jsh.cache_partition(
        jcfg, jspecs.cache_specs(jcfg, shape), ref_mesh))
    got = _port_flat(tsh.cache_partition(
        tcfg, tspecs.cache_specs(tcfg, shape), mesh))
    assert got == want


KINDS = ["act_btd", "logits", "attn_batch", "act_btd_full", "act_btf"]
ACT_SHAPES = [(256, 4096, 1024), (256, 512, 151936), (256, 4096, 16, 128),
              (128, 1, 2048), (1, 4096, 1024), (48, 4096, 1024), (256,),
              (8, 16)]


@pytest.mark.parametrize("dp_all", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("variants", [(), ("act",), ("attnb",), ("seq",),
                                      ("act", "attnb", "seq")])
def test_activation_sharder_choice_matches_reference(variants, multi_pod,
                                                     dp_all, monkeypatch):
    """The reference's spec, captured by replacing NamedSharding and
    with_sharding_constraint in its module; None where it leaves x."""
    ref_mesh, mesh = _meshes(multi_pod)
    monkeypatch.setattr(jsh, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jsh.jax.lax, "with_sharding_constraint",
                        lambda x, spec: ("pinned", tuple(spec)))
    dp = tuple(ref_mesh.axis_names) if dp_all else None
    ref = jsh.make_activation_sharder(ref_mesh, set(variants), dp=dp)
    port = tsh.activation_spec(mesh, set(variants), dp=dp)
    for kind in KINDS:
        for shape in ACT_SHAPES:
            out = ref(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
            want = out[1] if isinstance(out, tuple) else None
            assert port(shape, kind) == want, (kind, shape)


# ------------------------------------------------------ DTensor placements
def test_to_placements_one_axis_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tmesh.MeshShape({"pod": 2, "data": 16, "model": 16})
    assert tsh.to_placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.to_placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert tsh.to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="shards two tensor dims"):
        tsh.to_placements(("model", "model"), mesh)


# -------------------------------------------------------------------- mesh
def test_axis_size_and_dp_axes_on_a_plain_description():
    m = tmesh.MeshShape({"pod": 2, "data": 16, "model": 16})
    assert tmesh.axis_size(m, "model") == 16
    assert tmesh.axis_size(m, ("pod", "data")) == 32
    assert tmesh.dp_axes(m) == ("pod", "data")
    assert tmesh.mesh_label(m) == "2x16x16"


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_in_a_fake_world(multi_pod):
    n = 512 if multi_pod else 256
    with tmesh.fake_world(n):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert mesh.mesh_dim_names == names
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert tmesh.dp_axes(mesh) == names[:-1]
        assert tmesh.axis_size(mesh, names[:-1]) == n // 16
        with pytest.raises(RuntimeError, match="cannot nest"):
            with tmesh.fake_world(4):
                pass
    assert not torch.distributed.is_initialized()


def test_mesh_errors_keep_the_references():
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="must be >= 1"):
        tmesh.make_host_mesh(model=0)
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        tmesh.make_host_mesh(model=2)
    with pytest.raises(ValueError, match="num_hosts must be >= 1"):
        tmesh.make_hosts_mesh(0)
    with tmesh.fake_world(4):
        mesh = tmesh.make_host_mesh(model=2)
        assert tuple(mesh.shape) == (2, 2)
        assert tmesh.make_hosts_mesh(4).mesh_dim_names == ("hosts",)
        with pytest.raises(ValueError, match="exceeds the 4 available"):
            tmesh.make_host_mesh(model=8)
        with pytest.raises(RuntimeError, match="need 8 ranks"):
            tmesh.make_hosts_mesh(8)


# ------------------------------------------------ specs, counts and FLOPs
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_names_shapes_dtypes(arch):
    want = {k: (tuple(v.shape), _dt(v)) for k, v in
            _ref_leaves(JT.param_specs(jconfigs.get(arch))).items()}
    got = {k: (tuple(v.shape), _dt(v)) for k, v in
           _port_flat(TT.param_specs(tconfigs.get(arch))).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in
               _port_flat(TT.param_specs(tconfigs.get(arch))).values())


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_counts_and_model_flops(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert tcfg.active_params() == jcfg.active_params()
    assert tcfg.total_params() == jcfg.total_params()
    r = tconfigs.reduced(tcfg)
    assert r.total_params() == jconfigs.reduced(jcfg).total_params()
    for shape in SHAPES:
        assert tdry.model_flops(tcfg, shape) == jdry.model_flops(jcfg, shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_batch_and_cache_specs(arch, shape):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    if jspecs.INPUT_SHAPES[shape][2] == "decode":
        jcfg = jspecs.serve_config(jcfg, shape)
        tcfg = tspecs.serve_config(tcfg, shape)
        assert tcfg.sliding_window == jcfg.sliding_window
        want = {k: (tuple(v.shape), _dt(v)) for k, v in
                _ref_leaves(jspecs.cache_specs(jcfg, shape)).items()}
        got = {k: (tuple(v.shape), _dt(v)) for k, v in
               _port_flat(tspecs.cache_specs(tcfg, shape)).items()}
        assert got == want
    else:
        with pytest.raises(ValueError):
            tspecs.cache_specs(tcfg, shape)
    want = {k: (tuple(v.shape), _dt(v)) for k, v in
            jspecs.batch_specs(jcfg, shape).items()}
    got = {k: (tuple(v.shape), _dt(v)) for k, v in
           tspecs.batch_specs(tcfg, shape).items()}
    assert got == want


def test_long_500k_serve_configs_bounded():
    """tests/test_sharding.py's bound: no architecture materializes an
    O(500k) decode cache (<= 2.5 GB for batch 1)."""
    for arch in tconfigs.ARCH_IDS:
        cfg = tspecs.serve_config(tconfigs.get(arch), "long_500k")
        cache = _port_flat(tspecs.cache_specs(cfg, "long_500k"))
        per_seq = sum(v.numel() * v.element_size() for v in cache.values())
        jcfg = jspecs.serve_config(jconfigs.get(arch), "long_500k")
        ref = sum(np.prod(l.shape) * l.dtype.itemsize for l in
                  jax.tree_util.tree_leaves(jspecs.cache_specs(jcfg,
                                                               "long_500k")))
        assert per_seq == ref and per_seq < 2.5e9, (arch, per_seq)


@pytest.mark.parametrize("arch,shape", [
    ("qwen3_0p6b", "train_4k"), ("qwen3_0p6b", "decode_32k"),
    ("qwen2_vl_2b", "decode_32k")])
def test_concrete_batch_matches_the_specs(arch, shape):
    cfg = tconfigs.reduced(tconfigs.get(arch))
    if tspecs.INPUT_SHAPES[shape][2] == "decode":
        cfg = tspecs.serve_config(cfg, shape)
    gen = torch.Generator().manual_seed(3)
    batch = tspecs.concrete_batch(cfg, shape, gen)
    spec = tspecs.batch_specs(cfg, shape)
    assert set(batch) == set(spec)
    for k, v in batch.items():
        assert v.shape == spec[k].shape and v.dtype == spec[k].dtype, k
    if "tokens" in batch:
        assert int(batch["tokens"].max()) < cfg.vocab_size
    if "position" in batch:
        assert int(batch["position"]) == tspecs.INPUT_SHAPES[shape][0] - 1
    again = tspecs.concrete_batch(cfg, shape,
                                  torch.Generator().manual_seed(3))
    assert all(torch.equal(batch[k], again[k]) for k in batch)


# ------------------------------------------------------------ the shard hook
FAMILIES = ["qwen3_0p6b", "granite_moe_1b_a400m", "falcon_mamba_7b",
            "recurrentgemma_9b", "qwen2_vl_2b"]


def _record(log):
    def sharder(x, kind):
        log.append((kind, tuple(x.shape)))
        return x
    return sharder


def _reduced_pair(arch):
    jcfg = jconfigs.reduced(jconfigs.get(arch)).with_(dtype=jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get(arch)).with_(dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        b["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (3, B, S)).copy()
    return b


@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_hook_sequence_matches_reference(arch):
    """With a recording sharder in both packages, one reduced forward
    (the loss, and a prefill) makes the same sequence of shard kinds and
    shapes; the reference runs eagerly (``jax.disable_jit``) so its scans
    call the hook once a layer and a chunk, as the port's loops do."""
    jcfg, tcfg, jp, tp = _reduced_pair(arch)
    nb = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jlog, tlog = [], []
    jshard_ctx.set_sharder(_record(jlog))
    tshard_ctx.set_sharder(_record(tlog))
    try:
        with jax.disable_jit():
            JT.loss_fn(jcfg, jp, jb, remat=False)
            JT.prefill_step(jcfg, jp, {k: v for k, v in jb.items()
                                       if k != "labels"})
        with torch.no_grad():
            TT.loss_fn(tcfg, tp, tb, remat=False)
            TT.prefill_step(tcfg, tp, {k: v for k, v in tb.items()
                                       if k != "labels"})
    finally:
        jshard_ctx.set_sharder(None)
        tshard_ctx.set_sharder(None)
    assert tlog == jlog
    assert {k for k, _ in tlog} >= {"act_btd", "logits"}


def test_no_sharder_is_the_identity():
    x = torch.ones(2, 3)
    assert tshard_ctx.shard(x, "act_btd") is x


# ------------------------------------------------------------- accounting
@pytest.mark.parametrize("kind", list(jhlo._COLLECTIVES))
@pytest.mark.parametrize("n", [1, 2, 4, 16, 256])
@pytest.mark.parametrize("out_bytes", [0, 1000, 3 * 2 ** 20])
def test_wire_bytes_match_reference(kind, n, out_bytes):
    assert thlo._wire_bytes(kind, out_bytes, n) == \
        jhlo._wire_bytes(kind, out_bytes, n)
    assert thlo._COLLECTIVES == jhlo._COLLECTIVES


def _ref_flops(fn, *args):
    return jhlo.analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_plain_product_flops_match_reference():
    a, b = np.zeros((128, 256), np.float32), np.zeros((256, 64), np.float32)
    want = _ref_flops(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    got, _ = thlo.analyze(lambda a, b: a @ b, torch.from_numpy(a),
                          torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 2 * 128 * 256 * 64


def test_scanned_product_flops_match_reference():
    """L = 12 stacked products: the reference multiplies the scan's body
    by its trip count; the port's loop runs L times."""
    L, M, K, N = 12, 64, 128, 32
    ws, x = np.zeros((L, K, N), np.float32), np.zeros((M, K), np.float32)

    def jfn(x, ws):
        _, ys = jax.lax.scan(lambda c, w: (c, x @ w), None, ws)
        return ys

    def tfn(x, ws):
        return torch.stack([x @ ws[i] for i in range(L)])

    want = _ref_flops(jfn, jnp.asarray(x), jnp.asarray(ws))
    got, _ = thlo.analyze(tfn, torch.from_numpy(x), torch.from_numpy(ws))
    assert got["flops"] == want["flops"] == L * 2 * M * K * N


def test_nested_loop_flops_match_reference():
    Lo, Li, M = 4, 6, 32
    w = np.eye(M, dtype=np.float32)

    def jfn(x):
        def inner(c, _):
            return c @ jnp.asarray(w), None

        def outer(c, _):
            c, _ = jax.lax.scan(inner, c, None, length=Li)
            return c, None
        return jax.lax.scan(outer, x, None, length=Lo)[0]

    def tfn(x):
        tw = torch.from_numpy(w)
        for _ in range(Lo):
            for _ in range(Li):
                x = x @ tw
        return x

    want = _ref_flops(jfn, jnp.zeros((M, M), jnp.float32))
    got, _ = thlo.analyze(tfn, torch.zeros(M, M))
    assert got["flops"] == want["flops"] == Lo * Li * 2 * M ** 3


def test_combine_scales_counts_and_sites():
    """Sites combine by (kind, group size, provenance), count and output
    bytes apart: a collective repeated with the body grows in count, and
    one a step whose bytes grow with the body (a stacked leaf's gather)
    stays one collective of the whole stack's bytes."""
    def counts(flops, rep, stacked):
        return {"flops": flops, "pointwise_flops": 1.0, "traffic_bytes": 4.0,
                "peak_bytes": 2.0,
                "sites": {("all-gather", 2, "x:1"): [rep, 8.0 * rep],
                          ("all-gather", 2, "w:2"): [1.0, stacked]}}

    a, b = counts(10.0, 1.0, 100.0), counts(16.0, 2.0, 200.0)
    per = thlo.combine([(1.0, b), (-1.0, a)])
    assert per["flops"] == 6.0 and per["sites"] == {
        ("all-gather", 2, "x:1"): [1.0, 8.0],
        ("all-gather", 2, "w:2"): [0.0, 100.0]}
    s = thlo.summarize(thlo.combine([(1.0, a), (3.0, per)]), loops=[1])
    assert s["collectives"]["all-gather"]["count"] == 4.0 + 1.0
    assert s["collectives"]["all-gather"]["out_bytes"] == 4 * 8 + 400
    assert s["wire_bytes"] == (4 * 8 + 400) * 0.5 and s["loops"] == [1]
