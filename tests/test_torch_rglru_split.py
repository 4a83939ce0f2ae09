"""The recurrent blocks under DTensor: the Griffin block (RG-LRU) and the
mamba block run on local shards of their channels in Megatron's layout
(``shard_ctx.channels_local``), the same at every sequence length, in
train, prefill and decode, not in whatever DTensor's strategies of the
installed torch pick.

Left to DTensor, the Griffin block's gate products gathered the
activations at S = 16 and the 33.6 MB gate weights from S = 32 on, and
mamba's ``dt @ dt_proj`` switched its layout between S = 32 and 64: the
dry run, which traces a recurrent kind at two short lengths and
extrapolates in S, multiplied the switch 255 times a layer
(recurrentgemma-9b ``train_4k``: 3.37e12 wire bytes a device).  The dry
run now also combines each collective site by its count and bytes, so a
collective that grows with S or with a stacked leaf keeps its count.

Held here: the plain blocks are the plain code bit for bit; no DTensor
operation at ``rglru.py``'s or ``mamba.py``'s lines and nothing run
replicated, in train, prefill and decode (a batch of one too); a third
trace at 4·s1 on the line through the first two (``dryrun.linearity``),
reduced on a 2×2 world and at full width on 16×16; recurrentgemma-9b's
``train_4k`` pinned at this CPU's bound.  The 2×2 gloo steps, prefills
and decodes against the unsharded ones are
``test_torch_sharded_step.py``'s."""
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.launch import dryrun as tdry
from repro_torch.models import mamba as TM
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_dispatch_sites import dtensor_ops  # noqa: E402

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)


def _layer(arch: str, seed=0):
    cfg = configs.reduced(configs.get(arch)).with_(dtype=torch.float32)
    t = "rec" if cfg.family == "hybrid" else "ssm"
    params = TT.init_params(cfg, seed, device="cpu")
    p = {k: v[0].clone() for k, v in params[f"stack_{t}"].items()}
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed + 1))
    return cfg, p, x


def _griffin(cfg, p, x, state=None, return_state=False, impl="xla"):
    """The Griffin block as the plain code composes it."""
    u_raw = x @ p["in_proj_rnn"]
    g = F.gelu(x @ p["in_proj_gate"], approximate="tanh")
    if state is not None:
        u, conv = TM._causal_conv(u_raw, p["conv_w"], p["conv_b"],
                                  state["conv"])
        y, h = TR.rg_lru(p, u, h0=state["h"])
        return (y * g) @ p["out_proj"], {"conv": conv, "h": h}
    u = TM._causal_conv(u_raw, p["conv_w"], p["conv_b"])
    y, h = TR.rg_lru(p, u, impl=impl)
    out = (y * g) @ p["out_proj"]
    W = p["conv_w"].shape[1]
    return (out, {"conv": u_raw[:, -(W - 1):, :], "h": h}) \
        if return_state else out


def _mamba(cfg, p, x, state=None, return_state=False, impl="xla"):
    """The mamba block as the plain code composes it."""
    u_raw = x @ p["in_proj_u"]
    z = x @ p["in_proj_z"]
    if state is not None:
        u, conv = TM._causal_conv(u_raw, p["conv_w"], p["conv_b"],
                                  state["conv"])
        u = F.silu(u)
    else:
        u = F.silu(TM._causal_conv(u_raw, p["conv_w"], p["conv_b"]))
    delta, B_ssm, C_ssm = TM._ssm_inputs(cfg, p, u)
    if impl == "pallas" and not return_state and state is None:
        from repro_torch.kernels import ops
        y, h = ops.ssm_scan(u, delta, B_ssm, C_ssm, p["A_log"], p["D"]), None
    else:
        y, h = TM.selective_scan(cfg, p, u, delta, B_ssm, C_ssm,
                                 None if state is None else state["h"])
    out = (y * F.silu(z)) @ p["out_proj"]
    if state is not None:
        return out, {"conv": conv, "h": h}
    W = p["conv_w"].shape[1]
    return (out, {"conv": u_raw[:, -(W - 1):, :], "h": h}) \
        if return_state else out


BLOCKS = {"recurrentgemma-9b": (TR.recurrent_block, _griffin),
          "falcon-mamba-7b": (TM.mamba_block, _mamba)}


def _leaves(out):
    if isinstance(out, tuple):
        return [out[0]] + [v for v in out[1].values() if v is not None]
    return [out]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list(BLOCKS))
def test_plain_block_is_the_plain_code(arch, impl):
    """Bitwise: the train block's output and the gradients of x and of
    every parameter, prefill's output and state, a decode step's."""
    cfg, p, x = _layer(arch)
    block, plain = BLOCKS[arch]
    mod = TR if arch == "recurrentgemma-9b" else TM
    p = {k: p[k] for k in mod._COLS + mod._CHANNELS + mod._ROWS}
    x = x.requires_grad_(True)
    ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    wrt = [x] + list(ps.values())
    got = block(cfg, ps, x, impl=impl)
    want = plain(cfg, ps, x, impl=impl)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(2))
    for a, b in zip((got,) + torch.autograd.grad(got, wrt, g),
                    (want,) + torch.autograd.grad(want, wrt, g)):
        assert torch.equal(a, b)
    with torch.no_grad():
        got = block(cfg, p, x, return_state=True, impl=impl)
        want = plain(cfg, p, x, return_state=True)
        for a, b in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a, b)
        x1 = x[:, :1]
        if mod is TR:
            got = TR.recurrent_block(cfg, p, x1, state=dict(want[1]))
        else:
            got = TM.mamba_decode_step(cfg, p, x1, dict(want[1]))
        want = plain(cfg, p, x1, state=dict(want[1]))
        for a, b in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a, b)


SHAPES = [("train_4k", 2), ("prefill_32k", 2), ("decode_32k", 2),
          ("long_500k", 1)]


@pytest.mark.parametrize("shape,batch", SHAPES,
                         ids=[s for s, _ in SHAPES])
@pytest.mark.parametrize("arch,module", [("recurrentgemma-9b", "rglru.py"),
                                         ("falcon-mamba-7b", "mamba.py")])
def test_no_dtensor_op_runs_in_the_block(arch, module, shape, batch):
    """The reduced step on a 2×2 fake world (a batch of one for
    ``long_500k``: the channels split over both mesh dims): no operation
    at the block's lines is dispatched on a DTensor, and nothing of the
    step runs replicated."""
    notes: list = []
    ops = dtensor_ops(arch, shape, "fsdp_tp", notes=notes, batch_size=batch)
    assert ops
    assert [(op, site) for op, site in ops if module in site] == []
    assert notes == []


KINDS = [("recurrentgemma-9b", "rec"), ("falcon-mamba-7b", "ssm")]


@pytest.mark.parametrize("arch,kind", KINDS, ids=[k for _, k in KINDS])
def test_extrapolation_in_s_is_linear_on_2x2(arch, kind):
    """The kind's train step traced at S = 16, 32 and 64 on a 2×2 world:
    FLOPs, bytes, wire bytes and every collective's count at 64 within
    1 % of the line through 16 and 32 (here exactly on it)."""
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    cfg = configs.reduced(configs.get(arch))
    with fake_world(4):
        res = tdry.linearity(arch, kind, cfg=cfg,
                             mesh=make_host_mesh(model=2))
    assert res["traced"] == [16, 32, 64]
    assert any(" count " in k for k in res["rel_err"])
    assert res["max_rel_err"] <= chip_smoke.LINEARITY_TOL, \
        sorted(res["rel_err"].items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("arch,kind", KINDS, ids=[k for _, k in KINDS])
def test_extrapolation_in_s_is_linear_at_full_width(arch, kind):
    """The same at full width on the 16×16 fake world, as 3q runs it."""
    res = tdry.linearity(arch, kind)
    assert res["max_rel_err"] <= chip_smoke.LINEARITY_TOL, \
        sorted(res["rel_err"].items(), key=lambda kv: -kv[1])[:3]


def test_sites_combine_by_count_and_bytes():
    """A collective of a stacked leaf, one a step whatever the layers, its
    bytes growing with them: traced at one and two layers, it stays one
    collective of the whole stack's bytes at five (keyed by size, the
    two traces' sites would not cancel and the count would grow)."""
    def counts(ob):
        return {"flops": 0.0, "sites": {("all-gather", 16, "s"): [1.0, ob]}}

    one, two = counts(100.0), counts(200.0)
    layer = tdry._lin(two, one, 1.0, -1.0)
    base = tdry._lin(one, two, 2.0, -1.0)
    total = tdry._lin(base, layer, 1.0, 5.0)["sites"]
    assert total == {("all-gather", 16, "s"): [1.0, 500.0]}


def test_recurrentgemma_train_step_on_16x16():
    """recurrentgemma-9b ``train_4k`` at full width: this CPU's count and
    bound, which 3q holds the card to, nothing run replicated, and no
    collective site counted more than a few times a layer (13,260 times
    at ``rglru.py:31`` before)."""
    arch, key = "recurrentgemma-9b", ("recurrentgemma-9b", "train_4k",
                                      "fsdp_tp")
    res = tdry.dry_run(arch, "train_4k", policy="fsdp_tp")
    assert res["flops_per_device"] == pytest.approx(
        chip_smoke.CPU_FLOPS[key], rel=1e-9)
    assert max(res["roofline"].values()) == pytest.approx(
        chip_smoke.CPU_BOUND[key], rel=1e-9)
    assert res["notes"] == []
    layers = configs.get(arch).num_layers
    assert max(m for *_, m in res["sites"]) <= 4 * layers
    assert any("rglru.py" in s[3] for s in res["sites"])


def test_linearity_lines_run_small(monkeypatch, capsys):
    """chip_smoke.py 3q's linearity lines on the CPU, reduced on 2×2."""
    import json
    from repro_torch.launch import mesh
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    rt = dict(configs=configs, dryrun=tdry, mesh=mesh, smi="cpu")
    rows = chip_smoke.linearity_phase(torch, rt, reduced=True)
    assert [(r["arch"], r["kind"]) for r in rows] == \
        list(chip_smoke.LINEARITY_RUNS)
    assert chip_smoke.FAILED == []
    lines = [json.loads(line) for line in capsys.readouterr().out
             .splitlines() if line.startswith("{")]
    assert [line["path"] for line in lines] == ["dry_run_linearity"] * 2
    assert all(line["max_rel_err"] <= chip_smoke.LINEARITY_TOL
               for line in lines)
