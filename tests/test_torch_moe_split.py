"""The MoE block under DTensor: the routing, the expert products and the
combine run on local shards in a layout the port chooses
(``shard_ctx.experts_local``: experts over ``model``, as the reference's
``_MOE_RULES`` place the stacks), not in whatever DTensor's einsum
strategies of the installed torch pick.

Left to DTensor, this CPU's torch built the (G, S_g, E, C) combine
tensor by a global ``index_put`` and gathered its gradient for the whole
global batch (21.47 GB a device at granite-moe-1b-a400m's ``train_4k``
on 16×16, 24 times a step), and ran the combine einsum whole on every
model shard; torch 2.11 refused the combine's view.  Here every model
shard routes all tokens of its batch shard and builds the routing
tensors of its own experts only.

Also held: the count is the same whichever layout the residual stream
takes, llama4-scout (top-1, a shared expert) is no worse than before,
the expert shards' parts add up to the whole block on plain tensors,
and chip_smoke.py 3q's MoE lines run small.  The 2×2 gloo steps against
the unsharded step are ``test_torch_sharded_step.py``'s."""
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun as tdry
from repro_torch.models import moe as TM
from repro_torch.models import shard_ctx
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_leaves, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)

GRANITE = "granite-moe-1b-a400m"
SCOUT = "llama4-scout-17b-a16e"
# the parent tree's dry runs on this CPU (torch 2.13.0+cpu, 16×16
# train_4k): llama4-scout under fsdp_tp, and granite-moe's roofline bound
# before the heads' layout moved its MoE input off a 256-way batch split
SCOUT_FLOPS, SCOUT_BOUND_S = 6.948e14, 6.091
GRANITE_PARENT_BOUND_S = 3.889


@pytest.fixture(scope="module")
def runs():
    out = {(GRANITE, p): tdry.dry_run(GRANITE, "train_4k", policy=p)
           for p in ("fsdp_tp", "fsdp_tp+act")}
    out[(SCOUT, "fsdp_tp")] = tdry.dry_run(SCOUT, "train_4k",
                                           policy="fsdp_tp")
    return out


def _bound_s(res) -> float:
    return max(res["roofline"].values())


def _routing_bytes(arch: str) -> int:
    """Bytes of one data shard's (G, S_g, E, C) routing tensor in bf16 at
    ``train_4k`` on 16×16: a sixteenth of the whole batch's float32
    combine is twice this."""
    cfg = configs.get(arch)
    S, B, _ = tdry.specs.INPUT_SHAPES["train_4k"]
    G = B * S // cfg.moe_group_size // 16
    C = TM._capacity(cfg, cfg.moe_group_size)
    return G * cfg.moe_group_size * cfg.num_experts * C * 2


@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp_tp+act"])
def test_train_step_on_16x16_keeps_the_experts_sharded(runs, policy):
    res = runs[(GRANITE, policy)]
    assert [n for n in res["notes"] if "moe.py" in n["site"]] == []
    share = res["model_flops_per_device"]
    assert share < res["flops_per_device"] < 3 * share


@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp_tp+act"])
def test_no_routing_tensor_crosses_the_wire(runs, policy):
    """No collective made by the MoE block, forward or backward, moves a
    routing tensor of a data shard's groups, let alone the whole
    batch's (the 21.47 GB gather at ``IndexPutBackward0`` and the 1.34 GB
    one at the combine einsum before)."""
    limit = _routing_bytes(GRANITE)
    big = [s for s in runs[(GRANITE, policy)]["sites"]
           if "moe.py" in s[3] and s[1] >= limit]
    assert big == []


def test_the_count_does_not_depend_on_the_residual_streams_layout(runs):
    a, b = runs[(GRANITE, "fsdp_tp")], runs[(GRANITE, "fsdp_tp+act")]
    assert b["flops_per_device"] == pytest.approx(a["flops_per_device"],
                                                  rel=1e-9)


@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp_tp+act"])
def test_roofline_bound_is_below_the_parents(runs, policy):
    assert _bound_s(runs[(GRANITE, policy)]) < GRANITE_PARENT_BOUND_S


def test_llama4_scout_is_no_worse(runs):
    res = runs[(SCOUT, "fsdp_tp")]
    assert res["flops_per_device"] <= SCOUT_FLOPS
    assert _bound_s(res) <= SCOUT_BOUND_S
    assert [n for n in res["notes"] if "moe.py" in n["site"]] == []


def test_the_cards_count_is_held_to_this_cpus(runs):
    """chip_smoke.py 3q holds the card's count to this one."""
    want = chip_smoke.CPU_FLOPS[(GRANITE, "train_4k", "fsdp_tp")]
    assert runs[(GRANITE, "fsdp_tp")]["flops_per_device"] == \
        pytest.approx(want, rel=1e-9)


def _block_inputs(arch, **kw):
    cfg = configs.reduced(configs.get(arch)).with_(dtype=torch.float32,
                                                   **kw)
    params = TT.init_params(cfg, 0, device="cpu")
    p = {k: v[0] for k, v in params["stack_moe"].items()}
    x = torch.randn(2, 96, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    return cfg, p, x


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("arch,kw", [
    (GRANITE, {}),
    (GRANITE, {"capacity_factor": 0.5}),    # slots dropped
    (SCOUT, {}),
], ids=["granite", "granite-drops", "scout"])
def test_expert_shards_add_up_to_the_whole_block(arch, kw, shards):
    """Plain tensors, an expert shard at a time: its dispatch and combine
    are the whole block's columns bit for bit, its aux terms the whole
    block's, and the shards' outputs sum to the block's experts' output."""
    cfg, p, x = _block_inputs(arch, **kw)
    S_g = cfg.moe_group_size
    x_g = x.reshape(-1, S_g, cfg.d_model)
    combine, dispatch, terms = TM._route(cfg, p["router"], x_g)
    whole, whole_terms = TM._experts(cfg, S_g, x, p["router"], p["w_gate"],
                                     p["w_up"], p["w_down"])
    El = cfg.num_experts // shards
    y = torch.zeros_like(whole)
    for j in range(shards):
        e0, cut = j * El, slice(j * El, (j + 1) * El)
        c, d, t = TM._route(cfg, p["router"], x_g, e0, El)
        assert torch.equal(c, combine[:, :, cut])
        assert torch.equal(d, dispatch[:, :, cut])
        part, t2 = TM._experts(cfg, S_g, x, p["router"], p["w_gate"][cut],
                               p["w_up"][cut], p["w_down"][cut], e0)
        for a, b, w in zip(t, t2, whole_terms):
            assert torch.equal(a, w) and torch.equal(b, w)
        y += part
    torch.testing.assert_close(y, whole, rtol=1e-5, atol=1e-6)


def test_plain_tensors_take_the_plain_path():
    """On plain tensors ``experts_local`` is one call of the block with
    every expert, and ``moe_block`` is that call."""
    cfg, p, x = _block_inputs(GRANITE)
    seen = []
    out = shard_ctx.experts_local(lambda *a: seen.extend(a) or 7, x,
                                  p["router"], (p["w_gate"], p["w_up"],
                                                p["w_down"]), group=64)
    assert out == 7 and seen[0] is x and seen[2] is p["w_gate"]
    assert seen[-1] == 0
    y, aux = TM.moe_block(cfg, p, x)
    want, terms = TM._experts(cfg, 64, x, p["router"], p["w_gate"],
                              p["w_up"], p["w_down"])
    assert torch.equal(y, want)
    assert torch.equal(aux["load_balance"],
                       cfg.num_experts * torch.mean(terms[0]))


def test_mesh_phases_run_small_for_the_moe(monkeypatch, capsys):
    """chip_smoke.py 3q's MoE lines on the CPU: granite-moe's dry run on a
    2×2 fake world at the reduced config, then its (1, 1)-mesh train step
    over a one-rank gloo group, bitwise the plain step."""
    from repro_torch.launch import forensics, mesh, shardings, steps
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    rt = dict(configs=configs, transformer=TT, dryrun=tdry,
              forensics=forensics, mesh=mesh, shardings=shardings,
              steps=steps, shard_ctx=shard_ctx, tree_map=tree_map,
              tree_leaves=tree_leaves, smi="cpu")
    rows = chip_smoke.mesh_dry_run_phase(torch, rt, reduced=True,
                                         arch=chip_smoke.MOE_ARCH,
                                         runs=chip_smoke.MOE_DRY_RUNS)
    assert [(r["arch"], r["shape"]) for r in rows] == [(GRANITE,
                                                        "train_4k")]
    assert not [r for r in rows[0]["replicated"] if "moe.py" in r]
    row = chip_smoke.mesh_step_phase(torch, rt, device="cpu", reduced=True,
                                     arch=chip_smoke.MOE_ARCH)
    assert chip_smoke.FAILED == []
    assert row["arch"] == GRANITE and row["bitwise"], row["max_rel_err"]
    assert not torch.distributed.is_initialized()
    lines = [json.loads(line) for line in capsys.readouterr().out
             .splitlines() if line.startswith("{")]
    assert [line["path"] for line in lines] == ["dry_run",
                                                "mesh_train_step"]
