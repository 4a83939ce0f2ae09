"""The token embedding under DTensor: the lookup runs on local shards in a
vocabulary-parallel layout the port chooses (``shard_ctx.embed_local``:
the table's rows over ``model``, as the reference's rule places them),
not in whatever DTensor's indexing strategy of the installed torch
picks.

Left to DTensor, this CPU's torch gathered the whole table over
``model`` for the forward lookup, and torch 2.11 refused the backward's
``index_put`` and ran it replicated over both mesh dims.  Here each
vocabulary shard looks up the ids of its own rows and zeroes the rest;
the partial sum is reduced into the residual stream's layout, and the
table's gradient is a local ``index_put`` into each shard's rows.

Also held: the lookup on plain tensors is the plain one, the shards'
parts add up to the whole lookup and its gradient, and the dry-run
counts of the combinations the card counted otherwise (and qwen3-0.6b's
train step) are pinned at this CPU's, which chip_smoke.py 3q holds the
card to.  The 2×2 gloo steps against the unsharded step are
``test_torch_sharded_step.py``'s."""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun as tdry
from repro_torch.models import shard_ctx
from repro_torch.models import transformer as TT

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_dispatch_sites import dtensor_ops, source_lines  # noqa: E402

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)


def _table(V=512, d=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(V, d, generator=gen)
    tokens = torch.randint(0, V, (3, 40), generator=gen, dtype=torch.int32)
    tokens[0, :4] = tokens[0, 4]        # repeated ids accumulate
    return table, tokens


def test_plain_lookup_is_the_plain_index():
    table, tokens = _table()
    w = table.clone().requires_grad_(True)
    got = shard_ctx.embed_local(w, tokens)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    (gw,) = torch.autograd.grad(got, w, g)
    w2 = table.clone().requires_grad_(True)
    want = w2[tokens.long()]
    (gw2,) = torch.autograd.grad(want, w2, g)
    assert torch.equal(got, want) and torch.equal(gw, gw2)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_vocabulary_shards_add_up_to_the_lookup(shards):
    """Each shard's part (``vocab_rows`` on its rows) is the lookup where
    its ids fall and zero elsewhere; the parts sum to the whole lookup,
    and each shard's gradient is the whole table gradient's rows."""
    table, tokens = _table()
    V = table.shape[0]
    Vl = V // shards
    g = torch.randn(tokens.shape + (table.shape[1],),
                    generator=torch.Generator().manual_seed(1))
    w = table.clone().requires_grad_(True)
    want = w[tokens.long()]
    (gw,) = torch.autograd.grad(want, w, g)
    total = torch.zeros_like(want)
    for j in range(shards):
        rows = table[j * Vl:(j + 1) * Vl].clone().requires_grad_(True)
        part = shard_ctx.vocab_rows(rows, tokens, j * Vl)
        mine = (tokens.long() // Vl == j)[..., None]
        assert torch.equal(part, torch.where(mine, want.detach(), 0.0))
        (gr,) = torch.autograd.grad(part, rows, g)
        assert torch.equal(gr, gw[j * Vl:(j + 1) * Vl])
        total = total + part
    assert torch.equal(total, want.detach())


def _lookup_lines() -> set:
    """The lines of ``transformer.py`` that look a token up in the table."""
    return source_lines(TT, 'params["embed"]')


def _dtensor_ops(shape: str, policy: str) -> list:
    return dtensor_ops("qwen3-0.6b", shape, policy)


@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp_tp+act+seq"])
def test_no_dtensor_op_runs_at_the_lookup(policy):
    """During the reduced qwen3-0.6b train step on a 2×2 fake world, no
    operation at the lookup's lines, or in its backward, is dispatched on
    a DTensor: the lookup and its gradient's ``index_put`` run on local
    shards under any torch."""
    lookup = _lookup_lines()
    assert lookup
    ops = _dtensor_ops("train_4k", policy)
    assert ops                          # the step does dispatch DTensors
    bad = [(op, site) for op, site in ops
           if any(site == s or site.endswith(" of " + s) for s in lookup)
           or "IndexBackward0" in site or "EmbeddingBackward0" in site]
    assert bad == []


def test_no_dtensor_op_runs_at_the_decode_lookup():
    lookup = _lookup_lines()
    ops = _dtensor_ops("decode_32k", "tp")
    assert [(op, site) for op, site in ops if site in lookup] == []


# the combinations whose FLOPs a device the card (torch 2.11.0+cu128)
# counted otherwise than this CPU in the parent tree, and qwen3-0.6b's
# train step, whose embedding the card ran replicated
PINNED = [("musicgen-medium", "train_4k"), ("qwen2-vl-2b", "train_4k"),
          ("qwen2-vl-2b", "prefill_32k"), ("qwen2-vl-2b", "decode_32k"),
          ("qwen2-vl-2b", "long_500k"), ("falcon-mamba-7b", "long_500k"),
          ("qwen3-0.6b", "train_4k")]


@pytest.mark.parametrize("arch,shape", PINNED,
                         ids=[f"{a}-{s}" for a, s in PINNED])
def test_counts_are_pinned_at_this_cpus(arch, shape):
    """chip_smoke.py 3q holds the card's count of each to this one."""
    res = tdry.dry_run(arch, shape, policy="fsdp_tp")
    want = chip_smoke.CPU_FLOPS[(arch, shape, "fsdp_tp")]
    assert res["flops_per_device"] == pytest.approx(want, rel=1e-9)
    assert [n for n in res["notes"]
            if "attention.py" in n["site"] or "Index" in n["site"]] == []


def test_layout_dry_runs_run_small(monkeypatch, capsys):
    """chip_smoke.py 3q's layout lines on the CPU: each combination of
    ``LAYOUT_DRY_RUNS`` at its reduced config on a 2×2 fake world, with
    nothing of attention, the MoE block or the lookup run replicated."""
    import json
    from repro_torch.launch import forensics, mesh, shardings, steps
    from repro_torch.optim.api import tree_leaves, tree_map
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    rt = dict(configs=configs, transformer=TT, dryrun=tdry,
              forensics=forensics, mesh=mesh, shardings=shardings,
              steps=steps, shard_ctx=shard_ctx, tree_map=tree_map,
              tree_leaves=tree_leaves, smi="cpu")
    lookup = chip_smoke._lookup_sites(TT)
    assert len(lookup) >= 2             # the train and decode lookups
    for arch, shape, policy in chip_smoke.LAYOUT_DRY_RUNS:
        rows = chip_smoke.mesh_dry_run_phase(torch, rt, reduced=True,
                                             arch=arch,
                                             runs=((shape, policy),))
        assert [(r["arch"], r["shape"]) for r in rows] == [(arch, shape)]
        assert not [r for r in rows[0]["replicated"]
                    if chip_smoke._own_layout(r, lookup)]
        assert (arch, shape, policy) in chip_smoke.CPU_FLOPS
    assert chip_smoke.FAILED == []
    lines = [json.loads(line) for line in capsys.readouterr().out
             .splitlines() if line.startswith("{")]
    assert [line["path"] for line in lines] == \
        ["dry_run"] * len(chip_smoke.LAYOUT_DRY_RUNS)
