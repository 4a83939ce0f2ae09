"""The chunked cross-entropy under DTensor: vocabulary-parallel, in a
layout the port chooses (``shard_ctx.loss_local``: the LM head's columns
over ``model``, as the reference's ``"logits"`` rule keeps them), not in
whatever DTensor's strategies of the installed torch pick.

Left to DTensor, this CPU's torch all-reduced the whole (B, 512, Vp)
float32 chunk for the logsumexp and for the gold logit's gather (which it
ran replicated over ``model``), 85.6 % of internlm2-1.8b's ``train_4k``
wire bytes on the 16×16 mesh.  Here each vocabulary shard takes the
logsumexp of its own columns and the gold logits of the labels it holds;
only those (B, c, n_shards) parts cross the wire.

Held here: the plain loss is the plain three lines, bit for bit; the
shards' parts combine to the whole loss, and a single part exactly; no
DTensor operation at the loss's lines or in their backward; on a (1, 1)
gloo mesh the DTensor loss is bitwise the plain one; the logits never
cross the wire at full width, and the four ``train_4k`` bounds the loss
moved are pinned at this CPU's (``chip_smoke.CPU_BOUND``, which 3q holds
the card to)."""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun as tdry
from repro_torch.models import shard_ctx
from repro_torch.models import transformer as TT

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_dispatch_sites import dtensor_ops  # noqa: E402

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)


def _chunk(B=3, c=40, d=24, V=512, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    hc = torch.randn(B, c, d, generator=gen).to(dtype)
    w = (torch.randn(d, V, generator=gen) / d ** 0.5).to(dtype)
    y = torch.randint(0, V, (B, c), generator=gen, dtype=torch.int32)
    y[0, :4] = V - 1                    # the last column, repeated
    return hc, w, y


def _three_lines(hc, w, y):
    """The loss chunk as it was before its DTensor layout."""
    logits = (hc @ w).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def _value_and_grads(fn, hc, w, y):
    hc, w = (t.clone().requires_grad_(True) for t in (hc, w))
    out = fn(hc, w, y)
    return (out.detach(),) + torch.autograd.grad(out, (hc, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", [shard_ctx.loss_local, TT._chunk_loss],
                         ids=["loss_local", "_chunk_loss"])
def test_plain_loss_is_the_three_lines(fn, dtype):
    """Bitwise: the value and both gradients."""
    args = _chunk(dtype=dtype)
    got = _value_and_grads(fn, *args)
    want = _value_and_grads(_three_lines, *args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_vocabulary_shards_combine_to_the_loss(shards):
    """Each shard's logsumexp over its columns and its gold logits
    (``vocab_pick``: the labels it holds, zero elsewhere) combine to the
    whole chunk's: the gold logits exactly (one shard holds each label),
    log Z and its gradient to 1e-6 relative (float32)."""
    hc, w, y = _chunk()
    logits = (hc @ w).float().requires_grad_(True)
    Vl = logits.shape[-1] // shards
    lse = torch.stack([torch.logsumexp(logits[..., j * Vl:(j + 1) * Vl],
                                       dim=-1) for j in range(shards)], -1)
    gold = torch.stack([shard_ctx.vocab_pick(
        logits[..., j * Vl:(j + 1) * Vl], y, j * Vl)
        for j in range(shards)], -1)
    want_gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    assert torch.equal(gold.sum(-1), want_gold)
    assert torch.equal((gold != 0).sum(-1), torch.ones_like(y))
    logz = shard_ctx.logsumexp_parts(lse)
    want = torch.logsumexp(logits, dim=-1)
    torch.testing.assert_close(logz, want, rtol=1e-6, atol=0)
    g = torch.randn(logz.shape, generator=torch.Generator().manual_seed(1))
    (got,) = torch.autograd.grad(logz, logits, g)
    (ref,) = torch.autograd.grad(want, logits, g)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)


def test_one_shard_combine_is_exact():
    """A mesh dim of size 1 adds log(exp(0)) = 0.0 and passes the gradient
    times 1.0: bitwise the part itself."""
    lse = (torch.randn(3, 40, 1, generator=torch.Generator().manual_seed(0))
           * 30).requires_grad_(True)
    out = shard_ctx.logsumexp_parts(lse)
    assert torch.equal(out, lse[..., 0].detach())
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (grad,) = torch.autograd.grad(out, lse, g)
    assert torch.equal(grad, g[..., None])


@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp_tp+act", "tp"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_no_dtensor_op_runs_at_the_loss(arch, policy):
    """During the reduced train step on a 2×2 fake world, no operation at
    the loss's lines or in their backward is dispatched on a DTensor, and
    nothing of the step runs replicated."""
    loss = chip_smoke._loss_sites(TT)
    notes: list = []
    ops = dtensor_ops(arch, "train_4k", policy, notes=notes)
    assert ops                          # the step does dispatch DTensors
    bad = [(op, site) for op, site in ops
           if any(site == s or site.endswith(" of " + s) for s in loss)
           or "Logsumexp" in site or "GatherBackward" in site]
    assert bad == [] and notes == []


def test_one_rank_mesh_loss_is_bitwise_plain(tmp_path):
    """On a (1, 1) mesh of a one-rank gloo group, with and without the
    ``+act`` pins, the DTensor loss and its gradients are the plain
    loss's bit for bit (3q's (1, 1)-mesh steps rest on it)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import make_activation_sharder
    hc, w, y = _chunk(dtype=torch.bfloat16)
    want = _value_and_grads(_three_lines, hc, w, y)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1)
        for sharder in (None, make_activation_sharder(mesh, {"act"})):
            shard_ctx.set_sharder(sharder)
            try:
                dh = distribute_tensor(hc, mesh, (Shard(0), Replicate()))
                dw = distribute_tensor(w, mesh, (Replicate(), Shard(1)))
                dy = distribute_tensor(y, mesh, (Shard(0), Replicate()))
                dh.requires_grad_(True)
                dw.requires_grad_(True)
                out = shard_ctx.loss_local(dh, dw, dy)
                grads = torch.autograd.grad(out, (dh, dw))
            finally:
                shard_ctx.set_sharder(None)
            got = [t.full_tensor() for t in (out.detach(),) + grads]
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# the train_4k runs whose bound the loss's layout moved (the card's and
# this CPU's differed there by 2-9 % before)
LOSS_RUNS = ["granite-moe-1b-a400m", "internlm2-1.8b", "stablelm-12b",
             "yi-9b"]


@pytest.fixture(scope="module")
def train_runs():
    return {arch: tdry.dry_run(arch, "train_4k", policy="fsdp_tp")
            for arch in LOSS_RUNS}


@pytest.mark.parametrize("arch", LOSS_RUNS)
def test_bounds_are_pinned_at_this_cpus(train_runs, arch):
    """chip_smoke.py 3q holds the card's bound and count to these."""
    res = train_runs[arch]
    key = (arch, "train_4k", "fsdp_tp")
    assert max(res["roofline"].values()) == pytest.approx(
        chip_smoke.CPU_BOUND[key], rel=1e-9)
    assert res["flops_per_device"] == pytest.approx(
        chip_smoke.CPU_FLOPS[key], rel=1e-9)
    assert res["notes"] == []


@pytest.mark.parametrize("arch", LOSS_RUNS)
def test_the_logits_never_cross_the_wire(train_runs, arch):
    """At full width on the 16×16 mesh no collective at the loss's lines
    moves more than a data shard's hidden states of a chunk (the LM
    head's input, gathered over ``model``): never a chunk of the float32
    logits, 16 rows × 512 × Vp."""
    from repro_torch import configs
    cfg = configs.get(arch)
    loss = chip_smoke._loss_sites(TT)
    rows = 256 // 16
    hidden = rows * 512 * cfg.d_model * 2
    sites = [s for s in train_runs[arch]["sites"]
             if any(s[3] == x or s[3].endswith(" of " + x) for x in loss)]
    assert sites                        # the hidden states' gather
    assert max(s[1] for s in sites) <= hidden
    assert hidden < rows * 512 * TT.vocab_padded(cfg) * 4 / 10
