"""The attention heads under DTensor: the split of the projections into
heads, q's regrouping into (KV, H/KV), the merges, and the attention
between them run sharded in a layout the port chooses
(``models/shard_ctx.py``), not in whatever DTensor's view strategy of
the installed torch accepts.

This CPU's torch refuses, as torch 2.11 does, a view that splits a
sharded dim into factors its mesh dim does not divide ("Cannot unflatten
unevenly sharded tensor").  It reaches such a view wherever the
projection comes out sharded on its last dim: under ``fsdp_tp+act``,
whose residual stream is replicated over ``model`` as torch 2.11 lays
out plain ``fsdp_tp``, and in the decode step.  There, on qwen3-0.6b's
16-way model axis (8 KV heads of 128 columns, so half a head a shard),
the views ran replicated (``shardings.replicate_fallback``, a note at
each ``attention.py`` line) and every model shard computed all heads.

Also held: the layer's block ends (``reduced_grad``, ``residual``)
keep the count the same under either policy, and sharded GQA and MQA
steps on gloo meshes equal the unsharded step, head counts that do not
divide the model axis (a batch shard, or a block of the queries, a
shard) included."""
import multiprocessing as mp
import os
import pathlib
import sys

import pytest
import torch

from repro_torch.launch import dryrun as tdry
from repro_torch.models import shard_ctx

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from _torch_dispatch_sites import dtensor_ops, source_lines  # noqa: E402

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)

RTOL = 1e-5


def _attention_sites(notes) -> list:
    return [n for n in notes if "attention.py" in n["site"]]


@pytest.fixture(scope="module")
def train_runs():
    return {policy: tdry.dry_run("qwen3-0.6b", "train_4k", policy=policy)
            for policy in ("fsdp_tp", "fsdp_tp+act")}


@pytest.mark.parametrize("policy", ["fsdp_tp", "fsdp_tp+act"])
def test_train_step_on_16x16_keeps_the_heads_sharded(train_runs, policy):
    res = train_runs[policy]
    assert _attention_sites(res["notes"]) == []
    share = res["model_flops_per_device"]
    assert share < res["flops_per_device"] < 3 * share
    # the loss's gold logit is picked on each vocabulary shard
    # (shard_ctx.loss_local): nothing of the step runs replicated
    assert [n["site"] for n in res["notes"]
            if n["op"] == "aten.gather.default"] == []
    assert res["notes"] == []


def test_the_count_does_not_depend_on_the_residual_streams_layout(
        train_runs):
    """``+act`` pins the residual stream replicated over ``model``;
    ``fsdp_tp`` leaves it to DTensor.  Every product of the step is split
    over all 256 devices either way."""
    a, b = train_runs["fsdp_tp"], train_runs["fsdp_tp+act"]
    assert b["flops_per_device"] == pytest.approx(a["flops_per_device"],
                                                  rel=1e-9)


def test_decode_step_on_16x16_runs_no_view_replicated():
    res = tdry.dry_run("qwen3-0.6b", "decode_32k", policy="tp")
    assert res["notes"] == []
    assert "all-reduce" in res["collectives"]
    share = res["model_flops_per_device"]
    assert share < res["flops_per_device"]


# (name, model-axis size, arch, policy, config overrides): H / KV / the
# model axis take each of heads_local's layouts
GLOO_CASES = [
    # 1 q head a shard of 4, KV 2: k and v replicated, a head each read
    ("gqa_2_of_4", 4, "qwen3_0p6b", "fsdp_tp+act", {"num_kv_heads": 2}),
    # multi-query: the one KV head replicated
    ("mqa_1_of_4", 4, "qwen3_0p6b", "fsdp_tp", {"num_kv_heads": 1}),
    # 2 q heads a shard of 8, one KV head between them
    ("gqa_8x2_tp", 4, "qwen3_0p6b", "tp",
     {"num_heads": 8, "num_kv_heads": 2}),
    # 2 q heads and 1 KV head a shard: k and v sharded as q
    ("gqa_2x2_mesh", 2, "qwen3_0p6b", "fsdp_tp+act", {"num_kv_heads": 2}),
    # 6 heads do not divide over 4, the batch of 4 does: a row a shard
    ("batch_6_on_4", 4, "qwen3_0p6b", "fsdp_tp+act",
     {"num_heads": 6, "num_kv_heads": 2}),
    # neither divides (a batch of 2): a block of 16 queries a shard
    ("rows_6_on_4", 4, "qwen3_0p6b", "fsdp_tp+act",
     {"num_heads": 6, "num_kv_heads": 2, "batch": 2}),
    # the same from a sequence-parallel residual stream
    ("rows_6_on_4_seq", 4, "qwen3_0p6b", "fsdp_tp+act+seq",
     {"num_heads": 6, "num_kv_heads": 2, "batch": 2}),
]


# prefill under the serving layout, the heads dividing neither the model
# axis nor (with the batch) the mesh: the residual stream is split over
# the sequence, each shard attends a block of the queries, and the
# output projection runs on those rows (``shard_ctx.project``)
PREFILL_CASES = [
    ("prefill_rows_6_on_4", 4, "qwen3_0p6b", "tp",
     {"num_heads": 6, "num_kv_heads": 2, "batch": 2, "prefill": True}),
    ("prefill_rows_3_on_2", 2, "qwen3_0p6b", "tp",
     {"num_heads": 3, "num_kv_heads": 1, "batch": 2, "prefill": True}),
    # the heads divide: a shard of heads, the stream a batch shard
    ("prefill_heads_4_on_2", 2, "qwen3_0p6b", "tp",
     {"num_heads": 4, "num_kv_heads": 2, "prefill": True}),
    # the hybrid keeps its stream replicated over ``model`` (its scans
    # split the LRU width there); its local attention takes query blocks
    ("prefill_hybrid_rows", 4, "recurrentgemma_9b", "tp",
     {"batch": 2, "prefill": True}),
]


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    here = pathlib.Path(__file__).parent
    sys.path.insert(0, str(here))
    import _torch_sharded_rank as R
    env = os.environ.get("PYTHONPATH", "")
    src = str(here.parent / "src")
    if src not in env.split(os.pathsep):
        os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (src, env) if p)
    ctx = mp.get_context("spawn")
    out = {}
    for model in sorted({c[1] for c in GLOO_CASES + PREFILL_CASES}):
        d = tmp_path_factory.mktemp(f"heads{model}")
        cases = [(n, a, p, o) for n, m, a, p, o in GLOO_CASES + PREFILL_CASES
                 if m == model]
        procs = [ctx.Process(target=R.main_heads,
                             args=(r, 4, f"file://{d / 'rendezvous'}",
                                   model, cases, str(d)))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive, "a gloo rank hung"
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        out.update(torch.load(d / "rank0.pt", weights_only=False))
    return out


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}.")
        else:
            yield pre + k, v


@pytest.mark.parametrize("name", [c[0] for c in GLOO_CASES])
def test_sharded_gqa_step_equals_unsharded(gloo_runs, name):
    got = gloo_runs[name]
    ref = got["ref"]
    for state in ("zero", "warm"):
        for k in ("loss", "grad_norm"):
            assert got[state][k] == pytest.approx(ref[state][k], rel=RTOL), \
                (state, k)
    want = dict(_leaves(ref["params"]))
    leaves = dict(_leaves(got["params"]))
    assert leaves.keys() == want.keys()
    for k, leaf in leaves.items():
        assert torch.allclose(leaf, want[k], rtol=RTOL), \
            (k, (leaf - want[k]).abs().max().item())
    assert _attention_sites(got["notes"]) == []


@pytest.mark.parametrize("name", [c[0] for c in PREFILL_CASES])
def test_sharded_prefill_equals_unsharded(gloo_runs, name):
    """The last token's logits and every cache tensor of the sharded
    prefill equal the plain prefill's, each element to 1e-5 of the
    tensor's largest magnitude (the shards' partial sums add in another
    order); nothing of attention runs replicated."""
    got = gloo_runs[name]
    want = dict(_leaves(got["ref"]["cache"]), logits=got["ref"]["logits"])
    leaves = dict(_leaves(got["cache"]), logits=got["logits"])
    assert leaves.keys() == want.keys()
    for k, leaf in leaves.items():
        scale = want[k].abs().max().item()
        assert leaf.shape == want[k].shape, k
        assert (leaf - want[k]).abs().max().item() <= RTOL * scale, k
    assert _attention_sites(got["notes"]) == []


def test_no_dtensor_op_runs_at_the_query_block_merge():
    """A reduced prefill on a 2×2 fake world whose 3 heads divide neither
    the model axis nor, with a batch of 2, the mesh: attention's output is
    split over the sequence.  DTensor's own matmul flattened it with a
    view, which torch 2.11 refuses there ("Attempted to flatten multiple
    dimensions, with dimension 1 being sharded"; it ran replicated over
    ``model``); the merge and the output projection now dispatch nothing
    on a DTensor, under any torch."""
    from repro_torch.models import attention as TA
    merge = source_lines(TA, 'p["wo"]') | source_lines(TA, "cfg.q_dim))")
    ops = dtensor_ops("qwen3-0.6b", "prefill_32k", "tp", num_heads=3,
                      num_kv_heads=1)
    assert ops
    assert [(op, site) for op, site in ops if site in merge] == []


@pytest.mark.parametrize("src,dst,groups", [
    ((2, 3, 16, 128), (2, 3, 2048), [([0], [0]), ([1], [1]),
                                     ([2, 3], [2])]),
    ((2, 3, 1024), (2, 3, 8, 128), [([0], [0]), ([1], [1]),
                                    ([2], [2, 3])]),
    ((2, 1, 16, 64), (2, 1, 8, 2, 64), [([0], [0]), ([1], [1]),
                                        ([2], [2, 3]), ([3], [4])]),
    ((4, 1), (4,), [([0], [0]), ([1], [])]),
])
def test_reshape_groups(src, dst, groups):
    assert shard_ctx._groups(src, dst) == groups


def test_plain_tensors_take_the_plain_ops():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 12, generator=gen)
    assert torch.equal(shard_ctx.split_heads(x, 3, 4), x.reshape(2, 5, 3, 4))
    assert torch.equal(shard_ctx.reshape(x, (2, 5, 2, 6)),
                       x.reshape(2, 5, 2, 6))
    assert shard_ctx.reduced_grad(x) is x
    y = torch.randn(2, 5, 12, generator=gen)
    assert torch.equal(shard_ctx.residual(x, y), x + y)
    seen = []
    assert shard_ctx.heads_local(lambda *a: seen.extend(a) or 7,
                                 x, y, y) == 7
    assert seen[0] is x and seen[1] is y
