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
    assert [n["site"] for n in res["notes"]
            if n["op"] == "aten.gather.default"] == \
        ["repro_torch/models/transformer.py:321"]


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
    for model in sorted({c[1] for c in GLOO_CASES}):
        d = tmp_path_factory.mktemp(f"heads{model}")
        cases = [(n, a, p, o) for n, m, a, p, o in GLOO_CASES if m == model]
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
