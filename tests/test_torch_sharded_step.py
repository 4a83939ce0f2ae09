"""Real sharding, numerically: four gloo ranks on the CPU (a ``file://``
rendezvous under ``tmp_path``) run the port's train step on a 2×2
("data", "model") mesh with DTensor parameters, and each result is held
to the port's unsharded step on the same parameters and batch:

  * loss and gradient norm to 1e-5 relative, from the zero optimizer
    state and from a warm one;
  * every updated leaf to 1e-5 relative (``torch.allclose``'s default
    1e-8 absolute floor) from the warm state — m = 0, v = 1e-5, t = 10.
    AdamW's first step from the zero state is lr·g/(|g| + eps), a sign
    for all but the tiniest gradients, so a gradient of ~1e-8 that the
    sharded sums round differently moves its weight by up to lr; from a
    warm v the update is linear in the gradient and the comparison
    holds the gradients themselves.

Also: each rank's local shards of a tensor of distinct values under four
specs are JAX's row-major blocks (an axis tuple splits in mesh order)."""
import multiprocessing as mp
import os
import pathlib
import sys

import pytest
import torch

pytestmark = pytest.mark.tier1

# (arch, policy) or (arch, policy, name, config overrides); the reduced
# moe configs have 4 experts (top-2, or top-1 with a shared expert) in
# groups of 64 tokens: 2 experts a model shard, a row of 64 tokens whole
# groups
CASES = [("qwen3_0p6b", "fsdp_tp"), ("qwen3_0p6b", "tp"),
         ("granite_moe_1b_a400m", "fsdp_tp"),
         ("qwen3_0p6b", "fsdp_tp+act+attnb+seq"),
         ("granite_moe_1b_a400m", "fsdp_tp+act"),
         ("llama4_scout_17b_a16e", "fsdp_tp"),
         # capacity 16 slots an expert against 32 sent on average
         ("granite_moe_1b_a400m", "fsdp_tp", "drops",
          {"capacity_factor": 0.5}),
         # 3 experts do not divide the model axis: replicated there, so
         # each of the 4 ranks takes a row of the batch
         ("granite_moe_1b_a400m", "fsdp_tp", "experts_3",
          {"num_experts": 3}),
         # ... and with 2 rows, a row a data shard, the experts whole on
         # both model shards
         ("granite_moe_1b_a400m", "fsdp_tp+act", "experts_3_batch_2",
          {"num_experts": 3, "batch": 2}),
         # one group of all 256 tokens would straddle the data shards:
         # the batch replicated, the experts split
         ("granite_moe_1b_a400m", "fsdp_tp+act", "one_group",
          {"moe_group_size": 256}),
         ("granite_moe_1b_a400m", "fsdp_tp+act+seq"),
         # the embedding's vocabulary-parallel lookup reduced into the
         # stream: a batch shard over ``model`` (a batch of 4), the +act
         # pin (replicated there), the whole table under ZeRO-3, and a
         # sequence shard (a batch of 2: a row a data shard)
         ("qwen3_0p6b", "fsdp_tp+act"), ("qwen3_0p6b", "fsdp"),
         ("qwen3_0p6b", "fsdp_tp", "batch_2", {"batch": 2}),
         # the recurrent blocks' channels over ``model``
         # (shard_ctx.channels_local); the hybrid's stream replicated there
         ("falcon_mamba_7b", "fsdp_tp"), ("recurrentgemma_9b", "fsdp_tp"),
         # ... and pinned there by ``+act``
         ("recurrentgemma_9b", "fsdp_tp+act"),
         # the loss's vocabulary over ``model`` (shard_ctx.loss_local):
         # under ``tp`` with a row a data shard, the stream takes a
         # sequence shard over ``model``, gathered for the LM head
         ("qwen3_0p6b", "tp", "batch_2", {"batch": 2})]
MOE = [c for c in CASES if "moe" in c[0] or "scout" in c[0]]
# the serving layout's prefill, then a decode step from its cache: the
# recurrent blocks' channels over ``model``, a batch shard over ``data``;
# with a batch of one, the channels over both
PREFILL = [("recurrentgemma_9b", "tp", "prefill_decode", {"prefill": True}),
           ("recurrentgemma_9b", "tp", "prefill_decode_batch_1",
            {"prefill": True, "batch": 1}),
           ("falcon_mamba_7b", "tp", "prefill_decode_batch_1",
            {"prefill": True, "batch": 1})]
RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    here = pathlib.Path(__file__).parent
    sys.path.insert(0, str(here))
    import _torch_sharded_rank as R
    out = tmp_path_factory.mktemp("gloo")
    init = f"file://{out / 'rendezvous'}"
    ctx = mp.get_context("spawn")
    env = os.environ.get("PYTHONPATH", "")
    src = str(here.parent / "src")
    if src not in env.split(os.pathsep):
        os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (src, env) if p)
    procs = [ctx.Process(target=R.main,
                         args=(r, 4, init, CASES + PREFILL, str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a gloo rank hung"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}.")
        else:
            yield pre + k, v


def _id(case):
    return "+".join(case[:3])


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_sharded_step_equals_unsharded(ranks, case):
    case = case[:3]
    got, ref = ranks[0][case], ranks[0][case]["ref"]
    for state in ("zero", "warm"):
        for k in ("loss", "grad_norm"):
            assert got[state][k] == pytest.approx(ref[state][k], rel=RTOL), \
                (state, k)
    want = dict(_leaves(ref["params"]))
    n = 0
    for name, leaf in _leaves(got["params"]):
        assert leaf.shape == want[name].shape, name
        assert torch.allclose(leaf, want[name], rtol=RTOL), \
            (name, (leaf - want[name]).abs().max().item())
        n += 1
    assert n == len(want)
    # every rank holds the same whole values
    for r in ranks[1:]:
        for (name, a), (_, b) in zip(_leaves(got["params"]),
                                     _leaves(r[case]["params"])):
            assert torch.equal(a, b), name


def test_updated_leaves_keep_their_placements(ranks):
    placements = dict(_leaves(ranks[0][("qwen3_0p6b", "fsdp_tp")]
                              ["placements"]))
    # (d, Vp) lm_head: fsdp over data on d, tensor-parallel on Vp
    assert placements["lm_head"] == "(Shard(dim=0), Shard(dim=1))"
    assert placements["final_norm"] == "(Replicate(), Replicate())"
    # the loss's gold logit is picked on each vocabulary shard
    # (shard_ctx.loss_local), so nothing runs replicated at the loss's
    # lines, and nothing anywhere in the step
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
    import chip_smoke
    from repro_torch.models import transformer as T
    notes = ranks[0][("qwen3_0p6b", "fsdp_tp")]["notes"]
    assert [n for n in notes if n["op"] == "aten.gather.default"
            or n["site"] in chip_smoke._loss_sites(T)] == []
    assert notes == []


@pytest.mark.parametrize("case", MOE, ids=[_id(c) for c in MOE])
def test_moe_steps_run_no_op_replicated(ranks, case):
    """The MoE block's layout is the port's (``shard_ctx.experts_local``):
    no operation of ``moe.py`` runs replicated by the fallback."""
    notes = ranks[0][case[:3]]["notes"]
    assert [n for n in notes if "moe.py" in n["site"]] == []


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_no_step_runs_the_lookup_replicated(ranks, case):
    """The embedding's lookup and its gradient run on local shards
    (``shard_ctx.embed_local``): no note at the lookup or in its
    backward."""
    notes = ranks[0][case[:3]]["notes"]
    assert [n for n in notes if "Index" in n["site"]
            or "Embedding" in n["site"] or "index" in n["op"]] == []


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_no_step_runs_anything_replicated(ranks, case):
    """Every model operation of every case's step takes a layout of the
    port's own (the loss's vocabulary and the Griffin block's channels
    last): the fallback records nothing."""
    assert ranks[0][case[:3]]["notes"] == []


@pytest.mark.parametrize("case", PREFILL, ids=[_id(c) for c in PREFILL])
def test_sharded_prefill_and_decode_equal_unsharded(ranks, case):
    """The hybrid's prefill (last-token logits, every cache tensor), then
    a decode step from that cache (its logits and the updated cache), on
    the 2×2 mesh under the serving layout against the plain ones: each
    element to ``RTOL`` of its tensor's largest magnitude (the shards'
    partial sums add in another order); nothing runs replicated."""
    got = ranks[0][case[:3]]
    for step in ("prefill", "decode"):
        want = dict(_leaves(got["ref"][step]["cache"]),
                    logits=got["ref"][step]["logits"])
        leaves = dict(_leaves(got[step]["cache"]),
                      logits=got[step]["logits"])
        assert leaves.keys() == want.keys()
        for k, leaf in leaves.items():
            assert leaf.shape == want[k].shape, (step, k)
            scale = want[k].abs().max().item()
            assert (leaf - want[k]).abs().max().item() <= RTOL * scale, \
                (step, k)
    assert got["notes"] == []


def test_local_shards_are_jax_row_major_blocks(ranks):
    """Rank r sits at mesh coordinates (r // 2, r % 2) of ("data",
    "model"); JAX gives an axis tuple's blocks in row-major order of its
    axes, so ("data", "model") on dim 0 gives rank r rows 2r..2r+1."""
    x = torch.arange(8 * 4).reshape(8, 4)
    for r, res in enumerate(ranks):
        i, j = divmod(r, 2)
        want = [x[2 * r:2 * r + 2], x[4 * i:4 * i + 4, 2 * j:2 * j + 2],
                x[:, r:r + 1], x[4 * j:4 * j + 4, 2 * i:2 * i + 2]]
        for got, w in zip(res["layout"], want):
            assert torch.equal(got, w), r
