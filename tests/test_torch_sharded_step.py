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

CASES = [("qwen3_0p6b", "fsdp_tp"), ("qwen3_0p6b", "tp"),
         ("granite_moe_1b_a400m", "fsdp_tp"),
         ("qwen3_0p6b", "fsdp_tp+act+attnb+seq")]
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
    procs = [ctx.Process(target=R.main, args=(r, 4, init, CASES, str(out)))
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


@pytest.mark.parametrize("case", CASES, ids=["+".join(c) for c in CASES])
def test_sharded_step_equals_unsharded(ranks, case):
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
    # the loss's gold-logit gather always runs with its vocabulary dim
    # replicated; which other ops DTensor refuses depends on the torch
    # version (2.11 adds the embedding's backward index_put), but never
    # one of attention's: its heads' layout is the port's
    notes = ranks[0][("qwen3_0p6b", "fsdp_tp")]["notes"]
    gather = [n for n in notes if n["op"] == "aten.gather.default"]
    assert [n["site"] for n in gather] == \
        ["repro_torch/models/transformer.py:321"]
    for n in notes:
        assert n["layout"] == "Replicate" and n["reason"], n
        assert n["site"].startswith(("repro_torch/models/", "backward:")), n
        assert "attention.py" not in n["site"], n


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
