"""The port's dry run (``launch/dryrun.py``) on the CPU, on a 2×2 fake
world (``launch/mesh.fake_world``) at reduced configs: the train step of
the transformer, moe and vlm families under ``fsdp_tp``, held to the
reference's result keys and to the per-device argument bytes its own
specs give, with the weight all-gathers and gradient reduce-scatters of
ZeRO-3; and the per-device FLOPs of a sharded and of a replicated product
against hand arithmetic.  The recurrent families and the decode steps are
in ``test_torch_dryrun_serve.py``, the 16×16 world in
``test_torch_dryrun_pod.py``."""
import pytest
import torch

from _torch_dryrun_common import check_reduced
from repro_torch.launch import hlo as thlo
from repro_torch.launch import mesh as tmesh

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "granite_moe_1b_a400m",
                                  "qwen2_vl_2b"])
def test_train_step_dry_run_on_2x2(arch):
    res = check_reduced(arch, "train_4k", "fsdp_tp")
    coll = res["collectives"]
    assert coll["all-gather"]["count"] > 0          # the FSDP weight gathers
    assert coll["reduce-scatter"]["count"] > 0      # the gradients back
    assert res["loops"][-1]["trip"] == 2            # the reduced depth
    assert res["cost_analysis_raw"]["flops"] < res["flops_per_device"]


def _product(placements_x, placements_w):
    from torch.distributed.tensor import distribute_tensor
    M, K, N = 64, 32, 48
    mesh = tmesh.make_host_mesh(model=2)
    x = distribute_tensor(torch.empty(M, K, device="meta"), mesh,
                          placements_x, src_data_rank=None)
    w = distribute_tensor(torch.empty(K, N, device="meta"), mesh,
                          placements_w, src_data_rank=None)
    counts, out = thlo.analyze(lambda a, b: a @ b, x, w, device="meta")
    return counts, out, (M, K, N)


def test_sharded_product_flops_are_per_device():
    """x split over data by rows, w over model by columns: one device
    multiplies an (M/2, K) block by a (K, N/2) block, and nothing
    moves."""
    from torch.distributed.tensor import Replicate, Shard
    with tmesh.fake_world(4):
        counts, out, (M, K, N) = _product([Shard(0), Replicate()],
                                          [Replicate(), Shard(1)])
        assert counts["flops"] == 2 * (M // 2) * K * (N // 2)
        assert counts["sites"] == {}
        assert tuple(out.placements) == (Shard(0), Shard(1))


def test_replicated_product_flops_are_whole():
    from torch.distributed.tensor import Replicate
    with tmesh.fake_world(4):
        counts, _, (M, K, N) = _product([Replicate(), Replicate()],
                                        [Replicate(), Replicate()])
        assert counts["flops"] == 2 * M * K * N
        assert counts["sites"] == {}


def test_contraction_over_a_sharded_dim_all_reduces():
    """K split over model on both sides: each device multiplies
    (M, K/2) by (K/2, N), and the partial sums all-reduce when the
    result is asked for whole."""
    from torch.distributed.tensor import Replicate, Shard

    def fn(a, b):
        return (a @ b).redistribute(a.device_mesh, [Replicate()] * 2)

    with tmesh.fake_world(4):
        mesh = tmesh.make_host_mesh(model=2)
        from torch.distributed.tensor import distribute_tensor
        M, K, N = 64, 32, 48
        x = distribute_tensor(torch.empty(M, K, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        w = distribute_tensor(torch.empty(K, N, device="meta"), mesh,
                              [Replicate(), Shard(0)], src_data_rank=None)
        counts, _ = thlo.analyze(fn, x, w, device="meta")
    assert counts["flops"] == 2 * M * (K // 2) * N
    [(kind, out_bytes, n, _)] = list(counts["sites"])
    assert (kind, out_bytes, n) == ("all-reduce", M * N * 4, 2)
