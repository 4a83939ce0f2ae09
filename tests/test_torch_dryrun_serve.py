"""The port's dry run on a 2×2 fake world at reduced configs, continued
(``test_torch_dryrun.py`` has the transformer, moe and vlm train steps):
the recurrent families' train steps, whose Python loops over the
sequence are traced at two short lengths and extrapolated, and the
decode step of all five families under ``tp``, each held to the
reference's keys and per-device argument bytes."""
import pytest
import torch

from _torch_dryrun_common import check_reduced

pytestmark = pytest.mark.tier1
torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_9b"])
def test_recurrent_train_step_dry_run_on_2x2(arch):
    res = check_reduced(arch, "train_4k", "fsdp_tp")
    coll = res["collectives"]
    assert coll["all-gather"]["count"] > 0
    assert coll["reduce-scatter"]["count"] > 0
    steps = [l for l in res["loops"] if l["body"].startswith("time step")]
    assert steps and all(l["trip"] == 4096 for l in steps)
    assert steps[0]["traced"] == [16, 32]


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "granite_moe_1b_a400m",
                                  "falcon_mamba_7b", "recurrentgemma_9b",
                                  "qwen2_vl_2b"])
def test_decode_step_dry_run_on_2x2(arch):
    """Megatron's row-parallel products leave partial sums over the model
    axis: DTensor reduces them with an all-reduce, or with a
    reduce-scatter whose all-gather comes at the next column-parallel
    product (the all-reduce taken in two halves)."""
    res = check_reduced(arch, "decode_32k", "tp")
    coll = res["collectives"]
    assert "all-reduce" in coll or {"reduce-scatter", "all-gather"} <= \
        set(coll), coll
    assert res["kind"] == "decode" and res["loops"]
