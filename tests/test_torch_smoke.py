"""Pieces of ``chip_smoke.py`` that run on the CPU: its step breakdown
times each kernel's plain-version VJP inside the train step's backward,
by hooks on the kernel's autograd nodes, which it finds by name with
``graph_nodes``.  Here, on the reduced LMs, the loss's graph must hold
one such node per layer of the kernel's type, under the names the
breakdown looks for."""
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.api as P
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.tier1

torch.set_num_threads(1)


@pytest.mark.parametrize("arch, node, layer_type", [
    ("falcon-mamba-7b", "_SSMScanBackward", "ssm"),
    ("recurrentgemma-9b", "_RGLRUScanBackward", "rec"),
    ("recurrentgemma-9b", "_FlashAttentionBackward", "attn"),
])
def test_breakdown_finds_one_kernel_node_per_layer(arch, node, layer_type):
    spec = chip_smoke.lm_spec(P, arch=arch, reduced=True,
                              policy="fixed_steps", corpus=16, seq_len=16,
                              n0=8)
    sess = P.build(spec, device="cpu")
    cfg = sess.model_config
    rows = sess.dataset.window(2)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    params = tree_map(lambda x: x.detach().requires_grad_(True), sess.w0)
    with torch.enable_grad():
        loss = TT.loss_fn(cfg, params, batch, impl="pallas")[0]
        names = [n.name() for n in chip_smoke.graph_nodes(loss)]
    want = list(cfg.layer_types()).count(layer_type)
    assert want >= 1
    assert names.count(node) == want
