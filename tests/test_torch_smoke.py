"""Pieces of ``chip_smoke.py`` that run on the CPU: its step breakdown
times each kernel's plain-version VJP inside the train step's backward,
by hooks on the kernel's autograd nodes, which it finds by name with
``graph_nodes``, and times the rematerialization apart from them.  Here,
on the reduced LMs, the loss's graph must hold one such node per layer of
the kernel's type, under the names the breakdown looks for, with remat
on; and each convex run of its method phase must call the kernel wrapper
as often as its trace implies."""
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.api as P
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.optim.api import tree_leaves, tree_map

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


def test_kernel_compare_diff_counts_elements_and_ulps(tmp_path, capsys):
    """``kernel_compare.py diff``, which PERF.md's old-against-new kernel
    counts come from: a bfloat16 output with one element one ulp up, one
    element many ulps off near 0 and one sign flipped."""
    import json

    from repro_torch.launch import kernel_compare
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    x = torch.tensor([1.0, 2.0, 1e-6, 3.0, 4.0], dtype=torch.bfloat16)
    y = x.clone()
    y.view(torch.int16)[1] += 1                  # 2.0 -> next bfloat16
    y[2] = 3e-6
    y[3] = -3.0
    torch.save(x, a / "rglru_path_bfloat16.pt")
    torch.save(y, b / "rglru_path_bfloat16.pt")
    torch.save(torch.ones(3), a / "lvg_logistic.pt")
    torch.save(torch.ones(3), b / "lvg_logistic.pt")
    kernel_compare.diff(a, b)
    rows = {r["output"]: r for r in map(json.loads,
                                         capsys.readouterr().out.splitlines())}
    assert rows["lvg_logistic"]["differ"] == 0
    r = rows["rglru_path_bfloat16"]
    assert (r["differ"], r["one_ulp"], r["over_one_ulp"],
            r["sign_differs"]) == (3, 1, 1, 1)
    assert r["over_one_ulp_max_abs_value"] < 1e-5


@pytest.mark.parametrize("arch, parts", [
    ("falcon-mamba-7b", {"scan": ("_SSMScanBackward", "ssm")}),
    ("recurrentgemma-9b", {"rglru": ("_RGLRUScanBackward", "rec"),
                           "attention": ("_FlashAttentionBackward",
                                         "attn")}),
])
def test_breakdown_times_the_recomputation_apart_from_the_vjps(arch, parts):
    """With remat on (the train step's default) the breakdown's hooks
    still find every kernel node, each rematerialized region's
    recomputation runs once inside the backward (a layer of the mamba, the
    hybrid's super-block, and each loss chunk), and the VJP times leave
    the recomputation out."""
    spec = chip_smoke.lm_spec(P, arch=arch, reduced=True,
                              policy="fixed_steps", corpus=16, seq_len=64,
                              n0=8)
    sess = P.build(spec, device="cpu")
    cfg = sess.model_config
    rows = sess.dataset.window(2)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    params = tree_map(lambda x: x.detach().requires_grad_(True), sess.w0)
    seg, sync = {}, lambda: None
    context_fn, recompute = chip_smoke.recompute_timer(sync)
    saved = TT.REMAT_CONTEXT
    TT.REMAT_CONTEXT = context_fn
    try:
        with torch.enable_grad():
            loss = TT.loss_fn(cfg, params, batch, impl="pallas")[0]
            handles = chip_smoke.hook_vjps(
                loss, {k: v[0] for k, v in parts.items()}, seg, sync,
                recompute)
            torch.autograd.grad(loss, tree_leaves(params))
    finally:
        TT.REMAT_CONTEXT = saved
        for h in handles:
            h.remove()
    # the reduced hybrid is one super-block; 64 tokens are one loss chunk
    blocks = 1 if cfg.family == "hybrid" else cfg.num_layers
    assert recompute["regions"] == chip_smoke.remat_regions(cfg, 64) \
        == blocks + 1
    assert recompute["s"] > 0
    for part, (_, layer_type) in parts.items():
        assert seg[f"{part}_vjp_nodes"] == \
            list(cfg.layer_types()).count(layer_type)
        assert seg[f"{part}_vjp_in_backward_s"] >= 0


def test_method_runs_launch_what_their_traces_imply(monkeypatch):
    """The convex method set of chip_smoke.py's phase 3a' (at 1/24 of its
    size): the kernel wrapper is called exactly as often as
    ``methods.kernel_calls`` reads from each trace — the count the card's
    launches are held to."""
    from repro_torch.launch import methods
    calls = []
    real = tops.linear_value_grad
    monkeypatch.setattr(tops, "linear_value_grad",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rt = {"api": P, "methods": methods}
    runs = chip_smoke.method_runs(rt, scale=0.25)
    assert len(runs) == 7
    for name, run in runs.items():
        del calls[:]
        tr = run("cpu")
        assert len(calls) == methods.kernel_calls(tr) > 0, name
