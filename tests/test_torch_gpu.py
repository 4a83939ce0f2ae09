"""Tests of the port that need a CUDA card: the hand-written kernels
against their float64 plain versions, the scans' and the attention's
autograd on the card, and the main paths on the card against the CPU.  They skip (deciding
inside each test) where there is no card.

This file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.api as P
from repro_torch.kernels import (flash_attention, linear_grad, ops, ref,
                                 rglru_scan, ssm_scan)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    y[y == 0] = 1.0
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (X, y, w))


@pytest.mark.parametrize("n,d", [(200, 32), (49189, 300), (4096, 2048),
                                 (1000, 18), (3, 1)])
@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_cuda_kernel_matches_float64_plain_version(n, d, loss):
    _need_card()
    X, y, w = _inputs(n, d, seed=n + d)
    ops.reset_calls()
    L, g = ops.linear_value_grad(X, y, w, loss=loss)
    assert ops.CALLS["linear_value_grad"] == 1
    L2, g2 = ops.linear_value_grad(X, y, w, loss=loss)
    # fixed-order cross-block reduction: bit-reproducible
    assert torch.equal(L, L2) and torch.equal(g, g2)
    L64, g64 = ref.linear_value_grad(X.double(), y.double(), w.double(),
                                     loss=loss)
    # float32 accumulation against float64 (chip_smoke.py states the bound)
    assert abs(float(L) - float(L64)) <= 1e-5 * abs(float(L64))
    assert float((g.double() - g64).abs().max()) <= \
        1e-4 * max(1.0, float(g64.abs().max()))


def test_cuda_kernel_takes_row_views_of_the_window():
    _need_card()
    X, y, w = _inputs(1000, 300, seed=1)
    L, g = ops.linear_value_grad(X[:333], y[:333], w)
    Lc, gc = ops.linear_value_grad(X[:333].clone(), y[:333].clone(), w)
    assert torch.equal(L, Lc) and torch.equal(g, gc)


def test_cuda_kernel_refuses_what_it_does_not_take():
    _need_card()
    X = torch.zeros((8, 4096), device="cuda")
    with pytest.raises(ValueError, match="d <= 2048"):
        linear_grad.linear_value_grad(X, torch.ones(8, device="cuda"),
                                      torch.zeros(4096, device="cuda"))
    Xs = torch.zeros((8, 6), device="cuda")[:, ::2]     # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        linear_grad.linear_value_grad(Xs, torch.ones(8, device="cuda"),
                                      torch.zeros(3, device="cuda"))
    with pytest.raises(TypeError, match="float32"):
        linear_grad.linear_value_grad(X[:, :4].contiguous().double(),
                                      torch.ones(8, device="cuda").double(),
                                      torch.zeros(4, device="cuda").double())


def test_main_path_on_card_matches_cpu():
    _need_card()
    spec = P.RunSpec(
        data=P.DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3),
        policy=P.PolicySpec("fixed_steps", {"inner_steps": 4,
                                            "final_steps": 8}),
        optimizer=P.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=P.ScheduleSpec(n0=32))
    ops.reset_calls()
    gpu = P.build(spec, device="cuda").run()
    assert ops.CALLS["linear_value_grad"] == len(gpu.points)
    cpu = P.build(spec, device="cpu").run()
    for col in ("step", "stage", "window", "time", "accesses"):
        assert gpu.column(col) == cpu.column(col), col
    # the bound chip_smoke.py states for the card-vs-CPU main path
    np.testing.assert_allclose(gpu.column("f_full"), cpu.column("f_full"),
                               rtol=1e-4)


# ---------------------------------------------------------- ssm scan (B3)
def _scan_inputs(B, S, di, N, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    Bs = rng.standard_normal((B, S, N)).astype(np.float32)
    Cs = rng.standard_normal((B, S, N)).astype(np.float32)
    Al = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32)[None], (di, 1)))
    D = rng.standard_normal(di).astype(np.float32)
    t = [torch.from_numpy(a).cuda() for a in (u, dt, Bs, Cs, Al, D)]
    return [x.to(dtype) for x in t[:4]] + t[4:]


# float32 against the float64 plain version: the float32 carry and the
# SFU's exp2 (2 ulp) over S steps of a contracting recurrence, 1e-4
# relative to max(1, |y|); bfloat16: y itself is rounded to bfloat16
# (half an ulp, 2^-9), 1e-2 relative.  chip_smoke.py states the same.
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("B,S,di,N", [(1, 32, 64, 4), (2, 64, 128, 16),
                                      (1, 100, 96, 8), (3, 37, 200, 16),
                                      (2, 256, 8192, 16), (1, 5, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_matches_float64_plain_version(B, S, di, N, dtype):
    _need_card()
    args = _scan_inputs(B, S, di, N, seed=B + S + di + N, dtype=dtype)
    ops.reset_calls()
    y = ops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert ops.CALLS["ssm_scan"] == 1
    assert y.dtype == dtype and y.shape == (B, S, di)
    y64 = ref.ssm_scan(*(a.double() for a in args))
    err = (y.double() - y64).abs()
    assert bool(torch.isfinite(y).all())
    assert float((err / (1.0 + y64.abs())).max()) <= SCAN_TOL[dtype]
    assert torch.equal(y, ops.ssm_scan(*args))           # deterministic


def _scan_check(args, dtype):
    """The kernel against its float64 plain version at SCAN_TOL, and a
    repeat bitwise equal (the lane groups' shuffle sums run in a fixed
    order)."""
    y = ops.ssm_scan(*args)
    torch.cuda.synchronize()
    y64 = ref.ssm_scan(*(a.double() for a in args))
    assert y.dtype == dtype and bool(torch.isfinite(y).all())
    err = (y.double() - y64).abs() / (1.0 + y64.abs())
    assert float(err.max()) <= SCAN_TOL[dtype]
    assert torch.equal(y, ops.ssm_scan(*args))


# the redesigned kernel's edges: N from 1 to 16 (padded to 4, 8, 16 states
# and split over lane groups), di not a multiple of a lane group or of a
# block's channels, S not a multiple of the 16-step tile, the f̂ probe's
# shape
@pytest.mark.parametrize("B,S,di,N", [
    (2, 40, 96, 1), (2, 40, 96, 4), (2, 40, 96, 8), (2, 40, 96, 16),
    (3, 33, 130, 13), (1, 17, 8192 + 3, 16), (1, 1, 37, 16),
    (16, 256, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_edges(B, S, di, N, dtype):
    _need_card()
    _scan_check(_scan_inputs(B, S, di, N, seed=B * S + di + N, dtype=dtype),
                dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_strong_decay_and_zero_delta(dtype):
    _need_card()
    args = _scan_inputs(2, 64, 256, 16, seed=11, dtype=dtype)
    # A = -exp(log n + 6) = -403 n: delta·A below -126 / log2 e for most
    # steps, so the exponentials underflow to 0 (the SFU's flush, the
    # polynomial's cut-off) and h_t is (delta_t u_t) B_t alone
    strong = args[:4] + [args[4] + 6.0, args[5]]
    _scan_check(strong, dtype)
    # delta = 0: every exponential is 1 and the state never moves
    zero = [args[0], torch.zeros_like(args[1])] + args[2:]
    _scan_check(zero, dtype)


def test_ssm_scan_grad_on_card_matches_plain_autograd():
    _need_card()
    args = _scan_inputs(2, 48, 96, 8, seed=5)
    a = [x.clone().requires_grad_(True) for x in args]
    b = [x.clone().requires_grad_(True) for x in args]
    g = torch.randn((2, 48, 96), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    ops.ssm_scan(*a).backward(g)
    ref.ssm_scan(*b).backward(g)
    for x, y in zip(a, b):
        # the same plain VJP, from the kernel's saved inputs
        assert torch.equal(x.grad, y.grad)


def test_ssm_scan_refuses_what_it_does_not_take():
    _need_card()
    args = _scan_inputs(1, 8, 32, 4, seed=0)
    meta = [torch.empty_like(a, device="meta") for a in args]
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ops.ssm_scan(*meta)
    with pytest.raises(ValueError, match="N <= 16"):
        ssm_scan.ssm_scan(*_scan_inputs(1, 8, 32, 17, seed=0))
    with pytest.raises(TypeError, match="float32"):
        ssm_scan.ssm_scan(*[a.double() for a in args])
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.ssm_scan(args[0].transpose(1, 2).contiguous()
                          .transpose(1, 2), *args[1:])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_lm_path_on_card_matches_cpu(arch):
    _need_card()
    spec = P.RunSpec(
        data=P.DataSpec(kind="lm", corpus_size=32, seq_len=32, eval_rows=8),
        model=P.ModelSpec(arch=arch, reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=P.OptimizerSpec("adamw_lm", {"lr": 1e-3,
                                               "batch_size": 4}),
        policy=P.PolicySpec("fixed_steps", {"inner_steps": 3,
                                            "final_steps": 3}),
        schedule=P.ScheduleSpec(n0=16, step_cost="batch",
                                wait_on_expand=True, carry_state=True))
    cpu_sess = P.build(spec, device="cpu")
    gpu_sess = P.build(spec, device="cuda")
    gpu_sess.w0 = {k: (v.cuda() if torch.is_tensor(v) else
                       {n: t.cuda() for n, t in v.items()})
                   for k, v in cpu_sess.w0.items()}
    ops.reset_calls()
    gpu = gpu_sess.run()
    # a train step and an f̂ probe per step: two forward passes, each
    # launching the family's kernels once per layer that runs them
    counts = {t: sum(x == t for x in gpu_sess.model_config.layer_types())
              for t in ("ssm", "rec", "attn")}
    passes = 2 * len(gpu.points)
    want = {"ssm_scan": counts["ssm"] * passes,
            "rglru_scan": counts["rec"] * passes,
            "flash_attention": counts["attn"] * passes}
    assert dict(ops.CALLS) == {k: n for k, n in want.items() if n}
    cpu = cpu_sess.run()
    for col in ("step", "stage", "window", "time", "accesses"):
        assert gpu.column(col) == cpu.column(col), col
    # the bound chip_smoke.py states for the LM card-vs-CPU check
    np.testing.assert_allclose(gpu.column("f_full"), cpu.column("f_full"),
                               rtol=1e-4)


# -------------------------------------------------------- rglru scan (B4)
def _rglru_inputs(B, S, W, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    b = rng.standard_normal((B, S, W))
    return [torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)
            for x in (a, b)]


# against the float64 plain version, relative to 1 + |y| (chip_smoke.py
# states the same): float32 carries h in float32 through a contracting
# recurrence, 1e-5; bfloat16 rounds each y to bfloat16, 5e-2 (the
# reference's own bounds, tests/test_kernels.py)
RGLRU_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("B,S,W", [(1, 32, 64), (2, 100, 96), (1, 64, 256),
                                   (3, 77, 4096 + 40), (2, 4096, 4096),
                                   (1, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_matches_float64_plain_version(B, S, W, dtype):
    _need_card()
    a, b = _rglru_inputs(B, S, W, seed=B + S + W, dtype=dtype)
    ops.reset_calls()
    y = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert ops.CALLS["rglru_scan"] == 1
    assert y.dtype == dtype and y.shape == (B, S, W)
    y64 = ref.rglru_scan(a.double(), b.double())
    err = (y.double() - y64).abs() / (1.0 + y64.abs())
    assert bool(torch.isfinite(y).all())
    assert float(err.max()) <= RGLRU_TOL[dtype]
    assert torch.equal(y, ops.rglru_scan(a, b))          # deterministic


def test_rglru_scan_grad_on_card_matches_plain_autograd():
    _need_card()
    args = _rglru_inputs(2, 48, 96, seed=5)
    a = [x.clone().requires_grad_(True) for x in args]
    b = [x.clone().requires_grad_(True) for x in args]
    g = torch.randn((2, 48, 96), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    ops.rglru_scan(*a).backward(g)
    ref.rglru_scan(*b).backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


def test_rglru_scan_refuses_what_it_does_not_take():
    _need_card()
    a, b = _rglru_inputs(1, 8, 32, seed=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan.rglru_scan(a.double(), b.double())
    with pytest.raises(TypeError, match="share"):
        rglru_scan.rglru_scan(a, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2),
                              b)


# --------------------------------------------------- flash attention (B2)
def _qkv(B, S, H, KV, hd, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, n, hd))
                             .astype(np.float32)).cuda().to(dtype)
            for n in (H, KV, KV)]


# against the float64 plain version, relative to 1 + |o| (chip_smoke.py
# states the same): float32 accumulation over at most S keys, 1e-4;
# bfloat16 rounds o to bfloat16, 2e-2 (the reference's own bounds)
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (1, 64, 2, 2, 32, 0), (2, 128, 4, 2, 64, 0), (1, 96, 8, 1, 64, 0),
    (2, 160, 3, 3, 32, 0), (1, 96, 2, 2, 32, 16), (1, 200, 4, 1, 64, 48),
    (1, 300, 16, 1, 256, 128), (2, 77, 4, 4, 128, 0), (1, 1, 2, 1, 64, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_float64_plain_version(
        B, S, H, KV, hd, window, dtype):
    _need_card()
    q, k, v = _qkv(B, S, H, KV, hd, seed=B + S + H + hd, dtype=dtype)
    ops.reset_calls()
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.CALLS["flash_attention"] == 1
    assert o.dtype == dtype and o.shape == (B, S, H, hd)
    o64 = ref.gqa_attention(q.double(), k.double(), v.double(),
                            window=window)
    err = (o.double() - o64).abs() / (1.0 + o64.abs())
    assert bool(torch.isfinite(o).all())
    assert float(err.max()) <= ATTN_TOL[dtype]
    assert torch.equal(o, ops.flash_attention(q, k, v, window=window))


# the wgmma kernel's edges in bfloat16: the path shape; S not a multiple
# of its 128-row block (77, 1000); windows below one 64-key tile (16) and
# not a multiple of it (100); GQA ratios 1, 2, 8 and 16; hd 32, 64, 128
# and 256; one non-causal case
@pytest.mark.parametrize("B,S,H,KV,hd,window,causal", [
    (2, 4096, 16, 1, 256, 2048, True), (1, 77, 4, 4, 128, 0, True),
    (1, 1000, 16, 1, 256, 300, True), (1, 200, 4, 2, 64, 16, True),
    (1, 300, 8, 1, 64, 100, True), (2, 130, 8, 8, 32, 0, True),
    (1, 256, 16, 2, 128, 64, True), (1, 190, 8, 1, 32, 0, True),
    (1, 150, 16, 1, 64, 0, False), (1, 1000, 4, 1, 128, 0, False)])
def test_flash_attention_bf16_kernel_edges(B, S, H, KV, hd, window, causal):
    _need_card()
    q, k, v = _qkv(B, S, H, KV, hd, seed=S + H + hd, dtype=torch.bfloat16)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    o64 = torch.cat([ref.gqa_attention(q[i:i + 1].double(),
                                       k[i:i + 1].double(),
                                       v[i:i + 1].double(), causal=causal,
                                       window=window) for i in range(B)])
    err = (o.double() - o64).abs() / (1.0 + o64.abs())
    assert bool(torch.isfinite(o).all())
    assert float(err.max()) <= ATTN_TOL[torch.bfloat16]
    assert torch.equal(o, ops.flash_attention(q, k, v, causal=causal,
                                              window=window))


def test_flash_attention_grad_on_card_matches_plain_autograd():
    _need_card()
    args = _qkv(1, 64, 2, 1, 32, seed=3)
    a = [x.clone().requires_grad_(True) for x in args]
    b = [x.clone().requires_grad_(True) for x in args]
    g = torch.randn((1, 64, 2, 32), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    ops.flash_attention(*a, window=16).backward(g)
    ref.gqa_attention(*b, window=16).backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


def test_flash_attention_refuses_what_it_does_not_take():
    _need_card()
    q, k, v = _qkv(1, 16, 4, 2, 32, seed=0)
    with pytest.raises(ValueError, match="hd in 32, 64, 128, 256"):
        flash_attention.flash_attention(*_qkv(1, 16, 4, 2, 48, seed=0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(1, 2).contiguous()
                                        .transpose(1, 2), k, v)
