"""Tests of the port that need a CUDA card: the hand-written kernels
against their float64 plain versions, the scans' and the attention's
autograd on the card, the moe routing, the main paths on the card
against the CPU, and the race's WHILE graph against the eager loop with
its launch counts under replay.  They skip (deciding
inside each test) where there is no card.

This file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py
"""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.api as P
from repro_torch.core import engine
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


# the sizes of chip_smoke.py's KERNEL_SHAPES (w8a_like@6, Adagrad's
# mini-batch, a DSM sample, ragged, webspam_like@1, rcv1_like@1,
# susy_like@64, small)
KERNEL_SIZES = [(49152, 300), (64, 300), (512, 300), (49189, 300),
                (16384, 1024), (4096, 2048), (4194304, 18), (200, 32)]


@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_cuda_kernel_at_the_method_set_shapes(n, loss):
    """Adagrad's 64-row mini-batches and DSM's 512-row samples, gathered
    rows of the full-width problem, against the float64 plain version."""
    _need_card()
    X, y, w = _inputs(49152, 300, seed=n)
    idx = torch.randperm(49152, generator=torch.Generator().manual_seed(n))
    Xs, ys = X[idx[:n].cuda()], y[idx[:n].cuda()]
    L, g = ops.linear_value_grad(Xs, ys, w, loss=loss)
    L64, g64 = ref.linear_value_grad(Xs.double(), ys.double(), w.double(),
                                     loss=loss)
    assert abs(float(L) - float(L64)) <= 1e-5 * abs(float(L64))
    assert float((g.double() - g64).abs().max()) <= \
        1e-4 * max(1.0, float(g64.abs().max()))


@pytest.mark.parametrize("n,d", KERNEL_SIZES)
def test_cuda_kernel_repeats_bitwise_back_to_back_and_on_two_streams(n, d):
    """Each call zeroes its own ticket in its own scratch: calls queued back
    to back, and calls on two streams at once, elect their own last block
    and give the first call's bits."""
    _need_card()
    X, y, w = _inputs(n, d, seed=n % 997 + d)
    L, g = ops.linear_value_grad(X, y, w, loss="logistic")
    runs = [ops.linear_value_grad(X, y, w, loss="logistic") for _ in range(3)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            runs.append(ops.linear_value_grad(X, y, w, loss="logistic"))
    torch.cuda.synchronize()
    for L2, g2 in runs:
        assert torch.equal(L, L2) and torch.equal(g, g2)


@pytest.mark.parametrize("d", [18, 300])
def test_cuda_kernel_takes_rows_that_start_off_a_16_byte_boundary(d):
    """X may start anywhere on a 4-byte boundary (a row view at d = 18,
    whose rows are 72 bytes; any tensor at an odd float offset); the bulk
    copies cover the 16-byte granules around each tile and the threads
    skip the bytes before it, so such an X gives the bits of an aligned
    copy (the same tiles, the same sums)."""
    _need_card()
    n = 4001
    X, y, w = _inputs(n + 1, d, seed=d)
    flat = X.reshape(-1)
    views = [flat[k:k + n * d].view(n, d) for k in (1, 2, 3)]
    if d == 18:
        views.append(X[1:])
    for view in views:
        assert view.data_ptr() % 16
        L, g = ops.linear_value_grad(view, y[:n], w)
        Lc, gc = ops.linear_value_grad(view.clone(), y[:n].clone(), w)
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


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b",
                                  "qwen3-0.6b", "granite-moe-1b-a400m"])
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
    # a train step (its forward pass and the rematerialization in its
    # backward) and an f̂ probe per step: three forward passes, each
    # launching the family's kernels once per layer that runs them
    counts = {t: sum(x == t for x in gpu_sess.model_config.layer_types())
              for t in ("ssm", "rec", "attn")}
    passes = 3 * len(gpu.points)
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


@pytest.mark.parametrize("E,K", [(4, 2), (32, 8), (16, 1)])
def test_moe_route_on_card_matches_cpu(E, K):
    """``route`` at the reduced and the published routings on the card:
    the dispatch masks equal the CPU's bit for bit, the combine weights
    and the aux losses within 1e-6 (float32 softmax and logsumexp in
    other orders)."""
    _need_card()
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.reduced(configs.get("granite-moe-1b-a400m")).with_(
        num_experts=E, experts_per_token=K, dtype=torch.float32)
    rng = np.random.default_rng(E)
    x = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cfg.d_model, E))
                          * cfg.d_model ** -0.5).astype(np.float32))
    cc, cd, ca = moe.route(cfg, w, x)
    gc_, gd, ga = moe.route(cfg, w.cuda(), x.cuda())
    assert torch.equal(gd.cpu(), cd)
    np.testing.assert_allclose(gc_.cpu().numpy(), cc.numpy(), rtol=0,
                               atol=1e-6)
    for k in ca:
        np.testing.assert_allclose(ga[k].item(), ca[k].item(), rtol=1e-6)


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


# the chunked kernel's edges: S one below, at and one above its 256-step
# chunk, one step, and one past the path's 4096; W a multiple of a 16-byte
# vector and not (one element at a time)
@pytest.mark.parametrize("S", [255, 256, 257, 4097, 1])
@pytest.mark.parametrize("W", [4096 + 40, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_chunk_edges(S, W, dtype):
    _need_card()
    a, b = _rglru_inputs(2, S, W, seed=S + W, dtype=dtype)
    y = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    y64 = ref.rglru_scan(a.double(), b.double())
    err = (y.double() - y64).abs() / (1.0 + y64.abs())
    assert bool(torch.isfinite(y).all())
    assert float(err.max()) <= RGLRU_TOL[dtype]
    assert torch.equal(y, ops.rglru_scan(a, b))


@pytest.mark.parametrize("W", [64, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_carry_crosses_every_chunk_unchanged(W, dtype):
    """a = 1: y is the prefix sum of b.  With b small integers every sum is
    exact in the float32 carry, so the kernel's y must equal the exact
    prefix sum rounded to the dtype, bit for bit, across all 17 chunks of
    S = 4097 — a carry that is dropped, doubled or folded out of order
    shows at once."""
    _need_card()
    rng = np.random.default_rng(W)
    b = torch.from_numpy(rng.integers(-4, 5, (2, 4097, W)).astype(np.float32))
    b = b.cuda().to(dtype)
    a = torch.ones_like(b)
    y = ops.rglru_scan(a, b)
    assert torch.equal(y, torch.cumsum(b.double(), dim=1).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_zero_decay_forgets_the_carry(dtype):
    """a = 0: h_t = b_t, whatever came before (and A, the chunks' product,
    is 0: the carry-in drops out without a NaN)."""
    _need_card()
    _, b = _rglru_inputs(2, 1000, 4096 + 40, seed=7, dtype=dtype)
    assert torch.equal(ops.rglru_scan(torch.zeros_like(b), b), b)


def test_rglru_scan_two_streams_at_once_keep_their_own_scratch():
    """Two calls in flight at once on two streams, each with its own flags
    and aggregates, give the bits each gives alone."""
    _need_card()
    inputs = [_rglru_inputs(2, 2048, 4096, seed=s, dtype=torch.bfloat16)
              for s in (1, 2)]
    alone = [ops.rglru_scan(a, b) for a, b in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    together = []
    for s, (a, b) in zip(streams, inputs):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            together.append(ops.rglru_scan(a, b))
    torch.cuda.synchronize()
    for y, y2 in zip(alone, together):
        assert torch.equal(y, y2)


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


# --------------------------------------------- repeats at the path shapes
@pytest.mark.parametrize("B", [8, 16], ids=["train", "probe"])
def test_ssm_scan_repeats_bitwise_at_the_mamba_shapes(B):
    """A train step rematerializes the scan in its backward: the second
    call must give the first call's bits (the mamba path's train and
    probe shapes, bfloat16)."""
    _need_card()
    args = _scan_inputs(B, 256, 8192, 16, seed=B, dtype=torch.bfloat16)
    y = ops.ssm_scan(*args)
    for _ in range(2):
        assert torch.equal(y, ops.ssm_scan(*args))


@pytest.mark.parametrize("B", [2, 16], ids=["train", "probe"])
def test_flash_attention_repeats_bitwise_at_the_hybrid_shapes(B):
    _need_card()
    q, k, v = _qkv(B, 4096, 16, 1, 256, seed=B, dtype=torch.bfloat16)
    o = ops.flash_attention(q, k, v, window=2048)
    for _ in range(2):
        assert torch.equal(o, ops.flash_attention(q, k, v, window=2048))


@pytest.mark.parametrize("policy,optimizer", [
    ("two_track", "cg"), ("two_track", "lbfgs"), ("two_track", "adamw"),
    ("gradient_variance", "newton_cg")])
def test_convex_method_runs_on_card_match_cpu(policy, optimizer):
    """The other optimizers and the gradient-variance policy on the card:
    the CPU's columns and host transfers, f̂ within 1e-4."""
    _need_card()
    spec = P.RunSpec(
        data=P.DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3),
        policy=P.PolicySpec(policy, {"final_steps": 5}),
        optimizer=P.OptimizerSpec(optimizer, {"lr": 0.01}
                                  if optimizer == "adamw" else {}),
        schedule=P.ScheduleSpec(n0=128))
    gpu, cpu = (P.build(spec, device=d).run() for d in ("cuda", "cpu"))
    for col in ("step", "stage", "window", "time", "accesses"):
        assert gpu.column(col) == cpu.column(col), col
    assert gpu.meta["host_transfers"] == cpu.meta["host_transfers"]
    np.testing.assert_allclose(gpu.column("f_full"), cpu.column("f_full"),
                               rtol=1e-4)


@pytest.mark.parametrize("method", ["dsm", "adagrad"])
def test_baselines_on_card_match_cpu(method):
    _need_card()
    from repro_torch.launch import methods
    out = []
    for device in ("cuda", "cpu"):
        ds, obj, w0 = P.convex_problem(
            P.DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3),
            device=device)
        out.append(methods.run_method(method, ds, obj, w0, steps=8))
    gpu, cpu = out
    for col in ("step", "stage", "window", "time", "accesses"):
        assert gpu.column(col) == cpu.column(col), col
    np.testing.assert_allclose(gpu.column("f_full"), cpu.column("f_full"),
                               rtol=1e-4)


# ------------------------------------------------------ the legacy loops
class _ScalarReads(TorchDispatchMode):
    """Counts the reads of one scalar back to the host."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func.__name__.split(".")[0] == "_local_scalar_dense"
        return func(*args, **(kwargs or {}))


def test_pull_reads_one_scalar_from_the_card_a_call():
    _need_card()
    from repro_torch.core import legacy
    x = torch.arange(3, dtype=torch.float32, device="cuda")
    legacy.reset_host_pulls()
    with _ScalarReads() as mode:
        got = [legacy._pull(x[i] * 2) for i in range(3)]
    assert got == [0.0, 2.0, 4.0]
    assert legacy.host_pulls() == mode.reads == 3


@pytest.mark.parametrize("name,kw", [
    ("run_bet_fixed", dict(inner_steps=4, final_steps=8)),
    ("run_two_track", dict(final_steps=8)),
    ("run_batch", dict(steps=10, record_every=3)),
])
def test_legacy_loop_on_card_matches_the_engine(name, kw):
    """A legacy loop runs on the card where its dataset lies, reads back
    only at its pulls, launches B1 once an optimizer step, and matches the
    engine (its deprecated wrapper) as the reference's parity tests ask."""
    _need_card()
    import warnings

    from repro_torch.core import BETSchedule, SimulatedClock, bet, legacy
    from repro_torch.launch import methods
    from repro_torch.optim import NewtonCG
    ds, obj, w0 = P.convex_problem(
        P.DataSpec(dataset="w8a_like", scale=0.125, lam=1e-3),
        device="cuda")
    if name != "run_batch":
        kw = dict(kw, schedule=BETSchedule(n0=128))
    legacy.reset_host_pulls()
    ops.reset_calls()
    with _ScalarReads() as mode:
        tr_l = getattr(legacy, name)(ds, NewtonCG(), obj,
                                     clock=SimulatedClock(), **kw)
    assert legacy.host_pulls() == mode.reads > 0
    assert tr_l.params.device.type == "cuda"
    steps = tr_l.final().step + 1
    assert ops.CALLS["linear_value_grad"] == methods.kernel_calls(tr_l) >= \
        steps
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        tr_e = getattr(bet, name)(ds, NewtonCG(), obj,
                                  clock=SimulatedClock(), w0=w0, **kw)
    for col in ("step", "stage", "window", "time", "accesses"):
        assert tr_l.column(col) == tr_e.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(tr_l.column(col), tr_e.column(col),
                                   rtol=1e-5)


# ------------------------------------------------------ streaming data plane
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_device_window_appends_from_pinned_memory_bitwise(dtype):
    """Appends of uneven chunks land on the card (a pinned copy, no wait
    on the host) equal to a torch.cat of the same rows on the host, bit
    for bit; a view taken before a later append keeps its values."""
    _need_card()
    from repro_torch.data.device_window import DeviceWindow
    rng = np.random.default_rng(0)
    chunks = [(rng.standard_normal((k, 257)) * 1e3).astype(dtype)
              for k in (64, 1, 191, 256, 512)]
    total = sum(len(c) for c in chunks)
    win = DeviceWindow(capacity=total + 7, item_shape=(257,), dtype=dtype)
    early = None
    for c in chunks:
        win.append(c)
        if early is None:
            early = win.slice(64)
            early_host = early.cpu()
    host = torch.cat([torch.from_numpy(c) for c in chunks])
    assert win.buffer.is_cuda and win.n_valid == total
    assert torch.equal(win.slice(total).cpu(), host)
    assert torch.equal(win.buffer[total:].cpu(),
                       torch.zeros((7, 257), dtype=host.dtype))
    assert torch.equal(early.cpu(), early_host)
    assert int(win.masked().n_valid) == total


@pytest.mark.parametrize("policy", ["fixed_steps", "two_track"])
def test_convex_plane_on_card_equals_the_host_path(policy):
    """4,096 x 300 on the card: the plane and the host path give the same
    trace, final w and kernel launches, bit for bit."""
    _need_card()
    out = {}
    for plane in ("host", "plane"):
        spec = P.RunSpec(
            data=P.DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3,
                            plane=plane),
            policy=P.PolicySpec(policy, {"final_steps": 8}),
            optimizer=P.OptimizerSpec("newton_cg",
                                      {"hessian_fraction": 0.2}),
            schedule=P.ScheduleSpec(n0=128))
        ops.reset_calls()
        sess = P.build(spec, device="cuda")
        out[plane] = (sess.run(), ops.CALLS["linear_value_grad"], sess)
    (host, h_calls, _), (plane, p_calls, sess) = out["host"], out["plane"]
    assert sess.dataset.n == 4096 and sess.dataset.windows[0].buffer.is_cuda
    for col in ("step", "stage", "window", "time", "accesses", "f_window",
                "f_full"):
        assert plane.column(col) == host.column(col), col
    assert torch.equal(plane.params, host.params)
    assert p_calls == h_calls > 0
    m = plane.meta["data_plane"]
    assert m["examples_loaded"] == m["examples_uploaded"] == 4096
    assert m["examples_accessed"] == sess.clock.data_accesses


# ------------------------------------------------- the multi-host runtime
def test_b1_summed_over_lanes_equals_one_launch_on_the_rows():
    """B1 launched once per non-empty lane of a 4-host window and summed in
    lane order equals one launch on the lanes' rows concatenated, to 1e-6
    relative (float32 re-association); the empty lane is not launched."""
    _need_card()
    from repro_torch.dist import DistributedObjective
    from repro_torch.data.device_window import HostWindows
    X, y, w = _inputs(12288, 300, seed=7)
    counts = (4096, 3072, 0, 5120)
    cap = max(counts)
    fields = [torch.zeros((4, cap) + t.shape[1:], device="cuda")
              for t in (X, y)]
    lo = 0
    for h, m in enumerate(counts):
        fields[0][h, :m], fields[1][h, :m] = X[lo:lo + m], y[lo:lo + m]
        lo += m
    hw = HostWindows(fields, host_counts=counts)
    for loss in ("squared_hinge", "logistic"):
        obj = DistributedObjective(loss, 1e-3)
        ops.reset_calls()
        f, g = obj.value_and_grad(w, hw)
        assert ops.CALLS["linear_value_grad"] == 3
        L1, g1 = ops.linear_value_grad(X[:lo], y[:lo], w, loss=loss)
        f1 = L1 / lo + 0.5 * 1e-3 * torch.sum(w * w)
        g1 = g1 / lo + 1e-3 * w
        assert abs(float(f) - float(f1)) <= 1e-6 * abs(float(f1))
        assert float((g - g1).abs().max()) <= \
            1e-6 * max(1.0, float(g1.abs().max()))


def test_stacked_window_grows_in_place_and_repeats_its_bits():
    _need_card()
    from repro_torch.data.device_window import StackedDeviceWindow
    rng = np.random.default_rng(1)
    chunks = [(h, (rng.standard_normal((k, 65)) * 1e3).astype(np.float32))
              for h, k in ((0, 64), (2, 1), (1, 191), (0, 256), (3, 512),
                           (2, 127))]
    wins = [StackedDeviceWindow(num_hosts=4, capacity=600, item_shape=(65,),
                                dtype=np.float32) for _ in range(2)]
    for win in wins:
        ptr = win.buffer.data_ptr()
        for h, c in chunks:
            win.append(h, c)
        assert win.buffer.data_ptr() == ptr and win.buffer.is_cuda
    assert torch.equal(wins[0].buffer, wins[1].buffer)
    for h in range(4):
        rows = [c for lane, c in chunks if lane == h]
        host = torch.from_numpy(np.concatenate(rows))
        assert torch.equal(wins[0].buffer[h, :len(host)].cpu(), host)
    wins[0].reset_lane(3)
    assert not wins[0].buffer[3].any() and wins[0].counts[3] == 0


def test_faulted_four_host_run_on_card_equals_the_unfaulted_one():
    _need_card()
    spec = P.RunSpec(
        data=P.DataSpec(dataset="w8a_like", scale=0.5, lam=1e-3,
                        plane="plane"),
        policy=P.PolicySpec("two_track", {"final_steps": 8}),
        optimizer=P.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=P.ScheduleSpec(n0=128), topology=P.TopologySpec(hosts=4),
        elastic=P.ElasticSpec(enabled=True))
    out = {}
    for name, el in (("whole", P.ElasticSpec(enabled=True)),
                     ("killed", P.ElasticSpec(faults=("kill@2:1",)))):
        ops.reset_calls()
        tr = P.build(spec.replace(elastic=el), device="cuda").run()
        out[name] = (tr, ops.CALLS["linear_value_grad"])
    (whole, w_calls), (killed, k_calls) = out["whole"], out["killed"]
    for col in ("step", "stage", "window", "time", "accesses", "f_window",
                "f_full"):
        assert killed.column(col) == whole.column(col), col
    assert torch.equal(killed.params, whole.params)
    assert k_calls == w_calls > 0
    (kill,) = killed.meta["elastic_events"][0]["events"]
    assert kill["lanes"][0]["reread_examples"] == kill["lanes"][0]["window"]


# ------------------------------------------------------------------ serving
def _serve_tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).cuda()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("arch,kw", [
    ("falcon-mamba-7b", {}), ("qwen3-0.6b", {}),
    ("granite-moe-1b-a400m", {"capacity_factor": 8.0})])
def test_decode_against_prefill_at_full_width(arch, kw):
    """One full-width layer in float32: a decode step from a prefill of 64
    tokens against the last logits of a prefill of 65, at the reference
    test's exactness bound (1e-4 relative; tests/test_serving.py)."""
    _need_card()
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get(arch).with_(num_layers=1, dtype=torch.float32, **kw)
    params = T.init_params(cfg, 0, device="cuda")
    tok = _serve_tokens(cfg, 2, 65, 3)
    ref, _ = T.prefill_step(cfg, params, {"tokens": tok}, cache_len=72)
    _, cache = T.prefill_step(cfg, params, {"tokens": tok[:, :64]},
                              cache_len=72)
    dec, _ = T.decode_step(cfg, params, cache,
                           {"tokens": tok[:, 64:], "position": 64})
    assert _rel(dec, ref) < 1e-4


def test_pallas_prefill_launches_and_ring_at_full_width():
    """recurrentgemma-9b, one super-block at full width, prompts past the
    2,048 local window: a pallas prefill launches B2 once and B4 never
    (the reference's prefill runs the Griffin block's plain loop); its
    logits within 0.03 of the xla prefill's; a decode step on the wrapped
    ring within 0.03 of a prefill of one more token."""
    _need_card()
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get("recurrentgemma-9b").with_(num_layers=3)
    params = T.init_params(cfg, 0, device="cuda")
    tok = _serve_tokens(cfg, 1, 2561, 4)
    ops.reset_calls()
    lp, _ = T.prefill_step(cfg, params, {"tokens": tok[:, :2560]},
                           impl="pallas", cache_len=2600)
    assert dict(ops.CALLS) == {"flash_attention": 1}
    ops.reset_calls()
    lx, cache = T.prefill_step(cfg, params, {"tokens": tok[:, :2560]},
                               cache_len=2600)
    assert not ops.CALLS
    assert cache["stack_attn"]["k"].shape[2] == 2048
    assert _rel(lp, lx) < 0.03
    ref, _ = T.prefill_step(cfg, params, {"tokens": tok}, impl="pallas",
                            cache_len=2600)
    dec, _ = T.decode_step(cfg, params, cache,
                           {"tokens": tok[:, 2560:], "position": 2560})
    assert _rel(dec, ref) < 0.03


# ------------------------------------------------- the race's WHILE graph
def _race_spec(optimizer="newton_cg", **data):
    return P.RunSpec(
        data=P.DataSpec(dataset="w8a_like", scale=1.0, lam=1e-3, **data),
        policy=P.PolicySpec("two_track", {"final_steps": 4}),
        optimizer=P.OptimizerSpec(optimizer, {}),
        schedule=P.ScheduleSpec(n0=128))


def _plain_loop(step, carry, hist, s, done, max_iters, keep=()):
    return ops._PlainLoop(ref.race_loop(step, carry, hist, s, done,
                                        max_iters))


@pytest.mark.parametrize("optimizer", ["newton_cg", "gd", "lbfgs"])
def test_while_graph_matches_the_eager_loop_bitwise(optimizer, monkeypatch):
    """The race captured into a CUDA graph's WHILE node, against the same
    step run by the plain loop on the card (one host read a step): the
    same kernels on the same inputs, so the trace and the final carry
    are bitwise equal; one pull a stage."""
    _need_card()
    graph = P.build(_race_spec(optimizer), device="cuda").run()
    monkeypatch.setattr(ops, "race_loop", _plain_loop)
    eager = P.build(_race_spec(optimizer), device="cuda").run()
    for col in ("step", "stage", "window", "time", "accesses", "f_window",
                "f_full"):
        assert graph.column(col) == eager.column(col), col
    assert [p.extra for p in graph.points] == [p.extra for p in eager.points]
    assert torch.equal(graph.params, eager.params)
    assert graph.meta["host_transfers"] == graph.meta["stages"]


def test_calls_count_every_replay_of_the_captured_step():
    """B1 is counted once at capture; after the pull the host adds the
    body's launches for each replay: the counts equal the trace's, over
    one host and over 4 (one launch a non-empty lane a step)."""
    _need_card()
    from repro_torch.launch import methods
    ops.reset_calls()
    tr = P.build(_race_spec(), device="cuda").run()
    racing = tr.meta["stages"] - 1
    assert ops.CALLS["linear_value_grad"] == methods.kernel_calls(tr)
    assert ops.CALLS["device_while"] == racing
    ops.reset_calls()
    spec = _race_spec(plane="plane", shard_size=64).replace(
        topology=P.TopologySpec(hosts=4))
    sess = P.build(spec, device="cuda")
    tr = sess.run()
    own = sess.dataset.ownership

    def lanes(n):
        return sum(own.examples_in_prefix(h, n) > 0
                   for h in range(own.num_hosts))
    implied = 0
    for info in sess.stage_plan():
        pts = [p for p in tr.points if p.stage == info.stage]
        race = sum("f_fast_on_t" in p.extra for p in pts)
        implied += len(pts) * lanes(info.n_t) + race * lanes(info.n_prev)
    assert ops.CALLS["linear_value_grad"] == implied


def test_while_graph_stops_at_the_trigger_on_known_histories():
    """The condition kernel on the card against the plain condition: a
    step that writes known f̂ at the device index s; the loop stops at
    the first s where condition (3) holds, with s and the flag as the
    plain loop leaves them."""
    _need_card()
    slow = torch.tensor([5.0, 3.0, 2.5, 2.0, 1.9, 1.8, 1.7, 1.6],
                        device="cuda")
    fast = torch.tensor([4.0, 3.8, 3.6, 3.5, 3.4, 3.3, 3.2, 3.1],
                        device="cuda")
    out = {}
    for route in ("graph", "plain"):
        hist = torch.zeros((3, 8), device="cuda")
        s = torch.ones((), dtype=torch.int64, device="cuda")
        done = torch.zeros((), dtype=torch.bool, device="cuda")
        hist[0, 0], hist[1, 0] = slow[0], fast[0]

        def step(carry):
            row = torch.stack([slow.index_select(0, s.view(1))[0],
                               fast.index_select(0, s.view(1))[0],
                               carry[0]])
            hist.index_copy_(1, s.view(1), row.view(3, 1))
            carry[0] = carry[0] + 1
            return carry

        carry = [torch.zeros((), device="cuda")]
        loop = (ops.race_loop if route == "graph" else _plain_loop)(
            step, carry, hist, s, done, 8)
        torch.cuda.synchronize()
        out[route] = (int(s), bool(done), float(loop.carry[0]),
                      hist.cpu().clone())
        ops.finish_race_loop(loop, int(s))
    assert out["graph"][:3] == out["plain"][:3] == (4, True, 3.0)
    assert torch.equal(out["graph"][3], out["plain"][3])


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                             for k in a)
    return torch.equal(a, b)


def test_while_graph_is_replayed_over_the_planes_stages(monkeypatch):
    """On the plane an LM's windows keep one shape (a masked window over
    one buffer): the first racing stage captures the graph and every later
    one replays it (capture 0.0 s), from step 1.  The run is bitwise the
    plain loop's on the card, and B3's count equals the plain loop's,
    which launches every step from Python."""
    _need_card()
    spec = P.RunSpec(
        data=P.DataSpec(kind="lm", corpus_size=64, seq_len=32, eval_rows=8,
                        plane="plane", shard_size=8),
        model=P.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=P.OptimizerSpec("adamw_lm", {"lr": 1e-3,
                                               "batch_size": 4}),
        policy=P.PolicySpec("two_track", {"final_steps": 2,
                                          "max_stage_iters": 8}),
        schedule=P.ScheduleSpec(n0=8, step_cost="batch", wait_on_expand=True,
                                carry_state=True, clock={"preloaded": 8}))
    runs = []
    for route in ("graph", "plain"):
        if route == "plain":
            monkeypatch.setattr(ops, "race_loop", _plain_loop)
        sess = P.build(spec, device="cuda")
        ops.reset_calls()
        tr = sess.run()
        torch.cuda.synchronize()
        runs.append((tr, list(sess.engine.race_capture_s), dict(ops.CALLS)))
    (graph, cap, calls), (eager, _, eager_calls) = runs
    racing = graph.meta["stages"] - 1
    assert racing >= 3 and len(cap) == racing
    assert cap[0] > 0.0 and cap[1:] == [0.0] * (racing - 1)
    for col in ("step", "stage", "window", "f_window", "f_full"):
        assert graph.column(col) == eager.column(col), col
    assert [p.extra for p in graph.points] == [p.extra for p in eager.points]
    assert _tree_equal(graph.params, eager.params)
    assert graph.meta["host_transfers"] == graph.meta["stages"]
    assert calls["ssm_scan"] == eager_calls["ssm_scan"] > 0
    assert calls["device_while"] == racing


class _HoldOnce(engine.ExpansionPolicy):
    """A veto that holds every racing stage for two rounds."""
    name = "hold_once"

    def stage_begin(self, info):
        self.rounds = 0

    def plan_steps(self, info, done):
        return 1

    def should_expand(self, info, records):
        self.rounds += 1
        return info.is_final or self.rounds >= 2


def test_veto_rounds_replay_the_kept_graph(monkeypatch):
    """A veto's second race round in a stage replays the graph its first
    round captured (capture 0.0 s): the run is bitwise the plain loop's
    on the card, with one pull a round and B1 counted as it launches."""
    _need_card()
    runs = []
    for route in ("graph", "plain"):
        if route == "plain":
            monkeypatch.setattr(ops, "race_loop", _plain_loop)
        sess = P.build(_race_spec(), device="cuda")
        policy = engine.ComposedPolicy(engine.TwoTrack(final_steps=4),
                                       vetoes=[_HoldOnce()])
        ops.reset_calls()
        tr = sess.engine.run(sess.dataset, sess.optimizer, sess.objective,
                             policy, w0=sess.w0, eval_data=sess.eval_data)
        torch.cuda.synchronize()
        infos = sess.engine.stage_infos(policy, sess.dataset.n)[:-1]
        runs.append((tr, list(sess.engine.race_capture_s), dict(ops.CALLS)))
    (graph, cap, calls), (eager, _, eager_calls) = runs
    want = []
    for info in infos:
        want += [True] if info.is_final else [True, False]
    assert [c > 0.0 for c in cap] == want
    for col in ("step", "stage", "window", "f_window", "f_full"):
        assert graph.column(col) == eager.column(col), col
    assert torch.equal(graph.params, eager.params)
    assert graph.meta["host_transfers"] == len(want) + 1
    assert calls["linear_value_grad"] == eager_calls["linear_value_grad"]


# ------------------------------------------------------------ tiered corpus
def _tier_problem(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    return X, y


def _tiered_card(X, y, *, hbm_rows, shard, **kw):
    from repro_torch.data.shards import InMemoryShardStore
    from repro_torch.data.tiers import TieredCorpus
    row = X.shape[1] * 4 + 4
    return TieredCorpus([InMemoryShardStore(X, shard),
                         InMemoryShardStore(y, shard)],
                        hbm_bytes=hbm_rows * row, device="cuda", **kw)


def _rows_equal(view, X, y, lo, hi):
    Xv, yv = view
    return np.array_equal(Xv.cpu().numpy(), X[lo:hi]) and \
        np.array_equal(yv.cpu().numpy(), y[lo:hi])


def test_tiered_staged_commit_is_bitwise_a_direct_build(monkeypatch):
    """The copy-stream staging lands the same bits as a synchronous direct
    build, from a pinned ring, and its commit never synchronizes the
    device."""
    _need_card()
    X, y = _tier_problem(1 << 16, 300, seed=3)
    with _tiered_card(X, y, hbm_rows=1 << 16, shard=4096) as tc, \
            _tiered_card(X, y, hbm_rows=1 << 16, shard=4096) as direct:
        tc.begin_stage(1 << 14, 1 << 16)         # stages [16384, 65536)
        assert tc._copy_stream is not None
        assert all(t.is_pinned() for t in tc.ring._shards[0])

        def no_sync(*a, **k):
            raise AssertionError("the commit synchronized the device")

        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
        view = tc.begin_stage(1 << 16)
        monkeypatch.undo()
        assert tc.tier_meter.staged_commits == 1
        ref = direct.window(1 << 16)
        assert direct.tier_meter.direct_builds == 1
        assert all(torch.equal(a, b) for a, b in zip(view, ref))
        assert _rows_equal(view, X, y, 0, 1 << 16)
        assert tc.meter.bytes_uploaded == direct.meter.bytes_uploaded


def test_tiered_discard_while_a_copy_is_in_flight():
    """A staged segment discarded while its copy may still run: the
    discard waits for the stager, so a buffer the allocator hands out next
    is never written by the dropped copy, and the next commit lands the
    right rows."""
    _need_card()
    X, y = _tier_problem(1 << 18, 300, seed=4)
    with _tiered_card(X, y, hbm_rows=1 << 16, shard=1 << 14) as tc:
        tc.begin_stage(1 << 16, 1 << 17)
        tc.begin_stage(1 << 17)                  # rotation: [65536, 131072)
        assert tc.mode == "rotate" and tc._staged is not None
        tc._discard_staged()                     # its copy may be in flight
        fill = [torch.full(((1 << 16), 300), float("nan"), device="cuda")
                for _ in range(4)]
        assert tc.tier_meter.staged_discards == 1
        tc.segment_steps(1 << 17, 2)
        view = tc.advance_window()               # a plan miss: direct build
        assert tc.tier_meter.direct_builds >= 1
        torch.cuda.synchronize()
        assert _rows_equal(view, X, y, 1 << 16, 1 << 17)
        assert all(bool(torch.isnan(f).all()) for f in fill)


def test_tiered_bounded_ring_spills_and_repromotes_on_the_card():
    _need_card()
    X, y = _tier_problem(1 << 14, 64, seed=5)
    shard = 1 << 10
    shard_bytes = shard * (64 * 4 + 4)
    with _tiered_card(X, y, hbm_rows=1 << 12, shard=shard,
                      host_bytes=6 * shard_bytes) as tc:
        def sweep(n_t, k, check):
            view = tc.begin_stage(n_t)
            lo, hi = tc.hot_range
            assert not check or _rows_equal(view, X, y, lo, hi)
            for _ in tc.segment_steps(n_t, k)[1:]:
                view = tc.advance_window()
                lo, hi = tc.hot_range
                assert not check or _rows_equal(view, X, y, lo, hi)

        tc.begin_stage(1 << 12, 1 << 13)
        sweep(1 << 13, 2, False)
        sweep(1 << 14, 4, False)
        assert tc.tier_meter.evictions > 0
        loaded = tc.meter.examples_loaded
        sweep(1 << 14, 4, True)                  # re-promotes spilled rows
        assert tc.meter.examples_loaded > loaded
        assert tc.tier_meter.resident_reuploads == 0
        with tc.ring._lock:          # the stager may be inserting shards
            shards = list(tc.ring._shards.values())
        assert all(t.is_pinned() for f in shards for t in f)
