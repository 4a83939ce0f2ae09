"""The Two-Track race on the device, held against the reference on the
CPU: one pull a racing stage, as the reference's ``lax.while_loop``
(quickstart@6 two-track: 10 pulls over 10 stages in both packages), no
step past the trigger, Newton-CG's device step counter giving the
reference's Hessian sub-window rows on every kind of window, an LM run
pulling once a racing stage, the plain loop's stopping rule (condition
(3) at the device step index, or ``max_iters``), and no host read inside
a race step — what the card's WHILE graph captures."""
import collections
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.api as R
import repro_torch.api as P
from repro.data import device_window as jdw
from repro_torch.data import device_window as tdw
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

COLUMNS = ("step", "stage", "window", "time", "accesses")
# f̂ after ~60 float32 Newton-CG steps, summation orders apart: the bound
# of tests/test_torch_engine.py and chip_smoke.py's card-vs-CPU phase
RTOL_F = 1e-4


def test_quickstart6_two_track_pulls_once_a_stage_as_the_reference():
    _, base = chip_smoke.quickstart_specs(R)
    spec = R.RunSpec(policy=R.PolicySpec("two_track", {"final_steps": 20}),
                     **base)
    want = R.build(spec).run()
    got = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu").run()
    assert got.meta["host_transfers"] == want.meta["host_transfers"] == 10
    assert got.meta["stages"] == want.meta["stages"] == 10
    assert got.meta["race_overshoot"] == 0
    for col in COLUMNS:
        assert got.column(col) == want.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(got.column(col), want.column(col),
                                   rtol=RTOL_F)


@pytest.mark.parametrize("fraction", [0.1, 0.5, 1.0])
def test_device_step_counter_gives_the_references_subwindow_rows(fraction):
    """Newton-CG's ``t`` is a 0-d int32 tensor; the rows it selects from a
    plain (X, y) window, a ``HostWindows`` and a ``MaskedWindow`` are the
    reference's index for index."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, 3)).astype(np.float32)
    y = np.arange(60, dtype=np.float32)
    lanes = np.arange(3 * 40 * 2, dtype=np.float32).reshape(3, 40, 2)
    counts = [25, 40, 0]
    thw = tdw.HostWindows((torch.from_numpy(lanes),), host_counts=counts)
    jhw = jdw.HostWindows((jnp.asarray(lanes),),
                          jnp.asarray(counts, jnp.int32))
    tmw = tdw.MaskedWindow(torch.from_numpy(X),
                           torch.tensor(37, dtype=torch.int32))
    jmw = jdw.as_host_windows(jdw.MaskedWindow(jnp.asarray(X),
                                               jnp.int32(37)))
    for step in range(6):
        t = torch.tensor(step, dtype=torch.int32)
        jt = jnp.int32(step)
        got = tdw.rolling_subwindow((torch.from_numpy(X),
                                     torch.from_numpy(y)), fraction, t)
        want = jdw.rolling_subwindow((jnp.asarray(X), jnp.asarray(y)),
                                     fraction, jt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        sub, jsub = tdw.rolling_subwindow(thw, fraction, t), \
            jdw.rolling_subwindow(jhw, fraction, jt)
        assert list(sub.host_counts) == np.asarray(jsub.counts).tolist()
        for h, m in enumerate(sub.host_counts):
            np.testing.assert_array_equal(
                sub.lane(h)[0].numpy(), np.asarray(jsub.fields[0])[h, :m])
        msub = tdw.rolling_subwindow(tmw, fraction, t)
        jm = jdw.rolling_subwindow(jmw, fraction, jt)
        np.testing.assert_array_equal(msub.data.numpy(),
                                      np.asarray(jm.fields[0][0]))
        assert int(msub.n_valid) == int(jm.counts[0])


def test_lm_two_track_pulls_once_a_racing_stage():
    """A reduced falcon-mamba-7b two-track run: one pull a stage, each
    racing stage's steps in the trace, none past the trigger."""
    spec = P.RunSpec(
        data=P.DataSpec(kind="lm", corpus_size=32, seq_len=16, eval_rows=8),
        model=P.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=P.OptimizerSpec("adamw_lm", {"lr": 1e-3, "batch_size": 4}),
        policy=P.PolicySpec("two_track", {"final_steps": 2,
                                          "max_stage_iters": 8,
                                          "condition": "eval"}),
        schedule=P.ScheduleSpec(n0=8, step_cost="batch", carry_state=True))
    sess = P.build(spec, device="cpu")
    tr = sess.run()
    pulls = [b["transfers"] - a["transfers"] for a, b in
             zip([{"transfers": 0}] + sess.stage_ends, sess.stage_ends)]
    assert pulls == [1] * tr.meta["stages"] and len(pulls) >= 3
    assert tr.meta["host_transfers"] == tr.meta["stages"]
    assert tr.meta["race_overshoot"] == 0


def _histories(slow, fast, M):
    hist = torch.zeros((3, M))
    return hist, torch.tensor(slow + [0.0] * (M - len(slow))), \
        torch.tensor(fast + [0.0] * (M - len(fast)))


@pytest.mark.parametrize("slow,fast,M,steps,done", [
    # condition (3) at s = 4: slow after 2 steps (3.0) beats fast after 4
    # (3.5); never at s = 2 or 3
    ([5.0, 3.0, 2.5, 2.0, 1.9], [4.0, 3.8, 3.6, 3.5, 3.4], 8, 4, True),
    # never beats it: max_iters steps, no trigger
    ([5.0] * 6, [1.0] * 6, 6, 6, False),
    # at s = 2 already (slow after 1 step beats fast after 2)
    ([1.0, 0.5], [2.0, 1.5], 5, 2, True),
])
def test_plain_race_loop_stops_at_the_trigger_or_max_iters(slow, fast, M,
                                                           steps, done):
    """The loop the card's WHILE graph runs, in its plain version: after
    the eager first step (s = 1), each step writes index s and the
    condition reads the reference's indices; the loop ends exactly at the
    trigger."""
    hist, fs, ff = _histories(slow, fast, M)
    s = torch.ones((), dtype=torch.int64)
    flag = torch.zeros((), dtype=torch.bool)
    hist[0, 0], hist[1, 0] = fs[0], ff[0]
    seen = []

    def step(carry):
        i = int(s)
        hist[0, i], hist[1, i] = fs[i], ff[i]
        seen.append(i)
        carry[0] = carry[0] + 1
        return carry

    loop = ops.race_loop(step, [torch.zeros(())], hist, s, flag, M)
    assert int(s) == steps and bool(flag) is done
    assert seen == list(range(1, steps))
    assert int(loop.carry[0]) == steps - 1
    ops.finish_race_loop(loop, int(s))
    assert not ops.CALLS            # the CPU launches nothing


class _HostReads(TorchDispatchMode):
    """Fails on any operation that reads a tensor back on the host (what a
    captured graph cannot hold)."""
    READS = {"_local_scalar_dense", "nonzero", "is_nonzero", "equal"}

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        assert name not in self.READS, f"host read {name} in a race step"
        self.ops[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("optimizer", ["newton_cg", "gd", "lbfgs", "cg",
                                       "adamw", "adamw_lm"])
def test_a_race_step_reads_nothing_back_on_the_host(optimizer, monkeypatch):
    """Every race step (both tracks' steps, the three f̂, the history
    writes at the device index) runs without a host read, so the card
    captures it whole; the eager first step is held to it too."""
    counted = []

    def checked_loop(step, carry, hist, s, done, max_iters, keep=()):
        def checked(c):
            with _HostReads() as mode:
                out = step(c)
            counted.append(sum(mode.ops.values()))
            return out
        return ops._PlainLoop(ref.race_loop(checked, carry, hist, s, done,
                                            max_iters))

    monkeypatch.setattr(ops, "race_loop", checked_loop)
    if optimizer == "adamw_lm":
        spec = P.RunSpec(
            data=P.DataSpec(kind="lm", corpus_size=32, seq_len=16,
                            eval_rows=8, plane="plane", shard_size=8),
            model=P.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                              overrides={"dtype": "float32"}),
            optimizer=P.OptimizerSpec("adamw_lm", {"batch_size": 4}),
            policy=P.PolicySpec("two_track", {"final_steps": 1,
                                              "max_stage_iters": 3,
                                              "condition": "eval"}),
            schedule=P.ScheduleSpec(n0=8, step_cost="batch",
                                    carry_state=True))
    else:
        spec = P.RunSpec(
            data=P.DataSpec(dataset="w8a_like", scale=0.05, lam=1e-3,
                            plane="plane", shard_size=64),
            policy=P.PolicySpec("two_track", {"final_steps": 1}),
            optimizer=P.OptimizerSpec(optimizer, {}),
            schedule=P.ScheduleSpec(n0=128), topology=P.TopologySpec(
                hosts=2 if optimizer == "newton_cg" else 1))
    tr = P.build(spec, device="cpu").run()
    assert counted and all(counted)
    assert tr.meta["host_transfers"] == tr.meta["stages"]


def test_static_carry_owns_its_memory_and_writes_back_in_order():
    """What the WHILE graph captures around a step, on CPU tensors: the
    static carry clones a leaf that views a kept tensor (the stage's start
    point, which L-BFGS's state views) or another leaf, and the write-back
    reads a new leaf that views a static one before writing any."""
    from repro_torch.kernels import device_while as dw
    w0 = torch.arange(4.0)
    w1 = w0 + 1
    carry = [w1, {"prev": w0.view(-1), "again": w1.view(2, 2)}]
    static = dw._static(carry, keep=[w0])
    assert static[0] is w1
    for leaf in static[1].values():
        assert leaf.untyped_storage().data_ptr() not in (
            w0.untyped_storage().data_ptr(), w1.untyped_storage().data_ptr())
    # a step whose new state views its input point, as L-BFGS's does
    new = [static[0] * 2, {"prev": static[0].view(-1),
                           "again": (static[0] * 2).view(2, 2)}]
    old = static[0].clone()
    dw._write_back(static, new)
    assert torch.equal(static[1]["prev"], old)
    assert torch.equal(static[0], old * 2)
    assert torch.equal(w0, torch.arange(4.0))


def test_a_kept_race_graph_matches_only_what_it_captured():
    """What decides whether a later race round replays the kept graph, on
    CPU tensors: the plane's masked windows of two stages (one buffer,
    their own valid lengths) match, and a graph captured on their staged
    scalars reads the later window's length once it is copied in; a host
    window of another length, another buffer, or carries of another
    shape or dtype do not match."""
    from repro_torch.core import engine as tengine
    buf = torch.arange(24.0).view(12, 2)
    full = (torch.ones(12, 2), torch.ones(12))

    def masked(n):
        return tdw.MaskedWindow(buf, torch.tensor(n, dtype=torch.int32))

    def sig(wins):
        return tengine._signature(wins, addresses=True)
    a = (masked(4), masked(2), full)
    b = (masked(8), masked(4), full)
    assert sig(a) == sig(b)
    assert sig((buf[:4], buf[:2], full)) != sig((buf[:8], buf[:4], full))
    assert sig(a) != sig((tdw.MaskedWindow(buf.clone(), a[0].n_valid),
                          a[1], full))
    w = torch.zeros(3)
    carry = tengine._signature([w, {"m": w}], addresses=False)
    assert carry == tengine._signature([w + 1, {"m": w.clone()}],
                                       addresses=False)
    assert carry != tengine._signature([torch.zeros(4), {"m": w}],
                                       addresses=False)
    assert carry != tengine._signature([w.double(), {"m": w}],
                                       addresses=False)
    scalars = []
    staged = tengine._stage_scalars(a, scalars)
    assert staged[0].data is buf and len(scalars) == 2
    assert [int(x) for x in scalars] == [4, 2]
    for dst, src in zip(scalars, tengine._window_scalars(b)):
        dst.copy_(src)
    assert [int(staged[0].n_valid), int(staged[1].n_valid)] == [8, 4]
    assert [int(a[0].n_valid), int(a[1].n_valid)] == [4, 2]
