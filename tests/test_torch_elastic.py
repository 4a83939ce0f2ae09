"""The port's elastic runtime against the reference's, on the CPU: fault
plans, host loss and rejoin (their counters and the rebuilt lane's rows),
a kill mid-run bit for bit the unfaulted run (convex and the reduced
mamba LM), the straggler rebalance driven deterministically (loads held by
gates, the read pace set on the meters), distributed kill-and-resume
within the port, ``"distributed"`` stage checkpoints that cross between
the packages both ways, and the restore's refusals."""
import threading

import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro import elastic as jel
from repro.data import shards as jshards
from repro_torch import dist as tdist
from repro_torch import elastic as tel
from repro_torch.core.engine import FixedSteps
from repro_torch.data import shards as tshards
from repro_torch.elastic import checkpoint as tstage
from repro_torch.optim.api import tree_leaves

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores; the CPU's LM backward repeats its bits
# only on one thread
torch.set_num_threads(1)

LAM = 1e-3
# f̂ across packages (tests/test_torch_engine.py's bound)
RTOL_F = 1e-4
COLUMNS = ("step", "stage", "window", "time", "accesses")
CPU = (torch.device("cpu"),)
TIMEOUT_S = 30


def _problem(n=384, d=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    y[y == 0] = 1.0
    return X, y


def _jdd(X, y, shard, hosts, **kw):
    return jel.ElasticDataset([jshards.InMemoryShardStore(X, shard),
                               jshards.InMemoryShardStore(y, shard)],
                              num_hosts=hosts, **kw)


def _tdd(X, y, shard, hosts, stores=None, **kw):
    stores = stores or [tshards.InMemoryShardStore(X, shard),
                        tshards.InMemoryShardStore(y, shard)]
    return tel.ElasticDataset(
        stores, topology=tdist.SimulatedTopology(hosts, devices=CPU), **kw)


def _lanes(hw):
    return [hw.fields[0][h, :m].numpy() for h, m in enumerate(hw.host_counts)]


# ------------------------------------------------------------------ fault plan
def test_fault_plans_parse_as_the_references():
    specs = ["kill@2:1", "slow@1:3=0.02", "rejoin@4:1"]
    j, t = jel.FaultPlan.parse(specs), tel.FaultPlan.parse(specs)
    assert [vars(e) for e in t.events] == [vars(e) for e in j.events]
    assert t.at(2) == tuple(tel.FaultEvent(**vars(e)) for e in j.at(2))
    assert not t.at(3) and bool(t) and not tel.FaultPlan()
    for bad in (["explode@1:0"], ["kill@nonsense"], ["slow@1:2=x"]):
        with pytest.raises(ValueError) as je:
            jel.FaultPlan.parse(bad)
        with pytest.raises(ValueError) as te:
            tel.FaultPlan.parse(bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="stage must be"):
        tel.FaultEvent(stage=-1, kind="kill", host=0)


# ------------------------------------------------------------------ host loss
def test_lose_host_counters_and_rebuilt_lane_equal_the_references():
    X, y = _problem(96, 4)
    with _jdd(X, y, 16, 3) as jdd, _tdd(X, y, 16, 3) as tdd:
        jdd.window(64)
        tdd.window(64)
        loads = [m.examples_loaded for m in tdd.host_meters]
        ups = [m.bytes_uploaded for m in tdd.host_meters]
        jrec, trec = jdd.lose_host(1, n_t=64), tdd.lose_host(1, n_t=64)
        assert trec == jrec
        assert trec["lanes"][0]["reread_examples"] == \
            tdd.ownership.examples_in_prefix(1, 64)
        after = [m.examples_loaded for m in tdd.host_meters]
        for h in (0, 2):                        # survivors: untouched
            assert after[h] == loads[h]
            assert tdd.host_meters[h].bytes_uploaded == ups[h]
        ref = tdd.ownership.partition((X, y), device="cpu")
        for n_t in (64, 96):                    # rebuilt, then appended to
            hw = tdd.window(n_t)
            jhw = jdd.window(n_t)
            for got, m, full in zip(_lanes(hw), hw.host_counts,
                                    ref.fields[0]):
                np.testing.assert_array_equal(got, full[:m].numpy())
            np.testing.assert_array_equal(hw.fields[0].numpy(),
                                          np.asarray(jhw.fields[0]))
        assert tdd.assignment == jdd.assignment and tdd.alive == jdd.alive
        with pytest.raises(ValueError, match="not alive"):
            tdd.lose_host(1, n_t=96)


def test_lose_the_last_host_and_rejoin_as_the_reference():
    X, y = _problem(96, 4)
    with _jdd(X, y, 16, 3) as jdd, _tdd(X, y, 16, 3) as tdd:
        for dd in (jdd, tdd):
            dd.window(96)
            dd.lose_host(2, n_t=96)
        loads = [m.examples_loaded for m in tdd.host_meters]
        assert tdd.rejoin_host(2) == jdd.rejoin_host(2)
        assert tdd.assignment[2] == 2 and 2 in tdd.alive
        assert [m.examples_loaded for m in tdd.host_meters] == loads
        assert tdd.slow_host(0, 0.5) == jdd.slow_host(0, 0.5)
        assert tdd.elastic_state() == jdd.elastic_state()
        with pytest.raises(ValueError, match="already alive"):
            tdd.rejoin_host(2)
    with _tdd(X, y, 16, 2) as tdd:
        tdd.window(32)
        tdd.lose_host(0, n_t=32)
        with pytest.raises(RuntimeError, match="last alive"):
            tdd.lose_host(1, n_t=32)


def _convex_spec(api, *, policy="fixed_steps", **kw):
    params = {"fixed_steps": {"inner_steps": 2, "final_steps": 4},
              "two_track": {"final_steps": 4, "max_stage_iters": 10}}[policy]
    return api.RunSpec(
        data=api.DataSpec(dataset="w8a_like", scale=0.05, lam=LAM,
                          plane="plane", shard_size=32),
        policy=api.PolicySpec(policy, params),
        optimizer=api.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=api.ScheduleSpec(n0=64),
        topology=api.TopologySpec(hosts=4), **kw)


@pytest.mark.parametrize("policy", ["fixed_steps", "two_track"])
def test_kill_mid_run_is_bitwise_the_unfaulted_run(policy):
    """A killed host's lane, rebuilt from storage, holds the bits it held,
    so the run goes on as if nothing happened; the event matches the
    reference's."""
    spec = _convex_spec(P, policy=policy, elastic=P.ElasticSpec(enabled=True))
    whole = P.build(spec, device="cpu").run()
    faulted = spec.replace(elastic=P.ElasticSpec(faults=("kill@1:2",)))
    sess = P.build(faulted, device="cpu")
    tr = sess.run()
    for col in COLUMNS + ("f_window", "f_full"):
        assert tr.column(col) == whole.column(col), col
    assert torch.equal(tr.params, whole.params)
    assert 2 not in sess.dataset.alive
    (kill,) = [e for grp in tr.meta["elastic_events"] for e in grp["events"]]
    lane = kill["lanes"][0]
    assert lane["lane"] == 2 and lane["reread_examples"] == lane["window"]
    assert tr.meta["dist"]["elastic"]["alive"] == [0, 1, 3]
    ref = R.build(_convex_spec(R, policy=policy, elastic=R.ElasticSpec(
        faults=("kill@1:2",)))).run()
    assert tr.meta["elastic_events"] == ref.meta["elastic_events"]


def test_lm_kill_mid_run_is_bitwise_the_unfaulted_run():
    spec = P.RunSpec(
        data=P.DataSpec(kind="lm", corpus_size=32, seq_len=16, eval_rows=8,
                        plane="plane", shard_size=8),
        model=P.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=P.OptimizerSpec("adamw_lm", {"lr": 1e-3, "batch_size": 4}),
        policy=P.PolicySpec("fixed_steps", {"inner_steps": 2,
                                            "final_steps": 2}),
        schedule=P.ScheduleSpec(n0=8, step_cost="batch", wait_on_expand=True,
                                carry_state=True, clock={"preloaded": 8}),
        topology=P.TopologySpec(hosts=4))
    whole = P.build(spec, device="cpu").run()
    tr = P.build(spec.replace(elastic=P.ElasticSpec(faults=("kill@0:1",))),
                 device="cpu").run()
    for col in COLUMNS + ("f_window", "f_full"):
        assert tr.column(col) == whole.column(col), col
    for a, b in zip(tree_leaves(tr.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    (kill,) = tr.meta["elastic_events"][0]["events"]
    assert kill["lanes"][0]["reread_examples"] == 2


def test_faults_need_an_elastic_dataset():
    X, y = _problem(96, 4)
    with tdist.DistributedDataset(
            [tshards.InMemoryShardStore(X, 16),
             tshards.InMemoryShardStore(y, 16)],
            topology=tdist.SimulatedTopology(2, devices=CPU)) as dd:
        engine = tel.ElasticBetEngine(
            faults=tel.FaultPlan.parse(["kill@0:1"]))
        with pytest.raises(TypeError, match="ElasticDataset"):
            engine.run(dd, P.build_optimizer(P.OptimizerSpec("newton_cg")),
                       tdist.DistributedObjective(lam=LAM),
                       FixedSteps(inner_steps=1, final_steps=1),
                       w0=torch.zeros(4),
                       eval_data=tuple(map(torch.from_numpy, (X, y))))


# ------------------------------------------------------------------ straggler
class _Gated:
    """Mixin: loads of the global shards in ``gated`` wait on one event."""

    def __init__(self, data, shard_size, gated=()):
        super().__init__(data, shard_size)
        self.gated, self.gate = set(gated), threading.Event()

    def load(self, shard):
        if shard in self.gated:
            assert self.gate.wait(TIMEOUT_S)
        return super().load(shard)


class JGated(_Gated, jshards.InMemoryShardStore):
    pass


class TGated(_Gated, tshards.InMemoryShardStore):
    pass


def _straggle(dd, store):
    """Lane 1's loads for the next window are held, and its measured pace
    set to 0.3 s a shard (lane 0's to 1 ms): the deadline flush must move
    its backlog to the fastest lane."""
    dd.begin_stage(64, 192)
    for h, pace in ((0, 1e-3), (1, 0.3)):
        m = dd.host_meters[h]
        m.load_time_s = pace * m.loads
    moves = dd.rebalance_stragglers(64, 192, deadline_s=0.01)
    store.gate.set()
    return moves


def test_rebalance_moves_the_backlog_as_the_reference():
    X, y = _problem(256, 4, seed=3)
    # host 1 owns the odd shards; those of the next window (192) beyond the
    # resident one (64) are held
    held = {5, 7, 9, 11}
    js, ts = JGated(X, 16, held), TGated(X, 16, held)
    with jel.ElasticDataset([js, jshards.InMemoryShardStore(y, 16)],
                            num_hosts=2, capacity_slack=2.0) as jdd, \
            _tdd(X, y, 16, 2, capacity_slack=2.0,
                 stores=[ts, tshards.InMemoryShardStore(y, 16)]) as tdd:
        jmoves, tmoves = _straggle(jdd, js), _straggle(tdd, ts)
        assert tmoves == jmoves
        assert tmoves and tmoves[0]["from_lane"] == 1 \
            and tmoves[0]["to_lane"] == 0
        assert all(s >= 4 for s in tmoves[0]["shards"])
        hw = tdd.window(256)
        assert sum(hw.host_counts) == 256
        full = tdd.ownership.partition((X, y), device="cpu")
        for got, m, lane in zip(_lanes(hw), hw.host_counts, full.fields[0]):
            np.testing.assert_array_equal(got, lane[:m].numpy())
        np.testing.assert_array_equal(
            hw.fields[0].numpy(), np.asarray(jdd.window(256).fields[0]))
        assert sum(m.examples_loaded for m in tdd.host_meters) == 256
        assert tdd.ownership.num_owned_examples(0) > 128
        assert tdd.elastic_state() == jdd.elastic_state()


def test_rebalance_is_a_no_op_without_backlog_or_pressure():
    X, y = _problem(128, 4)
    with _tdd(X, y, 16, 2) as dd:
        dd.window(128)
        assert dd.rebalance_stragglers(128, None, 0.01) == []
        assert dd.rebalance_stragglers(64, 128, 1e9) == []


# ----------------------------------------------------------- kill-and-resume
class _Killed(Exception):
    pass


def _killed_run(api, spec, kill_stage, **kw):
    sess = api.build(spec, **kw)

    def die(end):
        if end.info.stage == kill_stage:
            raise _Killed

    sess.on_stage(die)
    with pytest.raises(_Killed):
        sess.run()


def _stitch(resumed, trace, col):
    return [p[col] for p in resumed.restored.trace_points()] + \
        trace.column(col)


def test_distributed_kill_and_resume_is_bitwise(tmp_path):
    base = _convex_spec(P, policy="two_track",
                        elastic=P.ElasticSpec(enabled=True))
    whole = P.build(base, device="cpu").run()
    spec = base.replace(checkpoint=P.CheckpointSpec(directory=str(tmp_path)))
    _killed_run(P, spec, 2, device="cpu")
    assert sorted(p.name for p in tmp_path.glob("stage_0002*")) == [
        "stage_0002.json", "stage_0002.npz"] + [
        f"stage_0002_lane{h:02d}.json" for h in range(4)]
    resumed = P.resume_session(tmp_path, device="cpu")
    tr = resumed.run()
    assert tr.meta["resumed_from_stage"] == 2
    for col in COLUMNS + ("f_window", "f_full"):
        assert _stitch(resumed, tr, col) == whole.column(col), col
    assert torch.equal(tr.params, whole.params)
    assert tr.meta["resume_rewarm"]["examples_loaded"] == resumed.restored.n_t
    for key in ("examples_loaded", "examples_uploaded", "examples_accessed"):
        assert tr.meta["data_plane"][key] == whole.meta["data_plane"][key]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_distributed_checkpoint_crosses_packages(tmp_path, writer):
    spec = _convex_spec(R, elastic=R.ElasticSpec(enabled=True),
                        checkpoint=R.CheckpointSpec(directory=str(tmp_path)))
    whole = R.build(spec.replace(checkpoint=R.CheckpointSpec())).run()
    if writer == "reference":
        _killed_run(R, spec, 1)
        resumed = P.resume_session(tmp_path, device="cpu")
    else:
        _killed_run(P, P.RunSpec.from_json(spec.to_json()), 1, device="cpu")
        resumed = R.resume_session(tmp_path)
    assert len(list(tmp_path.glob("stage_0001_lane*.json"))) == 4
    tr = resumed.run()
    assert tr.meta["resumed_from_stage"] == 1
    for col in COLUMNS:
        assert _stitch(resumed, tr, col) == whole.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(_stitch(resumed, tr, col),
                                   whole.column(col), rtol=RTOL_F)
    assert tr.meta["data_plane_hosts"][0]["examples_loaded"] == \
        whole.meta["data_plane_hosts"][0]["examples_loaded"]
    assert tr.meta["resume_rewarm"]["examples_loaded"] == 128


def test_restore_keeps_ownership_deltas_and_refuses_mismatches():
    X, y = _problem(256, 4, seed=3)
    ts = TGated(X, 16, {5, 7, 9, 11})
    with _tdd(X, y, 16, 2, capacity_slack=2.0,
              stores=[ts, tshards.InMemoryShardStore(y, 16)]) as dd:
        assert _straggle(dd, ts)
        dd.window(192)
        state = tstage.dataset_state(dd)
        ref = dd.window(192)
    with _tdd(X, y, 16, 2, capacity_slack=2.0) as dd2:
        tstage.restore_dataset(dd2, state, 192)
        assert dd2.ownership.owned_shards(0).tolist() == \
            state["elastic"]["owned_shards"][0]
        hw = dd2.window(192)
        assert hw.host_counts == ref.host_counts
        assert torch.equal(hw.fields[0], ref.fields[0])
        assert [m.examples_loaded for m in dd2.host_meters] == \
            [s["examples_loaded"] for s in state["host_meters"]]
    with _tdd(X, y, 16, 2) as dd3:
        with pytest.raises(ValueError, match="capacity_slack"):
            tstage.restore_dataset(dd3, state, 192)
    with P.build(_convex_spec(P).replace(topology=P.TopologySpec()),
                 device="cpu").dataset as plane:
        with pytest.raises(ValueError, match="'distributed' dataset"):
            tstage.restore_dataset(plane, state, 192)
