"""The port's multi-host runtime against the reference's, on the CPU: shard
ownership (both strategies), owned-shard reads, the stacked window's
growth and meters, the distributed dataset's views and the Hessian
subsample's rows index for index, the distributed objective against
``distributed_objective`` under JAX autodiff, a 4-host convex ``build``
run, the LM per-lane batches and a 4-host LM run, the validation errors,
the per-lane B1 launches, and ``ProcessTopology``/``ProcessCollectives``
at world size 1 over gloo."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro import dist as jdist
from repro.data import device_window as jdw
from repro.data import shards as jshards
from repro.data.window import synth_corpus
from repro.models import linear as jlin
from repro_torch import convert
from repro_torch import dist as tdist
from repro_torch.data import device_window as tdw
from repro_torch.data import plane as tplane
from repro_torch.data import shards as tshards
from repro_torch.kernels import ops

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

LAM = 1e-3
# float32 sums over at most a few hundred rows, in different orders by XLA
# and by PyTorch (tests/test_torch_linear.py's bounds)
RTOL, ATOL = 1e-5, 1e-6
# f̂ after tens of float32 Newton-CG steps, summation orders apart
# (tests/test_torch_engine.py's bound); the float32 reduced LM's
# (tests/test_torch_lm.py's)
RTOL_F = 1e-4
RTOL_F_LM = 2e-5
COLUMNS = ("step", "stage", "window", "time", "accesses")
RECORD_INTS = ("host", "window", "resident", "examples_loaded",
               "bytes_loaded", "examples_uploaded", "bytes_uploaded")
CPU = (torch.device("cpu"),)


def _problem(n=384, d=24, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    y[y == 0] = 1.0
    return X, y


def _stores(mod, arrays, shard):
    return [mod.InMemoryShardStore(a, shard) for a in arrays]


def _tdd(X, y, shard, hosts, cls=tdist.DistributedDataset, **kw):
    return cls(_stores(tshards, (X, y), shard),
               topology=tdist.SimulatedTopology(hosts, devices=CPU), **kw)


# ----------------------------------------------------------------- ownership
@pytest.mark.parametrize("strategy", ["striped", "blocked"])
def test_ownership_equals_the_reference(strategy):
    kw = dict(num_shards=7, num_hosts=3, shard_size=5, num_examples=33,
              strategy=strategy)
    j, t = jdist.ShardOwnership(**kw), tdist.ShardOwnership(**kw)
    for h in range(3):
        np.testing.assert_array_equal(t.owned_shards(h), j.owned_shards(h))
        np.testing.assert_array_equal(t.local_to_global(h),
                                      j.local_to_global(h))
        assert t.num_owned_examples(h) == j.num_owned_examples(h)
        assert [t.examples_in_prefix(h, n) for n in range(40)] == \
            [j.examples_in_prefix(h, n) for n in range(40)]
    assert [t.owner(s) for s in range(7)] == [j.owner(s) for s in range(7)]
    assert t.max_owned_examples == j.max_owned_examples
    assert t.min_full_participation_window() == \
        j.min_full_participation_window()
    X, _ = _problem(33, 2)
    hj, ht = j.partition((X,)), t.partition((X,), device="cpu")
    np.testing.assert_array_equal(ht.fields[0].numpy(),
                                  np.asarray(hj.fields[0]))
    assert list(ht.host_counts) == np.asarray(hj.counts).tolist()


@pytest.mark.parametrize("kw", [
    dict(num_shards=2, num_hosts=3, shard_size=4, num_examples=8),
    dict(num_shards=3, num_hosts=2, shard_size=4, num_examples=8),
    dict(num_shards=4, num_hosts=2, shard_size=4, num_examples=16,
         strategy="mystery"),
], ids=["hosts_over_shards", "shard_count", "strategy"])
def test_ownership_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as je:
        jdist.ShardOwnership(**kw)
    with pytest.raises(ValueError) as te:
        tdist.ShardOwnership(**kw)
    assert str(te.value) == str(je.value)


def test_elastic_reassign_equals_the_reference():
    store = np.zeros((128, 2), np.float32)
    j = jdist.ElasticOwnership.for_store(jshards.InMemoryShardStore(store, 8),
                                         4)
    t = tdist.ElasticOwnership.for_store(tshards.InMemoryShardStore(store, 8),
                                         4)
    assert t.reassign(1, 0, [9, 13], min_shard=6) == \
        j.reassign(1, 0, [9, 13], min_shard=6)
    for h in range(4):
        np.testing.assert_array_equal(t.owned_shards(h), j.owned_shards(h))
        assert [t.examples_in_prefix(h, n) for n in (0, 48, 100, 128)] == \
            [j.examples_in_prefix(h, n) for n in (0, 48, 100, 128)]
    for bad in ([1], [8], [1, 5, 9, 13]):
        with pytest.raises(ValueError) as je:
            j.reassign(1, 0, bad, min_shard=6 if bad != [1, 5, 9, 13] else 0)
        with pytest.raises(ValueError) as te:
            t.reassign(1, 0, bad, min_shard=6 if bad != [1, 5, 9, 13] else 0)
        assert str(te.value) == str(je.value)


def test_owned_store_reads_only_owned_shards():
    data = np.arange(66, dtype=np.float32).reshape(33, 2)
    inner = tshards.InMemoryShardStore(data, 5)
    reads = []
    orig = inner.load
    inner.load = lambda s: (reads.append(s), orig(s))[1]
    own = tdist.ShardOwnership.for_store(inner, 3)
    jown = jdist.ShardOwnership.for_store(
        jshards.InMemoryShardStore(data, 5), 3)
    for h in range(3):
        s = tdist.OwnedShardStore(inner, own, h)
        js = jdist.OwnedShardStore(jshards.InMemoryShardStore(data, 5),
                                   jown, h)
        assert s.num_examples == js.num_examples
        for j in range(s.num_shards):
            np.testing.assert_array_equal(s.load(j), js.load(j))
            assert s.global_shard(j) == js.global_shard(j)
    assert sorted(reads) == list(range(7))
    with pytest.raises(ValueError, match="does not match ownership"):
        tdist.OwnedShardStore(tshards.InMemoryShardStore(data, 4), own, 0)


# ------------------------------------------------------------ stacked window
def test_stacked_window_grows_in_place_and_meters_as_the_reference():
    meters = {m: tuple(m.DataAccessMeter() for _ in range(2))
              for m in (jshards, tshards)}
    jsw = jdw.StackedDeviceWindow(num_hosts=2, capacity=6, item_shape=(3,),
                                  dtype=np.float32, meters=meters[jshards])
    tsw = tdw.StackedDeviceWindow(num_hosts=2, capacity=6, item_shape=(3,),
                                  dtype=np.float32, meters=meters[tshards],
                                  device="cpu")
    buf = tsw.buffer
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    for sw in (jsw, tsw):
        sw.append(0, a)
        sw.append(1, 2 * a[:2])
        sw.append(1, 3 * a[:1])
    assert tsw.buffer is buf                       # grown in place
    np.testing.assert_array_equal(tsw.buffer.numpy(), np.asarray(jsw.buffer))
    assert tsw.counts.tolist() == jsw.counts.tolist() == [4, 3]
    assert tsw.next_size(1) == jsw.next_size(1)
    for jm, tm in zip(meters[jshards], meters[tshards]):
        assert tm.snapshot() == jm.snapshot()
    lane = tsw.lane(1)
    assert lane.n_valid == 3 and lane.buffer is buf
    assert tsw.cursor() == jsw.cursor() == {"counts": [4, 3]}
    for sw in (jsw, tsw):
        with pytest.raises(ValueError, match="overflows lane 0"):
            sw.append(0, np.ones((3, 3), np.float32))
        with pytest.raises(ValueError, match="item shape"):
            sw.append(1, np.ones((1, 2), np.float32))
        with pytest.raises(IndexError):
            sw.append(2, a)
    tsw.reset_lane(0)
    assert tsw.counts.tolist() == [0, 3] and not tsw.buffer[0].any()


def test_plane_appends_into_given_lanes():
    X, y = _problem(64, 3)
    sw = [tdw.StackedDeviceWindow(num_hosts=2, capacity=64,
                                  item_shape=a.shape[1:], dtype=a.dtype,
                                  device="cpu") for a in (X, y)]
    with tplane.StreamingDataset(_stores(tshards, (X, y), 16),
                                 windows=[w.lane(1) for w in sw]) as p:
        assert p.ensure_resident(20) == 32
    np.testing.assert_array_equal(sw[0].buffer[1, :32].numpy(), X[:32])
    assert sw[0].counts.tolist() == [0, 32]


# -------------------------------------------------------- distributed dataset
def test_distributed_views_equal_the_reference():
    X, y = _problem(96, 4)
    jdd = jdist.DistributedDataset(_stores(jshards, (X, y), 16), num_hosts=3)
    with jdd, _tdd(X, y, 16, 3) as tdd:
        for n_t in (16, 48, 80, 96):
            jh, th = jdd.window(n_t), tdd.window(n_t)
            assert isinstance(th, tdw.HostWindows)
            assert list(th.host_counts) == np.asarray(jh.counts).tolist()
            assert th.counts.tolist() == list(th.host_counts)
            for jf, tf in zip(jh.fields, th.fields):
                np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert [m.snapshot()["examples_loaded"] for m in tdd.host_meters] \
            == [m.examples_loaded for m in jdd.host_meters] \
            == [tdd.ownership.num_owned_examples(h) for h in range(3)]
        up = [m.bytes_uploaded for m in tdd.host_meters]
        tdd.window(96)                      # same window: nothing moves
        assert [m.bytes_uploaded for m in tdd.host_meters] == up
        assert tdd.host_stage_records(48) == [
            dict(r, blocked_time_s=t["blocked_time_s"]) for r, t in zip(
                jdd.host_stage_records(48), tdd.host_stage_records(48))]


@pytest.mark.parametrize("fraction", [0.1, 0.2, 0.5, 1.0])
def test_hessian_subsample_rows_are_the_references(fraction):
    lanes = np.arange(3 * 100 * 3, dtype=np.float32).reshape(3, 100, 3)
    counts = [40, 100, 0]
    jhw = jdw.HostWindows((jnp.asarray(lanes),),
                          jnp.asarray(counts, jnp.int32))
    thw = tdw.HostWindows((torch.from_numpy(lanes),), host_counts=counts)
    for t in range(7):
        js = jdw.rolling_subwindow(jhw, fraction, jnp.int32(t))
        # Newton-CG's step counter is a device int32 scalar
        ts = tdw.rolling_subwindow(thw, fraction,
                                   torch.tensor(t, dtype=torch.int32))
        assert list(ts.host_counts) == np.asarray(js.counts).tolist()
        # each lane's k rows from its device offset are the reference's
        # stacked rows, and lane() gathers the valid ones
        ref = np.asarray(js.fields[0])
        k = ref.shape[1]
        offsets = [int(o) for o in ts.offsets]
        for h, (off, m) in enumerate(zip(offsets, ts.host_counts)):
            np.testing.assert_array_equal(lanes[h, off:off + k], ref[h])
            np.testing.assert_array_equal(ts.lane(h)[0].numpy(), ref[h, :m])


def test_subsample_counts_round_in_float32_half_to_even():
    # 0.1 in float32 times 5 is just above 0.5: jnp.round gives 1 row
    # where float64 would give 0
    thw = tdw.HostWindows((torch.zeros(1, 50, 2),), host_counts=[5])
    jhw = jdw.HostWindows((jnp.zeros((1, 50, 2)),), jnp.asarray([5]))
    assert tdw.rolling_subwindow(thw, 0.1, 0).host_counts == (1,) == \
        tuple(np.asarray(jdw.rolling_subwindow(jhw, 0.1, 0).counts))


# ----------------------------------------------------------------- objective
@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
def test_distributed_objective_matches_autodiff(loss):
    X, y = _problem(128, 8, seed=3)
    rng = np.random.default_rng(4)
    w = (0.5 * rng.standard_normal(8)).astype(np.float32)
    v = rng.standard_normal(8).astype(np.float32)
    kw = dict(num_shards=8, num_hosts=3, shard_size=16, num_examples=128)
    jhw = jdist.ShardOwnership(**kw).partition((X, y))
    thw = tdist.ShardOwnership(**kw).partition((X, y), device="cpu")
    jobj = jdist.distributed_objective(jlin.make_example_losses(loss),
                                       regularizer=jdist.l2_regularizer(LAM))
    jw, jv = jnp.asarray(w), jnp.asarray(v)
    jf, jg = jax.value_and_grad(jobj)(jw, jhw)
    jhv = jax.jvp(lambda u: jax.grad(jobj)(u, jhw), (jw,), (jv,))[1]
    tobj = tdist.DistributedObjective(loss, LAM)
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    tf, tg = tobj.value_and_grad(tw, thw)
    np.testing.assert_allclose(float(tobj(tw, thw)), float(jf), rtol=RTOL)
    np.testing.assert_allclose(float(tf), float(jf), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=ATOL)
    np.testing.assert_allclose(tobj.hvp(tw, thw, tv).numpy(),
                               np.asarray(jhv), rtol=1e-4, atol=ATOL)
    W = torch.stack([tw, 0.5 * tw, tv], dim=1)
    vals = tobj.values(W, thw)
    for k in range(3):
        np.testing.assert_allclose(float(vals[k]),
                                   float(jobj(jnp.asarray(W[:, k].numpy()),
                                              jhw)), rtol=RTOL)
    # a host-resident eval set is one lane: the single-host objective
    plain = (torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(float(tobj(tw, plain)),
                               float(jobj(jw, (jnp.asarray(X),
                                               jnp.asarray(y)))), rtol=RTOL)


@pytest.mark.parametrize("fraction", [0.2, 0.5])
def test_hvp_on_the_lane_subsample_matches_autodiff(fraction):
    # the subsample's lanes are offset views of the window (no copy): the
    # Hessian-vector product over them is the reference's over its masked
    # stacked subsample
    X, y = _problem(128, 8, seed=5)
    rng = np.random.default_rng(6)
    w, v = (rng.standard_normal((2, 8)) * 0.5).astype(np.float32)
    kw = dict(num_shards=8, num_hosts=3, shard_size=16, num_examples=128)
    jobj = jdist.distributed_objective(
        jlin.make_example_losses("squared_hinge"),
        regularizer=jdist.l2_regularizer(LAM))
    tobj = tdist.DistributedObjective("squared_hinge", LAM)
    jhw = jdist.ShardOwnership(**kw).partition((X, y))
    thw = tdist.ShardOwnership(**kw).partition((X, y), device="cpu")
    for t in range(3):
        jsub = jdw.rolling_subwindow(jhw, fraction, jnp.int32(t))
        tsub = tdw.rolling_subwindow(thw, fraction, t)
        jhv = jax.jvp(lambda u: jax.grad(jobj)(u, jsub),
                      (jnp.asarray(w),), (jnp.asarray(v),))[1]
        np.testing.assert_allclose(
            tobj.hvp(torch.from_numpy(w), tsub, torch.from_numpy(v)).numpy(),
            np.asarray(jhv), rtol=1e-4, atol=ATOL)
    # the offset lanes have no device counts: a row gather cannot misread
    with pytest.raises(ValueError, match="lane"):
        tdw.rotation_rows(tsub, 6, 0)


def test_value_and_grad_launches_b1_once_per_non_empty_lane(monkeypatch):
    """The per-lane B1 calls, summed, equal one call on the concatenated
    valid rows to float32 rounding; an empty lane is never launched."""
    X, y = _problem(96, 5, seed=6)
    own = tdist.ShardOwnership(num_shards=6, num_hosts=4, shard_size=16,
                               num_examples=96)
    rows = []
    orig = ops.linear_value_grad
    monkeypatch.setattr(ops, "linear_value_grad",
                        lambda X, y, w, **kw: (rows.append(len(X)),
                                               orig(X, y, w, **kw))[1])
    with _tdd(X, y, 16, 4, ownership=own) as dd:
        hw = dd.window(32)                  # lanes 2 and 3 are empty
        assert hw.host_counts == (16, 16, 0, 0)
        w = torch.full((5,), 0.1)
        obj = tdist.DistributedObjective("logistic", LAM)
        f, g = obj.value_and_grad(w, hw)
    assert rows == [16, 16]
    L1, g1 = orig(torch.from_numpy(X[:32]), torch.from_numpy(y[:32]), w,
                  loss="logistic")
    np.testing.assert_allclose(float(f), float(L1) / 32
                               + 0.5 * LAM * float(w @ w), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), (g1 / 32 + LAM * w).numpy(),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- build, convex
def _convex_spec(api, policy="two_track", hosts=4, **kw):
    params = {"two_track": {"final_steps": 5, "max_stage_iters": 12},
              "fixed_steps": {"inner_steps": 3, "final_steps": 5}}[policy]
    return api.RunSpec(
        data=api.DataSpec(dataset="w8a_like", scale=0.05, lam=LAM,
                          plane="plane", shard_size=32),
        policy=api.PolicySpec(policy, params),
        optimizer=api.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=api.ScheduleSpec(n0=64, clock={"p": 10.0, "a": 1.0,
                                                "s": 5.0}),
        topology=api.TopologySpec(hosts=hosts), **kw)


@pytest.mark.parametrize("policy", ["fixed_steps", "two_track"])
def test_four_host_convex_build_matches_the_reference(policy):
    spec = _convex_spec(R, policy)
    ref = R.build(spec).run()
    sess = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
    assert isinstance(sess.dataset, tdist.DistributedDataset)
    assert isinstance(sess.engine, tdist.DistributedBetEngine)
    tr = sess.run()
    for col in COLUMNS:
        assert tr.column(col) == ref.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(tr.column(col), ref.column(col),
                                   rtol=RTOL_F)
    mine, theirs = (t.meta["host_stage_records"] for t in (tr, ref))
    assert [(r["stage"], r["n_t"]) for r in mine] == \
        [(r["stage"], r["n_t"]) for r in theirs]
    for a, b in zip(mine, theirs):
        assert [{k: h[k] for k in RECORD_INTS} for h in a["hosts"]] == \
            [{k: h[k] for k in RECORD_INTS} for h in b["hosts"]]
    for key in ("examples_loaded", "bytes_uploaded", "examples_accessed"):
        assert tr.meta["dist"]["meter"][key] == ref.meta["dist"]["meter"][key]
        assert {h: m[key] for h, m in tr.meta["data_plane_hosts"].items()} \
            == {h: m[key] for h, m in ref.meta["data_plane_hosts"].items()}
    assert tr.meta["dist"]["topology"]["num_hosts"] == 4
    assert sess.meters["hosts"][0]["examples_loaded"] == \
        sess.dataset.ownership.num_owned_examples(0)


def test_distributed_and_single_host_runs_agree_to_rounding():
    """At hessian_fraction 1 the subsample is the identity on both layouts,
    so the lanes' re-associated sums are the only difference (the
    reference benchmark's bound, rel 1e-3)."""
    spec = _convex_spec(P, "fixed_steps").replace(
        optimizer=P.OptimizerSpec("newton_cg", {"hessian_fraction": 1.0}))
    dist_tr = P.build(spec, device="cpu").run()
    one = P.build(spec.replace(topology=P.TopologySpec()), device="cpu").run()
    for col in COLUMNS:
        assert dist_tr.column(col) == one.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(dist_tr.column(col), one.column(col),
                                   rtol=1e-3)
    assert dist_tr.meta["host_transfers"] == one.meta["host_transfers"]


# -------------------------------------------------------------- LM path
def test_lm_per_lane_batches_are_the_references_token_for_token():
    corpus = synth_corpus(48, 9, 97, seed=2)
    jdd = jdist.DistributedDataset(_stores(jshards, (corpus,), 4),
                                   num_hosts=4)
    with jdd, tdist.DistributedDataset(
            _stores(tshards, (corpus,), 4),
            topology=tdist.SimulatedTopology(4, devices=CPU)) as tdd:
        for n_t in (16, 24, 48):
            jh, th = jdd.window(n_t), tdd.window(n_t)
            for t in range(5):
                np.testing.assert_array_equal(
                    tdw.rotation_rows(th, 8, torch.tensor(t)).numpy(),
                    np.asarray(jdw.rotation_rows(jh, 8, jnp.int32(t))))
                np.testing.assert_array_equal(
                    tdist.rotation_batch(th, 3, t).numpy(),
                    np.asarray(jdist.rotation_batch(jh, 3, jnp.int32(t))))
            for rows in (5, 8, 13):
                np.testing.assert_array_equal(
                    tdist.probe_rows(th, rows).numpy(),
                    np.asarray(jdist.probe_rows(jh, rows)))


def _lm_spec(api, **kw):
    return api.RunSpec(
        data=api.DataSpec(kind="lm", corpus_size=32, seq_len=16, eval_rows=8,
                          plane="plane", shard_size=8),
        model=api.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                            overrides={"dtype": "float32"}),
        optimizer=api.OptimizerSpec("adamw_lm", {"lr": 1e-3,
                                                 "batch_size": 4}),
        policy=api.PolicySpec("fixed_steps", {"inner_steps": 2,
                                              "final_steps": 2}),
        schedule=api.ScheduleSpec(n0=8, step_cost="batch",
                                  wait_on_expand=True, carry_state=True,
                                  clock={"preloaded": 8}),
        topology=api.TopologySpec(hosts=4), **kw)


def test_four_host_lm_build_matches_the_reference():
    """The reduced falcon-mamba-7b (float32) over 4 hosts, one row a lane a
    step, from the reference's parameters: every column equal, f̂ within
    the LM bound, the shard clamped to n0 // hosts so every lane serves
    from the first stage."""
    spec = _lm_spec(R)
    ref_sess = R.build(spec)
    ref = ref_sess.run()
    sess = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
    assert sess.dataset.ownership.shard_size == 2
    assert isinstance(sess.engine, P.session.ElasticBetEngine)
    sess.w0 = convert.params_from_jax(jax.device_get(ref_sess.w0), "cpu")
    tr = sess.run()
    for col in COLUMNS:
        assert tr.column(col) == ref.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(tr.column(col), ref.column(col),
                                   rtol=RTOL_F_LM)
    assert [m["examples_loaded"] for m in tr.meta["data_plane_hosts"].values()
            ] == [8, 8, 8, 8]
    assert all(min(h["window"] for h in r["hosts"]) >= 1
               for r in tr.meta["host_stage_records"])


# ---------------------------------------------------------------- validation
@pytest.mark.parametrize("change", [
    dict(topology={"hosts": 2}),
    dict(topology={"hosts": 2}, data={"plane": "plane"},
         policy={"name": "gradient_variance"}),
    dict(elastic={"faults": ["kill@1:0"]}),
    dict(elastic={"faults": ["kill@1:5"]}, topology={"hosts": 2},
         data={"plane": "plane"}),
    dict(elastic={"faults": ["explode@1:0"]}),
    dict(elastic={"straggler_deadline_s": 0.1}),
    dict(elastic={"capacity_slack": 0.5}, topology={"hosts": 2},
         data={"plane": "plane"}),
    dict(topology={"hosts": 0}),
    dict(topology={"hosts": 2, "kind": "mesh"}, data={"plane": "plane"}),
], ids=["host_path", "variance", "kill_one_host", "kill_unknown_host",
        "fault_grammar", "deadline_one_host", "slack", "no_hosts",
        "topology_kind"])
def test_convex_validation_errors_equal_the_references(change):
    d = _convex_spec(R, hosts=1).to_dict()
    for key, sub in change.items():
        d[key] = dict(d[key], **sub)
    d["data"]["plane"] = change.get("data", {}).get("plane", "host")
    with pytest.raises(ValueError) as je:
        R.build(d)
    with pytest.raises(ValueError) as te:
        P.build(d, device="cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("change", [
    dict(optimizer={"params": {"batch_size": 5}}),
    dict(schedule={"n0": 3}),
    dict(data={"plane": "host"}),
    dict(policy={"name": "gradient_variance"}),
], ids=["batch_split", "n0_below_hosts", "host_path", "variance"])
def test_lm_validation_errors_equal_the_references(change):
    d = _lm_spec(R).to_dict()
    for key, sub in change.items():
        d[key] = dict(d[key], **sub)
    if change.get("policy"):
        d["topology"]["hosts"] = 1
    with pytest.raises(ValueError) as je:
        R.build(d)
    with pytest.raises(ValueError) as te:
        P.build(d, device="cpu")
    assert str(te.value) == str(je.value)


def test_variance_policies_stay_refused_on_host_windows():
    X, y = _problem(96, 4)
    with _tdd(X, y, 16, 2) as dd:
        with pytest.raises(NotImplementedError, match="SPMD"):
            tdist.DistributedBetEngine().run(
                dd, P.build_optimizer(P.OptimizerSpec("newton_cg")),
                tdist.DistributedObjective(lam=LAM),
                P.build_policy(P.PolicySpec("gradient_variance")),
                w0=torch.zeros(4), eval_data=tuple(map(torch.from_numpy,
                                                       (X, y))))


# ---------------------------------------------------------------- topology
def test_simulated_topology_places_every_lane():
    topo = tdist.SimulatedTopology(4, devices=CPU)
    assert topo.num_hosts == 4 and topo.local_hosts == (0, 1, 2, 3)
    assert all(topo.devices_for(h) == CPU for h in range(4))
    assert topo.window_device() == CPU[0]
    assert topo.describe()["devices"][3] == ["cpu"]
    two = tdist.SimulatedTopology(2, devices=("cpu",) * 4)
    assert len(two.devices_for(1)) == 2
    # the grouping places nothing: every lane is on the window's device
    assert two.describe()["devices"] == {0: ["cpu"], 1: ["cpu"]}
    with pytest.raises(ValueError):
        tdist.SimulatedTopology(0, devices=CPU)
    with pytest.raises(IndexError):
        topo.devices_for(4)


@pytest.fixture
def gloo_world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_process_topology_and_collectives_at_world_size_one(
        gloo_world_of_one):
    topo = tdist.ProcessTopology(device="cpu")
    assert topo.num_hosts == 1 and topo.local_hosts == (0,)
    with pytest.raises(ValueError, match="remote"):
        topo.devices_for(1)
    comm = tdist.ProcessCollectives()
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])]
    assert comm.psum(parts, 1).tolist() == [4.0, 6.0]     # all_reduce ran
    assert comm.all_gather_records([{"host": 0}]) == [{"host": 0}]
    X, y = _problem(96, 4)
    with tdist.DistributedDataset(_stores(tshards, (X, y), 16),
                                  topology=topo) as pd, \
            _tdd(X, y, 16, 1) as sd:
        for n_t in (16, 50, 96):
            a, b = pd.window(n_t), sd.window(n_t)
            assert a.host_counts == b.host_counts
            for fa, fb in zip(a.fields, b.fields):
                assert torch.equal(fa, fb)
        w = torch.full((4,), 0.2)
        f1, g1 = tdist.DistributedObjective(lam=LAM, comm=comm) \
            .value_and_grad(w, pd.window(96))
        f2, g2 = tdist.DistributedObjective(lam=LAM).value_and_grad(
            w, sd.window(96))
        assert torch.equal(f1, f2) and torch.equal(g1, g2)
        assert P.session._make_topology(
            P.RunSpec(topology=P.TopologySpec(kind="process")),
            torch.device("cpu")).num_hosts == 1
