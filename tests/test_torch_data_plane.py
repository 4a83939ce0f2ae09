"""The port's streaming data plane against the reference's, on the CPU:
shard stores that cross packages on disk, the device window's prefix and
upload accounting, the ``MaskedWindow`` views, the construction errors,
the prefetcher's failure and cancellation contract, and the engine and
``build(RunSpec)`` on the plane — against the reference's plane at the
engine tests' tolerance, and bit-exact against the port's own host path.

Threads are ordered by ``threading.Event``s, never by sleeps: no assertion
here depends on how long anything takes."""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro.data import device_window as jdw
from repro.data import plane as jplane
from repro.data import prefetch as jprefetch
from repro.data import shards as jshards
from repro.data.window import synth_corpus
from repro_torch.data import device_window as tdw
from repro_torch.data import plane as tplane
from repro_torch.data import prefetch as tprefetch
from repro_torch.data import shards as tshards

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# f̂ after up to ~40 float32 Newton-CG steps, summation orders apart (the
# engine tests' bound, tests/test_torch_engine.py)
RTOL_F = 1e-4
# the meter's counters that do not depend on timing
METER_INTS = ("bytes_loaded", "examples_loaded", "loads", "prefetched_loads",
              "bytes_uploaded", "examples_uploaded", "uploads",
              "examples_accessed")
TIMEOUT_S = 30


def _plane(corpus, shard, **kw):
    return tplane.StreamingDataset.from_arrays(corpus, shard_size=shard,
                                               device="cpu", **kw)


# ------------------------------------------------------------------- storage
@pytest.mark.parametrize("writer,reader", [(jshards, tshards),
                                           (tshards, jshards)],
                         ids=["reference_to_port", "port_to_reference"])
def test_memmap_store_crosses_packages(tmp_path, writer, reader):
    corpus = synth_corpus(100, 8, 97, seed=3)
    writer.MemmapShardStore.write(corpus, str(tmp_path / "c"), shard_size=32)
    store = reader.MemmapShardStore.open(str(tmp_path / "c"))
    assert store.num_shards == 4 and store.examples_in(3) == 4
    assert store.item_shape == (8,) and store.dtype == corpus.dtype
    back = np.concatenate([store.load(i) for i in range(4)])
    np.testing.assert_array_equal(back, corpus)
    # and the layout is one file per shard plus the same meta.json
    reader.MemmapShardStore.write(corpus, str(tmp_path / "d"), shard_size=32)
    names = lambda d: sorted(p.name for p in (tmp_path / d).iterdir())
    assert names("c") == names("d")
    assert json.loads((tmp_path / "c" / "meta.json").read_text()) == \
        json.loads((tmp_path / "d" / "meta.json").read_text())


def test_memmap_store_names_a_truncated_shard(tmp_path):
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    tshards.MemmapShardStore.write(data, str(tmp_path), 4)
    (tmp_path / "shard_00001.npy").write_bytes(b"\x93NUMPY")
    with pytest.raises(tshards.ShardLoadError) as e:
        tshards.MemmapShardStore.open(str(tmp_path))
    assert e.value.shard == 1


# ----------------------------------------------------- device-window growth
def test_device_window_prefix_monotone_and_bit_exact():
    """Grown windows are nested prefixes of the permutation, bit-exact
    against the host corpus at every size; a view taken before a later
    append keeps its rows and values."""
    corpus = synth_corpus(64, 8, 97, seed=1)
    with _plane(corpus, 16, masked=True) as plane:
        prev, early = 0, None
        for n_t in (16, 24, 48, 64):
            rows, n_valid = tdw.window_rows(plane.window(n_t))
            assert int(n_valid) == n_t
            np.testing.assert_array_equal(rows[: plane.resident].numpy(),
                                          corpus[: plane.resident])
            assert plane.resident >= n_t >= prev
            prev = n_t
            if early is None:
                early = plane.windows[0].slice(16)
                early_copy = early.clone()
        assert plane.resident == 64
        assert early.data_ptr() == plane.windows[0].buffer.data_ptr()
        assert torch.equal(early, early_copy)


def test_convex_plane_views_match_numpy_slices():
    X = np.random.default_rng(0).standard_normal((50, 6)).astype(np.float32)
    y = np.sign(X[:, 0]).astype(np.float32)
    with _plane((X, y), 13) as plane:
        for n_t in (13, 26, 50):
            Xv, yv = plane.window(n_t)
            np.testing.assert_array_equal(Xv.numpy(), X[:n_t])
            np.testing.assert_array_equal(yv.numpy(), y[:n_t])


def test_grow_never_reuploads_and_meters_like_the_reference():
    corpus = synth_corpus(64, 8, 97, seed=2)
    row_bytes = corpus.dtype.itemsize * corpus.shape[1]
    ref = jplane.StreamingDataset.from_arrays(corpus, shard_size=16,
                                              masked=True)
    with ref, _plane(corpus, 16, masked=True) as plane:
        for p in (ref, plane):
            p.window(16)
            assert p.meter.bytes_uploaded == 16 * row_bytes
            p.window(16)                    # same window: nothing moves
            assert p.meter.bytes_uploaded == 16 * row_bytes
            p.window(32)                    # grow: only the new shard
            assert p.meter.bytes_uploaded == 32 * row_bytes
            p.note_access(7)
        assert plane.meter.examples_loaded == 32
        for k in METER_INTS:
            assert getattr(plane.meter, k) == getattr(ref.meter, k), k
        assert plane.windows[0].cursor() == ref.windows[0].cursor()


@pytest.mark.parametrize("n_valid", [5, 16, 23])
def test_masked_rows_equal_the_host_path_and_the_reference(n_valid):
    """rotation_rows / probe_rows on the plane's MaskedWindow gather the
    rows the host path's slice does, and the reference's; the rolling
    sub-window of a MaskedWindow is the reference's one-lane one."""
    corpus = synth_corpus(32, 6, 50, seed=4)
    with _plane(corpus, 8, masked=True) as plane:
        plane.window(32)
        win = plane.windows[0].masked(n_valid)
        host = torch.from_numpy(corpus[:n_valid])
        jwin = jdw.MaskedWindow(jnp.asarray(corpus), jnp.int32(n_valid))
        for t in (0, 1, 3, torch.tensor(5, dtype=torch.int32)):
            rows = tdw.rotation_rows(win, 4, t)
            assert torch.equal(rows, tdw.rotation_rows(host, 4, t))
            np.testing.assert_array_equal(
                rows.numpy(), np.asarray(jdw.rotation_rows(jwin, 4, int(t))))
        for k in (3, 9, 40):
            assert torch.equal(tdw.probe_rows(win, k),
                               tdw.probe_rows(host, k))
            np.testing.assert_array_equal(
                tdw.probe_rows(win, k).numpy(),
                np.asarray(jdw.probe_rows(jwin, k)))
        for frac, t in ((0.5, 0), (0.5, 3), (0.25, 7), (1.0, 2)):
            sub = tdw.rolling_subwindow(win, frac, t)
            ref = jdw.rolling_subwindow(jdw.as_host_windows(jwin), frac, t)
            np.testing.assert_array_equal(sub.data.numpy(),
                                          np.asarray(ref.fields[0][0]))
            assert int(sub.n_valid) == int(ref.counts[0])


def _error(fn):
    try:
        fn()
    except Exception as e:              # the type and text are compared
        return type(e).__name__, str(e)
    raise AssertionError("no error raised")


def _overflow(mod, **kw):
    win = mod.DeviceWindow(capacity=8, item_shape=(2,), dtype=np.float32,
                           **kw)
    win.append(np.ones((8, 2), np.float32))
    win.append(np.ones((1, 2), np.float32))


def _beyond(mod, view, **kw):
    win = mod.DeviceWindow(capacity=8, item_shape=(2,), dtype=np.float32,
                           **kw)
    win.append(np.ones((3, 2), np.float32))
    getattr(win, view)(4)


CONSTRUCTION_ERRORS = {
    "growth": lambda m, **kw: m.DeviceWindow(
        capacity=8, item_shape=(4,), dtype=np.float32, growth=1.0, **kw),
    "capacity": lambda m, **kw: m.DeviceWindow(
        capacity=0, item_shape=(4,), dtype=np.float32, **kw),
    "item_shape": lambda m, **kw: m.DeviceWindow(
        capacity=8, item_shape=(2,), dtype=np.float32, **kw).append(
        np.ones((1, 3), np.float32)),
    "overflow": _overflow,
    "slice": lambda m, **kw: _beyond(m, "slice", **kw),
    "masked": lambda m, **kw: _beyond(m, "masked", **kw),
    "cursor": lambda m, **kw: m.DeviceWindow(
        capacity=8, item_shape=(2,), dtype=np.float32,
        **kw).restore_cursor({"n_valid": 9}),
}


@pytest.mark.parametrize("case", sorted(CONSTRUCTION_ERRORS))
def test_window_errors_match_the_reference(case):
    make = CONSTRUCTION_ERRORS[case]
    assert _error(lambda: make(tdw, device="cpu")) == _error(
        lambda: make(jdw))


STORE = np.zeros((10, 2), np.float32)


@pytest.mark.parametrize("case", ["masked_two_fields", "no_stores",
                                  "fields_disagree",
                                  "plane_fields_disagree"])
def test_plane_and_prefetcher_errors_match_the_reference(case):
    def make(shards, prefetch, plane, **kw):
        mem = shards.InMemoryShardStore
        return {
            "masked_two_fields": lambda: plane.StreamingDataset(
                [mem(STORE, 4), mem(STORE, 4)], masked=True, **kw),
            "no_stores": lambda: prefetch.Prefetcher([]),
            "fields_disagree": lambda: prefetch.Prefetcher(
                [mem(STORE, 4), mem(STORE, 5)]),
            "plane_fields_disagree": lambda: plane.StreamingDataset(
                [mem(STORE, 4), mem(STORE, 5)], **kw),
        }[case]
    assert _error(make(tshards, tprefetch, tplane, device="cpu")) == \
        _error(make(jshards, jprefetch, jplane))


@pytest.mark.parametrize("kw", [{"windows": ()}, {"shardings": object()}],
                         ids=["windows", "shardings"])
def test_multi_host_plane_arguments_name_their_slice(kw):
    """``windows=`` (a host's lanes of the stacked window) is checked as in
    the reference; ``shardings=`` (a JAX ``NamedSharding``) has no
    counterpart and says where the port places windows."""
    store = [tshards.InMemoryShardStore(STORE, 4)]
    if "windows" in kw:
        with pytest.raises(ValueError) as te:
            tplane.StreamingDataset(store, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jplane.StreamingDataset([jshards.InMemoryShardStore(STORE, 4)],
                                    **kw)
        assert str(te.value) == str(je.value)
    else:
        with pytest.raises(NotImplementedError, match="topology's device"):
            tplane.StreamingDataset(store, device="cpu", **kw)


# ------------------------------------------------------------------ prefetch
class GatedStore(tshards.InMemoryShardStore):
    """A store whose loads wait on a per-shard gate and raise on chosen
    shards (the dead-NAS failure mode); ``started[i]`` is set when shard
    i's load begins."""

    def __init__(self, data, shard_size, *, bad=(), fail_once=(),
                 gated=()):
        super().__init__(data, shard_size)
        self.bad, self.fail_once = set(bad), set(fail_once)
        self.gates = {i: threading.Event() for i in gated}
        self.started = {i: threading.Event() for i in range(self.num_shards)}
        self.calls: list[int] = []

    def load(self, shard):
        self.calls.append(shard)
        self.started[shard].set()
        if shard in self.gates:
            assert self.gates[shard].wait(TIMEOUT_S)
        if shard in self.bad:
            raise IOError(f"storage path gone for shard {shard}")
        if shard in self.fail_once:
            self.fail_once.discard(shard)
            raise IOError("transient storage blip")
        return super().load(shard)


def _settle(p, shard):
    """Wait until ``shard``'s scheduled load has finished."""
    with p._lock:
        _, fut = p._pending[shard]
    fut.exception(timeout=TIMEOUT_S)


def test_prefetch_failure_surfaces_eagerly_not_at_take():
    corpus = synth_corpus(64, 8, 97, seed=7)
    with tprefetch.Prefetcher([GatedStore(corpus, 16, bad=[1])]) as p:
        p.schedule([0, 1])
        _settle(p, 1)
        with pytest.raises(tshards.ShardLoadError) as e:
            p.schedule([2])
        assert e.value.shard == 1
        assert isinstance(e.value.__cause__, IOError)
        (rows,) = p.take(0)             # healthy shards still flow
        np.testing.assert_array_equal(rows, corpus[:16])


def test_a_dropped_loads_failure_spares_its_rescheduled_load():
    """A load cancelled while running, then scheduled again, fails: the
    failure belongs to the dropped load, so it surfaces nowhere, and the
    new load of the same shard lands."""
    corpus = synth_corpus(64, 8, 97, seed=13)
    store = GatedStore(corpus, 16, fail_once=[1], gated=[1])
    with tprefetch.Prefetcher([store]) as p:
        p.schedule([1])
        assert store.started[1].wait(TIMEOUT_S)
        _, dropped = p._pending[1]
        assert p.cancel([1]) == [1]         # running: dropped, not stopped
        p.schedule([1])                     # queued behind it
        store.gates[1].set()
        assert isinstance(dropped.exception(timeout=TIMEOUT_S), IOError)
        p.schedule([])                      # the failure is not this load's
        (rows,) = p.take(1)
        np.testing.assert_array_equal(rows, corpus[16:32])
        assert store.calls == [1, 1]


def test_take_wraps_its_own_failure_with_the_cause():
    corpus = synth_corpus(32, 8, 97, seed=8)
    with tprefetch.Prefetcher([GatedStore(corpus, 16, bad=[0])]) as p:
        with pytest.raises(tshards.ShardLoadError) as e:
            p.take(0)
        assert isinstance(e.value.__cause__, IOError)


def test_ensure_resident_is_retry_safe_after_a_failure():
    """Shards taken before a failed one land, so a retry resumes at the
    failed shard instead of appending later shards at earlier offsets."""
    corpus = synth_corpus(64, 8, 97, seed=10)
    store = GatedStore(corpus, 16, fail_once=[1])
    with tplane.StreamingDataset([store], masked=True, device="cpu") as plane:
        with pytest.raises(tshards.ShardLoadError):
            plane.window(48)
        assert plane.resident == 16 * plane.next_shard < 48
        rows, n = tdw.window_rows(plane.window(48))
        np.testing.assert_array_equal(rows[:48].numpy(), corpus[:48])
        assert plane.meter.examples_loaded == 48        # each shard once
        assert plane.meter.examples_uploaded == 48


def test_cancel_drops_pending_and_inflight_loads():
    corpus = synth_corpus(96, 8, 97, seed=11)
    store = GatedStore(corpus, 16, gated=[0])
    with tprefetch.Prefetcher([store]) as p:
        p.schedule([0, 1, 2, 3])
        assert store.started[0].wait(TIMEOUT_S)     # 0 in flight, 1-3 queued
        assert p.cancel([1, 2, 3]) == [1, 2, 3]
        assert p.scheduled() == [0]
        assert p.cancel([7]) == []                  # unknown ids: no-op
        store.gates[0].set()
        (rows,) = p.take(0)                 # the untouched load lands
        np.testing.assert_array_equal(rows, corpus[:16])
        (rows,) = p.take(2)                 # a demand load after the cancel
        np.testing.assert_array_equal(rows, corpus[32:48])
    assert p.cancel([0]) == []              # after close: a no-op
    assert 1 not in store.calls and 3 not in store.calls


def test_drop_pending_guards_the_landed_prefix():
    corpus = synth_corpus(96, 8, 97, seed=12)
    store = GatedStore(corpus, 16, gated=[2])
    with tplane.StreamingDataset([store], masked=True, device="cpu") as plane:
        plane.window(32)                    # shards 0-1 landed
        plane.prefetch(96)                  # 2-5 scheduled, 2 held
        assert plane.next_shard == 2
        assert plane.pending_shards() == [2, 3, 4, 5]
        assert plane.drop_pending(3) == [3, 4, 5]
        with pytest.raises(ValueError, match="already landed"):
            plane.drop_pending(1)
        store.gates[2].set()
        rows, _ = tdw.window_rows(plane.window(96))
        np.testing.assert_array_equal(rows[:96].numpy(), corpus)
        assert plane.meter.examples_loaded == 96


def test_close_is_idempotent_and_safe_against_a_racing_schedule():
    corpus = synth_corpus(64, 8, 97, seed=9)
    store = tshards.InMemoryShardStore(corpus, 16)
    p = tprefetch.Prefetcher([store])
    p.close()
    p.close()                               # idempotent
    p.schedule([0, 1])                      # a racing schedule: no-op
    with pytest.raises(RuntimeError, match="closed"):
        p.take(0)                           # a demand load fails loudly

    p2 = tprefetch.Prefetcher([store])
    errors, running, stop = [], threading.Event(), threading.Event()

    def driver():
        i = 0
        while not stop.is_set():
            try:
                p2.schedule([i % store.num_shards])
            except Exception as exc:        # any leak fails the test
                errors.append(exc)
                return
            i += 1
            if i == 10:
                running.set()

    t = threading.Thread(target=driver)
    t.start()
    assert running.wait(TIMEOUT_S)
    p2.close()
    stop.set()
    t.join(timeout=TIMEOUT_S)
    assert not t.is_alive() and errors == []
    with _plane(corpus, 16) as plane:
        plane.close()                       # the plane's close, twice


# ------------------------------------------------------ engine on the plane
def _convex_spec(policy, params, **data):
    return R.RunSpec(
        data=R.DataSpec(dataset="w8a_like", scale=0.05, lam=1e-3,
                        plane="plane", shard_size=32, **data),
        policy=R.PolicySpec(policy, params),
        optimizer=R.OptimizerSpec("newton_cg", {"hessian_fraction": 0.2}),
        schedule=R.ScheduleSpec(n0=32, clock={"p": 10.0, "a": 1.0, "s": 5.0}))


POLICIES = {"fixed_steps": {"inner_steps": 3, "final_steps": 5},
            "two_track": {"final_steps": 5, "max_stage_iters": 12}}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_convex_plane_matches_the_reference_plane(policy):
    spec = _convex_spec(policy, POLICIES[policy])
    ref_sess = R.build(spec)
    ref = ref_sess.run()
    sess = P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
    port = sess.run()
    assert len(port.points) == len(ref.points)
    for col in ("step", "stage", "window", "time", "accesses"):
        assert port.column(col) == ref.column(col), col
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(port.column(col), ref.column(col),
                                   rtol=RTOL_F)
    for k in METER_INTS:
        assert port.meta["data_plane"][k] == ref.meta["data_plane"][k], k
    assert sess.meters["data_plane"]["examples_accessed"] == \
        sess.clock.data_accesses == ref_sess.clock.data_accesses
    assert sess.meters["clock"] == ref_sess.meters["clock"]


def _lm_spec(policy, params, plane):
    return P.RunSpec(
        data=P.DataSpec(kind="lm", corpus_size=32, seq_len=16, eval_rows=8,
                        plane=plane, shard_size=8),
        model=P.ModelSpec(arch="falcon-mamba-7b", reduced=True,
                          overrides={"dtype": "float32"}),
        optimizer=P.OptimizerSpec("adamw_lm", {"lr": 1e-3, "batch_size": 4}),
        policy=P.PolicySpec(policy, params),
        schedule=P.ScheduleSpec(n0=8, step_cost="batch", wait_on_expand=True,
                                carry_state=True, clock={"preloaded": 8}))


LM_POLICIES = {"fixed_steps": {"inner_steps": 2, "final_steps": 2},
               "two_track": {"final_steps": 2, "max_stage_iters": 4,
                             "condition": "eval"}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("workload,policy", [
    ("convex", "fixed_steps"), ("convex", "two_track"),
    ("mamba", "fixed_steps"), ("mamba", "two_track")])
def test_plane_and_host_path_are_bit_exact(workload, policy):
    """Within the port the plane and the host path run the same numbers:
    every trace column, the final parameters and the transfers, with every
    example loaded and uploaded once and accesses equal to the clock's."""
    runs = {}
    for plane in ("host", "plane"):
        if workload == "convex":
            spec = P.RunSpec.from_json(_convex_spec(
                policy, POLICIES[policy]).to_json())
            spec = spec.replace(data=spec.data.replace(plane=plane))
        else:
            spec = _lm_spec(policy, LM_POLICIES[policy], plane)
        sess = P.build(spec, device="cpu")
        runs[plane] = (sess, sess.run())
    (hs, host), (ps, plane) = runs["host"], runs["plane"]
    for col in ("step", "stage", "window", "time", "accesses", "f_window",
                "f_full"):
        assert plane.column(col) == host.column(col), col
    assert [p.extra for p in plane.points] == [p.extra for p in host.points]
    for a, b in zip(_leaves(plane.params), _leaves(host.params)):
        assert torch.equal(a, b)
    for key in ("host_transfers", "race_overshoot", "stages"):
        assert plane.meta[key] == host.meta[key], key
    m = plane.meta["data_plane"]
    assert m["examples_loaded"] == m["examples_uploaded"] == ps.dataset.n
    assert m["examples_accessed"] == ps.clock.data_accesses
    assert ps.dataset.prefetcher._closed         # the session closed it


def test_build_plane_with_a_throttled_memmap_store(tmp_path):
    """The storage knobs through build: memmap shards written under the
    workdir, reads throttled, the same trajectory as the in-memory plane."""
    base = P.RunSpec.from_json(_convex_spec(
        "fixed_steps", POLICIES["fixed_steps"]).to_json())
    disk = base.replace(data=base.data.replace(
        store="memmap", workdir=str(tmp_path), delay_ms=1.0))
    sess = P.build(disk, device="cpu")
    assert isinstance(sess.dataset.stores[0], tshards.ThrottledStore)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["X", "y"]
    tr = sess.run()
    mem = P.build(base, device="cpu").run()
    assert tr.column("f_full") == mem.column("f_full")
    assert tr.meta["data_plane"]["examples_loaded"] == sess.dataset.n


@pytest.mark.parametrize("bad,needle", [
    (dict(store="memmap"), "needs DataSpec.workdir"),
    (dict(store="s3"), "unknown store"),
], ids=["memmap_workdir", "unknown_store"])
def test_store_errors_match_the_reference(bad, needle):
    spec = _convex_spec("fixed_steps", POLICIES["fixed_steps"], **bad)
    with pytest.raises(R.SpecError, match=needle) as ref:
        R.build(spec)
    with pytest.raises(P.SpecError, match=needle) as port:
        P.build(P.RunSpec.from_json(spec.to_json()), device="cpu")
    assert str(port.value) == str(ref.value)


class _Killed(Exception):
    pass


def test_session_closes_the_plane_when_the_run_fails():
    sess = P.build(P.RunSpec.from_json(_convex_spec(
        "fixed_steps", POLICIES["fixed_steps"]).to_json()), device="cpu")

    def boom(end):
        raise _Killed

    sess.on_stage(boom)
    with pytest.raises(_Killed):
        sess.run()
    assert sess.dataset.prefetcher._closed
