"""The port's tiered corpus against the reference's, on the CPU: the
seventeen cases of ``tests/test_tiers.py`` at their sizes, each driven
through ``repro.data.tiers`` and ``repro_torch.data.tiers`` on the same
numpy inputs (windows and views, segment plans, meters, tier reports and
``tier.*`` event streams equal; trajectories within the float32 bound;
bit-exactness held within the port where the reference holds it within
itself), then the prefetcher's event order and ``max_inflight`` backlog,
the ``"tiered"`` stage checkpoint across packages both ways, and
``_validate``'s tiering refusals.

Every corpus, ring and prefetcher is closed by ``with`` or by the session
that owns it, and a fixture checks that no loader or stager thread
outlives a test.  Threads are ordered by the prefetcher's own lock and by
``threading.Event``s, never by sleeps."""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro import core as jcore
from repro import elastic as jel
from repro import obs as jobs
from repro import optim as joptim
from repro.data import plane as jplane
from repro.data import prefetch as jprefetch
from repro.data import shards as jshards
from repro.data import tiers as jtiers
from repro.data.synthetic import make_classification
from repro.models import linear as jlin
from repro.obs.metrics import attach_dataset as jattach
from repro_torch import core as tcore
from repro_torch import dist as tdist
from repro_torch import elastic as tel
from repro_torch import obs as tobs
from repro_torch import optim as toptim
from repro_torch.data import plane as tplane
from repro_torch.data import prefetch as tprefetch
from repro_torch.data import shards as tshards
from repro_torch.data import tiers as ttiers
from repro_torch.dist.collectives import DistributedObjective
from repro_torch.elastic import checkpoint as tstage
from repro_torch.models import linear as tlin
from repro_torch.obs.metrics import attach_dataset as tattach
from repro_torch.obs.metrics import attach_prefetcher as tattach_prefetcher

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

LAM = 1e-3
SHARD = 16
# f̂ across packages (tests/test_torch_engine.py's bound); a rotating
# sweep steps on 64-row segments whose Newton systems amplify float32
# rounding: the reference's own f̂ moves by 1.7e-4 (relative) at one step of
# the rotation run below when its inputs move by 1e-7, so runs that sweep
# are held at RTOL_F_SWEEP
RTOL_F = 1e-4
RTOL_F_SWEEP = 1e-3
COLUMNS = ("step", "stage", "window", "time", "accesses")
TIMEOUT_S = 30
# wall-clock fields: measured, never compared across packages
TIMED = {"load_time_s", "blocked_time_s", "overlap_fraction", "stage_time_s",
         "commit_block_s", "staging_overlap", "blocked_s", "duration_s"}
THREADS = ("bet-prefetch", "bet-tier")
# what the stager thread changes while the driver reads: the ring's size
# at an occupancy sample, and, under a host budget, which shards spill
# and so how many loads a sweep makes (the reference's vary from run to
# run too)
RING_FIELDS = {"ring_shards", "ring_bytes"}
SPILL_FIELDS = RING_FIELDS | {"examples_loaded", "bytes_loaded", "loads",
                              "prefetched_loads", "evictions",
                              "evicted_examples"}


@pytest.fixture(autouse=True)
def no_stray_threads():
    """No loader or stager thread a test starts outlives it (closing a
    corpus, ring or prefetcher joins its pools)."""
    before = {t.ident for t in threading.enumerate()}
    yield
    stray = [t.name for t in threading.enumerate()
             if t.ident not in before and t.name.startswith(THREADS)]
    assert stray == [], stray


REF = SimpleNamespace(
    name="reference", store=jshards.InMemoryShardStore,
    throttled=jshards.ThrottledStore, meter=jshards.DataAccessMeter,
    tiered=jtiers.TieredCorpus, plane=jplane.StreamingDataset,
    prefetcher=jprefetch.Prefetcher, manager=jtiers.RingTierManager,
    engine=jcore.BetEngine, schedule=jcore.BETSchedule,
    fixed=jcore.FixedSteps, clock=jcore.SimulatedClock,
    newton=joptim.NewtonCG, stage=jel, recorder=jobs.EventRecorder,
    attach=jattach, ckpt=jtiers,
    objective=lambda: jlin.make_objective("squared_hinge", lam=LAM),
    w0=jlin.init_params, rows=lambda a: a, host=np.asarray)
PORT = SimpleNamespace(
    name="port", store=tshards.InMemoryShardStore,
    throttled=tshards.ThrottledStore, meter=tshards.DataAccessMeter,
    tiered=lambda stores, **kw: ttiers.TieredCorpus(stores, device="cpu",
                                                    **kw),
    plane=lambda stores, **kw: tplane.StreamingDataset(stores, device="cpu",
                                                       **kw),
    prefetcher=tprefetch.Prefetcher, manager=ttiers.RingTierManager,
    engine=tcore.BetEngine, schedule=tcore.BETSchedule,
    fixed=tcore.FixedSteps, clock=tcore.SimulatedClock,
    newton=toptim.NewtonCG, stage=tstage, recorder=tobs.EventRecorder,
    attach=tattach, ckpt=ttiers,
    objective=lambda: tlin.make_objective("squared_hinge", lam=LAM),
    w0=lambda d: tlin.init_params(d, device="cpu"),
    rows=torch.from_numpy, host=lambda t: t.numpy())
SIDES = (REF, PORT)


def problem(n=256, d=8, seed=0):
    ds = make_classification("tiers_t", n=n, d=d, seed=seed)
    return np.array(ds.X), np.array(ds.y)


def row_bytes(X, y):
    return X.dtype.itemsize * X.shape[1] + y.dtype.itemsize


def tiered(side, X, y, *, hbm_rows, shard=SHARD, **kw):
    return side.tiered([side.store(X, shard), side.store(y, shard)],
                       hbm_bytes=hbm_rows * row_bytes(X, y), **kw)


def untimed(snap: dict, drop=frozenset()) -> dict:
    return {k: v for k, v in snap.items() if k not in TIMED | drop}


def tier_record(tc, drop=frozenset()) -> dict:
    """What a corpus reports, wall-clock fields (and ``drop``) aside,
    once a staging job in flight has finished."""
    if tc._staged is not None:
        tc._staged.future.exception(timeout=TIMEOUT_S)
    rep = untimed(tc.tier_report(), drop)
    rep["meter"] = untimed(rep["meter"], drop)
    return {"meter": untimed(tc.meter.snapshot(), drop), "tiers": rep,
            "mode": tc.mode, "hot_range": tuple(tc.hot_range),
            "resident": tc.resident}


def tier_events(rec, drop=RING_FIELDS) -> list:
    """The ``tier.*`` stream in order, the ring's fields of each sample
    and the evictions (which the stager thread may emit) aside; the
    evicted shards as a sorted list unless ``drop`` has them."""
    evs = [e for e in rec.event_dicts() if e["name"].startswith("tier.")]
    drv = [(e["name"], untimed(e["fields"], drop)) for e in evs
           if e["name"] != "tier.evict"]
    evict = [] if "evictions" in drop else sorted(
        e["fields"]["shard"] for e in evs if e["name"] == "tier.evict")
    return [drv, evict]


def both(case, *args) -> list:
    """``case(side, *args)`` for the reference and the port; the port's
    record must equal the reference's."""
    ref, port = (case(side, *args) for side in SIDES)
    assert port == ref
    return port


def check_view(side, view, X, y, lo, hi):
    Xv, yv = view
    np.testing.assert_array_equal(side.host(Xv), X[lo:hi])
    np.testing.assert_array_equal(side.host(yv), y[lo:hi])


# ------------------------------------------------------------------ manager
def _manager(side):
    m = side.manager(hbm_bytes=100 * 36, row_bytes=36, shard_size=16,
                     capacity=256)
    assert m.hot_cap == 96                       # 100 rows aligned down
    assert not m.rotates(96) and m.rotates(97)
    segs = m.segments(250)
    assert segs[0] == (0, 96) and segs[-1] == (192, 250)
    assert [lo for lo, _ in segs[1:]] == [hi for _, hi in segs[:-1]]
    assert m.segments(50) == [(0, 50)]
    assert side.manager(hbm_bytes=10**9, row_bytes=36, shard_size=16,
                        capacity=64).hot_cap == 64
    with pytest.raises(ValueError, match="below one shard") as e:
        side.manager(hbm_bytes=36 * 15, row_bytes=36, shard_size=16,
                     capacity=64)
    return [m.hot_cap, segs, str(e.value)]


def test_manager_hot_cap_shard_aligned_and_tiling_disjoint():
    both(_manager)


# ------------------------------------------------------------ append regime
def _append(side, X, y):
    views = []
    rec = side.recorder()
    with tiered(side, X, y, hbm_rows=128) as tc:
        side.attach(tc, rec)
        for n_t in (32, 64, 128):
            view = tc.window(n_t)
            check_view(side, view, X, y, 0, n_t)
            views.append(n_t)
        assert tc.mode == "append"
        assert tc.meter.examples_loaded == 128       # each example once
        assert tc.meter.examples_uploaded == 128
        assert tc.meter.bytes_uploaded == 128 * row_bytes(X, y)
        assert tc.tier_meter.resident_reuploads == 0
        return [views, tier_record(tc), tier_events(rec)]


def test_append_regime_bit_exact_and_loads_each_example_once():
    both(_append, *problem(n=128))


def _double_buffer(side, X, y):
    rec = side.recorder()
    with tiered(side, X, y, hbm_rows=128) as tc:
        side.attach(tc, rec)
        tc.begin_stage(64, 128)                  # stages [64, 128) async
        assert tc.tier_meter.staged_segments == 1
        view = tc.begin_stage(128)               # lands the staged buffers
        assert tc.tier_meter.staged_commits == 1
        assert tc.tier_meter.direct_builds == 1  # only the cold start
        check_view(side, view, X, y, 0, 128)
        assert tc.meter.examples_uploaded == 128
        assert tc.meter.bytes_uploaded == 128 * row_bytes(X, y)
        return [tier_record(tc), tier_events(rec)]


def test_append_double_buffers_the_next_expansion():
    both(_double_buffer, *problem(n=128))


def _engine_run(side, dataset, X, y, policy, *, n0=64, **kw):
    w0 = side.w0(X.shape[1])
    return side.engine(schedule=side.schedule(n0=n0)).run(
        dataset, side.newton(hessian_fraction=1.0), side.objective(),
        side.fixed(**policy), w0=w0, clock=side.clock(),
        eval_data=(side.rows(X[:64]), side.rows(y[:64])), **kw)


def _columns(tr) -> dict:
    return {c: tr.column(c) for c in COLUMNS}


def assert_f_close(tr, ref, rtol=RTOL_F):
    for col in ("f_window", "f_full"):
        np.testing.assert_allclose(tr.column(col), ref.column(col),
                                   rtol=rtol)


def test_engine_tiered_full_budget_bit_exact_vs_streaming_plane():
    X, y = problem()
    policy = dict(inner_steps=2, final_steps=4)
    with PORT.plane([PORT.store(X, SHARD), PORT.store(y, SHARD)]) as plane:
        tr_plane = _engine_run(PORT, plane, X, y, policy)
    with tiered(PORT, X, y, hbm_rows=len(X)) as tc:
        tr = _engine_run(PORT, tc, X, y, policy)
        assert tc.mode == "append"
    # within the port, bit for bit, as the reference within itself
    for col in ("f_window", "f_full"):
        assert tr.column(col) == tr_plane.column(col), col
    with tiered(REF, X, y, hbm_rows=len(X)) as tc:
        tr_ref = _engine_run(REF, tc, X, y, policy)
    assert _columns(tr) == _columns(tr_ref)
    assert_f_close(tr, tr_ref)


# ---------------------------------------------------------- rotation regime
def _rotation(side, X, y):
    with tiered(side, X, y, hbm_rows=64) as tc:
        tc.begin_stage(64, 128)
        assert tc.mode == "append"
        plans = []
        check_view(side, tc.begin_stage(128, 256), X, y, 0, 64)
        assert tc.mode == "rotate"
        plans.append(tc.segment_steps(128, 2))
        check_view(side, tc.advance_window(), X, y, 64, 128)
        # mid-sweep position survives the expansion (stride alignment)
        check_view(side, tc.begin_stage(256), X, y, 64, 128)
        plans.append(tc.segment_steps(256, 4))
        for lo in (128, 192, 0):
            check_view(side, tc.advance_window(), X, y, lo, lo + 64)
        assert tc.meter.examples_loaded == 256
        assert tc.tier_meter.resident_reuploads == 0
        assert tc.tier_meter.evictions == 0
        assert tc.ring.resident_shards == 16
        with pytest.raises(RuntimeError, match="eval_data"):
            tc.window(256)                       # no full-window fallback
        return [plans, tier_record(tc)]


def test_rotation_sweep_views_bit_exact_and_disjoint():
    plans, _ = both(_rotation, *problem(n=256))
    assert plans == [[(1, 64), (1, 64)], [(1, 64)] * 4]


def _rotation_run(side, X, y):
    rec = side.recorder()
    with tiered(side, X, y, hbm_rows=64) as tc:
        side.attach(tc, rec)
        tr = _engine_run(side, tc, X, y,
                         dict(inner_steps=4, final_steps=8))
        assert tc.mode == "rotate"
        assert int(tr.points[-1].window) == 256
        assert tc.meter.examples_loaded == 256
        assert tc.meter.examples_uploaded > 256
        assert tc.tier_meter.resident_reuploads == 0
        assert tc.tier_meter.staged_commits > 0
        return tr, [tier_record(tc), tier_events(rec),
                    tr.meta["host_transfers"]]


def test_engine_rotation_run_loads_once_and_never_reuploads_resident():
    X, y = problem(n=256)
    (tr_ref, want), (tr, got) = (_rotation_run(s, X, y) for s in SIDES)
    assert got == want
    assert _columns(tr) == _columns(tr_ref)
    assert_f_close(tr, tr_ref, RTOL_F_SWEEP)


def _bounded_ring(side, X, y):
    shard_bytes = SHARD * row_bytes(X, y)
    rec = side.recorder()
    with tiered(side, X, y, hbm_rows=64, host_bytes=6 * shard_bytes) as tc:
        side.attach(tc, rec)

        def sweep(n_t, k):
            views = [tc.begin_stage(n_t)]
            views += [tc.advance_window()
                      for _ in tc.segment_steps(n_t, k)[1:]]
            return views

        def sweep_checked(n_t, k, want):
            # a rotation commit lands over the hot segment in place in the
            # port, so each view is checked before the next goes hot
            got = [tc.begin_stage(n_t)]
            check_view(side, got[0], X, y, *want[0])
            for (lo, hi), _ in zip(want[1:], tc.segment_steps(n_t, k)[1:]):
                check_view(side, tc.advance_window(), X, y, lo, hi)
                got.append((lo, hi))
            return len(got)

        tc.begin_stage(64, 128)
        tc.begin_stage(128, 256)                 # enter rotation
        for _ in tc.segment_steps(128, 2)[1:]:
            tc.advance_window()
        sweep(256, 4)
        assert tc.tier_meter.evictions > 0       # the budget bites
        assert tc.ring.resident_bytes <= 6 * shard_bytes + \
            len(tc.ring._protected) * shard_bytes
        loaded_once = tc.meter.examples_loaded
        assert sweep_checked(256, 4, ((0, 64), (64, 128), (128, 192),
                                      (192, 256))) == 4
        assert tc.meter.examples_loaded > loaded_once
        assert tc.tier_meter.resident_reuploads == 0
        return [tier_record(tc, SPILL_FIELDS),
                tier_events(rec, SPILL_FIELDS)]


def test_bounded_ring_spills_then_repromotes_bit_exact():
    both(_bounded_ring, *problem(n=256))


# --------------------------------------------------------------- checkpoint
def _tier_state(side, X, y):
    with tiered(side, X, y, hbm_rows=64) as tc:
        tc.begin_stage(64, 128)
        tc.begin_stage(128, 256)
        tc.segment_steps(128, 2)
        tc.advance_window()                      # hot segment = [64, 128)
        state = side.stage.dataset_state(tc)
        ref = tc.meter.snapshot()
    assert state["kind"] == "tiered"
    assert state["tier"]["mode"] == "rotate"
    with tiered(side, X, y, hbm_rows=64) as tc2:
        rewarm = side.stage.restore_dataset(tc2, state, 128)
        assert rewarm["rewarm_examples"] == 64
        assert rewarm["examples_loaded"] == 64
        assert tc2.mode == "rotate" and tc2.hot_range == (64, 128)
        check_view(side, tc2._view_seg(), X, y, 64, 128)
        assert tc2.meter.snapshot() == ref
        assert tc2.tier_meter.snapshot() == state["tier"]["meter"]
        state["meter"] = untimed(state["meter"])
        state["tier"]["meter"] = untimed(state["tier"]["meter"])
        return [state, untimed(rewarm), tier_record(tc2)]


def test_tier_state_checkpoint_rewarm_bounded_by_hot_cap():
    both(_tier_state, *problem(n=256))


def _mismatch(side, X, y):
    with tiered(side, X, y, hbm_rows=64) as tc:
        tc.window(64)
        state = side.stage.dataset_state(tc)
    with side.plane([side.store(X, SHARD), side.store(y, SHARD)]) as plane:
        with pytest.raises(ValueError, match="'tiered'") as e:
            side.stage.restore_dataset(plane, state, 64)
    return str(e.value).split(" (")[0]


def test_restore_rejects_tiered_streaming_mismatch():
    both(_mismatch, *problem(n=64))


class _Killed(Exception):
    pass


def _kill_resume(side, X, y, tmp_path):
    policy = dict(inner_steps=4, final_steps=8)
    with tiered(side, X, y, hbm_rows=64) as tc:
        whole = _engine_run(side, tc, X, y, policy)
    ck = side.stage.StageCheckpointer(str(tmp_path / side.name))

    def die(end):
        ck(end)
        if end.info.stage == 1:
            raise _Killed

    killed = side.engine(schedule=side.schedule(n0=64))
    killed.stage_callback = die
    with tiered(side, X, y, hbm_rows=64) as tc:
        with pytest.raises(_Killed):
            killed.run(tc, side.newton(hessian_fraction=1.0),
                       side.objective(), side.fixed(**policy),
                       w0=side.w0(X.shape[1]), clock=side.clock(),
                       eval_data=(side.rows(X[:64]), side.rows(y[:64])))
    w0 = side.w0(X.shape[1])
    restored = ck.restore(w0, side.newton(hessian_fraction=1.0).init(w0))
    clock = restored.restore_clock(side.clock())
    with tiered(side, X, y, hbm_rows=64) as tc:
        rewarm = restored.restore_dataset(tc)
        assert rewarm["rewarm_examples"] <= tc.hot_cap
        tr = side.engine(schedule=side.schedule(n0=64)).run(
            tc, side.newton(hessian_fraction=1.0), side.objective(),
            side.fixed(**policy), clock=clock, resume=restored.resume,
            w0=restored.params, opt_state0=restored.opt_state,
            eval_data=(side.rows(X[:64]), side.rows(y[:64])))
        # the restart lost the host ring: beyond the hot re-land, the
        # resumed sweep re-reads one segment, bounded by hot_cap
        assert tc.meter.examples_loaded == 256 + 64
        record = [untimed(rewarm), tier_record(tc)]

    def stitch(col):
        return [p[col] for p in restored.trace_points()] + tr.column(col)

    # within each package, bit for bit the uninterrupted run
    for col in COLUMNS + ("f_window", "f_full"):
        assert stitch(col) == whole.column(col), col
    return whole, record


def test_kill_resume_tiered_rotation_bit_compatible(tmp_path):
    X, y = problem(n=256)
    (whole_ref, want), (whole, got) = (_kill_resume(s, X, y, tmp_path)
                                       for s in SIDES)
    assert got == want
    assert _columns(whole) == _columns(whole_ref)
    assert_f_close(whole, whole_ref, RTOL_F_SWEEP)


# ------------------------------------------------- checkpoint lane slices
@pytest.mark.parametrize("writer,reader", [(PORT, PORT), (PORT, REF),
                                           (REF, PORT)],
                         ids=["port", "port_to_reference",
                              "reference_to_port"])
def test_lane_slice_files_roundtrip_and_cleanup(tmp_path, writer, reader):
    meters = [{"examples_loaded": 10 * i, "bytes_loaded": 100 * i}
              for i in range(5)]
    pointer = writer.ckpt.write_lane_slices(tmp_path, "stage_0003", meters)
    assert reader.ckpt.is_lane_pointer(pointer)
    assert not reader.ckpt.is_lane_pointer(meters)
    names = pointer["lane_files"]
    assert names == [f"stage_0003_lane{i:02d}.json" for i in range(5)]
    assert reader.ckpt.load_lane_slices(tmp_path, pointer) == meters
    reader.ckpt.unlink_lane_slices(tmp_path, "stage_0003")
    assert not list(tmp_path.glob("stage_0003_lane*.json"))
    # one copy: tiers re-exports the stage checkpoint's helpers
    assert ttiers.write_lane_slices is tstage.write_lane_slices


def test_distributed_checkpoint_writes_and_inflates_lane_slices(tmp_path):
    X, y = problem(n=256)
    opt = PORT.newton(hessian_fraction=1.0)
    w0 = PORT.w0(X.shape[1])
    ck = tstage.StageCheckpointer(str(tmp_path), keep=2)
    engine = tel.ElasticBetEngine(schedule=tcore.BETSchedule(n0=32))
    engine.stage_callback = ck
    topo = tdist.SimulatedTopology(3, devices=(torch.device("cpu"),))
    with tel.ElasticDataset([PORT.store(X, SHARD), PORT.store(y, SHARD)],
                            topology=topo) as dd:
        engine.run(dd, opt, DistributedObjective("squared_hinge", LAM),
                   tcore.FixedSteps(inner_steps=1, final_steps=1), w0=w0,
                   clock=tcore.SimulatedClock(),
                   eval_data=(torch.from_numpy(X), torch.from_numpy(y)))
        ref = [m.snapshot() for m in dd.host_meters]
    latest = ck.latest()
    assert len(list(tmp_path.glob(f"{latest.name}_lane*.json"))) == 3
    meta = tstage.peek_stage_meta(latest)
    assert ttiers.is_lane_pointer(meta["dataset"]["host_meters"])
    # the reference inflates the port's lane files, and so does the port
    assert jtiers.load_lane_slices(tmp_path,
                                   meta["dataset"]["host_meters"]) == ref
    restored = ck.restore(w0, opt.init(w0))
    assert restored.meta["dataset"]["host_meters"] == ref
    kept = {p.stem for p in tmp_path.glob("stage_*.npz")}
    assert len(kept) == 2
    for lane in tmp_path.glob("stage_*_lane*.json"):
        assert lane.name.rsplit("_lane", 1)[0] in kept


# ------------------------------------------------- prefetcher backpressure
class GatedStore(tshards.InMemoryShardStore):
    """A store whose loads wait on a per-shard gate; ``started[i]`` is set
    when shard i's load begins."""

    def __init__(self, data, shard_size, gated=()):
        super().__init__(data, shard_size)
        self.gates = {i: threading.Event() for i in gated}
        self.started = {i: threading.Event() for i in range(self.num_shards)}

    def load(self, shard):
        self.started[shard].set()
        if shard in self.gates:
            assert self.gates[shard].wait(TIMEOUT_S)
        return super().load(shard)


class WatchingRecorder(tobs.EventRecorder):
    """Notes, as each ``prefetch.scheduled`` is emitted, whether its shard
    was already submitted or its load already started."""

    def __init__(self, prefetcher, store):
        super().__init__()
        self.prefetcher, self.store, self.early = prefetcher, store, []

    def instant(self, name, **kw):
        if name == "prefetch.scheduled":
            i = kw["shard"]
            if i in self.prefetcher._pending or self.store.started[i].is_set():
                self.early.append(i)
        return super().instant(name, **kw)


def test_hidden_take_records_zero_blocked_time():
    X, _ = problem(n=64)
    for side in SIDES:
        store = side.throttled(side.store(X, SHARD), delay_s=0.02)
        meter = side.meter()
        with side.prefetcher([store], meter) as p:
            (rows,) = p.take(0, hidden=True)
            np.testing.assert_array_equal(rows, X[:SHARD])
            assert meter.blocked_time_s == 0.0       # overlapped by contract
            assert meter.load_time_s > 0.0
            (rows,) = p.take(1)                      # demand take blocks
            assert meter.blocked_time_s > 0.0


def _backpressure(side, X):
    store = side.store(X, SHARD)
    with pytest.raises(ValueError, match="max_inflight") as e:
        side.prefetcher([store], max_inflight=0)
    seen = [str(e.value)]
    with side.prefetcher([store], max_inflight=2) as p:
        p.schedule([0, 1, 2, 3])
        seen.append((p.inflight(), p.scheduled()))
        (rows,) = p.take(0)                          # frees a slot -> pump
        np.testing.assert_array_equal(rows, X[:SHARD])
        seen.append((p.inflight(), p.scheduled()))
        (rows,) = p.take(3)                          # backlogged: demand
        np.testing.assert_array_equal(rows, X[3 * SHARD: 4 * SHARD])
        seen.append((p.inflight(), p.scheduled()))
        for i in (1, 2):
            (rows,) = p.take(i)
            np.testing.assert_array_equal(rows,
                                          X[i * SHARD: (i + 1) * SHARD])
        seen.append((p.inflight(), p.scheduled()))
    return seen


def test_max_inflight_backpressures_hints_not_demand():
    seen = both(_backpressure, problem(n=128)[0])
    assert seen[1:] == [(2, [0, 1, 2, 3]), (2, [1, 2, 3]), (2, [1, 2]),
                        (0, [])]


def test_tiered_corpus_threads_max_inflight_through():
    X, y = problem(n=128)
    for side in SIDES:
        with tiered(side, X, y, hbm_rows=128, max_inflight=3) as tc:
            assert tc.prefetcher.max_inflight == 3
            tc.window(128)
            assert tc.prefetcher.inflight() == 0     # everything drained


@pytest.mark.parametrize("max_inflight", [None, 2])
def test_prefetcher_announces_a_shard_before_its_load_starts(max_inflight):
    """``prefetch.scheduled`` goes out before the shard's load is submitted,
    whether it goes straight to the pool or waits in the backlog; a
    backlogged load starts only as an earlier one is taken, and the
    depth counter carries the backlog."""
    X, _ = problem(n=128)
    store = GatedStore(X, SHARD, gated=[0])
    with tprefetch.Prefetcher([store], tshards.DataAccessMeter(),
                              max_inflight=max_inflight) as p:
        rec = WatchingRecorder(p, store)
        tattach_prefetcher(p, rec, host=0)
        p.schedule([0, 1, 2, 3])
        assert store.started[0].wait(TIMEOUT_S)
        if max_inflight is not None:
            assert p.inflight() == 2 and p.unfinished() == [0, 1, 2, 3]
        store.gates[0].set()
        for i in range(4):
            (rows,) = p.take(i)
            np.testing.assert_array_equal(rows, X[i * SHARD:(i + 1) * SHARD])
    assert rec.early == []
    evs = rec.event_dicts()
    depths = [e["fields"] for e in evs if e["name"] == "prefetch.depth"]
    backlog = 0 if max_inflight is None else 2
    assert depths[0] == {"inflight": 4 - backlog, "backlog": backlog}
    seq: dict = {}
    for e in evs:
        if e["name"] != "prefetch.depth":
            seq.setdefault(e["fields"]["shard"], {})[e["name"]] = e["seq"]
    for i in range(4):
        s = seq[i]
        assert s["prefetch.scheduled"] < s["prefetch.loaded"] \
            < s["prefetch.landed"], (i, s)


def test_prefetcher_close_between_announce_and_submit_submits_nothing():
    """A close racing ``schedule`` between its announce and its submit
    wins: nothing is submitted to the shut pool and no error escapes."""
    X, _ = problem(n=64)
    store = GatedStore(X, SHARD)
    p = tprefetch.Prefetcher([store])

    class Closer(tobs.EventRecorder):
        def instant(self, name, **kw):
            if name == "prefetch.scheduled":
                p.close()
            return super().instant(name, **kw)

    p.recorder = Closer()
    p.schedule([0, 1])
    assert p.scheduled() == [] and not store.started[0].is_set()
    with pytest.raises(RuntimeError, match="closed"):
        p.take(0)


# --------------------------------------------------------------- spec gate
def _tiered_spec(api, data_kw=None, **tiering):
    kw = dict(dataset="w8a_like", scale=0.02, plane="plane",
              store="memory", shard_size=64,
              tiering=api.TieringSpec(**tiering))
    kw.update(data_kw or {})
    return api.RunSpec(
        data=api.DataSpec(**kw),
        policy=api.PolicySpec("fixed_steps", {"inner_steps": 2,
                                              "final_steps": 4}),
        optimizer=api.OptimizerSpec("newton_cg", {"hessian_fraction": 1.0}),
        schedule=api.ScheduleSpec(n0=128))


BAD = {
    "host_plane": (({"plane": "host"},), dict(enabled=True,
                                               hbm_bytes=1 << 20), None),
    "lm": (({"kind": "lm"},), dict(enabled=True, hbm_bytes=1 << 20), None),
    "no_budget": ((), dict(enabled=True), None),
    "host_bytes": ((), dict(enabled=True, hbm_bytes=1 << 20,
                            host_bytes=-1), None),
    "max_inflight": ((), dict(enabled=True, hbm_bytes=1 << 20,
                              max_inflight=0), None),
    "hosts": ((), dict(enabled=True, hbm_bytes=1 << 20),
              ("topology", lambda api: api.TopologySpec(hosts=2))),
    "disabled": ((), dict(hbm_bytes=1 << 20), None),
    "manager": ((), dict(enabled=True, hbm_bytes=1 << 20,
                         manager="nonesuch"), None),
    "two_track": ((), dict(enabled=True, hbm_bytes=1 << 20),
                  ("policy", lambda api: api.PolicySpec(
                      "two_track", {"final_steps": 4}))),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_tiering_spec_validation_rejects_bad_combos(case):
    """Each combination the reference refuses, the port refuses with the
    reference's error and message."""
    data_kw, tiering, replace = BAD[case]
    msgs = []
    for api, kw in ((R, {}), (P, {"device": "cpu"})):
        spec = _tiered_spec(api, *data_kw, **tiering)
        if replace is not None:
            spec = spec.replace(**{replace[0]: replace[1](api)})
        with pytest.raises(api.SpecError) as e:
            api.build(spec, **kw)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_tier_manager_registry_names_the_ring():
    assert P.TIERS.get("ring") is ttiers.RingTierManager
    assert P.TIERS.names() == R.TIERS.names()

    class Wide(ttiers.RingTierManager):
        name = "wide"

    try:
        assert P.register_tier_manager("wide", Wide) is Wide
        sess = P.build(_tiered_spec(P, enabled=True, hbm_bytes=64 * 1204,
                                    manager="wide"), device="cpu")
        with sess:
            assert type(sess.dataset.manager) is Wide
    finally:
        P.TIERS._entries.pop("wide", None)


def test_session_tiered_rotation_run_end_to_end():
    """w8a_like @0.02 is 163 rows of 1204 bytes; one 64-row shard of
    budget forces the rotation sweep (3 segments at the final stage)."""
    recs = []
    for api, kw in ((R, {}), (P, {"device": "cpu"})):
        session = api.build(_tiered_spec(api, enabled=True,
                                         hbm_bytes=64 * 1204), **kw)
        assert type(session.dataset).__name__ == "TieredCorpus"
        trace = session.run()
        assert int(trace.points[-1].window) == session.dataset.n
        assert trace.meta["tiers"]["mode"] == "rotate"
        meters = session.meters
        assert meters["tiers"]["resident_reuploads"] == 0
        assert meters["tiers"]["staged_commits"] > 0
        tiers = dict(trace.meta["tiers"], meter=untimed(meters["tiers"]))
        recs.append((trace, [tiers, untimed(meters["data_plane"]),
                             meters["clock"], trace.meta["host_transfers"]]))
    (tr_ref, want), (tr, got) = recs
    assert got == want
    assert _columns(tr) == _columns(tr_ref)
    assert_f_close(tr, tr_ref, RTOL_F_SWEEP)
    # the port's tiered problem stays in host memory; the eval probe and
    # the parameters are the only tensors the build puts on the device
    assert session.problem.X.device.type == "cpu"
    assert session.eval_data[0].shape[0] == session.spec.data.eval_rows


# ------------------------------------------- tiered checkpoints across packages
def _resume_spec(api, directory):
    """Four stages (32, 64, 128, 163 rows) under a 64-row budget: stage 2
    is the first to sweep; the run is killed after it."""
    spec = _tiered_spec(api, enabled=True, hbm_bytes=64 * 1204)
    return spec.replace(
        data=spec.data.replace(shard_size=SHARD),
        schedule=api.ScheduleSpec(n0=32),
        checkpoint=api.CheckpointSpec(directory=directory))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tiered_stage_checkpoint_crosses_packages(tmp_path, writer):
    """A ``"tiered"`` stage checkpoint written by one package resumes in
    the other; the stitched run matches the reference's uninterrupted run
    (columns equal, f̂ within RTOL_F), its rewarm bounded by the hot
    window."""
    spec = _resume_spec(R, str(tmp_path))
    whole = R.build(spec.replace(checkpoint=R.CheckpointSpec())).run()
    killer, resumer, kw = (R, P, {}) if writer == "reference" \
        else (P, R, {"device": "cpu"})
    sess = killer.build(killer.RunSpec.from_json(spec.to_json()), **kw)

    def die(end):
        if end.info.stage == 2:
            raise _Killed

    sess.on_stage(die)
    with pytest.raises(_Killed):
        sess.run()
    meta = (tstage if writer == "port" else jel).peek_stage_meta(
        tmp_path / "stage_0002")
    assert meta["dataset"]["kind"] == "tiered"
    assert meta["dataset"]["tier"]["mode"] == "rotate"
    resumed = resumer.resume_session(
        tmp_path, **({"device": "cpu"} if resumer is P else {}))
    tr = resumed.run()
    assert tr.meta["resumed_from_stage"] == 2
    for col in COLUMNS:
        got = [p[col] for p in resumed.restored.trace_points()] + \
            tr.column(col)
        assert got == whole.column(col), col
    for col in ("f_window", "f_full"):
        got = [p[col] for p in resumed.restored.trace_points()] + \
            tr.column(col)
        np.testing.assert_allclose(got, whole.column(col),
                                   rtol=RTOL_F_SWEEP)
    assert tr.meta["resume_rewarm"]["rewarm_examples"] == 64
    assert tr.meta["tiers"]["mode"] == "rotate"
