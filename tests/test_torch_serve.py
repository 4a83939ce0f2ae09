"""Serve-while-you-train in the port, on the CPU — ``tests/test_serve.py``
case for case (online ingestion, the traffic-driven policy, hot
checkpoint swap, the closed loop behind ``RunSpec.serve``), plus: a
checkpoint the reference wrote adopted by the port's server, the server's
weights never aliased by the trainer's, and a reduced ``build_loop`` whose
report columns and logged corpus equal the reference's on the same spec
and weights."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.api import RunSpec as JRunSpec
from repro.elastic.checkpoint import StageCheckpointer as JCheckpointer
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.api import (CheckpointSpec, DataSpec, ModelSpec, ObsSpec,
                             OptimizerSpec, PolicySpec, RunSpec,
                             ScheduleSpec, ServeSpec, SpecError, build,
                             check_resume_spec, resume_session)
from repro_torch.api import run as trun
from repro_torch.core.engine import (BETSchedule, BetEngine, FixedSteps,
                                     StageEnd, StageInfo, StageRecords,
                                     TwoTrack)
from repro_torch.core.timemodel import SimulatedClock
from repro_torch.core.trace import Trace
from repro_torch.data.plane import StreamingDataset
from repro_torch.dist.ownership import ShardOwnership
from repro_torch.elastic.checkpoint import (StageCheckpointer,
                                            load_stage_checkpoint,
                                            peek_stage_meta)
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.obs import events as ev
from repro_torch.optim.api import tree_leaves
from repro_torch.serve import (BetServer, CheckpointWatcher,
                               OnlineShardStore, TrafficDriven, build_loop)

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)


def _rows(lo, n, width=3):
    return np.arange(lo, lo + n, dtype=np.int32)[:, None] * \
        np.ones((1, width), np.int32)


# ------------------------------------------------------------ OnlineShardStore
def test_online_store_exposes_sealed_shards_only():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=16)
    assert st.append(_rows(0, 3)) == 0          # tail only: nothing sealed
    assert st.num_examples == 0 and st.total_logged == 3
    assert st.append(_rows(3, 3)) == 4          # one full shard sealed
    assert st.total_logged == 6
    np.testing.assert_array_equal(st.load(0), _rows(0, 4))
    with pytest.raises(IndexError):
        st.load(1)                              # tail is not visible
    np.testing.assert_array_equal(st.prefix(4), _rows(0, 4))
    with pytest.raises(ValueError):
        st.prefix(5)                            # beyond sealed


def test_online_store_close_seals_ragged_tail_idempotently():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=16)
    st.append(_rows(0, 6))
    assert st.num_examples == 4
    assert st.close() == 6                      # tail becomes the last shard
    assert st.close() == 6                      # idempotent
    np.testing.assert_array_equal(st.load(1), _rows(4, 2))
    with pytest.raises(RuntimeError):
        st.append(_rows(6, 1))                  # frozen


def test_online_store_rejects_overflow_and_bad_shapes():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=8)
    st.append(_rows(0, 6))
    with pytest.raises(ValueError):
        st.append(_rows(6, 3))                  # 6 + 3 > capacity 8
    with pytest.raises(ValueError):
        st.append(np.zeros((2, 5), np.int32))   # wrong item_shape
    st.append(_rows(6, 1)[0])                   # single example is fine
    assert st.total_logged == 7


def test_online_store_concurrent_reads_during_appends():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=256)
    errs = []

    def reader():
        for _ in range(500):
            n = st.num_examples
            if n:
                try:
                    st.load(n // st.shard_size - 1)
                except Exception as e:          # pragma: no cover
                    errs.append(e)
    t = threading.Thread(target=reader)
    t.start()
    for i in range(256):
        st.append(_rows(i, 1))
    t.join(timeout=60)
    assert not t.is_alive()
    assert not errs
    np.testing.assert_array_equal(st.prefix(256), _rows(0, 256))


# --------------------------------------------------- plane + ownership sizing
def test_streaming_plane_preallocates_at_capacity_no_reupload():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=32)
    st.append(_rows(0, 8))
    with StreamingDataset([st], masked=True, device="cpu") as ds:
        assert ds.windows[0].capacity == 32     # runtime-discovered capacity
        ds.window(8)
        st.append(_rows(8, 8))                  # traffic keeps landing
        ds.window(16)
        m = ds.meter.snapshot()
        # append-only end to end: grown residency uploads only the new rows
        assert m["examples_uploaded"] == 16
        assert m["examples_loaded"] == 16


def test_ownership_prefix_invariant_extends_to_capacity():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=32)
    st.append(_rows(0, 8))
    own = ShardOwnership.for_store(st, num_hosts=2)
    assert own.num_examples == 32               # capacity, not sealed count
    assert own.num_shards == 8


# ------------------------------------------------------------- TrafficDriven
def test_traffic_driven_holds_stage_until_arrivals_then_expands():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=32)
    st.append(_rows(0, 8))
    pumped = []

    def pump():
        pumped.append(1)
        st.append(_rows(8 + 4 * (len(pumped) - 1), 4))
    pol = TrafficDriven(inner_steps=1).attach(st, pump)
    info = StageInfo(stage=0, n_t=8, n_prev=8, is_final=False, N=8, n_next=16)
    pol.stage_begin(info)
    assert pol.plan_steps(info, 0) == 1
    assert not pol.should_expand(info, StageRecords())  # 12 < 16 after pump
    assert pol.should_expand(info, StageRecords())      # 16 sealed now
    assert pol.holds_total == 2 and len(pumped) == 2


def test_traffic_driven_closed_source_and_hold_bound():
    st = OnlineShardStore((3,), np.int32, shard_size=4, capacity=32)
    st.append(_rows(0, 8))
    pol = TrafficDriven(max_hold_chunks=3).attach(st)   # no pump wired
    info = StageInfo(stage=0, n_t=8, n_prev=8, is_final=False, N=8, n_next=16)
    pol.stage_begin(info)
    assert not pol.should_expand(info, StageRecords())
    assert not pol.should_expand(info, StageRecords())
    with pytest.raises(RuntimeError, match="close the source or wire"):
        pol.should_expand(info, StageRecords())
    st.close()
    assert pol.should_expand(info, StageRecords())      # closed == arrived
    # final stages and offline (no-source) policies always expand
    assert TrafficDriven().should_expand(
        StageInfo(0, 8, 8, True, 8, None), StageRecords())
    assert TrafficDriven().should_expand(info, StageRecords())


# ---------------------------------------------------------------- run_online
def test_run_online_rejects_unusable_configurations():
    class _DS:
        n = 0
    eng = BetEngine(schedule=BETSchedule(n0=4))
    with pytest.raises(ValueError, match="eval_data"):
        eng.run_online(_DS(), None, None, FixedSteps(1, 1))
    with pytest.raises(ValueError, match="two_track"):
        eng.run_online(_DS(), None, None, TwoTrack(final_steps=2),
                       eval_data=torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="sealed example"):
        eng.run_online(_DS(), None, None, FixedSteps(1, 1),
                       eval_data=torch.zeros((2, 3)))


# -------------------------------------------------------------- hot swapping
@pytest.fixture(scope="module")
def serve_cfg():
    return tconfigs.reduced(tconfigs.get("qwen3_0p6b"))


@pytest.fixture(scope="module")
def serve_params(serve_cfg):
    return (TT.init_params(serve_cfg, 0, device="cpu"),
            TT.init_params(serve_cfg, 1, device="cpu"))


def _prompts(cfg, b=2, s=8):
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(
        0, min(cfg.vocab_size, 256), (b, s)).astype(np.int32))


def test_inflight_batch_finishes_under_pinned_weights(serve_cfg, serve_params):
    """A swap mid-generation must not change the in-flight batch's output:
    its KV cache was built under the old weights, so it finishes on them."""
    old, new = serve_params
    prompts = _prompts(serve_cfg)
    ref = BetServer(serve_cfg, old, cache_len=16).generate(
        prompts, gen_tokens=4)
    srv = BetServer(serve_cfg, old, cache_len=16)
    batch = srv.start(prompts)
    batch.step()
    batch.step()
    assert srv.adopt(0, new)                    # hot swap mid-generation
    batch.step()
    batch.step()
    assert torch.equal(batch.finish(), ref)
    # ...while the *next* batch serves the adopted weights
    ref_new = BetServer(serve_cfg, new, cache_len=16).generate(
        prompts, gen_tokens=4)
    fresh = srv.start(prompts)
    assert fresh.stage == 0
    for _ in range(4):
        fresh.step()
    assert torch.equal(fresh.finish(), ref_new)
    assert srv.requests_completed == srv.requests_started


def test_adopt_rejects_stale_stages(serve_cfg, serve_params):
    old, new = serve_params
    srv = BetServer(serve_cfg, old, cache_len=16, stage=2)
    assert not srv.adopt(2, new)                # not fresher
    assert not srv.adopt(1, new)
    assert srv.adopt(3, new) and srv.adopted_stage == 3
    assert srv.swap_count == 1


# ------------------------------------------------- atomic checkpoint publish
def _stage_end(params, stage=0, spec=None):
    return StageEnd(
        info=StageInfo(stage=stage, n_t=4, n_prev=4, is_final=True, N=4,
                       n_next=None),
        params=params, opt_state={"m": torch.zeros(3)},
        clock=SimulatedClock(), dataset=object(), trace=Trace("t"),
        step_count=3, stages=1, transfers=1)


def test_checkpointer_publishes_atomically(tmp_path):
    params = {"w": torch.arange(3.0)}
    ck = StageCheckpointer(str(tmp_path), spec={"name": "x"})
    rec = ev.EventRecorder()
    ck.recorder = rec
    ck.save(_stage_end(params))
    # no temp debris, and nothing tmp-shaped ever matches the reader's glob
    assert not list(tmp_path.glob(".tmp_*"))
    assert [p.name for p in sorted(tmp_path.glob("stage_*.npz"))] == \
        ["stage_0000.npz"]
    meta = peek_stage_meta(tmp_path / "stage_0000")
    assert meta["spec"] == {"name": "x"}
    assert meta["cursor"]["stage"] == 0
    restored = load_stage_checkpoint(tmp_path / "stage_0000", params, None)
    assert torch.equal(restored.params["w"], params["w"])
    (span,) = rec.event_dicts()
    assert span["name"] == "checkpoint.publish" and span["kind"] == "span"
    assert span["fields"] == {"stage": 0, "n_t": 4}


def test_watcher_adopts_published_stages_in_order(tmp_path, serve_cfg,
                                                  serve_params):
    old, new = serve_params
    srv = BetServer(serve_cfg, old, cache_len=16)
    watcher = CheckpointWatcher(str(tmp_path), old, srv)
    assert watcher.published_stage() is None
    assert not watcher.poll()                   # nothing published yet
    ck = StageCheckpointer(str(tmp_path))
    ck.save(_stage_end(new, stage=0))
    assert watcher.staleness() == 1
    assert watcher.poll() and srv.adopted_stage == 0
    assert watcher.staleness() == 0
    assert not watcher.poll()                   # already fresh
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(srv.params), tree_leaves(new)))


def test_watcher_adopts_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference's StageCheckpointer publishes stage 1; the port's
    watcher adopts it, and the served weights equal the reference's bit
    for bit (bfloat16 included)."""
    jcfg = jconfigs.reduced(jconfigs.get("qwen3_0p6b"))
    tcfg = tconfigs.reduced(tconfigs.get("qwen3_0p6b"))
    jp = JT.init_params(jcfg, jax.random.key(3))
    from repro.core.engine import StageEnd as JStageEnd
    from repro.core.engine import StageInfo as JStageInfo
    from repro.core.timemodel import SimulatedClock as JClock
    from repro.core.trace import Trace as JTrace
    JCheckpointer(str(tmp_path)).save(JStageEnd(
        info=JStageInfo(stage=1, n_t=4, n_prev=4, is_final=True, N=4,
                        n_next=None),
        params=jp, opt_state=None, clock=JClock(), dataset=object(),
        trace=JTrace("t"), step_count=3, stages=2, transfers=2))
    like = TT.init_params(tcfg, 0, device="cpu")
    srv = BetServer(tcfg, like, cache_len=16)
    watcher = CheckpointWatcher(str(tmp_path), like, srv)
    assert watcher.staleness() == 2             # stage 1 against -1
    assert watcher.poll() and srv.adopted_stage == 1
    want = convert.params_from_jax(jax.device_get(jp), device="cpu")
    for name, stack in want.items():
        got = srv.params[name]
        if isinstance(stack, dict):
            for k in stack:
                assert torch.equal(got[k], stack[k]), (name, k)
        else:
            assert torch.equal(got, stack), name


# --------------------------------------------------------- specs + front door
def _serve_spec(ckpt_dir, capacity=48, swap=True, **model_kw):
    return RunSpec(
        name="t_serve",
        data=DataSpec(kind="lm", plane="plane", corpus_size=capacity,
                      seq_len=32, eval_rows=16, shard_size=8, seed=0),
        policy=PolicySpec("traffic_driven",
                          params={"inner_steps": 1, "final_steps": 2}),
        optimizer=OptimizerSpec("adamw_lm",
                                params={"lr": 1e-3, "batch_size": 4}),
        schedule=ScheduleSpec(n0=16, growth=2.0, step_cost="batch"),
        checkpoint=CheckpointSpec(directory=str(ckpt_dir)),
        serve=ServeSpec(enabled=True, requests_per_tick=8, prompt_len=16,
                        capacity=capacity, swap=swap),
        model=ModelSpec(arch="qwen3-0.6b", reduced=True, **model_kw),
    )


def test_build_refuses_serve_specs_and_points_to_build_loop(tmp_path):
    with pytest.raises(SpecError, match="build_loop"):
        build(_serve_spec(tmp_path), device="cpu")


def test_build_loop_validates_serve_geometry(tmp_path):
    spec = _serve_spec(tmp_path)
    with pytest.raises(SpecError, match="enabled"):
        build_loop(spec.replace(serve=ServeSpec(enabled=False)),
                   device="cpu")
    bad_len = spec.replace(serve=spec.serve.replace(gen_tokens=10))
    with pytest.raises(SpecError, match="tile training rows"):
        build_loop(bad_len, device="cpu")       # 16 + 10 != 33
    with pytest.raises(SpecError, match="below n0"):
        build_loop(spec.replace(serve=spec.serve.replace(capacity=8)),
                   device="cpu")
    with pytest.raises(SpecError, match="directory"):
        build_loop(spec.replace(checkpoint=CheckpointSpec()), device="cpu")


def test_build_loop_refuses_health_naming_the_observability_slice(tmp_path):
    spec = _serve_spec(tmp_path).replace(
        obs=ObsSpec(enabled=True, health=True))
    with pytest.raises(SpecError, match="not yet ported") as e:
        build_loop(spec, device="cpu")
    assert "observability slice (ROADMAP queue A11)" in str(e.value)


def test_check_resume_spec_flags_critical_divergence(tmp_path):
    spec = _serve_spec(tmp_path)
    stored = spec.to_dict()
    check_resume_spec(spec, stored)             # identical: fine
    stored["data"]["seq_len"] = 64
    with pytest.raises(SpecError, match="data"):
        check_resume_spec(spec, stored)


# ------------------------------------------------------------ the closed loop
def test_closed_loop_trains_swaps_and_freezes_the_log(tmp_path):
    loop = build_loop(_serve_spec(tmp_path), device="cpu")
    rep = loop.run()
    # the window expanded: n0=16 -> 32 -> 48 under growth 2.0
    assert rep["stages"] >= 3
    assert rep["logged_examples"] == 48 and loop.store.closed
    # every request completed; the log is exactly the served traffic
    assert rep["server"]["requests_completed"] == \
        rep["server"]["requests_started"] == rep["ticks"] * 8
    # append-only residency: each logged example uploaded exactly once
    assert rep["data_plane"]["examples_uploaded"] == 48
    assert rep["data_plane"]["examples_loaded"] == 48
    # the server drained to the newest published checkpoint
    assert rep["server"]["swap_count"] >= 1
    assert rep["staleness"]["final"] == 0
    assert rep["staleness"]["adopted_stage"] == rep["checkpoints"][-1]
    # the report's RunReport columns come from the one event stream
    assert [r["stage"] for r in rep["stage_table"]] == \
        list(range(rep["stages"]))
    assert rep["serve_events"]["ticks"] == rep["ticks"]
    assert rep["serve_events"]["holds"] == rep["holds"]
    assert len(rep["serve_events"]["swaps"]) == rep["server"]["swap_count"]
    # serve-run checkpoints do not resume through the offline front door:
    # the corpus was the request log, which a rebuild cannot regenerate
    with pytest.raises(SpecError, match="serve"):
        resume_session(tmp_path, device="cpu")


def test_server_params_never_alias_the_trainers(tmp_path, serve_cfg):
    """The server's slot holds the params0 that training starts from: a
    train step on the trainer's copy (run_online copies w0) leaves the
    served tensors bitwise unchanged, and shares no storage with them."""
    loop = build_loop(_serve_spec(tmp_path, swap=False), device="cpu")
    before = [t.clone() for t in tree_leaves(loop.server.params)]
    ptrs = {t.data_ptr() for t in tree_leaves(loop.server.params)}
    rep = loop.run()
    assert rep["server"]["swap_count"] == 0
    trained = tree_leaves(loop.trace.params)
    assert not ptrs & {t.data_ptr() for t in trained}
    assert any(not torch.equal(a, b) for a, b in zip(before, trained))
    for a, b in zip(before, tree_leaves(loop.server.params)):
        assert torch.equal(a, b)
    # one explicit step through the family's train step as well
    params = loop.params0
    step = tsteps.make_train_step(loop.cfg)
    rows = torch.from_numpy(loop.store.prefix(4).astype(np.int64))
    step(params, tsteps.init_opt_state(params),
         {"tokens": rows[:, :-1], "labels": rows[:, 1:]})
    for a, b in zip(before, tree_leaves(loop.server.params)):
        assert torch.equal(a, b)


def test_obs_dir_lands_events_trace_and_report(tmp_path):
    spec = _serve_spec(tmp_path / "ck").replace(obs=ObsSpec(
        enabled=True, dir=str(tmp_path / "obs"), chrome_trace=True))
    rep = build_loop(spec, device="cpu").run()
    out = tmp_path / "obs"
    assert rep["obs_dir"] == str(out)
    version, events = ev.read_log(out / "events.jsonl")
    assert version == ev.SCHEMA_VERSION and not ev.validate_events(events)
    names = {e["name"] for e in events}
    assert {"stage.begin", "stage.acquire", "stage.compute",
            "engine.transfer", "expand.decision", "stage.flush",
            "stage.totals", "stage.end", "checkpoint.publish",
            "serve.tick", "serve.ingest", "serve.swap", "prefetch.scheduled",
            "prefetch.loaded", "prefetch.landed", "meter.load",
            "clock.charge", "run.meta"} <= names
    assert (out / "trace.json").exists()
    assert (out / "report.json").exists() and (out / "report.txt").exists()


def _report_columns(rep):
    """The deterministic columns of a closed-loop report."""
    keep = ("bytes_loaded", "examples_loaded", "loads", "prefetched_loads",
            "bytes_uploaded", "examples_uploaded", "uploads",
            "examples_accessed")
    stage_keys = ("stage", "window", "steps", "bytes_loaded",
                  "examples_loaded", "bytes_uploaded", "examples_uploaded",
                  "transfers", "clock_time", "clock_accesses",
                  "clock_loaded")
    server = {k: v for k, v in rep["server"].items()
              if k not in ("swap_latency_mean_s", "swap_latency_max_s",
                           "serve_time_s", "tokens_per_s")}
    return {
        "ticks": rep["ticks"], "requests": rep["requests"],
        "logged": rep["logged_examples"], "stages": rep["stages"],
        "holds": rep["holds"], "checkpoints": rep["checkpoints"],
        "clock": rep["clock"], "server": server,
        "meter": {k: rep["data_plane"][k] for k in keep},
        "stage_table": [{k: r[k] for k in stage_keys}
                        for r in rep["stage_table"]],
        "staleness": rep["staleness"],
        "serve_events": {k: v for k, v in rep["serve_events"].items()
                         if k not in ("serve_wall_s", "swaps")},
        "swapped_stages": [s["stage"] for s in rep["serve_events"]["swaps"]],
    }


def test_closed_loop_matches_the_references(tmp_path):
    """The same reduced spec in float32 through both packages' build_loop,
    the reference's initial weights carried across: every count of the
    report and the logged corpus, token for token; f̂ within 1e-4."""
    spec = _serve_spec(tmp_path / "torch", overrides={"dtype": "float32"})
    jspec = JRunSpec.from_json(spec.replace(checkpoint=CheckpointSpec(
        directory=str(tmp_path / "jax"))).to_json())
    jloop = jserve.build_loop(jspec)
    want = jloop.run()
    p0 = convert.params_from_jax(jax.device_get(jloop.params0),
                                 device="cpu")
    loop = build_loop(spec, device="cpu", params0=p0)
    got = loop.run()
    assert _report_columns(got) == _report_columns(want)
    n = want["logged_examples"]
    np.testing.assert_array_equal(loop.store.prefix(n),
                                  jloop.store.prefix(n))
    np.testing.assert_allclose(loop.trace.column("f_full"),
                               jloop.trace.column("f_full"), rtol=1e-4)


def test_run_routes_serve_presets_to_build_loop(tmp_path, monkeypatch):
    """``api.run`` on a serve preset returns the finished loop (the
    preset's checkpoint directory is relative: run it in tmp_path)."""
    monkeypatch.chdir(tmp_path)
    loop = trun("qwen3@serve", device="cpu")
    assert loop.store.closed and loop.trace.meta["stages"] >= 2
    assert loop.run_report.serve_summary()["ticks"] == loop.ticks
