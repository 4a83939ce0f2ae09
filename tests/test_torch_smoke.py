"""Pieces of ``chip_smoke.py`` that run on the CPU: its step breakdown
times each kernel's plain-version VJP inside the train step's backward,
by hooks on the kernel's autograd nodes, which it finds by name with
``graph_nodes``, and times the rematerialization apart from them.  Here,
on the reduced LMs, the loss's graph must hold one such node per layer of
the kernel's type, under the names the breakdown looks for, with remat
on; and each convex run of its method phase must call the kernel wrapper
as often as its trace implies.  Its plane, resume, multi-host and elastic
phases run here small."""
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.api as P
from repro_torch.core.engine import BETSchedule, BetEngine
from repro_torch.data.device_window import window_rows
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
    rows = chip_smoke.first_rows({"window_rows": window_rows}, sess, 2)
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
    rows = chip_smoke.first_rows({"window_rows": window_rows}, sess, 2)
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


class _OnCPU:
    """``repro_torch.api`` with ``build`` and ``resume_session`` sent to
    the CPU, as chip_smoke.py's phases call them for the card."""

    def __getattr__(self, name):
        return getattr(P, name)

    @staticmethod
    def build(spec, device="cuda"):
        return P.build(spec, device="cpu")

    @staticmethod
    def resume_session(directory, device="cuda"):
        return P.resume_session(directory, device="cpu")


def _cpu_rt(monkeypatch, tmp_path):
    """chip_smoke.py's runtime table on the CPU, with the wrapper counting
    its calls where the card's launches are counted."""
    from repro_torch.launch import methods
    counts = {"linear_value_grad": 0}
    real = tops.linear_value_grad

    def counted(*a, **kw):
        counts["linear_value_grad"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tops, "linear_value_grad", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    ops = type("Ops", (), {"CALLS": counts, "reset_calls": staticmethod(
        lambda: counts.update(linear_value_grad=0)),
        "linear_value_grad": staticmethod(counted)})
    return {"api": _OnCPU(), "ops": ops, "methods": methods,
            "window_rows": window_rows, "tree_leaves": tree_leaves,
            "build_dir": tmp_path}


def test_plane_phases_find_their_specs(tmp_path):
    """The specs of chip_smoke.py's plane phases: quickstart@6 on the plane
    is 768 shards of 64 rows (76.8 KB of X each); the memmap run is
    BENCH_data.json's fig3 setting; the LM runs are on the plane, and the
    resume run is falcon-mamba-7b at full width, one layer, one checkpoint
    kept, two racing stages and the final phase."""
    import json
    from repro_torch.api import session
    data, base = chip_smoke.quickstart_specs(P)
    sess = P.build(P.RunSpec(**dict(base, data=data.replace(plane="plane"))),
                   device="cpu")
    store = sess.dataset.stores[0]
    assert (store.num_examples, store.num_shards, store.shard_size) == \
        (49152, 768, 64)
    assert store.shard_size * store.example_nbytes == 76800
    sess.close()
    bench = json.loads((Path(chip_smoke.__file__).parent
                        / "BENCH_data.json").read_text())
    mm = P.DataSpec(lam=1e-3, store="memmap", workdir=str(tmp_path),
                    plane="plane", **chip_smoke.MEMMAP_DATA)
    sess = P.build(P.RunSpec(data=mm), device="cpu")
    ds = sess.dataset
    assert f"fig3/{mm.dataset}" == bench["workload"]
    assert (ds.n, ds.d, mm.shard_size, mm.delay_ms) == \
        (bench["n"], bench["d"], bench["shard_size"], bench["delay_ms"])
    assert chip_smoke.MEMMAP_N0 == max(128, min(ds.d, ds.n // 8))
    assert chip_smoke.MEMMAP_HESSIAN == min(1.0, max(0.1, 2.0 * ds.d / ds.n))
    sess.close()
    for arch, kw in (("falcon-mamba-7b", {}),
                     ("recurrentgemma-9b", {"layers": chip_smoke.HY_LAYERS})):
        spec = chip_smoke.lm_spec(P, arch=arch, reduced=False,
                                  policy="fixed_steps", corpus=64,
                                  seq_len=32, n0=32, **kw)
        assert spec.data.plane == "plane"
        session._validate(spec)
    spec = chip_smoke.lm_spec(
        P, reduced=False, policy="two_track",
        corpus=chip_smoke.RESUME_CORPUS, seq_len=chip_smoke.LM_SEQ,
        n0=chip_smoke.RESUME_N0, max_stage_iters=chip_smoke.RESUME_ITERS,
        layers=chip_smoke.RESUME_LAYERS)
    session._validate(spec)
    cfg = session.lm_config(spec.model)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner) == (1, 4096, 8192)
    engine = BetEngine(schedule=BETSchedule(n0=spec.schedule.n0))
    stages = engine.stage_infos(P.build_policy(spec.policy),
                                chip_smoke.RESUME_CORPUS)
    assert [i.n_t for i in stages] == [128, 256, 256]


def test_convex_plane_phase_holds_the_plane_to_the_host_path(monkeypatch,
                                                            tmp_path):
    """chip_smoke.py's convex plane phase at 1/24 of its size, on the CPU:
    every plane run equals its host-path run bit for bit, meters every
    example once and calls the kernel wrapper as its trace implies."""
    rt = _cpu_rt(monkeypatch, tmp_path)
    assert chip_smoke.convex_plane_phase(torch, rt, scale=0.25) > 0
    assert chip_smoke.FAILED == []
    assert list(tmp_path.iterdir()) == []       # the memmap store is gone


@pytest.mark.parametrize("run", ["convex", "mamba"])
def test_kill_and_resume_stitches_bitwise(monkeypatch, tmp_path, run):
    """chip_smoke.py's kill-and-resume on the CPU: a convex two-track run
    and the reduced falcon-mamba-7b (float32) two-track run, each killed
    after stage 1 and resumed from its checkpoint, equal their whole runs;
    the checkpoint directory is deleted."""
    rt = _cpu_rt(monkeypatch, tmp_path)
    if run == "convex":
        data, base = chip_smoke.quickstart_specs(P, 0.25)
        spec = P.RunSpec(name="convex", policy=P.PolicySpec(
            "two_track", {"final_steps": 4}),
            **dict(base, data=data.replace(plane="plane", shard_size=32)))
    else:
        spec = chip_smoke.lm_spec(
            P, reduced=True, policy="two_track", corpus=64, seq_len=16,
            n0=16, max_stage_iters=4, batch=4, eval_rows=8)
        spec = spec.replace(
            data=spec.data.replace(shard_size=16),
            checkpoint=P.CheckpointSpec(keep=1))
    row = chip_smoke.kill_and_resume(torch, rt, spec, 1,
                                     chip_smoke.CONVEX_COLUMNS)
    assert row["differs_from_whole_run"] == [] and chip_smoke.FAILED == []
    assert row["rewarm"]["examples_loaded"] == row["n_t"]
    assert row["checkpoint_bytes"] > 0 and row["checkpoint_read_s"]
    assert 0 < len(row["checkpoints_left_on_disk"]) <= \
        2 * spec.checkpoint.keep                # .npz and .json, rolled
    assert list(tmp_path.iterdir()) == []


def test_dist_phases_hold_their_claims_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's multi-host and elastic convex phases at 1/24 of
    their size on the CPU: B1 called once per non-empty lane per step as
    ``dist_kernel_calls`` reads the trace, the reference benchmarks'
    claims, the killed run bit for bit, the straggler's shards migrated,
    the distributed resume bitwise; the memmap store is gone."""
    rt = _cpu_rt(monkeypatch, tmp_path)
    # card timings (CUDA events) cannot run here: each timed call runs once
    monkeypatch.setattr(chip_smoke, "spin_cycles_per_s", lambda torch: 1.0)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda torch, fn, spin: (
        fn(), {"ms": 0.0, "call_ms": 0.0})[1])
    assert chip_smoke.dist_convex_phase(torch, rt, scale=0.25) > 0
    out = chip_smoke.elastic_convex_phase(torch, rt, scale=0.25)
    assert chip_smoke.FAILED == []
    assert out["straggler"]["shards_migrated"] > 0
    assert out["host_loss"]["reread_examples"] == \
        out["host_loss"]["window_at_loss"] > 0
    assert list(tmp_path.iterdir()) == []


def test_process_phase_runs_over_gloo(monkeypatch, tmp_path):
    rt = _cpu_rt(monkeypatch, tmp_path)
    row = chip_smoke.process_phase(torch, rt, device="cpu")
    assert chip_smoke.FAILED == [] and row["backend"] == "gloo"
    assert all(row["views_bitwise_simulated"])


def test_dist_lm_phase_specs_validate():
    """The LMs of chip_smoke.py's multi-host phase: batches that split over
    the hosts, every lane non-empty from the first stage (the shard
    clamped to n0 // hosts), and one layer of falcon-mamba-7b."""
    from repro_torch.api import session
    from repro_torch.dist import ShardOwnership
    for arch, kw in (
            ("falcon-mamba-7b", dict(corpus=chip_smoke.LM_CORPUS,
                                     seq_len=chip_smoke.LM_SEQ,
                                     layers=chip_smoke.DIST_LM_LAYERS,
                                     batch=chip_smoke.LM_BATCH)),
            ("recurrentgemma-9b", dict(corpus=chip_smoke.HY_CORPUS,
                                       seq_len=chip_smoke.HY_SEQ,
                                       layers=chip_smoke.HY_LAYERS,
                                       batch=chip_smoke.DIST_HY_BATCH))):
        spec = chip_smoke.lm_spec(P, arch=arch, reduced=False,
                                  policy="fixed_steps",
                                  n0=kw["corpus"] // 2,
                                  fixed=chip_smoke.SHORT_STEPS, **kw)
        spec = spec.replace(topology=P.TopologySpec(hosts=chip_smoke.HOSTS))
        session._validate(spec)
        assert kw["batch"] % chip_smoke.HOSTS == 0
        shard = min(spec.data.shard_size, spec.schedule.n0 // chip_smoke.HOSTS)
        full = ShardOwnership(num_shards=-(-kw["corpus"] // shard),
                              num_hosts=chip_smoke.HOSTS, shard_size=shard,
                              num_examples=kw["corpus"]
                              ).min_full_participation_window()
        assert full <= spec.schedule.n0


def _count_kernel_calls(monkeypatch):
    """The kernel wrappers count their calls where the card counts its
    launches (on the CPU they serve the plain versions uncounted), into a
    counter of the test's own: the module's stays empty for the tests
    that check the CPU launches nothing."""
    monkeypatch.setattr(tops, "CALLS", type(tops.CALLS)())
    for name in ("ssm_scan", "rglru_scan", "flash_attention"):
        def counted(*a, real=getattr(tops, name), name=name, **kw):
            tops.CALLS[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(tops, name, counted)


def test_presets_phase_holds_the_claims_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's preset phase (the port's sweep) on the CPU: its
    presets are BENCH_workloads.json's eleven; one of them, a mamba preset
    kernel-routed by its wrapper's calls, runs through the phase with
    every claim of the reference sweep but ``overlap_ge_half``, which
    compares wall seconds that a loaded CPU does not hold steady (the
    card holds ``matrix_green`` whole; ``tests/test_torch_sweep.py`` runs
    the eleven here)."""
    import json
    from repro_torch import workloads
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    bench = json.loads((Path(chip_smoke.__file__).parent
                        / "BENCH_workloads.json").read_text())
    assert [p["name"] for p in bench["presets"]] == \
        [p.name for p in workloads.PRESETS]
    rows = chip_smoke.sweep_phase(
        torch, {"workloads": workloads, "build_dir": tmp_path}, device="cpu",
        names=["falcon-mamba@2stages"])
    assert [r["name"] for r in rows] == ["falcon-mamba@2stages"]
    for r in rows:
        assert r["error"] is None, r
        assert "kernel_routed" in r["claims"]
        assert all(v for k, v in r["claims"].items()
                   if k != "overlap_ge_half"), r
    assert list(tmp_path.iterdir()) == []


def test_obs_phase_runs_small_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's observability phase at 1/24 of its size on the CPU:
    the observed quickstart two-track, inside ``torch.profiler``'s trace,
    bitwise the unobserved one, the trace written, one ``profile.stage``
    a stage with FLOPs, the files written; the 4-host fleet run's lanes,
    causal merge and claims; the temporary directories gone."""
    rt = _cpu_rt(monkeypatch, tmp_path)
    row = chip_smoke.obs_phase(torch, rt, scale=0.25, device="cpu")
    assert row["unobserved_differs"] == []
    assert row["profiler_trace"]["written"]
    assert row["profiler_trace"]["events"] > 0
    assert row["profile"] and all(p["flops"] for p in row["profile"])
    assert not [f for f in chip_smoke.FAILED
                if "claims" not in f or "fleet" in f]
    assert list(tmp_path.iterdir()) == []


def test_transformer_phases_run_small_on_the_cpu(monkeypatch):
    """chip_smoke.py's transformer and moe main paths (on the reduced
    configs in float32, a few steps) and its zoo phase (reduced, 64
    tokens) on the CPU, the card's memory counters stubbed: no kernel
    called, remat on and off bitwise, one region recomputed per layer
    and loss chunk, a moe stack's aux terms in the breakdown, every zoo
    loss finite."""
    from repro_torch import configs, workloads
    from repro_torch.optim import adam
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "max_memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    real = chip_smoke.lm_spec

    def small(api, **kw):
        kw.update(reduced=True, corpus=64, seq_len=32, n0=16, batch=4,
                  eval_rows=8, max_stage_iters=4, fixed=(2, 2))
        return real(api, **kw)

    monkeypatch.setattr(chip_smoke, "lm_spec", small)
    monkeypatch.setattr(chip_smoke, "TF_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "ZOO_SEQ", 64)

    class Reduced:
        @staticmethod
        def get(arch):
            return configs.reduced(configs.get(arch)).with_(
                dtype=torch.float32)

    rt = {"api": _OnCPU(), "ops": tops, "transformer": TT, "adam": adam,
          "tree_map": tree_map, "tree_leaves": tree_leaves,
          "window_rows": window_rows, "configs": Reduced,
          "workloads": workloads,
          "resolve_family": workloads.resolve_family}
    tops.reset_calls()
    runs = [chip_smoke.transformer_main_path_phase(torch, rt, arch, policy)
            for arch, policy in chip_smoke.TF_RUNS]
    rows = chip_smoke.zoo_phase(torch, rt, device="cpu")
    assert chip_smoke.FAILED == []
    assert [r["path"] for r in runs] == ["transformer", "moe"]
    assert all(r["launches"] == {} for r in runs)
    moe = runs[1]["breakdown"]
    assert {"load_balance", "router_z"} <= set(moe["metrics"])
    assert moe["recompute_regions"] == 2 + 1     # 2 layers, 1 loss chunk
    assert [r["arch"] for r in rows] == list(chip_smoke.ZOO)
    assert rows[-1]["mrope"] and rows[-1]["input_mode"] == "embeddings"


def _serve_rt(tmp_path):
    from repro_torch import configs, serve
    from repro_torch.launch import serve as launch_serve
    return {"api": P, "ops": tops, "transformer": TT, "configs": configs,
            "serve": launch_serve, "serve_pkg": serve,
            "tree_map": tree_map, "tree_leaves": tree_leaves,
            "build_dir": tmp_path}


def test_serving_phase_runs_small_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's 3l on the reduced configs: the hybrid's pallas
    prefill calls B2 once and B4 never, the decode steps none, the logits
    within their bounds; generate deterministic; decode against prefill
    for one layer of falcon-mamba-7b and granite-moe-1b-a400m."""
    _count_kernel_calls(monkeypatch)
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    out = chip_smoke.serving_phase(torch, _serve_rt(tmp_path), device="cpu",
                                   reduced=True)
    assert chip_smoke.FAILED == []
    hybrid = out["hybrid"]
    assert hybrid["launches_pallas_128"] == {"flash_attention": 1}
    assert hybrid["launches_xla_128"] == {} == hybrid["launches_decode"]
    assert hybrid["ring_slots"] == 64           # the reduced local window
    assert out["generate"]["deterministic"]
    assert [r["arch"] for r in out["layers"]] == [
        "falcon-mamba-7b", "granite-moe-1b-a400m"]


def test_serve_loop_phases_run_small_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's 3m on reduced falcon-mamba-7b (B3 called 3 x layers
    x steps, every claim that needs no A/B) and 3m' on a smaller setting
    (every claim but the timing of throughput under swap); and the
    serving card-vs-CPU phase with the CPU standing in for the card."""
    _count_kernel_calls(monkeypatch)
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    rt = _serve_rt(tmp_path)
    small = dict(chip_smoke.SERVE_LOOP, reduced=True, layers=None,
                 capacity=64, seq_len=32, prompt=16, n0=16, shard=8,
                 eval_rows=8, batch=4)
    row = chip_smoke.serve_loop_phase(torch, rt, small, device="cpu")
    assert chip_smoke.FAILED == []
    assert row["launches"] == row["launches_implied"] == {
        "ssm_scan": 3 * 2 * row["steps"]}
    assert row["stages"] >= 3 and row["claims"]["resume_bit_compatible"]
    ab = chip_smoke.serve_ab_phase(
        torch, rt, dict(chip_smoke.SERVE_BENCH, capacity=64), device="cpu")
    assert all(v for k, v in ab["claims"].items()
               if k != "throughput_under_swap"), ab["claims"]
    assert all(m.startswith("serve A/B") for m in chip_smoke.FAILED)
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    cmp = chip_smoke.serve_card_vs_cpu_phase(torch, rt, card="cpu")
    assert chip_smoke.FAILED == []
    assert cmp["loop_columns_equal"] and cmp["loop_tokens_equal"]


def test_tiered_phase_specs_and_claims_on_the_cpu(monkeypatch):
    """chip_smoke.py's tiered phase at 2^16 rows (4 shards of its 16,384
    rows) on the CPU: its spec is w8a_like's width, tiered at a quarter
    of the corpus, and a run computes the twelve BENCH_scale claims from
    the meters and the event stream; those that do not compare wall
    seconds hold, and the kernel wrapper is called once a step."""
    from repro_torch.launch import methods
    calls = []
    real = tops.linear_value_grad
    monkeypatch.setattr(tops, "linear_value_grad",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    n = 1 << 16
    spec = chip_smoke.tiered_spec(P, n, n * chip_smoke.TIER_ROW_BYTES // 4,
                                  {"inner_steps": 2, "final_steps": 4},
                                  obs=True)
    sess = P.build(spec, device="cpu")
    ds = sess.dataset
    assert (ds.n, ds.d, ds.hot_cap, ds.stores[0].num_shards) == \
        (n, 300, n // 4, 4)
    assert sum(s.example_nbytes for s in ds.stores) == \
        chip_smoke.TIER_ROW_BYTES
    tr = sess.run()
    assert len(calls) == methods.kernel_calls(tr) == 8
    claims = chip_smoke.scale_claims(sess, tr, n, bit_compatible=True)
    timed = {"overlap_ge_half", "staging_overlap_ge_half",
             "events_overlap_ge_half"}
    assert len(claims) == 12
    assert all(v for k, v in claims.items() if k not in timed), claims
    assert sorted({p.window for p in tr.points}) == [n // 4, n // 2, n]
    assert chip_smoke.tiered_spec(P, n, None, {}).data.tiering.enabled \
        is False


def _mesh_rt():
    from repro_torch import configs
    from repro_torch.launch import dryrun, forensics, mesh, shardings, steps
    from repro_torch.models import shard_ctx
    return dict(configs=configs, transformer=TT, dryrun=dryrun,
                forensics=forensics, mesh=mesh, shardings=shardings,
                steps=steps, shard_ctx=shard_ctx, tree_map=tree_map,
                tree_leaves=tree_leaves, smi="cpu")


def test_mesh_phases_run_small_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py 3q on the CPU: the dry run's two lines on a 2×2 fake
    world at the reduced config, then the (1, 1)-mesh train step over a
    one-rank gloo group, bitwise the plain step."""
    import json
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    rt = _mesh_rt()
    rows = chip_smoke.mesh_dry_run_phase(torch, rt, reduced=True)
    assert [r["shape"] for r in rows] == ["train_4k", "decode_32k"]
    assert len(rows[0]["top_sites"]) == 5
    row = chip_smoke.mesh_step_phase(torch, rt, device="cpu", reduced=True)
    assert chip_smoke.FAILED == []
    assert row["bitwise"], row["max_rel_err"]
    assert row["predicted_bytes"] > row["argument_bytes"] > 0
    assert not torch.distributed.is_initialized()
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert all(l["card"] == "cpu" for l in lines)


def test_legacy_phase_runs_small_on_the_cpu(monkeypatch, tmp_path, capsys):
    """chip_smoke.py 3r on the CPU: each legacy host loop against the
    engine at quickstart@0.25 (columns, expansions, f̂, the wrapper's
    calls and the loop's pulls what the traces imply), then
    BENCH_engine.json's comparison at scale 0.06, whose claims hold but
    ``engine_faster`` (a comparison of wall seconds)."""
    import json
    rt = _cpu_rt(monkeypatch, tmp_path)
    out = chip_smoke.legacy_phase(torch, rt, scale=0.25, engine_scale=0.06,
                                  device="cpu")
    assert chip_smoke.FAILED == []
    assert {k: v for k, v in out["claims"].items()
            if k != "engine_faster"} == {
        "engine_max_one_transfer_per_stage": True,
        "legacy_at_least_two_syncs_per_step": True, "parity": True}
    m = out["methods"]
    assert m["bet_fixed"]["legacy"]["syncs_per_inner_step"] == 2.0
    assert m["two_track"]["legacy"]["syncs_per_inner_step"] == 3.0
    assert all(v["engine"]["launches"] == v["engine"]["launches_implied"] > 0
               for v in m.values())
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    parity = [r for r in rows if r.get("path") == "legacy_parity"]
    assert [r["loop"] for r in parity] == list(chip_smoke.LEGACY_PARITY)
    for r in parity:
        assert r["columns_differ"] == [] and r["expansions_equal"]
        assert r["max_rel_f"] <= chip_smoke.LEGACY_RTOL
        assert r["legacy"]["pulls"] == r["pulls_implied"] > 0
        assert r["legacy"]["launches"] == r["legacy"]["implied"] > 0
    assert all(r["card"] == "cpu" for r in rows)
