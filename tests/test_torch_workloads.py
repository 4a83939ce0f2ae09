"""The port's workloads subsystem against the reference, on the CPU: the
``arch@scenario`` grammar (the reference's own test cases, mirrored), the
composed RunSpecs equal to the reference's through ``to_dict()``, family
resolution, the registry, ``repro_torch.api.run``; preset runs through
``build(RunSpec)`` whose claims equal the reference sweep's and whose
float32 trajectories equal the reference's; the qwen2-vl preset failing
as the reference's does; and ``launch/train.py``'s specs and CLI."""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro_torch.api as P
from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.workloads import PRESETS as JPRESETS
from repro.workloads import describe as jdescribe
from repro.workloads import run_preset
from repro.workloads import workload_spec as jworkload_spec
from repro_torch import configs, convert
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.workloads import (FAMILIES, PRESETS, SHORT, describe,
                                   family_of_config, get_workload, parse,
                                   resolve_family, workload_spec)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.tier1

# small shapes: one intra-op thread keeps the suite's parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

# f̂ of a float32 reduced model after a few AdamW steps, the same algorithm
# summed in other orders: the bound of tests/test_torch_lm.py
RTOL_F = 2e-5
COLUMNS = ("step", "stage", "window", "time", "accesses")

# the presets the port runs and holds against the reference: both new
# families, one over the plane and 2 hosts, and an unregistered grammar
# string (musicgen, the audio config family)
RUN_PRESETS = ["qwen3@2stages", "internlm2@2hosts", "musicgen@2stages",
               "granite-moe@2stages", "llama4-scout@2stages"]


# ----------------------------------------------------------------- grammar
def test_parse_expands_short_arch_names():
    arch, tokens = parse("qwen3@2stages")
    assert arch == "qwen3-0.6b"
    assert tokens == ["2stages"]
    arch, tokens = parse("granite-moe@4hosts-elastic")
    assert arch == "granite-moe-1b-a400m"
    assert tokens == ["4hosts", "elastic"]


def test_parse_accepts_full_alias():
    arch, _ = parse("falcon-mamba-7b@2stages")
    assert arch == "falcon-mamba-7b"


@pytest.mark.parametrize("name,needle", [
    ("qwen3", "arch@scenario"),
    ("qwne3@2stages", "did you mean.*qwen3"),
    ("qwen3@straem", "did you mean.*'stream'"),
    ("qwen3@", "empty scenario"),
], ids=["missing_at", "unknown_arch", "unknown_token", "empty_scenario"])
def test_parse_rejects_what_the_reference_rejects(name, needle):
    with pytest.raises(P.SpecError, match=needle):
        parse(name)
    with pytest.raises(R.SpecError, match=needle):
        jworkload_spec(name)


def test_describe_mentions_family_and_tokens():
    d = describe("recurrentgemma@serve")
    assert "rglru" in d and "serve-while-you-train" in d
    for p in JPRESETS:
        assert describe(p.name) == jdescribe(p.name)


# ---------------------------------------------------------- spec composing
@pytest.mark.parametrize("name", [p.name for p in JPRESETS] + [
    "musicgen@2stages", "qwen2-vl@2stages", "yi@4stages-stream",
    "granite-moe@2hosts-stream-obs", "falcon-mamba-7b@3hosts-elastic"])
def test_workload_spec_equals_the_reference(name):
    assert workload_spec(name).to_dict() == jworkload_spec(name).to_dict()


def test_workload_spec_stage_corpus_arithmetic():
    spec = workload_spec("qwen3@3stages")
    # n0=8, growth=2 -> 3 stages needs corpus 32
    assert spec.data.corpus_size == 32
    assert spec.schedule.n0 == 8


def test_workload_spec_stream_runs_three_stages():
    spec = workload_spec("stablelm@stream")
    assert spec.data.corpus_size == 32
    assert spec.data.delay_ms > 0
    assert spec.data.plane == "plane"


@pytest.mark.parametrize("name,needle", [
    ("qwen3@1stages", "below the 2-stage minimum"),
    ("qwen3@elastic", "'elastic'.*hosts"),
    ("recurrentgemma@2hosts-serve", "single-host"),
], ids=["one_stage", "elastic_needs_hosts", "serve_excludes_hosts"])
def test_workload_spec_rejects_what_the_reference_rejects(name, needle):
    with pytest.raises(P.SpecError, match=needle):
        workload_spec(name)


def test_workload_spec_serve_defaults_checkpoint():
    spec = workload_spec("recurrentgemma@serve")
    assert spec.serve.enabled
    assert spec.checkpoint.directory
    assert spec.policy.name == "traffic_driven"


# ------------------------------------------------------- family resolution
def test_every_config_family_maps_to_adapter():
    for alias in SHORT.values():
        cfg = configs.get(alias)
        fam = FAMILIES[family_of_config(cfg)]
        assert cfg.family in fam.config_families


@pytest.mark.parametrize("arch", sorted(configs.ALIASES))
def test_families_are_the_references(arch):
    """Every architecture resolves to the reference's adapter, with its
    impl and kernels: transformer and moe run impl="xla", no kernel."""
    from repro.workloads import FAMILIES as JFAMILIES
    from repro.workloads import family_of_config as jfamily_of_config
    name = family_of_config(configs.get(arch))
    assert name == jfamily_of_config(jconfigs.get(arch))
    fam, want = FAMILIES[name], JFAMILIES[name]
    assert (fam.impl, fam.kernels, fam.config_families) == \
        (want.impl, want.kernels, want.config_families)


def test_resolve_family_auto_and_explicit():
    cfg = configs.get("granite-moe-1b-a400m")
    fam = resolve_family(P.ModelSpec(arch="granite-moe-1b-a400m"), cfg)
    assert fam.name == "moe" and fam.impl == "xla" and fam.kernels == ()
    assert resolve_family(P.ModelSpec(arch="granite-moe-1b-a400m",
                                      family="moe"), cfg) is fam


def test_resolve_family_mismatch_is_eager_spec_error():
    cfg = configs.get("qwen3-0.6b")
    with pytest.raises(P.SpecError, match="cannot adapt"):
        resolve_family(P.ModelSpec(arch="qwen3-0.6b", family="moe"), cfg)


def test_build_validates_family_eagerly():
    spec = workload_spec("qwen3@2stages")
    bad = spec.replace(model=spec.model.replace(family="mamba"))
    with pytest.raises(P.SpecError, match="family"):
        P.build(bad, device="cpu")


# ---------------------------------------------------------------- registry
def test_registered_presets_are_the_references():
    assert [p.name for p in PRESETS] == [p.name for p in JPRESETS]
    for p, q in zip(PRESETS, JPRESETS):
        assert (p.arch, p.family, p.scenario, p.description) == \
            (q.arch, q.family, q.scenario, q.description)
    assert {p.family for p in PRESETS} == set(FAMILIES)
    assert P.WORKLOADS.names() == R.WORKLOADS.names()


def test_workloads_registry_did_you_mean():
    with pytest.raises(P.SpecError, match="did you mean 'qwen3@2stages'"):
        P.WORKLOADS.get("qwen3@2stage")


def test_get_workload_grammar_fallback():
    p = get_workload("yi@2stages")
    assert p.arch == "yi-9b" and p.family == "transformer"
    assert p.spec().meta["workload"] == "yi@2stages"


def test_get_workload_rejects_garbage_with_suggestions():
    with pytest.raises(P.SpecError, match="registered"):
        get_workload("not-a-workload")


# ------------------------------------------------------------- end to end
def test_run_mamba_preset_routes_through_the_scan_wrapper(monkeypatch):
    """The mamba family's traffic goes through ``ops.ssm_scan`` (on the
    CPU its plain version: the card's launches are counted there)."""
    calls = []
    real = tops.ssm_scan

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tops, "ssm_scan", counted)
    session = P.run("falcon-mamba@2stages", device="cpu")
    tr = session.trace
    assert tr.meta["stages"] >= 2 and calls
    assert math.isfinite(tr.final().f_full)


@pytest.mark.parametrize("name", RUN_PRESETS)
def test_preset_claims_equal_the_reference_sweeps(name, tmp_path):
    """``api.run(name)`` on the CPU, its claims computed as chip_smoke.py
    computes them (the reference sweep's formulas), equal to the claims
    of the reference's own sweep on the same preset."""
    want = run_preset(name, tmp_path)
    assert want.error is None, want.error
    session = P.run(name, device="cpu")
    preset = get_workload(name)
    got = chip_smoke.preset_result(preset, FAMILIES, session, {})
    assert set(got["claims"]) <= set(want.claims)
    assert got["claims"] == {k: want.claims[k] for k in got["claims"]}
    assert all(got["claims"].values())
    assert (got["stages"], got["transfers"]) == (want.stages, want.transfers)


@pytest.mark.parametrize("name", RUN_PRESETS)
def test_preset_float32_trajectory_equals_the_reference(name):
    """The preset's spec in float32 through ``build`` in both packages,
    the reference's parameters carried into the port's session: every
    clock and access column equal, f̂ within RTOL_F."""
    spec = workload_spec(name)
    spec = spec.replace(model=spec.model.replace(
        overrides=dict(spec.model.overrides, dtype="float32")))
    ref_spec = R.RunSpec.from_json(spec.to_json())
    ref_spec = ref_spec.replace(model=ref_spec.model.replace(
        overrides=dict(ref_spec.model.overrides, dtype="float32")))
    ref_sess = R.build(ref_spec)
    want = ref_sess.run()
    sess = P.build(spec, device="cpu")
    sess.w0 = convert.params_from_jax(jax.device_get(ref_sess.w0), "cpu")
    got = sess.run()
    for col in COLUMNS:
        assert got.column(col) == want.column(col), col
    np.testing.assert_allclose(got.column("f_full"), want.column("f_full"),
                               rtol=RTOL_F)
    assert got.meta["host_transfers"] == want.meta["host_transfers"]


def test_qwen2_vl_preset_fails_as_the_references():
    """The LM objective and train batches hold tokens only, while the
    embeddings input mode reads ``batch["embeds"]``: both packages raise
    KeyError('embeds') on the preset (ROADMAP queue C)."""
    with pytest.raises(KeyError, match="embeds"):
        R.run("qwen2-vl@2stages")
    with pytest.raises(KeyError, match="embeds"):
        P.run("qwen2-vl@2stages", device="cpu")


@pytest.mark.parametrize("name,needle", [
    ("recurrentgemma@serve", "repro_torch.serve.build_loop"),
    ("yi@3stages-obs", "observability slice (ROADMAP queue A11)"),
], ids=["recurrentgemma@serve-serve slice (ROADMAP queue A11)",
        "yi@3stages-obs-observability slice (ROADMAP queue A11)"])
def test_serve_and_obs_presets_are_refused_naming_their_slice(
        name, needle, tmp_path, monkeypatch):
    """The obs preset waits for its slice.  The serve preset, once refused
    as the serve slice's, is refused by ``build`` as the reference refuses
    it, naming ``build_loop``; ``run`` routes it there (its checkpoint
    directory is relative, so it runs in tmp_path)."""
    if name.endswith("@serve"):
        spec = get_workload(name).spec()
        with pytest.raises(P.SpecError) as e:
            P.build(spec, device="cpu")
        assert needle in str(e.value)
        monkeypatch.chdir(tmp_path)
        loop = P.run(name, device="cpu")
        assert loop.trace.meta["stages"] >= 2 and loop.store.closed
        assert loop.server.requests_completed == \
            loop.server.requests_started > 0
        return
    with pytest.raises(P.SpecError, match="not yet ported") as e:
        P.run(name, device="cpu")
    assert needle in str(e.value)


# ------------------------------------------------------------- launch/train
@pytest.mark.parametrize("arch,reduced,kw", [
    ("qwen3-0.6b", True, dict(schedule="two_track")),
    ("granite-moe-1b-a400m", False, dict(schedule="bet", use_plane=False)),
    ("falcon-mamba-7b", True, dict(schedule="batch", num_hosts=2,
                                   kill_host_at="1:1")),
    ("yi-9b", True, dict(straggler_deadline_s=0.5, ckpt_dir="ck",
                         resume=True)),
])
def test_to_run_spec_equals_the_references(arch, reduced, kw):
    tcfg, jcfg = configs.get(arch), jconfigs.get(arch)
    if reduced:
        tcfg, jcfg = configs.reduced(tcfg), jconfigs.reduced(jcfg)
    got = ttrain.to_run_spec(tcfg, ttrain.TrainConfig(**kw))
    want = jtrain.to_run_spec(jcfg, jtrain.TrainConfig(**kw))
    assert got.to_dict() == want.to_dict()
    assert ttrain.to_run_spec(arch, ttrain.TrainConfig(**kw)).model.reduced
    with pytest.raises(ValueError, match="overrides"):
        ttrain.to_run_spec(tcfg.with_(num_layers=3), ttrain.TrainConfig())


def test_train_lm_runs_a_reduced_qwen3_on_the_cpu():
    tc = ttrain.TrainConfig(schedule="bet", corpus_size=32, seq_len=16,
                            n0=8, batch_size=4, inner_steps=2,
                            final_steps=2, eval_rows=8)
    tr = ttrain.train_lm(configs.reduced(configs.get("qwen3-0.6b")), tc,
                         device="cpu")
    assert tr.meta["stages"] == 3
    assert all(math.isfinite(v) for v in tr.column("f_full"))


def test_cli_lists_workloads_and_dry_runs(capsys):
    ttrain.main(["--list-workloads"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(JPRESETS)
    for line, p in zip(lines, JPRESETS):
        assert line.split()[0] == p.name and line.endswith(
            jdescribe(p.name))
    ttrain.main(["--workload", "granite-moe@2stages", "--dry-run",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    text = out[:out.index("\nstage ")]
    assert json.loads(text) == jworkload_spec("granite-moe@2stages").to_dict()
    assert "stage 1: window 16 (final)" in out
    ttrain.main(["--arch", "granite-moe-1b-a400m", "--schedule", "two_track",
                 "--dry-run", "--device", "cpu"])
    spec = json.loads(capsys.readouterr().out.split("\nstage ")[0])
    assert spec["model"] == {"arch": "granite-moe-1b-a400m",
                             "reduced": True, "family": "auto",
                             "overrides": {}}
    with pytest.raises(SystemExit):
        ttrain.main(["--workload", "qwen3@2stages", "--n0", "4"])
