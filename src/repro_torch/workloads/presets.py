"""The workload preset registry — the port of ``repro.workloads.presets``:
one string names a complete run.

Grammar: ``arch@scenario`` — ``arch`` is a model-zoo alias (short forms
like ``qwen3`` expand through :data:`SHORT`), ``scenario`` is a
``-``-joined list of modifier tokens, each composing one sub-spec of the
:class:`~repro_torch.api.RunSpec`:

=============  ==========================================================
``<N>stages``  corpus sized for N expansion stages (``n0 · growth^(N-1)``)
``<N>hosts``   simulated N-host SPMD topology over the streaming plane
``elastic``    inject a host loss at stage 1 and recover (needs ``Nhosts``)
``stream``     throttled shard reads through the streaming plane, so
               prefetch overlap is the thing being exercised
``serve``      serve-while-you-train closed loop (traffic-driven
               expansion, hot checkpoint swap)
``obs``        telemetry plane on (events + RunReport)
=============  ==========================================================

Tokens compose: ``granite-moe@4hosts-elastic`` is the MoE stack on four
simulated hosts with a mid-run host kill.  Every composed spec is tiny
(reduced configs + aggressive overrides) and equal to the reference's
through ``to_dict()``; scale up by ``.replace()``-ing the returned spec.
The ``serve`` and ``obs`` tokens compose their specs as the reference
does, and ``build`` refuses those specs until their slice (ROADMAP queue
A11).

Registered presets (:data:`PRESETS`) land in
``repro_torch.api.WORKLOADS``; unregistered-but-parseable strings work
too — ``repro_torch.api.run`` falls back to the grammar.
"""
from __future__ import annotations

import dataclasses
import re

from .. import configs
from ..api.registry import WORKLOADS, register_workload
from ..api.specs import (CheckpointSpec, DataSpec, ModelSpec, ObsSpec,
                         OptimizerSpec, PolicySpec, RunSpec, ScheduleSpec,
                         ServeSpec, SpecError, TopologySpec, ElasticSpec)
from .families import family_of_config

# short arch spellings -> configs.ALIASES keys
SHORT = {
    "qwen3": "qwen3-0.6b",
    "internlm2": "internlm2-1.8b",
    "stablelm": "stablelm-12b",
    "yi": "yi-9b",
    "qwen2-vl": "qwen2-vl-2b",
    "musicgen": "musicgen-medium",
    "falcon-mamba": "falcon-mamba-7b",
    "recurrentgemma": "recurrentgemma-9b",
    "granite-moe": "granite-moe-1b-a400m",
    "llama4-scout": "llama4-scout-17b-a16e",
}

# tiny-run baseline: every preset trains >=2 expansion stages in seconds
# on CPU; batch 4 splits over <=4 hosts, n0=8 keeps every lane non-empty
_TINY = dict(n0=8, growth=2.0, seq_len=32, batch_size=4, eval_rows=8,
             shard_size=4, lr=1e-3)

# per config-family ModelConfig overrides shrinking the reduced() smoke
# variant further (the reference's: every preset runs in seconds)
_SHRINK = {
    "dense": dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
                  d_ff=128, vocab_size=256),
    # vlm keeps head_dim=64: reduced() pins mrope_sections to half=32
    "vlm": dict(d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
                vocab_size=256),
    "audio": dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
                  d_ff=128, vocab_size=256),
    "ssm": dict(d_model=64, vocab_size=256, d_inner=128, dt_rank=8),
    "hybrid": dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
                   d_ff=128, vocab_size=256, lru_width=64, local_window=16),
    "moe": dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
                d_ff=128, vocab_size=256, moe_d_ff=64),
}

_STAGES = re.compile(r"^(\d+)stages$")
_HOSTS = re.compile(r"^(\d+)hosts$")

_TOKEN_DESC = {
    "stages": "{n} expansion stages (fixed-steps schedule)",
    "hosts": "{n} simulated SPMD hosts, streaming plane",
    "elastic": "host loss injected at stage 1, elastic recovery",
    "stream": "throttled shard reads, prefetch overlap",
    "serve": "serve-while-you-train, traffic-driven expansion + hot swap",
    "obs": "telemetry plane on",
}
_KNOWN_TOKENS = ("<N>stages", "<N>hosts", "elastic", "stream", "serve",
                 "obs")


def _suggest(bad: str, options) -> str:
    import difflib
    close = difflib.get_close_matches(bad, list(options), n=3, cutoff=0.4)
    return f"; did you mean {', '.join(map(repr, close))}?" if close else ""


@dataclasses.dataclass(frozen=True)
class WorkloadPreset:
    """One registered matrix cell: the parsed name plus a spec factory."""
    name: str
    arch: str                       # full configs alias
    family: str                     # adapter name (transformer/mamba/...)
    scenario: str
    description: str

    def spec(self) -> RunSpec:
        return workload_spec(self.name)


def parse(name: str) -> tuple[str, list[str]]:
    """``arch@scenario`` -> (full arch alias, modifier tokens)."""
    if "@" not in name:
        raise SpecError(
            f"workload {name!r} is not 'arch@scenario' (e.g. "
            f"'qwen3@2stages'); registered presets: {WORKLOADS.names()}")
    arch, _, scenario = name.partition("@")
    arch = SHORT.get(arch, arch)
    if arch not in configs.ALIASES and arch not in configs.ARCH_IDS:
        raise SpecError(
            f"workload {name!r}: unknown arch {arch.split('@')[0]!r}"
            f"{_suggest(arch, list(SHORT) + sorted(configs.ALIASES))} "
            f"short names: {sorted(SHORT)}")
    tokens = [t for t in scenario.split("-") if t]
    if not tokens:
        raise SpecError(f"workload {name!r} has an empty scenario; "
                        f"tokens: {_KNOWN_TOKENS}")
    for t in tokens:
        if not (_STAGES.match(t) or _HOSTS.match(t)
                or t in ("elastic", "stream", "serve", "obs")):
            raise SpecError(
                f"workload {name!r}: unknown scenario token {t!r}"
                f"{_suggest(t, ['stages', 'hosts', 'elastic', 'stream', 'serve', 'obs'])} "
                f"tokens: {_KNOWN_TOKENS}")
    return arch, tokens


def describe(name: str) -> str:
    """One-line scenario description for ``--list-workloads``."""
    arch, tokens = parse(name)
    cfg = configs.get(arch)
    fam = family_of_config(cfg)
    parts = []
    for t in tokens:
        if m := _STAGES.match(t):
            parts.append(_TOKEN_DESC["stages"].format(n=m.group(1)))
        elif m := _HOSTS.match(t):
            parts.append(_TOKEN_DESC["hosts"].format(n=m.group(1)))
        else:
            parts.append(_TOKEN_DESC[t])
    return f"{arch} [{fam}] — {'; '.join(parts)}"


def workload_spec(name: str) -> RunSpec:
    """Compose the full tiny-size RunSpec a workload string names."""
    arch, tokens = parse(name)
    cfg = configs.get(arch)
    fam = family_of_config(cfg)

    stages = 2
    hosts = 1
    elastic_on = stream = serve = obs = False
    for t in tokens:
        if m := _STAGES.match(t):
            stages = int(m.group(1))
        elif m := _HOSTS.match(t):
            hosts = int(m.group(1))
        elif t == "elastic":
            elastic_on = True
        elif t == "stream":
            stream = True
        elif t == "serve":
            serve = True
        else:
            obs = True
    if stages < 2:
        raise SpecError(f"workload {name!r}: a BET run expands — "
                        f"{stages}stages is below the 2-stage minimum")
    if stream:
        # stage 0's window loads before compute exists to hide them; with
        # >=3 stages the prefetchable tail dominates, so the overlap claim
        # measures the plane, not the unavoidable cold start
        stages = max(stages, 3)
    if elastic_on and hosts < 2:
        raise SpecError(
            f"workload {name!r}: 'elastic' injects a host loss and needs "
            f"an '<N>hosts' token with N >= 2 (e.g. "
            f"'{name.split('@')[0]}@4hosts-elastic')")
    if serve and (hosts > 1 or elastic_on):
        raise SpecError(f"workload {name!r}: 'serve' is the single-host "
                        f"closed loop; it does not compose with "
                        f"'<N>hosts'/'elastic' yet")

    t = dict(_TINY)
    corpus = int(t["n0"] * t["growth"] ** (stages - 1))
    plane = "plane" if (hosts > 1 or stream or serve) else "host"
    data = DataSpec(
        kind="lm", corpus_size=corpus, seq_len=t["seq_len"],
        eval_rows=t["eval_rows"], plane=plane, shard_size=t["shard_size"],
        delay_ms=0.5 if stream else 0.0, seed=0)
    model = ModelSpec(arch=arch, reduced=True, family=fam,
                      overrides=dict(_SHRINK[cfg.family]))
    if serve:
        policy = PolicySpec("traffic_driven",
                            params=dict(inner_steps=2, final_steps=4))
    else:
        policy = PolicySpec("fixed_steps",
                            params=dict(inner_steps=2, final_steps=4))
    spec = RunSpec(
        name=name,
        data=data,
        model=model,
        policy=policy,
        optimizer=OptimizerSpec("adamw_lm", params=dict(
            lr=t["lr"], batch_size=t["batch_size"])),
        schedule=ScheduleSpec(n0=t["n0"], growth=t["growth"],
                              step_cost="batch"),
        topology=TopologySpec(hosts=hosts),
        elastic=ElasticSpec(faults=("kill@1:1",)) if elastic_on
        else ElasticSpec(),
        serve=ServeSpec(enabled=True, requests_per_tick=4, prompt_len=16,
                        gen_tokens=t["seq_len"] + 1 - 16) if serve
        else ServeSpec(),
        # the serve loop publishes stage checkpoints for the hot-swap
        # server; a deterministic relative default keeps the spec
        # self-contained (callers .replace() it into their own workdir)
        checkpoint=CheckpointSpec(directory=f"runs/{name}/ckpt", keep=2)
        if serve else CheckpointSpec(),
        obs=ObsSpec(enabled=True) if obs else ObsSpec(),
        meta={"workload": name, "family": fam, "scenario": tokens},
    )
    return spec


def get_workload(name: str) -> WorkloadPreset:
    """Preset lookup with grammar fallback: registered names resolve from
    ``WORKLOADS`` (typos get did-you-mean suggestions); any other
    ``arch@scenario`` string becomes an ad-hoc preset via the grammar."""
    if name in WORKLOADS:
        return WORKLOADS.get(name)
    if "@" in name:
        arch, tokens = parse(name)      # raises with token/arch suggestions
        cfg = configs.get(arch)
        return WorkloadPreset(name=name, arch=arch,
                              family=family_of_config(cfg),
                              scenario="-".join(tokens),
                              description=describe(name))
    return WORKLOADS.get(name)          # raises with preset suggestions


def _register(name: str) -> WorkloadPreset:
    arch, tokens = parse(name)
    preset = WorkloadPreset(name=name, arch=arch,
                            family=family_of_config(configs.get(arch)),
                            scenario="-".join(tokens),
                            description=describe(name))
    register_workload(name, preset)
    return preset


# the curated matrix, the reference's: every family covered, every
# capability exercised by at least one cell (engine stages, streaming
# plane, SPMD hosts, elastic faults, serve loop, obs plane)
PRESETS = tuple(_register(n) for n in (
    # transformer family
    "qwen3@2stages",
    "internlm2@2hosts",
    "stablelm@stream",
    "yi@3stages-obs",
    # mamba family (kernels/ssm_scan.py carries the training traffic)
    "falcon-mamba@2stages",
    "falcon-mamba@stream",
    # rglru family (kernels/rglru_scan.py + flash attention)
    "recurrentgemma@2stages",
    "recurrentgemma@serve",
    # moe family
    "granite-moe@2stages",
    "granite-moe@4hosts-elastic",
    "llama4-scout@2stages",
))
