"""Multi-node dry run: lay a step out on a 256- or 512-rank mesh without
the hardware — the port of ``repro.launch.dryrun``.

For an (architecture × input shape × mesh × policy) combination it builds
the step the reference lowers (the train step for ``train_4k``, the
prefill step for ``prefill_32k``, the serve step for the decode shapes)
on DTensor arguments laid out by ``launch/shardings.py``, inside
``fake_world(n)`` (a ``fake`` process group of n ranks, the reference's
forced host devices), on meta tensors (shapes, nothing allocated or
computed).
It runs the step under ``launch/hlo.py``'s per-device counter, and
derives the three roofline terms of one H100 SXM5.

Loop-aware by construction: the reference's accounting multiplies a
scanned layer stack's body by its trip count.  Here the step is traced
with one and with two layers of each layer kind, at full width, and the
difference — one layer's forward, rematerialized forward, backward,
optimizer update and collectives — is multiplied by the kind's layer
count.  The port's recurrences (the ssm and rec kinds) are Python loops
over the sequence, so those kinds are traced at two short sequence
lengths and their counts, linear in S, extrapolated to the shape's S
(``linearity`` checks a third length).  Each collective site is
combined by its count and output bytes, so one that grows with the
layers or with S keeps its count.
Parameter, optimizer and batch bytes are counted whole from the specs.
``loops`` lists what was multiplied.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multi-pod] [--policy fsdp_tp] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 10×4 sweep
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback

import torch

from .. import configs
from ..models import shard_ctx
from ..models import transformer as T
from ..obs.profile import HBM_BW, NVLINK_BW, PEAK_FLOPS
from ..optim.api import tree_leaves, tree_map
from . import hlo, specs, steps
from .mesh import (axis_names, axis_sizes, dp_axes, fake_world,
                   make_production_mesh, mesh_label)
from .shardings import (batch_partition, cache_partition, distribute_tree,
                        make_activation_sharder, param_specs_tree,
                        to_placements)

# --- H100 SXM5 roofline constants (per GPU, NVIDIA's H100 data sheet,
# kept with the profiler's): HBM3 bandwidth, the bf16 dense tensor-core
# peak, and NVLink 4's one direction — a floor for the collective term,
# since a 256- or 512-GPU mesh crosses nodes, whose links are slower ---
PEAK_FLOPS_BF16 = PEAK_FLOPS[torch.bfloat16]   # 989e12 FLOP/s

_RECURRENT_KINDS = ("ssm", "rec")


def model_flops(cfg, shape_name: str, *, batch_size: int | None = None,
                seq_len: int | None = None) -> float:
    """6·N_active·D for training, 2·N_active·D for inference."""
    S, B, kind = specs.INPUT_SHAPES[shape_name]
    S, B = seq_len or S, batch_size or B
    n_active = cfg.active_params()
    if kind == "train":
        return 6.0 * n_active * B * S
    if kind == "prefill":
        return 2.0 * n_active * B * S
    return 2.0 * n_active * B  # decode: one token per sequence


def _parse_policy(policy: str):
    parts = policy.split("+")
    return parts[0], set(parts[1:])


def _meta_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


@contextlib.contextmanager
def _memo_strided_shards():
    """DTensor computes a strided shard's size and offset by splitting an
    ``arange`` of the whole dim, again at every redistribution it plans;
    at a 4,096 × 256-token dim that is most of a trace.  The function is
    pure (it must have no side effect, its contract says), so while the
    dry run traces its results are kept per argument."""
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset
    memo: dict = {}

    def cached(self, curr_local_size, num_chunks, rank, *rest, **kw):
        key = (self, curr_local_size, num_chunks, rank, rest,
               tuple(sorted(kw.items())))
        try:
            hit = memo.get(key)
        except TypeError:               # a symbolic size: not hashable
            return orig(self, curr_local_size, num_chunks, rank, *rest, **kw)
        if hit is None:
            hit = memo[key] = orig(self, curr_local_size, num_chunks, rank,
                                   *rest, **kw)
        return hit

    _StridedShard.local_shard_size_and_offset = cached
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _resized(name: str, spec: torch.Tensor, B: int | None,
             S: int | None) -> torch.Tensor:
    """A batch spec with batch size ``B`` and sequence length ``S`` (None
    keeps one): dims 1 and 2 of ``positions`` (3, B, S), 0 and 1 of the
    others (a decode batch keeps its one token)."""
    shape = list(spec.shape)
    if not shape:
        return spec
    b_dim = 1 if name == "positions" else 0
    if B:
        shape[b_dim] = B
    if S and len(shape) > b_dim + 1 and shape[b_dim + 1] != 1:
        shape[b_dim + 1] = S
    return torch.empty(shape, dtype=spec.dtype, device="meta")


def _distribute(tree, spec_tree, mesh):
    return distribute_tree(tree_map(_meta_like, tree), spec_tree, mesh)


def build_step(cfg, shape_name: str, mesh, policy: str, *,
               notes: list | None = None, seq_len: int | None = None,
               batch_size: int | None = None):
    """(step function, its DTensor arguments): meta tensors laid out on
    ``mesh`` (their local shards are meta too), so nothing is allocated or
    computed and any mesh can be laid out.

    Policy grammar: base ("fsdp_tp" | "tp" | "fsdp") + optional variants:
      +act   — activation-sharding at layer boundaries and in the loss
      +attnb — attention inputs' batch over the whole mesh
      +seq   — layer-boundary activations' sequence over the model axis
      +kv    — expand GQA KV heads to H for clean TP
    e.g. ``fsdp_tp+act+kv``.  ``seq_len`` and ``batch_size`` replace the
    shape's (the dry run's short traces of the recurrences; a step of
    another size).  The sharder
    stays installed until the caller clears it
    (``shard_ctx.set_sharder(None)``)."""
    policy, variants = _parse_policy(policy)
    dp = tuple(axis_names(mesh)) if policy == "fsdp" else None
    shard_ctx.set_sharder(
        make_activation_sharder(mesh, variants, dp=dp)
        if variants & {"act", "attnb", "seq"} else None)
    if "kv" in variants:
        cfg = cfg.with_(expand_kv=True)
    S, B, kind = specs.INPUT_SHAPES[shape_name]
    S, B = seq_len or S, batch_size or B
    pshape = T.param_specs(cfg)
    bspec = specs.batch_specs(cfg, shape_name)
    if seq_len or batch_size:
        bspec = {k: _resized(k, v, batch_size, seq_len)
                 for k, v in bspec.items()}
    batch_sh = batch_partition(cfg, bspec, mesh, dp=dp)

    if kind == "train":
        params = _distribute(pshape, param_specs_tree(cfg, pshape, mesh,
                                                      policy), mesh)
        opt = steps.init_opt_state(params)
        batch = _distribute(bspec, batch_sh, mesh)
        fsdp = {"fsdp": tuple(axis_names(mesh)), "fsdp_tp": dp_axes(mesh)}
        step = steps.make_train_step(cfg, notes=notes,
                                     gather_axes=fsdp.get(policy, ()))
        return step, (params, opt, batch)

    # inference shapes use the tensor-parallel serving layout
    serve_policy = "tp" if policy == "fsdp_tp" else policy
    params = _distribute(pshape, param_specs_tree(cfg, pshape, mesh,
                                                  serve_policy), mesh)
    if kind == "prefill":
        batch = _distribute(bspec, batch_sh, mesh)
        prefill = steps.make_prefill_step(cfg, cache_len=S)

        def prefill_step(params, batch):
            with steps.mesh_context(params, notes):
                logits, cache = prefill(params, batch)
                cache_sh = cache_partition(cfg, cache, mesh)
                cache = tree_map(
                    lambda x, s: x.redistribute(x.device_mesh,
                                                to_placements(s, mesh)),
                    cache, cache_sh)
            return logits, cache

        return prefill_step, (params, batch)

    cache_shape = T.init_cache(cfg, B, S, device="meta")
    cache = _distribute(cache_shape, cache_partition(cfg, cache_shape, mesh),
                        mesh)
    batch = _distribute({k: v for k, v in bspec.items() if k != "position"},
                        batch_sh, mesh)
    batch["position"] = S - 1
    serve = steps.make_serve_step(cfg)

    def serve_step(params, cache, batch):
        with steps.mesh_context(params, notes):
            return serve(params, cache, batch)

    return serve_step, (params, cache, batch)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    n = 0
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def _trace(cfg, shape_name, mesh, policy, notes, seq_len=None,
           batch_size=None) -> dict:
    """One traced step: its counts, with its arguments' and outputs'
    per-device bytes."""
    fn, args = build_step(cfg, shape_name, mesh, policy, notes=notes,
                          seq_len=seq_len, batch_size=batch_size)
    with _memo_strided_shards():
        counts, out = hlo.analyze(fn, *args, device="meta")
    counts["argument_bytes"] = float(_local_bytes(args))
    counts["output_bytes"] = float(_local_bytes(out))
    return counts


def _kind_config(cfg, kind: str, n: int):
    """``cfg`` with ``n`` layers, all of layer kind ``kind``."""
    if cfg.family == "hybrid":
        return cfg.with_(num_layers=n, block_pattern=(kind,))
    return cfg.with_(num_layers=n)


def _lin(a: dict, b: dict, ca: float, cb: float) -> dict:
    """ca·a + cb·b over counts, the byte fields and each site's count and
    output bytes included."""
    return hlo.combine([(ca, a), (cb, b)])


def _kind_point(cfg, t: str, shape_name, mesh, policy, notes, seq_len,
                batch_size) -> tuple:
    """(one layer's counts, the rest of the step's, the one-layer trace)
    for layer kind ``t``, from its traces with one and with two layers."""
    one = _trace(_kind_config(cfg, t, 1), shape_name, mesh, policy, notes,
                 seq_len, batch_size)
    two = _trace(_kind_config(cfg, t, 2), shape_name, mesh, policy, notes,
                 seq_len, batch_size)
    return _lin(two, one, 1.0, -1.0), _lin(one, two, 2.0, -1.0), one


def _first_length(mesh) -> int:
    """The shorter sequence length a recurrent kind is traced at."""
    return max(16, max(axis_sizes(mesh).values()))


def account(cfg, shape_name: str, mesh, policy: str, notes: list, *,
            batch_size: int | None = None, seq_len: int | None = None):
    """(whole-step counts, loops, raw counts of the first trace): each
    layer kind traced with one and two layers, the recurrent kinds at two
    short sequence lengths, then combined.  Every count is linear in the
    layers and, for a recurrent kind, in S (``linearity`` checks it at a
    third length), but the peak of live bytes, which is combined the same
    way: an estimate."""
    S, B, kind = specs.INPUT_SHAPES[shape_name]
    S = seq_len or S
    n_of = T.stack_counts(cfg)
    per_layer, bases, loops, raw = {}, [], [], None
    for t, n in sorted(n_of.items()):
        if t in _RECURRENT_KINDS and kind != "decode":
            s1 = _first_length(mesh)
            points = (s1, 2 * s1)
        else:
            points = (seq_len,)
        at = []
        for s in points:
            layer, base, one = _kind_point(cfg, t, shape_name, mesh, policy,
                                           notes, s, batch_size)
            raw = raw or one
            at.append((layer, base))
        if len(at) == 2:
            # linear in S: X(S) = X(s1) + (S - s1)/(s2 - s1)·(X(s2) - X(s1))
            s1, s2 = points
            f = (S - s1) / (s2 - s1)
            layer = _lin(at[0][0], at[1][0], 1.0 - f, f)
            base = _lin(at[0][1], at[1][1], 1.0 - f, f)
            loops.append({"body": f"time step of a {t} layer", "trip": S,
                          "mult": float(n), "traced": list(points)})
            bases.append((True, base))
        else:
            layer, base = at[0]
            bases.append((False, base))
        per_layer[t] = layer
        loops.append({"body": f"{t} layer", "trip": n, "mult": 1.0})
    # the embedding, loss and final norm: from a full-length trace where
    # one exists (False sorts first), else extrapolated
    base = min(bases, key=lambda b: b[0])[1]
    total = base
    for t, n in n_of.items():
        total = _lin(total, per_layer[t], 1.0, float(n))
    # the arguments whole, at the full depth, from the specs
    total["argument_bytes"] = _argument_bytes(cfg, shape_name, mesh, policy,
                                              seq_len, batch_size)
    return total, loops, raw


def linearity(arch: str, kind: str, *, cfg=None, mesh=None) -> dict:
    """Whether ``account``'s extrapolation of the recurrent layer kind
    ``kind`` in S holds for ``train_4k`` under ``fsdp_tp``: the kind traced
    at s1, 2·s1 and 4·s1, and the third trace's counts (one layer's, and
    the rest of the step's) held against the line through the first two.
    -> {"traced": [...], "max_rel_err": the largest, "rel_err": {metric:
    relative error}} over FLOPs, bytes, wire bytes and each collective's
    count (by kind, group size and provenance).  ``cfg`` and ``mesh`` as
    ``dry_run``'s."""
    cfg = cfg if cfg is not None else configs.get(arch)
    with contextlib.ExitStack() as stack:
        if mesh is None:
            stack.enter_context(fake_world(256))
            mesh = make_production_mesh()
        stack.callback(shard_ctx.set_sharder, None)
        s1 = _first_length(mesh)
        points = (s1, 2 * s1, 4 * s1)
        at = [_kind_point(cfg, kind, "train_4k", mesh, "fsdp_tp", [], s,
                          None)[:2] for s in points]
    errs = {}
    for i, part in enumerate(("layer", "rest")):
        got = _lin(at[0][i], at[1][i], -2.0, 3.0)     # 4·s1 on the line
        want = at[2][i]
        a, b = hlo.summarize(got), hlo.summarize(want)
        for k in ("flops", "traffic_bytes", "wire_bytes"):
            errs[f"{part} {k}"] = _rel(a[k], b[k])
        for key in sorted(set(got["sites"]) | set(want["sites"])):
            errs[f"{part} count {' '.join(map(str, key))}"] = _rel(
                got["sites"].get(key, (0.0,))[0],
                want["sites"].get(key, (0.0,))[0])
    return {"arch": arch, "kind": kind, "traced": list(points),
            "max_rel_err": max(errs.values()), "rel_err": errs}


def _rel(a: float, b: float) -> float:
    """|a - b| relative to |b| (0 where both are 0)."""
    d = abs(a - b)
    return d / abs(b) if b else (0.0 if d < 1e-9 else math.inf)


def _argument_bytes(cfg, shape_name, mesh, policy, seq_len=None,
                    batch_size=None) -> float:
    """Per-device bytes of the full-depth step's arguments (parameters,
    optimizer state, batch, cache), from the layout alone."""
    _, args = build_step(cfg, shape_name, mesh, policy, seq_len=seq_len,
                         batch_size=batch_size)
    shard_ctx.set_sharder(None)
    return float(_local_bytes(args))


def dry_run(arch: str, shape_name: str, *, multi_pod: bool = False,
            policy: str = "fsdp_tp", cfg=None, mesh=None,
            batch_size: int | None = None,
            seq_len: int | None = None) -> dict:
    """The roofline of one combination.  ``cfg`` replaces the registry's
    config (a reduced one in tests); ``mesh`` replaces the production mesh
    (built in a ``fake_world`` of its size when not given); ``batch_size``
    and ``seq_len`` replace the shape's."""
    cfg = cfg if cfg is not None else configs.get(arch)
    S, B, kind = specs.INPUT_SHAPES[shape_name]
    if kind == "decode":
        cfg = specs.serve_config(cfg, shape_name)
    with contextlib.ExitStack() as stack:
        if mesh is None:
            stack.enter_context(fake_world(512 if multi_pod else 256))
            mesh = make_production_mesh(multi_pod=multi_pod)
        stack.callback(shard_ctx.set_sharder, None)
        n_chips = math.prod(axis_sizes(mesh).values())
        notes: list = []
        t0 = time.time()
        counts, loops, raw = account(cfg, shape_name, mesh, policy, notes,
                                     batch_size=batch_size, seq_len=seq_len)
        trace_s = time.time() - t0
    notes = [dict(n) for n in {tuple(sorted(n.items())): 0 for n in notes}]

    acc = hlo.summarize(counts, loops)
    flops_dev = acc["flops"]
    bytes_dev = acc["traffic_bytes"]
    wire_dev = acc["wire_bytes"]
    mf = model_flops(cfg, shape_name, batch_size=batch_size, seq_len=seq_len)
    memory = {"argument_size_in_bytes": int(counts["argument_bytes"]),
              "output_size_in_bytes": int(counts["output_bytes"]),
              "temp_size_in_bytes": int(counts["peak_bytes"])}
    raw_acc = hlo.summarize(raw)
    result = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": mesh_label(mesh), "policy": policy, "chips": int(n_chips),
        # the counts and notes depend on DTensor's strategies, which
        # change between torch versions
        "torch": torch.__version__,
        "trace_s": round(trace_s, 1),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_wire_bytes_per_device": wire_dev,
        "collectives": acc["collectives"],
        "loops": loops,
        "cost_analysis_raw": {
            "flops": raw_acc["flops"],
            "bytes_accessed": raw_acc["traffic_bytes"],
            "note": "the one-layer trace's counts, before the layers and "
                    "time steps were multiplied; see the loop-aware fields",
        },
        "memory": memory,
        "roofline": {
            "compute_s": flops_dev / PEAK_FLOPS_BF16,
            "memory_s": bytes_dev / HBM_BW,
            "collective_s": wire_dev / NVLINK_BW,
        },
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops_dev if flops_dev else 0.0,
        # [kind, mean output bytes, group size, provenance, count]
        "sites": [[kind, ob / m, n, site, m]
                  for (kind, n, site), (m, ob) in counts["sites"].items()
                  if m > 1e-6],
        "notes": notes,
    }
    terms = result["roofline"]
    result["bottleneck"] = max(terms, key=terms.get)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(specs.INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", type=str, default="fsdp_tp",
                    help="fsdp_tp | tp | fsdp, with optional +act / +attnb "
                         "/ +seq / +kv variants")
    ap.add_argument("--all", action="store_true",
                    help="run the full arch x shape sweep on this mesh")
    ap.add_argument("--out", type=str, default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    combos = []
    if args.all:
        for arch in configs.ARCH_IDS:
            for shape in specs.INPUT_SHAPES:
                combos.append((arch, shape))
    else:
        combos.append((args.arch, args.shape))

    for arch, shape in combos:
        tag = f"{configs.ALIASES.get(arch, arch)}__{shape}__" \
              f"{'2x16x16' if args.multi_pod else '16x16'}__{args.policy}"
        try:
            res = dry_run(arch, shape, multi_pod=args.multi_pod,
                          policy=args.policy)
            (outdir / f"{tag}.json").write_text(json.dumps(res, indent=2))
            r = res["roofline"]
            print(f"OK   {tag}: compute={r['compute_s']*1e3:.2f}ms "
                  f"memory={r['memory_s']*1e3:.2f}ms "
                  f"collective={r['collective_s']*1e3:.2f}ms "
                  f"bottleneck={res['bottleneck']} "
                  f"(trace {res['trace_s']}s) "
                  f"replicated={sorted({n['op'] for n in res['notes']})}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — sweep must report, not die
            (outdir / f"{tag}.FAILED.txt").write_text(traceback.format_exc())
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
