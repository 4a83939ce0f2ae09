"""One rank of ``test_torch_sharded_step.py``'s 2×2 gloo world: the
port's train step on DTensor parameters against its unsharded step (a
case may override config fields), and
the local shards of a tensor of distinct values under four specs; and of
``test_torch_head_split.py``'s worlds (``main_heads``: a mesh of the
model-axis size given, configs with their head counts overridden; a
case with ``prefill`` in its overrides runs the prefill step, and in
``main`` a decode step after it).  Rank 0 saves what the test reads.  Imports no JAX."""
import datetime
import pathlib

import torch
import torch.distributed as dist


def warm_state(params):
    """Adam moments as after some steps: m = 0, v = 1e-5 (√v ≈ 3e-3, the
    scale of these gradients), t = 10."""
    from repro_torch.optim.api import tree_map
    return {"m": tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                          params),
            "v": tree_map(lambda x: torch.full_like(x, 1e-5,
                                                    dtype=torch.float32),
                          params),
            "t": torch.tensor(10, dtype=torch.int32)}


def run_case(mesh, arch: str, policy: str, overrides=None) -> dict:
    """``overrides``: config fields, and ``batch`` (default 4)."""
    from repro_torch import configs
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models import shard_ctx
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import tree_map

    overrides = dict(overrides or {})
    B = overrides.pop("batch", 4)
    cfg = configs.reduced(configs.get(arch)).with_(dtype=torch.float32,
                                                   **overrides)
    params = T.init_params(cfg, 0, device="cpu")
    base, *variants = policy.split("+")
    specs = SH.param_specs_tree(cfg, params, mesh, base)
    sharded = SH.distribute_tree(params, specs, mesh)
    gen = torch.Generator().manual_seed(1)
    S = 64
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    dbatch = SH.distribute_tree(batch, SH.batch_partition(cfg, batch, mesh),
                                mesh)
    notes = []
    gather = {"fsdp_tp": dp_axes(mesh)}.get(base, ())
    step = steps.make_train_step(cfg, notes=notes, gather_axes=gather)
    plain = steps.make_train_step(cfg)
    shard_ctx.set_sharder(SH.make_activation_sharder(mesh, set(variants))
                          if variants else None)
    try:
        _, _, m0 = step(sharded, steps.init_opt_state(sharded), dbatch)
        warm = SH.distribute_tree(warm_state(params), {
            "m": specs, "v": specs, "t": ()}, mesh)
        new, opt, m1 = step(sharded, warm, dbatch)
    finally:
        shard_ctx.set_sharder(None)
    out = {"zero": {k: float(m0[k]) for k in ("loss", "grad_norm")},
           "warm": {k: float(m1[k]) for k in ("loss", "grad_norm")},
           "params": tree_map(lambda x: x.full_tensor(), new),
           "placements": tree_map(lambda x: str(tuple(x.placements)),
                                  new),
           "notes": notes}
    if dist.get_rank() == 0:
        _, _, r0 = plain(params, steps.init_opt_state(params), batch)
        rnew, _, r1 = plain(params, warm_state(params), batch)
        out["ref"] = {"zero": {k: float(r0[k]) for k in ("loss",
                                                         "grad_norm")},
                      "warm": {k: float(r1[k]) for k in ("loss",
                                                         "grad_norm")},
                      "params": rnew}
    return out


def run_prefill_case(mesh, arch: str, policy: str, overrides=None) -> dict:
    """The prefill step on DTensor parameters (the serving layout of
    ``policy``'s base) against the plain prefill: last-token logits and
    the cache, whole.  ``overrides``: config fields, ``batch``, and
    ``decode``: then one decode step follows each prefill, from its cache
    (the sharded one laid out by ``cache_partition``), under ``"decode"``
    beside the prefill's results under ``"prefill"``."""
    from repro_torch import configs
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import shard_ctx
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import tree_map

    overrides = dict(overrides or {})
    B = overrides.pop("batch", 4)
    decode = overrides.pop("decode", False)
    cfg = configs.reduced(configs.get(arch)).with_(dtype=torch.float32,
                                                   **overrides)
    params = T.init_params(cfg, 0, device="cpu")
    base, *variants = policy.split("+")
    sharded = SH.distribute_tree(
        params, SH.param_specs_tree(cfg, params, mesh, base), mesh)
    S = 64
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, dtype=torch.int32)}
    nxt = {"tokens": torch.randint(0, cfg.vocab_size, (B, 1),
                                   generator=gen, dtype=torch.int32)}
    dbatch, dnxt = (SH.distribute_tree(b, SH.batch_partition(cfg, b, mesh),
                                       mesh) for b in (batch, nxt))
    prefill = steps.make_prefill_step(cfg, cache_len=S + decode)
    serve = steps.make_serve_step(cfg)
    notes = []
    shard_ctx.set_sharder(SH.make_activation_sharder(mesh, set(variants))
                          if variants else None)
    try:
        with steps.mesh_context(sharded, notes):
            logits, cache = prefill(sharded, dbatch)
            out = {"logits": logits.full_tensor(),
                   "cache": tree_map(lambda x: x.full_tensor(), cache)}
            if decode:
                cache = SH.distribute_tree(
                    tree_map(lambda x: x.full_tensor(), cache),
                    SH.cache_partition(cfg, cache, mesh), mesh)
                logits, cache = serve(sharded, cache,
                                      dict(dnxt, position=S))
                out = {"prefill": out, "decode": {
                    "logits": logits.full_tensor(),
                    "cache": tree_map(lambda x: x.full_tensor(), cache)}}
    finally:
        shard_ctx.set_sharder(None)
    out["notes"] = notes
    if dist.get_rank() == 0:
        ref_logits, ref_cache = prefill(params, batch)
        ref = {"logits": ref_logits, "cache": ref_cache}
        if decode:
            ref_cache = tree_map(lambda x: x.clone(), ref_cache)
            d_logits, d_cache = serve(params, ref_cache,
                                      dict(nxt, position=S))
            ref = {"prefill": ref, "decode": {"logits": d_logits,
                                              "cache": d_cache}}
        out["ref"] = ref
    return out


LAYOUT_SPECS = [(("data", "model"), None), ("data", "model"),
                (None, ("data", "model")), ("model", "data")]


def main(rank: int, world: int, init: str, cases, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.shardings import to_placements
        mesh = make_host_mesh(model=2)
        x = torch.arange(8 * 4).reshape(8, 4)
        res = {"layout": [distribute_tensor(x, mesh, to_placements(s, mesh),
                                            src_data_rank=None)
                          .to_local() for s in LAYOUT_SPECS]}
        # (arch, policy) or (arch, policy, name, config overrides); a
        # case with ``prefill`` in its overrides runs the prefill and a
        # decode step
        for case in cases:
            over = dict(case[3]) if case[3:] else {}
            if over.pop("prefill", False):
                res[case[:3]] = run_prefill_case(mesh, *case[:2],
                                                 dict(over, decode=True))
            else:
                res[case[:3]] = run_case(mesh, *case[:2], *case[3:])
        torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def main_heads(rank: int, world: int, init: str, model: int, cases,
               out_dir: str) -> None:
    """``cases``: (name, arch, policy, config overrides) on a
    (world // model, model) mesh."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=model)
        res = {name: (run_prefill_case if overrides.get("prefill")
                      else run_case)(
                          mesh, arch, policy,
                          {k: v for k, v in overrides.items()
                           if k != "prefill"})
               for name, arch, policy, overrides in cases}
        torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
