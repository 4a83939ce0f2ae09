"""Batched serving driver — the port of ``repro.launch.serve``: prefill,
then a decode loop over the serve step.

Sampling draws from an explicit ``torch.Generator`` (the reference splits
a ``jax.random`` key), so sampled tokens are reproducible per generator
but never equal to the reference's; greedy decoding is the same function
and gives the same tokens.  Runs on the card unless ``--device cpu``.

Usage (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --prompt-len 64 --gen 32 --batch 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..device import resolve_device
from ..models import transformer as T
from . import steps


def next_tokens(cfg, logits, *, greedy: bool = True,
                generator: torch.Generator | None = None):
    """(B,) next tokens from (B, Vp) logits over the real vocabulary:
    the argmax, or a draw from the softmax with ``generator``."""
    logits = logits[:, : max(2, cfg.vocab_size)]
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(cfg, params, prompts: torch.Tensor, *, gen_tokens: int,
             cache_len: int | None = None, greedy: bool = True,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """prompts: (B, S) integer tokens on the params' device.  Returns
    (B, gen_tokens) int32 on that device: no host transfer per token."""
    B, S = prompts.shape
    cache_len = cache_len or (S + gen_tokens)
    prefill = steps.make_prefill_step(cfg, cache_len=cache_len)
    serve = steps.make_serve_step(cfg)
    if not greedy and generator is None:
        generator = torch.Generator(device=prompts.device).manual_seed(0)
    logits, cache = prefill(params, {"tokens": prompts})
    out = []
    for i in range(gen_tokens):
        nxt = next_tokens(cfg, logits, greedy=greedy, generator=generator)
        out.append(nxt)
        logits, cache = serve(params, cache, {"tokens": nxt[:, None],
                                              "position": S + i})
    return torch.stack(out, dim=1).to(torch.int32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-0.6b")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = configs.reduced(configs.get(args.arch))
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} is an embeddings-input backbone; "
                         f"serve demo uses token-mode archs")
    params = T.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(
        0, max(2, cfg.vocab_size), (args.batch, args.prompt_len),
        dtype=np.int32)).to(dev)
    t0 = time.time()
    toks = generate(cfg, params, prompts, gen_tokens=args.gen).cpu()
    dt = time.time() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
    print(toks.numpy()[:2])


if __name__ == "__main__":
    main()
