"""Batched serving demo: prefill + KV-cache decode with the same serve
step the dry run lays out for decode_32k / long_500k, on a reduced config
with a sliding-window cache — the port of ``examples/serve_decode.py``,
printing the same lines.

The weights come from ``init_params`` with seed 0 and the prompts from a
``torch.Generator`` seeded 1 (the reference draws both from
``jax.random``, so the numbers differ); ``run`` takes any weights and
prompts, and given the reference's (``convert.params_from_jax``) its
greedy tokens are the reference's.

    python -m repro_torch.examples.serve_decode [--arch internlm2-1.8b]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from ..device import resolve_device
from ..launch.serve import generate
from ..models import transformer as T


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=32,
                    help="sliding-window size (the long_500k carve-out)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.reduced(configs.get(args.arch)).with_(
        sliding_window=args.window)
    params = T.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, max(2, cfg.vocab_size),
                            (args.batch, args.prompt_len), generator=gen,
                            device=dev, dtype=torch.int32)
    return run(cfg, params, prompts, args.gen, args.window)


def run(cfg, params, prompts: torch.Tensor, gen_tokens: int,
        window: int) -> torch.Tensor:
    """Generate greedily and print the reference's two lines; returns the
    tokens (B, gen_tokens)."""
    t0 = time.time()
    toks = generate(cfg, params, prompts, gen_tokens=gen_tokens)
    if toks.is_cuda:
        torch.cuda.synchronize()
    dt = time.time() - t0
    B, S = prompts.shape
    print(f"{cfg.name}: sliding-window={window} cache "
          f"(prompt {S} > window -> ring buffer wrapped)")
    print(f"generated {tuple(toks.shape)} tokens in {dt:.1f}s "
          f"({B * gen_tokens / dt:.1f} tok/s greedy)")
    return toks


if __name__ == "__main__":
    main()
