"""Hot checkpoint swap: serve every stage's weights without dropping a
request — the port of ``repro.serve.swap``.

``BetEngine``'s stage boundary is the one point where (params, opt_state)
are exact carries — and, with ``StageCheckpointer``'s atomic publish, the
one point where a *serving* process can adopt fresh weights knowing they
are a complete, consistent checkpoint.  This module is the serving side of
that contract:

  * ``BetServer`` — wraps the seed decode path (``steps.make_prefill_step``
    / ``make_serve_step``, ``impl="xla"``: no kernel, as the reference's)
    behind an atomically-swappable parameter slot.  Requests *pin* the
    weights they prefilled under: a swap lands between requests, while any
    in-flight decode finishes its generation under the weights its KV
    cache was built from — no request is ever dropped or restarted.
  * ``CheckpointWatcher`` — polls a checkpoint directory for newly
    published ``stage_*.npz``, loads the params tree onto the server's
    device, and ``adopt``s it, tracking how many stages the served weights
    trail the newest published ones (the *staleness*).

The server never shares a tensor with the trainer: its slot holds the
tensors it was given or loaded, and ``BetEngine.run_online`` trains on
copies of its ``w0``.
"""
from __future__ import annotations

import dataclasses
import pathlib
import threading
import time
from typing import Any, Callable

import torch

from ..elastic.checkpoint import load_stage_checkpoint
from ..launch import steps
from ..launch.serve import next_tokens
from ..optim.api import tree_leaves, tree_map

def serve_kernels(cfg, cache_len: int) -> tuple[Callable, Callable]:
    """The (prefill, decode) pair a server of ``cache_len`` runs.  The
    reference caches its jitted pair per (config, cache_len) so that a
    swap never recompiles; eager PyTorch compiles nothing, so the port
    makes the pair afresh."""
    return (steps.make_prefill_step(cfg, cache_len=cache_len),
            steps.make_serve_step(cfg))


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (``jax.block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class InflightBatch:
    """One decode batch pinned to the weights it prefilled under."""
    server: "BetServer"
    stage: int                  # stage of the pinned weights
    params: Any
    cache: Any
    logits: Any
    position: int
    tokens: list = dataclasses.field(default_factory=list)

    def step(self, *, greedy: bool = True,
             generator: torch.Generator | None = None):
        """Emit one token for every row of the batch, on the device.  The
        pinned ``params`` are used even if the server adopted newer weights
        after this batch prefilled — the KV cache and the weights must
        agree."""
        nxt = next_tokens(self.server.cfg, self.logits, greedy=greedy,
                          generator=generator)
        self.tokens.append(nxt)
        self.logits, self.cache = self.server._decode(
            self.params, self.cache,
            {"tokens": nxt[:, None], "position": self.position})
        self.position += 1
        return nxt

    def finish(self) -> torch.Tensor:
        """(B, generated) int32 on the device; counts the request as
        completed."""
        out = torch.stack(self.tokens, dim=1).to(torch.int32) \
            if self.tokens else torch.zeros(
                (self.logits.shape[0], 0), dtype=torch.int32,
                device=self.logits.device)
        self.server.requests_completed += int(out.shape[0])
        return out


class BetServer:
    """The seed decode path behind an atomically-swappable weight slot, on
    the device of the weights it starts with."""

    def __init__(self, cfg, params, *, cache_len: int, stage: int = -1):
        self.cfg = cfg
        self.cache_len = int(cache_len)
        self.device = tree_leaves(params)[0].device
        self._prefill, self._decode = serve_kernels(cfg, self.cache_len)
        self._lock = threading.Lock()
        self._live = (int(stage), params)
        # ---- metrics
        self.swap_count = 0
        self.swap_latencies_s: list[float] = []
        self.requests_started = 0
        self.requests_completed = 0
        self.tokens_generated = 0
        self.serve_time_s = 0.0

    # ------------------------------------------------------------- weights
    @property
    def adopted_stage(self) -> int:
        return self._live[0]

    @property
    def params(self):
        return self._live[1]

    def adopt(self, stage: int, params, *, t_detect: float | None = None):
        """Atomically replace the served weights.  In-flight batches keep
        the weights they pinned; every batch started after this call serves
        ``params``.  The weights are moved to the server's device and the
        device synchronized before the clock is read, so the recorded swap
        latency includes the upload; ``t_detect`` (a
        ``time.perf_counter`` reading taken when the new checkpoint was
        spotted) makes it include the load too."""
        t0 = t_detect if t_detect is not None else time.perf_counter()
        params = tree_map(lambda x: x.to(self.device), params)
        _sync(self.device)
        with self._lock:
            if stage <= self._live[0]:
                return False            # stale adopt (concurrent poller)
            self._live = (int(stage), params)
        self.swap_count += 1
        self.swap_latencies_s.append(time.perf_counter() - t0)
        return True

    # ------------------------------------------------------------- serving
    def start(self, prompts: torch.Tensor) -> InflightBatch:
        """Prefill a (B, S) prompt batch under the currently-live weights
        and pin them for the batch's lifetime."""
        with self._lock:
            stage, params = self._live
        logits, cache = self._prefill(params, {"tokens": prompts})
        self.requests_started += int(prompts.shape[0])
        return InflightBatch(server=self, stage=stage, params=params,
                             cache=cache, logits=logits,
                             position=int(prompts.shape[1]))

    def generate(self, prompts: torch.Tensor, *, gen_tokens: int,
                 greedy: bool = True,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Serve one batch start-to-finish (the launch/serve.generate loop,
        metered).  Returns (B, gen_tokens) int32 on the device, after the
        device has finished it."""
        t0 = time.perf_counter()
        batch = self.start(prompts)
        for _ in range(gen_tokens):
            batch.step(greedy=greedy, generator=generator)
        out = batch.finish()
        _sync(self.device)
        self.serve_time_s += time.perf_counter() - t0
        self.tokens_generated += int(out.shape[0] * out.shape[1])
        return out

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.serve_time_s, 1e-9)

    def metrics(self) -> dict:
        return {
            "adopted_stage": self.adopted_stage,
            "swap_count": self.swap_count,
            "swap_latency_mean_s": (sum(self.swap_latencies_s)
                                    / len(self.swap_latencies_s))
            if self.swap_latencies_s else 0.0,
            "swap_latency_max_s": max(self.swap_latencies_s, default=0.0),
            "requests_started": self.requests_started,
            "requests_completed": self.requests_completed,
            "tokens_generated": self.tokens_generated,
            "serve_time_s": round(self.serve_time_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
        }


class CheckpointWatcher:
    """Polls a stage-checkpoint directory and hot-swaps the server.

    The ``StageCheckpointer`` publishes atomically (tempfile +
    ``os.replace``), so a visible ``stage_*.npz`` is always complete; the
    only race left is the rolling prune deleting a checkpoint between
    listing and load, which surfaces as ``FileNotFoundError`` and is
    retried on the next poll.  ``params_like`` gives the loaded tree its
    structure, dtypes and device."""

    def __init__(self, directory, params_like, server: BetServer):
        self.directory = pathlib.Path(directory)
        self.params_like = params_like
        self.server = server
        self.staleness_samples: list[int] = []

    def published_stage(self) -> int | None:
        """Stage index of the newest published checkpoint, or None."""
        ckpts = sorted(self.directory.glob("stage_*.npz"))
        if not ckpts:
            return None
        return int(ckpts[-1].stem.split("_")[1])

    def staleness(self) -> int:
        """How many stages the served weights trail the newest published
        checkpoint right now (0 = serving the freshest weights)."""
        pub = self.published_stage()
        if pub is None:
            return 0
        return max(0, pub - self.server.adopted_stage)

    def poll(self) -> bool:
        """Record a staleness sample, then adopt the newest checkpoint if
        it is fresher than what the server holds.  Returns True on swap."""
        self.staleness_samples.append(self.staleness())
        ckpts = sorted(self.directory.glob("stage_*.npz"))
        if not ckpts:
            return False
        latest = ckpts[-1]
        stage = int(latest.stem.split("_")[1])
        if stage <= self.server.adopted_stage:
            return False
        t_detect = time.perf_counter()
        try:
            restored = load_stage_checkpoint(
                latest.with_suffix(""), self.params_like, None)
        except FileNotFoundError:
            return False                # pruned between glob and read
        return self.server.adopt(stage, restored.params, t_detect=t_detect)
