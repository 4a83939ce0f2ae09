"""ExpandingWindow — the host-side compatibility shim over the streaming
plane, and the synthetic token corpus of the LM path; the port of
``repro.data.window``.

The real data plane lives in ``shards.py`` / ``prefetch.py`` /
``device_window.py`` / ``plane.py`` (``StreamingDataset``): sharded
storage, async prefetch, and a window on the card grown in place.
``ExpandingWindow`` keeps the original host-side numpy API for the
property tests and anything that wants §3.3 semantics without a device:
nested prefix windows of one permutation, ``grow()`` doubling,
``SimulatedClock`` charging, and real-read accounting through an optional
``DataAccessMeter``.  It stays host numpy, as the reference's does: it
holds no tensor and launches nothing, so it takes no device.

``synth_corpus`` is numpy from a seed, so the port's corpus is
bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from ..core.timemodel import SimulatedClock
from .shards import DataAccessMeter


@dataclasses.dataclass
class ExpandingWindow:
    """A windowed view over a pre-permuted token corpus.

    tokens: (N, seq_len) int32 — sequence-packed examples, pre-permuted.

    .. deprecated::
        The host shim survives for §3.3-semantics-without-a-device tests;
        real runs compose the streaming plane declaratively through
        ``repro_torch.api.build(RunSpec)`` (``DataSpec(plane="plane")``).
        Construction emits a ``DeprecationWarning``.
    """
    tokens: np.ndarray
    n0: int
    growth: float = 2.0
    clock: SimulatedClock | None = None
    meter: DataAccessMeter | None = None

    def __post_init__(self):
        warnings.warn(
            "ExpandingWindow is a host-side compatibility shim: compose "
            "the streaming data plane through repro_torch.api.build(RunSpec) "
            "(DataSpec(plane='plane')) instead", DeprecationWarning,
            stacklevel=3)
        if not self.growth > 1.0:
            raise ValueError(
                f"ExpandingWindow.growth must be > 1, got {self.growth}: "
                "grow() would loop forever without reaching the corpus")
        self.n_t = min(self.n0, len(self.tokens))
        if self.clock is not None:
            self.clock.wait_for(self.n_t)
        self._record_load(self.n_t)

    @property
    def N(self) -> int:
        return len(self.tokens)

    @property
    def full(self) -> bool:
        return self.n_t >= self.N

    def grow(self) -> int:
        """Expand the window (Alg. 1 line: n_{t+1} <- b * n_t)."""
        new_n = min(self.N, int(np.ceil(self.n_t * self.growth)))
        if new_n > self.n_t:
            if self.clock is not None:
                self.clock.wait_for(new_n)  # loading overlaps; block if behind
            self._record_load(new_n - self.n_t)    # only the new examples
        self.n_t = new_n
        return self.n_t

    def window(self) -> np.ndarray:
        return self.tokens[: self.n_t]

    def previous_window(self) -> np.ndarray:
        """The half-size window used by the two-track secondary."""
        prev = max(1, int(self.n_t / self.growth))
        return self.tokens[:prev]

    def sample_batch(self, batch_size: int, step: int) -> np.ndarray:
        """Deterministic rotation through the resident window (sequential
        epochs over loaded data — no random disk access, the BET property).
        Charges the clock for one batch of compute-side access."""
        n = self.n_t
        idx = (np.arange(batch_size) + step * batch_size) % n
        if self.clock is not None:
            self.clock.eval_pass(batch_size)
        if self.meter is not None:
            self.meter.record_access(batch_size)
        return self.tokens[idx]

    def host_shard(self, batch: np.ndarray, host: int, num_hosts: int):
        """Per-host slice of a global batch (data-parallel loading).

        Every host gets the same ``ceil(len/num_hosts)`` rows (SPMD lockstep
        needs shape agreement across hosts), the slices cover the whole
        batch, and the unpadded portions are disjoint.  When
        ``len(batch) % num_hosts != 0`` the tail is padded by wrapping to
        the batch start instead of silently dropping — only the last host's
        pad rows duplicate examples."""
        if not 0 <= host < num_hosts:
            raise ValueError(f"host {host} not in [0, {num_hosts})")
        per = -(-len(batch) // num_hosts)
        if per * num_hosts != len(batch):
            # cyclic tile (handles pad > len(batch), e.g. 2 rows, 5 hosts)
            batch = np.resize(batch, (per * num_hosts,) + batch.shape[1:])
        return batch[host * per: (host + 1) * per]

    def _record_load(self, examples: int) -> None:
        if self.meter is not None and examples > 0:
            row_bytes = self.tokens.dtype.itemsize * int(
                np.prod(self.tokens.shape[1:], dtype=np.int64))
            self.meter.record_load(nbytes=examples * row_bytes,
                                   examples=examples, duration_s=0.0,
                                   blocked_s=0.0, prefetched=False)


def synth_corpus(n_seqs: int, seq_len: int, vocab: int, *,
                 seed: int = 0) -> np.ndarray:
    """Synthetic Zipf-distributed token corpus with local n-gram structure —
    enough statistical texture for loss curves to be meaningful."""
    rng = np.random.default_rng(seed)
    # Zipfian unigrams
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    base = rng.choice(vocab, size=(n_seqs, seq_len), p=probs)
    # inject bigram structure: with prob .5, next token = f(prev)
    shift = (base[:, :-1] * 31 + 7) % vocab
    mask = rng.random((n_seqs, seq_len - 1)) < 0.5
    base[:, 1:] = np.where(mask, shift, base[:, 1:])
    return base.astype(np.int32)
