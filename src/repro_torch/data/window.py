"""The synthetic token corpus of the LM path — the port's copy of
``repro.data.window.synth_corpus``.  It is numpy from a seed, so the
port's corpus is bit-identical to the reference's."""
from __future__ import annotations

import numpy as np


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
