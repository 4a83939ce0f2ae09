"""The port's ``ExpandingWindow`` (``repro_torch.data.window``), the host
numpy shim of §3.3: the reference's own shim tests and hypothesis
properties re-run on the port's class, and a seeded comparison with the
reference's class element for element — windows after each ``grow()``,
batches, host shards, and the clock's and meter's counters."""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.core import SimulatedClock as JClock
from repro.data.shards import DataAccessMeter as JMeter
from repro.data.window import ExpandingWindow as JWindow
from repro_torch.core import SimulatedClock
from repro_torch.data import DataAccessMeter, ExpandingWindow, synth_corpus
from repro_torch.data import window as twindow

pytestmark = pytest.mark.tier1

pytest.importorskip("hypothesis",
                    reason="property tests need the optional hypothesis dep")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _window(*args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return ExpandingWindow(*args, **kw)


# --------------------------------------------- the reference's shim tests
def test_expanding_window_shim_warns():
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        win = ExpandingWindow(np.zeros((16, 4), np.int32), n0=4)
    assert win.n_t == 4                     # still bit-exact semantics
    assert win.grow() == 8


def test_expanding_window_rejects_non_expanding_growth():
    corpus = synth_corpus(32, 8, 97)
    with pytest.raises(ValueError):
        _window(corpus, 8, growth=1.0)
    with pytest.raises(ValueError):
        _window(corpus, 8, growth=0.5)
    assert _window(corpus, 8, growth=1.0 + 1e-6).n_t == 8


def test_expanding_window_meter_counts_unique_loads():
    corpus = synth_corpus(40, 8, 97)
    meter = DataAccessMeter()
    w = _window(corpus, 10, meter=meter)
    assert meter.examples_loaded == 10
    while not w.full:
        w.grow()
    assert meter.examples_loaded == 40          # each example once
    w.sample_batch(4, 0)
    assert meter.examples_accessed == 4


def test_host_shard_disjoint_covering_slices():
    corpus = synth_corpus(16, 4, 97)
    w = _window(corpus, 16)
    batch = w.window()

    for num_hosts in (2, 3, 5):                 # divisible and ragged
        shards = [w.host_shard(batch, h, num_hosts) for h in range(num_hosts)]
        per = -(-len(batch) // num_hosts)
        assert all(len(s) == per for s in shards)
        np.testing.assert_array_equal(
            np.concatenate(shards)[: len(batch)], batch)
    np.testing.assert_array_equal(w.host_shard(batch, 0, 2), batch[:8])
    tiny = batch[:2]
    tiny_shards = [w.host_shard(tiny, h, 5) for h in range(5)]
    assert all(len(s) == 1 for s in tiny_shards)
    np.testing.assert_array_equal(np.concatenate(tiny_shards)[:2], tiny)
    with pytest.raises(ValueError):
        w.host_shard(batch, 2, 2)


def test_the_shim_holds_no_tensor():
    """Host numpy, as the reference's: no field, window or batch is a
    tensor, and the module does not import torch."""
    w = _window(synth_corpus(32, 4, 97), 8, clock=SimulatedClock(),
                meter=DataAccessMeter())
    outs = [w.window(), w.previous_window(), w.sample_batch(3, 1),
            w.host_shard(w.window(), 0, 3)]
    assert all(type(o) is np.ndarray for o in outs)
    assert "torch" not in vars(twindow)


# ---------------------------------------- the reference's properties
@given(n0=st.integers(1, 50), n=st.integers(51, 400))
@settings(max_examples=50, deadline=None)
def test_window_prefix_reuse(n0, n):
    """Windows are nested prefixes of one permutation — data loaded once
    is never invalidated."""
    corpus = synth_corpus(n, 8, 97, seed=1)
    w = _window(corpus, n0)
    prev = w.window().copy()
    while not w.full:
        w.grow()
        cur = w.window()
        assert len(cur) >= len(prev)
        np.testing.assert_array_equal(cur[: len(prev)], prev)
        prev = cur.copy()


@given(bs=st.integers(1, 16), step=st.integers(0, 100))
@settings(max_examples=50, deadline=None)
def test_window_sampling_stays_resident(bs, step):
    corpus = synth_corpus(64, 8, 97, seed=2)
    w = _window(corpus, 16)
    batch = w.sample_batch(bs, step)
    win = w.window()
    for row in batch:
        assert any((row == r).all() for r in win)


@given(n=st.integers(1, 64), num_hosts=st.integers(1, 7),
       seed=st.integers(0, 5))
@settings(max_examples=50, deadline=None)
def test_host_shard_invariants(n, num_hosts, seed):
    corpus = synth_corpus(n, 4, 97, seed=seed)
    w = _window(corpus, n)
    batch = w.window()
    shards = [w.host_shard(batch, h, num_hosts) for h in range(num_hosts)]
    per = -(-n // num_hosts)
    assert all(s.shape == (per,) + batch.shape[1:] for s in shards)
    np.testing.assert_array_equal(np.concatenate(shards)[:n], batch)


# ------------------------------------ element for element, the reference
def _drive(cls, clock, meter, corpus, n0, growth):
    """Everything the shim returns and charges, grow by grow."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        w = cls(corpus, n0, growth=growth, clock=clock, meter=meter)
    out = []
    step = 0
    while True:
        batch = w.sample_batch(5, step)
        out.append({"n_t": w.n_t, "full": w.full, "N": w.N,
                    "window": w.window(), "previous": w.previous_window(),
                    "batch": batch,
                    "shards": [[w.host_shard(batch, h, k) for h in range(k)]
                               for k in range(1, 8)]})
        if clock is not None:
            out[-1]["clock"] = (clock.time, clock.data_accesses,
                                clock.points_loaded)
        if meter is not None:
            out[-1]["meter"] = dataclasses.asdict(meter)
        step += 1
        if w.full:
            break
        w.grow()
    return out


def _equal(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("n0,growth,N", [(8, 2.0, 100), (3, 1.5, 61),
                                         (7, 3.0, 200), (50, 2.0, 40),
                                         (1, 1.0 + 1e-6, 3)])
@pytest.mark.parametrize("accounting", [False, True])
def test_window_equals_the_reference_element_for_element(n0, growth, N,
                                                        accounting):
    corpus = synth_corpus(N, 6, 97, seed=N)
    clock = dict(p=10.0, a=1.0, s=5.0, preloaded=2)
    ref = _drive(JWindow, JClock(**clock) if accounting else None,
                 JMeter() if accounting else None, corpus, n0, growth)
    port = _drive(ExpandingWindow,
                  SimulatedClock(**clock) if accounting else None,
                  DataAccessMeter() if accounting else None, corpus, n0,
                  growth)
    assert len(port) == len(ref) >= 1
    _equal(port, ref)
