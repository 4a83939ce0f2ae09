"""The device-resident expanding window and its views — the single-lane
part of the reference's ``repro.data.device_window``.

``DeviceWindow`` is BET's data contract (§3.3): one device buffer,
allocated once at full capacity and grown **in place** as shards arrive,
so resident examples are never transferred again.  Two views:

  * ``masked(n)`` — a ``MaskedWindow``: the whole buffer plus a 0-d int32
    valid length on the buffer's device; consumers index ``% n_valid`` on
    the device (the LM path), so a step never reads the length back,
  * ``slice(n)`` — the prefix ``buf[:n]`` (the convex path, whose
    objectives reduce over the leading axis; bit-exact against slicing
    the same rows on the host path).

The adapters ``rotation_rows``, ``probe_rows`` and ``rolling_subwindow``
take a plain window or a ``MaskedWindow``.  The multi-host stacked window
(``StackedDeviceWindow``, ``HostWindows``, ``WindowLane``) comes with the
distributed slice (ROADMAP queue A8), ``append_staged`` with the tiered
corpus (A11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .shards import DataAccessMeter


@dataclasses.dataclass
class MaskedWindow:
    """A fixed-capacity row buffer with a device-side valid length: an
    expansion changes only ``n_valid``, never the buffer's shape."""
    data: torch.Tensor          # (capacity, *item_shape)
    n_valid: torch.Tensor       # () int32, on data's device

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def window_rows(data):
    """(rows, n) for either a ``MaskedWindow`` or a plain row tensor — the
    one adapter consumers need to run unchanged on both data paths."""
    if isinstance(data, MaskedWindow):
        return data.data, data.n_valid
    return data, data.shape[0]


def rotation_rows(data, batch_size: int, t):
    """The inner step's mini-batch: ``batch_size`` rows rotating through
    the window's valid prefix, ``(arange(B) + t·B) % n`` (sequential
    epochs over resident data — no random disk access).  ``t`` may be a
    device tensor, and ``n`` is one for a ``MaskedWindow``: the indices are
    then made on the device and the step never syncs.  The host path's
    slice and the plane's ``MaskedWindow`` gather the same rows."""
    rows, n = window_rows(data)
    idx = (torch.arange(batch_size, device=rows.device) + t * batch_size) % n
    return rows[idx]


def probe_rows(data, rows: int):
    """A deterministic ``rows``-row measurement probe: the window's first
    rows, wrapping when the valid prefix is smaller."""
    buf, n = window_rows(data)
    return buf[torch.arange(rows, device=buf.device) % n]


def rolling_subwindow(data, fraction: float, t: int):
    """Rolling contiguous sub-window of a stage view — the Newton-CG
    Hessian subsample (decorrelates Hessian error across iterations
    without re-loading anything; BET's no-resampling property concerns
    *data access*, not in-memory slicing).  ``t`` is the optimizer's
    host-side step counter.

    A tuple of tensors sharing their leading (example) axis gives row
    views: ``k = round(fraction * n)`` rows from offset
    ``t * k mod (n - k + 1)``, the reference's offsets exactly.  A
    ``MaskedWindow`` gives a ``MaskedWindow`` of a static
    ``round(fraction * capacity)`` rows whose valid count is
    ``round(fraction * n_valid)`` (at least 1), from an offset kept inside
    both the valid prefix and the buffer — the reference's one-lane
    masked semantics, computed on the device."""
    if isinstance(data, MaskedWindow):
        cap, m = data.capacity, data.n_valid
        k = max(1, int(round(fraction * cap)))
        k_eff = torch.clamp(torch.round(fraction * m.float()).int(),
                            torch.clamp(m, max=1), m)
        lim = torch.clamp(m - k_eff, max=cap - k)
        off = (t * torch.clamp(k_eff, min=1)) % torch.clamp(lim + 1, min=1)
        idx = off + torch.arange(k, device=data.data.device)
        return MaskedWindow(data.data[idx], k_eff)
    n = data[0].shape[0]
    k = max(1, int(round(fraction * n)))
    off = (int(t) * k) % max(1, n - k + 1)
    return tuple(x[off:off + k] for x in data)


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (a store's) or a torch dtype, as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


@dataclasses.dataclass
class DeviceWindow:
    """Preallocated expanding window resident on ``device``.

    ``append`` uploads only the new rows and lands them after the
    resident prefix, so growing never re-uploads resident data.  On the
    card the rows are copied from pinned host memory with
    ``non_blocking=True`` on the current stream, the stream every later
    kernel of the run is queued on, so no reader can see rows that have
    not landed.  ``growth`` mirrors the stage schedule and is validated
    like ``BETSchedule.growth``.

    Views stay valid: an append writes only rows beyond the resident
    prefix, so a view handed out earlier keeps its rows and values (the
    reference, whose appends donate the buffer, must drop its views)."""
    capacity: int
    item_shape: tuple
    dtype: Any
    growth: float = 2.0
    meter: DataAccessMeter | None = None
    # multi-field planes (X, y) append the same example range to several
    # windows; only one of them counts *examples* uploaded (bytes are
    # genuinely per-field and always counted)
    meter_examples: bool = True
    device: Any = "cuda"

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if not self.growth > 1.0:
            raise ValueError(
                f"DeviceWindow.growth must be > 1, got {self.growth}: the "
                "window would never expand to its full capacity")
        self.item_shape = tuple(self.item_shape)
        self.device = resolve_device(self.device)
        self._buf = torch.zeros((self.capacity,) + self.item_shape,
                                dtype=_torch_dtype(self.dtype),
                                device=self.device)
        self._n = 0
        self._n_dev = self._scalar(0)

    def _scalar(self, n: int) -> torch.Tensor:
        # a fresh tensor each time: a MaskedWindow handed out earlier keeps
        # its own count
        return torch.full((), n, dtype=torch.int32, device=self.device)

    # ---------------------------------------------------------------- state
    @property
    def n_valid(self) -> int:
        return self._n

    @property
    def buffer(self) -> torch.Tensor:
        return self._buf

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def next_size(self) -> int:
        """The schedule's next window: n_{t+1} = min(cap, ceil(g * n_t))."""
        return min(self.capacity, int(math.ceil(max(1, self._n) * self.growth)))

    # --------------------------------------------------------------- updates
    def append(self, rows: np.ndarray) -> int:
        """Upload ``rows`` and land them in place after the resident prefix.
        Returns the new valid length."""
        rows = np.asarray(rows)
        if rows.shape[1:] != self.item_shape:
            raise ValueError(
                f"rows shape {rows.shape[1:]} != item shape {self.item_shape}")
        k = int(rows.shape[0])
        if self._n + k > self.capacity:
            raise ValueError(
                f"append of {k} rows overflows window "
                f"({self._n}/{self.capacity} resident)")
        src = torch.from_numpy(np.ascontiguousarray(rows)).to(self._buf.dtype)
        if self.device.type == "cuda":
            # the pinned block is not reused before the copy has run: the
            # caching host allocator records the copy's stream
            src = src.pin_memory()
        self._buf[self._n:self._n + k].copy_(src, non_blocking=True)
        if self.meter is not None:
            self.meter.record_upload(nbytes=rows.nbytes,
                                     examples=k if self.meter_examples else 0)
        self._n += k
        self._n_dev = self._scalar(self._n)
        return self._n

    # ---------------------------------------------------------------- cursor
    def cursor(self) -> dict:
        """Checkpointable residency bookkeeping: together with the fixed
        permutation, ``n_valid`` fully determines the window's contents."""
        return {"n_valid": self._n}

    def restore_cursor(self, cursor: dict) -> None:
        """Restore the valid-length bookkeeping from a checkpoint.  Pure
        cursor state: the caller re-lands the first ``n_valid`` examples
        beneath it (a resumed plane replays ``ensure_resident``)."""
        n = int(cursor["n_valid"])
        if not 0 <= n <= self.capacity:
            raise ValueError(
                f"cursor n_valid={n} outside window capacity {self.capacity}")
        self._n = n
        self._n_dev = self._scalar(n)

    # ----------------------------------------------------------------- views
    def masked(self, n: int | None = None) -> MaskedWindow:
        """Fixed-shape view exposing the first ``n`` (default: all resident)
        examples through the valid-length mask."""
        if n is None:
            return MaskedWindow(self._buf, self._n_dev)
        if n > self._n:
            raise ValueError(f"window {n} exceeds resident prefix {self._n}")
        return MaskedWindow(self._buf, self._scalar(n))

    def slice(self, n: int) -> torch.Tensor:
        """Device-side prefix view (the convex path's (X[:n], y[:n]))."""
        if n > self._n:
            raise ValueError(f"window {n} exceeds resident prefix {self._n}")
        return self._buf[:n]
