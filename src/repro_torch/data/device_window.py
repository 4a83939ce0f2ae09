"""Window views on the device.

This port carries the single-lane branches of the reference's
``repro.data.device_window``: ``rolling_subwindow`` on a plain ``(X, y)``
window, and ``rotation_rows`` / ``probe_rows`` on a plain token window.
The stacked multi-host ``HostWindows`` branches come with the distributed
slice, ``MaskedWindow`` with the data-plane slice.
"""
from __future__ import annotations

import torch


def rolling_subwindow(data, fraction: float, t: int):
    """Rolling contiguous sub-window of a stage view — the Newton-CG
    Hessian subsample (decorrelates Hessian error across iterations
    without re-loading anything; BET's no-resampling property concerns
    *data access*, not in-memory slicing).

    ``data`` is a tuple of tensors sharing their leading (example) axis;
    ``t`` is the optimizer's host-side step counter.  Returns row views:
    ``k = round(fraction * n)`` rows from offset ``t * k mod (n - k + 1)``,
    the reference's offsets exactly."""
    n = data[0].shape[0]
    k = max(1, int(round(fraction * n)))
    off = (int(t) * k) % max(1, n - k + 1)
    return tuple(x[off:off + k] for x in data)


def rotation_rows(data, batch_size: int, t):
    """The inner step's mini-batch: ``batch_size`` rows rotating through
    the window, ``(arange(B) + t·B) % n`` (sequential epochs over resident
    data — no random disk access).  ``t`` may be a device tensor: the
    indices are then made on the device and the step never syncs."""
    idx = (torch.arange(batch_size, device=data.device) + t * batch_size) \
        % data.shape[0]
    return data[idx]


def probe_rows(data, rows: int):
    """A deterministic ``rows``-row measurement probe: the window's first
    rows, wrapping when the window is smaller."""
    return data[torch.arange(rows, device=data.device) % data.shape[0]]
