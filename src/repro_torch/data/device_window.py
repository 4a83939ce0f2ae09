"""Window views on the device.

This slice carries the plain ``(X, y)`` branch of the reference's
``rolling_subwindow`` (``repro.data.device_window``); the stacked
multi-host ``HostWindows`` branch comes with the distributed slice.
"""
from __future__ import annotations


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
