"""Run traces shared by all training drivers and the benchmark harness."""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass
class Point:
    step: int
    stage: int
    window: int          # n_t
    time: float          # simulated clock
    accesses: int
    f_window: float      # f̂_t(w) on the current window
    f_full: float        # f̂(w) on the full dataset (measurement only)
    extra: dict = dataclasses.field(default_factory=dict)


def _as_column(value, n: int) -> list:
    """Broadcast a scalar to n entries, or pass a length-n sequence through."""
    if hasattr(value, "__len__") and not isinstance(value, (str, bytes)):
        if len(value) != n:
            raise ValueError(f"column of length {len(value)} != {n}")
        return list(value)
    return [value] * n


@dataclasses.dataclass
class Trace:
    method: str
    points: list = dataclasses.field(default_factory=list)
    params: Any = None
    meta: dict = dataclasses.field(default_factory=dict)

    def add(self, **kw):
        self.points.append(Point(**kw))

    def extend(self, *, step, stage, window, time, accesses, f_window, f_full,
               extra: Sequence[dict] | None = None) -> list:
        """Append a batch of points in one call.

        Columns may be scalars (broadcast) or equal-length sequences /
        numpy arrays — this is the hot path for the engine's once-per-stage
        device-to-host flush, replacing a Python loop of per-step ``add``
        calls.  Returns the appended points.
        """
        cols = dict(step=step, stage=stage, window=window, time=time,
                    accesses=accesses, f_window=f_window, f_full=f_full)
        lengths = [len(v) for v in cols.values()
                   if hasattr(v, "__len__") and not isinstance(v, (str, bytes))]
        if extra is not None:
            lengths.append(len(extra))
        if not lengths:
            raise ValueError("extend() needs at least one sequence column")
        n = lengths[0]
        cols = {k: _as_column(v, n) for k, v in cols.items()}
        if extra is not None and len(extra) != n:
            raise ValueError(f"extra of length {len(extra)} != {n}")
        new = [Point(step=int(cols["step"][i]), stage=int(cols["stage"][i]),
                     window=int(cols["window"][i]), time=float(cols["time"][i]),
                     accesses=int(cols["accesses"][i]),
                     f_window=float(cols["f_window"][i]),
                     f_full=float(cols["f_full"][i]),
                     extra=dict(extra[i]) if extra is not None else {})
               for i in range(n)]
        self.points.extend(new)
        return new

    def column(self, name):
        return [getattr(p, name) for p in self.points]

    def final(self) -> Point:
        return self.points[-1]
