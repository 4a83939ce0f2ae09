"""A bounded span of the device's trace, read in memory.

``Span`` wraps ``torch.profiler`` (CUPTI on the card) around a stretch of
the measured window that the caller opens and closes at a boundary of
its own (a solve, a stage).  On close it keeps the device's activities
(kernels, copies, sets) and the host's operations as plain tuples, and
writes no trace file.  The reductions below are the only arithmetic the
per-layer readers apply to them: merged busy time, time by kernel name,
and the longest idle gaps labelled by what the host was running.
"""
from __future__ import annotations

MARK = "perfbench.span"          # the span's own host event
PREFIX = "perfbench."               # the harness's host markers


class Span:
    """``open()`` starts the profiler; ``close()`` stops it; ``collect()``
    (once the window has closed: it reads every event) keeps ``device``
    (name, start_ns, dur_ns) and ``host`` (name, start_ns, end_ns)
    lists and the span's own ``start_ns``/``end_ns``.  The harness's own
    markers (``mark(name)``, named ``perfbench.*``) are host events; their
    device-side copies are left out."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = self.mark = None
        self.device: list = []
        self.host: list = []
        self.start_ns = self.end_ns = 0

    def open(self) -> None:
        tp = self.torch.profiler
        acts = [tp.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
            self.torch.cuda.synchronize()
        self.prof = tp.profile(activities=acts)
        self.prof.__enter__()
        # the span's own host event: its ends are the span's, on the
        # profiler's clock
        self.mark = self.torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def marker(self, name: str):
        """A host event ``perfbench.<name>`` around a stretch of the span."""
        return self.torch.profiler.record_function(PREFIX + name)

    def close(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.mark = None

    def collect(self) -> None:
        if self.prof is None:
            return
        events = self.prof.profiler.kineto_results.events()
        dev_type = self.torch.autograd.DeviceType.CUDA
        for ev in events:
            name = ev.name()
            if ev.device_type() == dev_type:
                if not name.startswith(PREFIX):
                    self.device.append((name, ev.start_ns(),
                                        ev.duration_ns()))
            elif name == MARK:
                self.start_ns, self.end_ns = ev.start_ns(), ev.end_ns()
            else:
                self.host.append((name, ev.start_ns(), ev.end_ns()))
        self.prof = None

    def markers(self, name: str) -> list:
        """(start_ns, end_ns) of the host markers ``name``, in order."""
        return sorted((s, e) for n, s, e in self.host if n == PREFIX + name)


def merged_busy_ns(device: list, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] in which some device activity ran."""
    iv = sorted((max(lo, s), min(hi, s + d)) for _, s, d in device
                if s + d > lo and s < hi)
    busy, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def time_by_name(device: list) -> dict:
    out: dict = {}
    for name, _, dur in device:
        out[name] = out.get(name, 0) + dur
    return out


def gaps(device: list, lo: int, hi: int) -> list:
    """The stretches (start_ns, end_ns) of [lo, hi] with nothing on the
    device, longest first."""
    iv = sorted((s, s + d) for _, s, d in device)
    out, cur = [], lo
    for s, e in iv:
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


def idle_gaps(device: list, host: list, lo: int, hi: int, top: int = 10
              ) -> list:
    """The ``top`` longest stretches of [lo, hi] with nothing on the
    device, each named by the innermost host operation running at its
    middle, as [name, seconds]."""
    out = []
    for a, b in gaps(device, lo, hi)[:top]:
        mid = (a + b) // 2
        covering = [h for h in host if h[1] <= mid <= h[2]]
        name = min(covering, key=lambda h: h[2] - h[1])[0] \
            if covering else "host: no operation recorded"
        out.append([f"{name}", (b - a) * 1e-9])
    return out


def breakdown(span: Span) -> dict:
    """The ``breakdown`` of a traced run's result line."""
    ops = sorted(time_by_name(span.device).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, ns * 1e-9] for n, ns in ops[:10]],
            "idle_gaps": idle_gaps(span.device, span.host, span.start_ns,
                                   span.end_ns)}
