"""Opt-in profiling: a ``torch.profiler`` capture + per-stage FLOP and
byte counts — the port of ``repro.obs.profile``.

  * ``profiler_trace(logdir)`` wraps a run in ``torch.profiler.profile``
    (CPU activity, and CUDA activity where a card is present) and writes
    its Chrome trace to ``logdir/trace.json`` (``ObsSpec.jax_profiler_dir``
    and ``ObsSpec.profile``; the field keeps the reference's name, so specs
    cross between the packages);
  * ``StageProfiler`` costs each stage's step once per (callable, window
    size) and emits a ``profile.stage`` event with its FLOPs (the matrix
    products' from ``torch.utils.flop_counter.FlopCounterMode``, the
    matrix-vector and dot products', and one an output element of each
    pointwise operation), its bytes (every
    operation's tensor inputs and outputs, views excepted: the unfused
    count XLA's "bytes accessed" gives the reference) and the roofline
    seconds on an H100.  The step runs on meta tensors, so nothing is
    computed or launched and no optimizer state advances; the kernels'
    wrappers take their plain versions there, whose operations are the
    ones counted.  A failure lands in the event's ``error`` field:
    profiling never stops a run.

``seed_kernel_costs`` applies the same counts to the plain versions of
B1–B4 (``kernels/ref.py``) at the reference's small shapes.
"""
from __future__ import annotations

import contextlib
import pathlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..data.device_window import HostWindows, MaskedWindow
from ..kernels import ops

# NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit (NVIDIA's H100 data
# sheet, dense rates): HBM3 bandwidth, float32 outside the tensor cores
# (the port runs float32 products at full precision, no TF32), and bf16
# and fp16 on the tensor cores
HBM_BW = 3.35e12                   # bytes/s
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              torch.bfloat16: 989e12, torch.float16: 989e12}
# NVLink 4 (the same data sheet): 900 GB/s counts both directions; the
# dry run's wire bytes count what one GPU sends, so it divides by one
# direction.  A floor for a mesh that crosses nodes, whose links are
# slower (``launch/dryrun.py``)
NVLINK_BW = 4.5e11                  # bytes/s, one direction (450 GB/s)


def profiler_trace(logdir):
    """A ``torch.profiler`` capture written to ``logdir`` as a Chrome
    trace when a log dir is given, a no-op otherwise."""
    if not logdir:
        return contextlib.nullcontext()
    return _chrome_trace(pathlib.Path(logdir))


@contextlib.contextmanager
def _chrome_trace(logdir: pathlib.Path):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    logdir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(logdir / "trace.json"))


def _roofline(flops: float, nbytes: float, peak: float) -> dict:
    compute_s = flops / peak
    memory_s = nbytes / HBM_BW
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "roofline_us": max(compute_s, memory_s) * 1e6,
        "bottleneck": "memory" if memory_s > compute_s else "compute",
        "intensity_flops_per_byte": flops / nbytes if nbytes else 0.0,
        "peak_flops": peak, "hbm_bw": HBM_BW,
    }


_aten = torch.ops.aten
# the products ``FlopCounterMode`` leaves out: matrix-vector and dot
_VECTOR_PRODUCTS = {_aten.mv.default: lambda A, x: 2 * A.numel(),
                    _aten.dot.default: lambda a, b: 2 * a.numel(),
                    _aten.vdot.default: lambda a, b: 2 * a.numel()}


# the collectives DTensor issues, by the reference's HLO names
_C10D_KINDS = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all"}


def _group_size(func, args) -> int:
    name = func._schema.name.split("::")[-1]
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    if name == "all_to_all_single":
        return len(args[1])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class _OpCounter(TorchDispatchMode):
    """Bytes of every operation's tensor inputs and outputs (a view moves
    none); the matrix-vector and dot products' FLOPs; and one operation per
    output element of each pointwise operation (``FlopCounterMode``
    counts the matrix products).

    With ``local=True`` (the dry run, ``launch/hlo.py``) it counts what one
    device runs: an operation on DTensors is left to DTensor, whose
    operations on the local shards come back here and are counted, with
    the matrix products' FLOPs (``FlopCounterMode``'s formulas) and each
    collective DTensor issues (kind, output bytes, group size and
    ``site()``, the caller's provenance); and it keeps the peak of the
    bytes alive in the tensors made under it (``peak_bytes``).  With
    ``device``, only operations with a tensor on that device count: the
    dry run's tensors are on the meta device, and DTensor's own index
    arithmetic on the host is not the step's work."""

    def __init__(self, *, local: bool = False, site=None, device=None):
        super().__init__()
        self.device = torch.device(device) if device is not None else None
        self.bytes = 0
        self.pointwise = 0
        self.vector_products = 0
        self.local = local
        self.products = 0
        self.collectives: list = []
        self.site = site or (lambda: "?")
        self.live_bytes = 0
        self.peak_bytes = 0
        self.paused = 0

    def _track(self, out) -> None:
        import weakref
        seen = set()
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or id(t) in seen:
                continue
            seen.add(id(t))
            n = t.numel() * t.element_size()
            self.live_bytes += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.paused:
            return func(*args, **(kwargs or {}))
        if self.local:
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self.device is not None and not any(
                t.device == self.device for t in tree_leaves((args, out))
                if isinstance(t, torch.Tensor)):
            return out                  # host-side bookkeeping of DTensor
        if func in _VECTOR_PRODUCTS:
            self.vector_products += _VECTOR_PRODUCTS[func](*args[:2])
        is_view = getattr(func, "is_view", False)
        if not is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        if torch.Tag.pointwise in func.tags:
            self.pointwise += sum(t.numel() for t in tree_leaves(out)
                                  if isinstance(t, torch.Tensor))
        if self.local:
            self._count_local(func, args, kwargs or {}, out, is_view)
        return out

    def _count_local(self, func, args, kwargs, out, is_view) -> None:
        from torch.utils.flop_counter import flop_registry
        packet = func.overloadpacket
        if packet in flop_registry:
            self.products += flop_registry[packet](*args, **kwargs,
                                                   out_val=out)
        name = func._schema.name
        kind = _C10D_KINDS.get(name.split("::")[-1]) \
            if name.startswith("_c10d_functional::") else None
        if kind is not None:
            self.collectives.append({
                "kind": kind, "out_bytes": out.numel() * out.element_size(),
                "group_size": _group_size(func, args), "site": self.site()})
        if not is_view and not func._schema.is_mutable \
                and not name.endswith("wait_tensor"):
            self._track(out)


def to_meta(x):
    """``x`` with every tensor replaced by a meta tensor of its shape and
    dtype: dicts, lists, tuples and the windows (``MaskedWindow``,
    ``HostWindows``) keep their structure; other leaves pass through."""
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, dict):
        return {k: to_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_meta(v) for v in x)
    if isinstance(x, MaskedWindow):
        return MaskedWindow(to_meta(x.data), to_meta(x.n_valid))
    if isinstance(x, HostWindows):
        return HostWindows(to_meta(x.fields), counts=to_meta(x._counts),
                           host_counts=x.host_counts,
                           offsets=to_meta(x.offsets))
    return x


def _peak(args) -> float:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor) and t.dtype in PEAK_FLOPS:
            return PEAK_FLOPS[t.dtype]
    return PEAK_FLOPS[torch.float32]


def cost(fn, *args, **kwargs) -> dict:
    """FLOPs, bytes and roofline terms of ``fn(*args, **kwargs)``, run on
    meta copies of the arguments (nothing computed)."""
    margs, mkw = to_meta(args), to_meta(kwargs)
    flops = FlopCounterMode(display=False)
    counter = _OpCounter()
    with ops.plain_on_meta(), flops, counter:
        fn(*margs, **mkw)
    products = float(flops.get_total_flops() + counter.vector_products)
    total = products + counter.pointwise
    out = {"flops": total, "bytes": float(counter.bytes),
           "product_flops": products, "pointwise_flops": counter.pointwise}
    out.update(_roofline(total, out["bytes"], _peak(args)))
    return out


# ---------------------------------------------------------- seed kernel costs
def _seed_kernel_cases() -> dict:
    """(fn, args) per kernel, over the plain versions at the reference's
    small shapes (``kernels/ref.py`` signatures)."""
    from ..kernels import ref

    f32 = torch.float32
    X = torch.ones((256, 64), dtype=f32)
    y = torch.ones((256,), dtype=f32)
    w = torch.ones((64,), dtype=f32)
    q = torch.ones((1, 128, 2, 64), dtype=f32)      # (B, S, H, hd)
    u = torch.ones((1, 64, 32), dtype=f32)
    bc = torch.ones((1, 64, 16), dtype=f32)
    A_log = torch.zeros((32, 16), dtype=f32)
    D = torch.ones((32,), dtype=f32)
    ab = torch.ones((1, 64, 32), dtype=f32)
    return {
        "linear_forward": (ref.linear_forward, (X, w)),
        "linear_value_grad": (ref.linear_value_grad, (X, y, w)),
        "flash_attention": (ref.gqa_attention, (q, q, q)),
        "ssm_scan": (ref.ssm_scan, (u, u, bc, bc, A_log, D)),
        "rglru_scan": (ref.rglru_scan, (ab, ab)),
    }


def seed_kernel_costs() -> dict:
    """Per-kernel FLOPs, bytes and roofline for B1–B4's plain versions.
    A kernel that fails to run reports an ``error`` instead of aborting
    the sweep."""
    out = {}
    for name, (fn, args) in _seed_kernel_cases().items():
        try:
            out[name] = cost(fn, *args)
        except Exception as exc:
            out[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return out


# ------------------------------------------------------------ stage profiling
class StageProfiler:
    """Per-stage analytic cost events.  The engine calls ``observe`` before
    each stage's first step with the stage's step callable (a scan step or
    both race tracks' step) and its arguments; the profiler counts it once
    per (callable, window size) and emits one ``profile.stage`` event.
    Every failure is caught and reported in the event — profiling never
    alters the run."""

    def __init__(self, recorder):
        self.recorder = recorder
        self._seen: set = set()

    def observe(self, info, kernel, args, kwargs) -> None:
        n_t = int(getattr(info, "n_t", 0))
        name = getattr(kernel, "__name__", type(kernel).__name__)
        key = (name, n_t)
        if key in self._seen:
            return
        self._seen.add(key)
        fields = {"stage": int(getattr(info, "stage", -1)), "n_t": n_t,
                  "callable": name}
        try:
            fields.update(cost(kernel, *args, **kwargs))
        except Exception as exc:
            fields["error"] = f"{type(exc).__name__}: {exc}"
        self.recorder.instant("profile.stage", **fields)
