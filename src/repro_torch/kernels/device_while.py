"""The Two-Track race's device-side loop on Hopper: a CUDA graph whose
conditional WHILE node repeats one race step until condition (3) fires or
``max_iters`` steps have run — the port of the reference's
``lax.while_loop`` over a racing stage (``repro.core.engine``).

``csrc/device_while.cu`` builds the loop from the CUDA runtime's
conditional nodes, which need CUDA 12.3 or later in both the runtime and
the driver.  This module is its wrapper: it captures one race step with
``torch.cuda.CUDAGraph(keep_graph=True)`` (the step, the ``copy_`` of its
new carries into the static ones it read, and the condition kernel), puts
the captured graph into the body of the WHILE node, and launches the loop
once on the current stream.  Nothing is read back: the caller pulls the
histories, the step count and the trigger flag once, then ``close``s the
loop, which frees the graphs and the capture's memory pool, or
``relaunch``es it from a new carry of the same shapes.

The captured step reads the static carries and the device step index
``s``, so it must hold no Python value that changes from step to step:
every optimizer's step counter is a device tensor.  Dispatch by device
(the plain loop for CPU tensors) and the launch counts live in
``ops.py``.
"""
from __future__ import annotations

import ctypes
import time

import torch

from ..optim.api import tree_leaves, tree_map
from . import build

MIN_CUDA = 12030            # conditional nodes: CUDA 12.3, runtime and driver

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.library("device_while")
        lib.dw_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.dw_versions.restype = ctypes.c_int
        lib.dw_create.argtypes = [ctypes.c_uint,
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_ulonglong)]
        lib.dw_create.restype = ctypes.c_int
        lib.dw_condition.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_void_p]
        lib.dw_condition.restype = ctypes.c_int
        lib.dw_finish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dw_finish.restype = ctypes.c_int
        lib.dw_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dw_launch.restype = ctypes.c_int
        lib.dw_destroy.argtypes = [ctypes.c_void_p]
        lib.dw_destroy.restype = ctypes.c_int
        lib.dw_error_string.argtypes = [ctypes.c_int]
        lib.dw_error_string.restype = ctypes.c_char_p
        _check_versions(lib)
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"device_while {what} failed: "
                           f"{lib.dw_error_string(rc).decode()} ({rc})")


def _check_versions(lib) -> None:
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.dw_versions(ctypes.byref(runtime), ctypes.byref(driver)),
           "version query")
    if min(runtime.value, driver.value) < MIN_CUDA:
        raise RuntimeError(
            f"the race's WHILE graph needs CUDA conditional nodes (12.3 or "
            f"later in the runtime and the driver); found runtime "
            f"{runtime.value}, driver {driver.value}")


def _static(carry, keep=()):
    """``carry`` with every tensor leaf owning its memory: a leaf sharing
    storage with an earlier one, or with a tensor of ``keep`` (the
    stage's starting carries and data, which a step's output may view:
    L-BFGS keeps the previous point as a view of it), is cloned, so the
    ``copy_`` of a new leaf overwrites nothing but its own static
    input."""
    seen = {x.untyped_storage().data_ptr() for x in keep}

    def own(x):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"a captured race carries tensors only, got "
                            f"{type(x).__name__}")
        key = x.untyped_storage().data_ptr()
        if key in seen:
            return x.clone()
        seen.add(key)
        return x
    return tree_map(own, carry)


def _write_back(static, new) -> None:
    """``static`` <- ``new``, leaf by leaf, in place.  A new leaf that
    views a static leaf's memory (L-BFGS's previous point is a view of its
    input) is copied out first, so it is read before any leaf is
    written."""
    owned = {x.untyped_storage().data_ptr() for x in tree_leaves(static)}
    new = tree_map(lambda x: x.clone()
                   if x.untyped_storage().data_ptr() in owned else x, new)
    with torch.no_grad():
        tree_map(lambda a, b: a.copy_(b), static, new)


class WhileLoop:
    """One launched race loop.  ``carry`` is the static carry the loop
    writes every step: after the launch has run, the carry of the last
    step.  ``close`` frees the graphs once the caller has synchronized
    with the launch (its pull does)."""
    replayable = True

    def __init__(self, step, carry, hist, s, done, max_iters: int,
                 keep=()):
        lib = _library()
        dev = hist.device
        loop, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
        t0 = time.perf_counter()
        _check(lib, lib.dw_create(1, ctypes.byref(loop), ctypes.byref(handle)),
               "graph creation")
        self._lib, self._loop = lib, loop
        self.carry = _static(carry, keep)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            _write_back(self.carry, step(list(self.carry)))
            _check(lib, lib.dw_condition(
                hist[0].data_ptr(), hist[1].data_ptr(), s.data_ptr(),
                done.data_ptr(), max_iters, handle.value,
                torch.cuda.current_stream(dev).cuda_stream),
                "condition launch")
        _check(lib, lib.dw_finish(loop, self.graph.raw_cuda_graph()),
               "WHILE node")
        self.capture_s = time.perf_counter() - t0
        self._stream = torch.cuda.current_stream(dev)
        self.launch()

    def relaunch(self, carry) -> None:
        """Write ``carry`` (shaped as the static carry) into the static
        carry and launch the loop from it."""
        _write_back(self.carry, carry)
        self.launch()

    def launch(self) -> None:
        """Launch the loop on the stream current at its capture: it runs
        from whatever the static carry, the histories, ``s`` and the flag
        hold then."""
        _check(self._lib, self._lib.dw_launch(self._loop,
                                              self._stream.cuda_stream),
               "launch")

    def close(self) -> None:
        if self._loop is not None:
            rc = self._lib.dw_destroy(self._loop)
            self._loop = None
            self.graph.reset()
            _check(self._lib, rc, "destroy")
