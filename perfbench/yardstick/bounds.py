"""Operations and bytes of the kernels and steps, counted from shapes.

``bounds_ms`` is a frozen copy of ``chip_smoke.py:496-507``: each input
byte read once, each output byte written once, whatever a kernel reads
again.  The step counts below (Newton-CG) are the algorithm's own
work from its shapes, with no recomputation; they never read a kernel's
launch plan, so a share reads the same work whatever implements it.
"""
from __future__ import annotations

from .peaks import HBM_BW, PEAK_FLOPS


def _bound(bytes_: float, flops: float, peak: float) -> dict:
    b_ms = bytes_ / HBM_BW * 1e3
    f_ms = flops / peak * 1e3
    return {"bound_ms": max(b_ms, f_ms), "bytes_bound_ms": b_ms,
            "flops_bound_ms": f_ms,
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


def bounds_ms(n: int, d: int) -> dict:
    """Least time for linear_value_grad's work (B1): read X, y, w once,
    write g and L once; 4nd float32 operations (2nd forward, 2nd
    transposed)."""
    return _bound(4 * (n * d + n + 2 * d + 1), 4 * n * d,
                  PEAK_FLOPS["float32"])


# ------------------------------------------------------------ convex solve
def newton_cg_step_flops(n: int, d: int, *, hessian_fraction: float,
                         cg_steps: int, ls_candidates: int) -> float:
    """One sub-sampled Newton-CG step on an n-row window: the fused value
    and gradient (4nd), the curvature weights on the k-row subsample
    (2kd), ``cg_steps`` Hessian-vector products (4kd each) and the
    batched Armijo search, which scores ``ls_candidates`` points in one
    product (2nd each).  Vector updates (O(d)) are left out."""
    k = max(1, round(hessian_fraction * n))
    return 4 * n * d + 2 * k * d + cg_steps * 4 * k * d \
        + ls_candidates * 2 * n * d
