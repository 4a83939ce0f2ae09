"""linear_grad_roofline: B1's share of its roofline over the traced
solves.  Each launch's bound is ``bounds_ms`` at the rows of the window
it ran on (a scan step's stage window), over the device time of the
``lvg_kernel`` events, matched in launch order within each traced solve
(a solve whose events the trace does not hold whole is left out).  The
bound reads HBM's rate: a window small enough to be read from the 50 MB
L2 would read above 100 %, and needs a bound of its own."""
from perfbench.yardstick import bounds, shares


def read(rec: dict):
    solves = rec.get("b1_launches")
    if not solves:
        return None
    d = rec["d"]
    return shares.roofline_by_marker(
        rec, "solve", "lvg_kernel",
        [[bounds.bounds_ms(n, d)["bound_ms"] for n in s] for s in solves],
        "linear_grad")
