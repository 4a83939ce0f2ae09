"""mfu.convex: the window's solves' model FLOPs (Newton-CG's work from
its shapes, ``bounds.newton_cg_step_flops``) over the window's time, as
a share of the card's float32 peak (the program runs float32 products at
full precision)."""
from perfbench.yardstick.peaks import PEAK_FLOPS


def read(rec: dict):
    if not rec.get("model_flops") or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] \
        / PEAK_FLOPS[rec["peak_flops"]]
