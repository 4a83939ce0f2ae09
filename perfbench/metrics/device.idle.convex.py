"""device.idle.convex: the share of the traced solves' span in which no
kernel, copy or set ran on the card (torch.profiler's device intervals,
merged)."""
from perfbench.yardstick.shares import idle_percent


def read(rec: dict):
    return idle_percent(rec)
