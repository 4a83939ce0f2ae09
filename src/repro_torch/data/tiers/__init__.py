"""Tiered corpus subsystem: HBM-hot windows over host-RAM and disk tiers;
the port of ``repro.data.tiers``.

See :mod:`repro_torch.data.tiers.corpus` for the design overview.
"""
from .corpus import TieredCorpus
from .host import HostRing
from .manager import RingTierManager, TierMeter
from .ckpt import (is_lane_pointer, load_lane_slices,  # noqa: E402
                   unlink_lane_slices, write_lane_slices)

__all__ = ["TieredCorpus", "HostRing", "RingTierManager", "TierMeter",
           "write_lane_slices", "load_lane_slices", "unlink_lane_slices",
           "is_lane_pointer"]
