"""Shard-parallel checkpoint lane slices, under the reference's names
(``repro.data.tiers.ckpt``).

The helpers live with the stage checkpoints that write them
(``repro_torch.elastic.checkpoint``): each lane's meter becomes its own
``<stem>_laneNN.json`` file, written by its own thread, and the sidecar
keeps only a pointer ``{"lane_files": [...]}``.  This module re-exports
them; it keeps no copy.
"""
from ...elastic.checkpoint import (LANE_POINTER_KEY, is_lane_pointer,
                                   load_lane_slices, unlink_lane_slices,
                                   write_lane_slices)

__all__ = ["LANE_POINTER_KEY", "is_lane_pointer", "load_lane_slices",
           "unlink_lane_slices", "write_lane_slices"]
