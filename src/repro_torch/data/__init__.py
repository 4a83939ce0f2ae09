from .synthetic import Dataset, load, make_classification, PAPER_LIKE
from .window import ExpandingWindow, synth_corpus
from .shards import (DataAccessMeter, InMemoryShardStore, MemmapShardStore,
                     ShardLoadError, ShardStore, ThrottledStore,
                     store_capacity)
from .prefetch import Prefetcher
from .device_window import (DeviceWindow, HostWindows, MaskedWindow,
                            StackedDeviceWindow, WindowLane, as_host_windows,
                            probe_rows, rolling_subwindow, rotation_rows,
                            window_rows)
from .plane import StreamingDataset

_TIERS = ("HostRing", "RingTierManager", "TieredCorpus", "TierMeter")


def __getattr__(name: str):
    """The tiered corpus's names, as the reference's package exports them,
    imported on first use: ``data.tiers`` reaches the stage checkpoints,
    which import this package's plane."""
    if name in _TIERS:
        from . import tiers
        return getattr(tiers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
