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
