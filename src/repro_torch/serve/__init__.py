# Serve-while-you-train — the port of ``repro.serve``: the seed decode path
# serving live traffic while a BET run trains on the log of that traffic.
#
#   * ingest.py — OnlineShardStore, the append-only request log behind the
#     streaming data plane (corpus capacity discovered at runtime),
#   * policy.py — TrafficDriven, the arrival-keyed expansion policy
#     (expand when enough new examples landed; otherwise hold the stage),
#   * swap.py  — BetServer + CheckpointWatcher, hot stage-checkpoint
#     adoption without dropping in-flight decode requests,
#   * loop.py  — the closed-loop harness (traffic -> serve -> log ->
#     ingest -> expand -> swap) behind RunSpec.serve.
#
# loop.py composes the whole api stack and is loaded lazily so the
# registries (api/registry.py registers TrafficDriven by importing
# serve.policy) never import it back — no cycle.
from .ingest import OnlineShardStore
from .policy import TrafficDriven
from .swap import BetServer, CheckpointWatcher, InflightBatch

__all__ = ["OnlineShardStore", "TrafficDriven", "BetServer",
           "CheckpointWatcher", "InflightBatch", "ServeTrainLoop",
           "TrafficGenerator", "build_loop"]


def __getattr__(name):
    if name in ("ServeTrainLoop", "TrafficGenerator", "build_loop"):
        from . import loop
        return getattr(loop, name)
    raise AttributeError(name)
