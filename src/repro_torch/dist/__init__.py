# The multi-host BET runtime: host topology, shard ownership, collectives,
# and the distributed engine and data plane — the paper's distributed claim
# (§3.3, Fig. 5): workers keep resident data and stream only their share of
# each expansion.  N simulated hosts share one process (and one card), or
# one torch.distributed process drives each host.
from .topology import HostTopology, ProcessTopology, SimulatedTopology
from .ownership import (ElasticOwnership, OwnedShardStore, OwnershipAlgebra,
                        ShardOwnership)
from .collectives import (Collectives, DistributedObjective,
                          ProcessCollectives, StackedCollectives,
                          l2_regularizer, masked_partial_sum, probe_rows,
                          rotation_batch)
from .runtime import DistributedBetEngine, DistributedDataset
