# The elastic fault-tolerance subsystem: stage-boundary checkpoints
# capturing the full runtime state, lane handover and rebuild on host loss,
# tail reassignment for stragglers and joins, and deterministic failure
# injection — layered over dist/ + data/ + core/engine.py.  The recovery
# contract comes from §3.3: the window is a prefix of one fixed
# permutation, so (t, n_t) and the ownership map determine exactly what a
# replacement worker must re-read.
from .checkpoint import (RestoredRun, StageCheckpointer, dataset_state,
                         load_stage_checkpoint, peek_stage_meta,
                         restore_dataset)
from .faults import FaultEvent, FaultPlan
from .runtime import ElasticBetEngine, ElasticDataset
