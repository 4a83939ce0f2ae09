# Stage-boundary checkpoints of a single-host run: the window cursor, the
# clock, the data plane's meters and the trace, so a resumed run continues
# bit for bit.  The elastic runtime and fault plans need the distributed
# runtime and come with it (ROADMAP queue A8).
from .checkpoint import (RestoredRun, StageCheckpointer, dataset_state,
                         load_stage_checkpoint, peek_stage_meta,
                         restore_dataset)
