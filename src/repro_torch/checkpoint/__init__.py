from .ckpt import (CheckpointManager, load_checkpoint, load_state,
                   save_checkpoint, save_state)
