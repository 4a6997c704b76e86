from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.loop import (StageTimer, TrainState,
                                      make_train_step, run_training)
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm

__all__ = ["AdamW", "AdamWState", "global_norm", "CheckpointManager",
           "StageTimer", "TrainState", "make_train_step",
           "run_training"]
