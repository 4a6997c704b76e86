from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.loop import TrainState, make_train_step, run_training
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm

__all__ = ["AdamW", "AdamWState", "global_norm", "CheckpointManager",
           "TrainState", "make_train_step", "run_training"]
