from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.loop import (StageTimer, TrainState,
                                      make_train_step, run_training)
from repro_torch.training.optimizer import (AdamW, AdamWState,
                                            compress_int8,
                                            compressed_grad_tree,
                                            decompress_grad_tree,
                                            decompress_int8, global_norm)

__all__ = ["AdamW", "AdamWState", "global_norm", "compress_int8",
           "decompress_int8", "compressed_grad_tree",
           "decompress_grad_tree", "CheckpointManager",
           "StageTimer", "TrainState", "make_train_step",
           "run_training"]
