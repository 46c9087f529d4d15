from split_learning_tpu_torch.runtime.evaluate import evaluate
from split_learning_tpu_torch.runtime.fused import (
    FusedSplitTrainer, check_supported)
from split_learning_tpu_torch.runtime.state import (
    SGD, TrainState, leaves_of, make_lr, make_state, make_tx, sgd)

__all__ = ["FusedSplitTrainer", "SGD", "TrainState", "check_supported",
           "evaluate", "leaves_of", "make_lr", "make_state", "make_tx",
           "sgd"]
