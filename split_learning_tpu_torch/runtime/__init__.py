from split_learning_tpu_torch.runtime.evaluate import (
    evaluate, split_client_stages)
from split_learning_tpu_torch.runtime.fused import (
    FusedSplitTrainer, check_supported)
from split_learning_tpu_torch.runtime.generate import (
    generate_remote, greedy_generate, sample_generate)
from split_learning_tpu_torch.runtime.state import (
    SGD, TrainState, leaves_of, make_lr, make_state, make_tx, sgd)

__all__ = ["FusedSplitTrainer", "SGD", "TrainState", "check_supported",
           "evaluate", "generate_remote", "greedy_generate", "leaves_of",
           "make_lr", "make_state", "make_tx", "sample_generate", "sgd",
           "split_client_stages"]
