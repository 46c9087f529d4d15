from split_learning_tpu_torch.runtime.client import (
    FailurePolicy, SplitClientTrainer, StepRecord)
from split_learning_tpu_torch.runtime.evaluate import (
    evaluate, split_client_stages)
from split_learning_tpu_torch.runtime.fused import (
    FusedSplitTrainer, check_supported)
from split_learning_tpu_torch.runtime.generate import (
    generate_remote, greedy_generate, sample_generate)
from split_learning_tpu_torch.runtime.party import ProtocolError
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.runtime.server import ServerRuntime
from split_learning_tpu_torch.runtime.state import (
    SGD, TrainState, check_config, init_params, leaves_of, make_lr,
    make_state, make_tx, sgd)

__all__ = ["FailurePolicy", "FusedSplitTrainer", "ProtocolError",
           "ReplayCache", "SGD", "ServerRuntime", "SplitClientTrainer",
           "StepRecord", "TrainState", "check_config", "check_supported",
           "evaluate", "generate_remote", "greedy_generate", "init_params",
           "leaves_of", "make_lr", "make_state", "make_tx",
           "sample_generate", "sgd", "split_client_stages"]
