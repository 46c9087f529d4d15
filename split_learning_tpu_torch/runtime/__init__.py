from split_learning_tpu_torch.runtime.admission import AdmissionController
from split_learning_tpu_torch.runtime.breaker import CircuitBreaker
from split_learning_tpu_torch.runtime.client import (
    FailurePolicy, FederatedClientTrainer, SplitClientTrainer, StepRecord,
    USplitClientTrainer)
from split_learning_tpu_torch.runtime.coalesce import (
    ContinuousBatcher, RequestCoalescer)
from split_learning_tpu_torch.runtime.evaluate import (
    evaluate, evaluate_remote, split_client_stages)
from split_learning_tpu_torch.runtime.fused import (
    FusedSplitTrainer, check_supported)
from split_learning_tpu_torch.runtime.generate import (
    generate_remote, greedy_generate, sample_generate)
from split_learning_tpu_torch.runtime.multi_client import (
    MultiClientSplitRunner)
from split_learning_tpu_torch.runtime.party import ProtocolError
from split_learning_tpu_torch.runtime.pipeline_runner import (
    SCHEDULES, PipelineRunner, bubble_fraction, onefb_warmup,
    pipeline_ticks)
from split_learning_tpu_torch.runtime.pipelined_client import (
    PipelinedSplitClientTrainer)
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.runtime.replica import (
    ReplicaGroup, maybe_replicate, rendezvous_pick)
from split_learning_tpu_torch.runtime.server import (
    FedAvgAggregator, ServerRuntime)
from split_learning_tpu_torch.runtime.stage import (
    MB_STRIDE, StageRuntime, hop_seq)
from split_learning_tpu_torch.runtime.checkpoint import (
    Checkpointer, ForeignCheckpointError, read_latest_extras, write_extras)
from split_learning_tpu_torch.runtime.state import (
    SGD, TrainState, check_config, compressed_sync_contribution,
    fedavg_mean, init_params, leaves_of, make_lr, make_state, make_tx,
    restore_state, sgd, state_tree)

__all__ = ["AdmissionController", "Checkpointer", "CircuitBreaker",
           "ContinuousBatcher", "FailurePolicy",
           "FedAvgAggregator", "ForeignCheckpointError",
           "FederatedClientTrainer", "FusedSplitTrainer", "MB_STRIDE",
           "MultiClientSplitRunner", "PipelineRunner",
           "PipelinedSplitClientTrainer",
           "ProtocolError", "ReplayCache", "ReplicaGroup",
           "RequestCoalescer", "SCHEDULES",
           "SGD", "ServerRuntime", "SplitClientTrainer", "StageRuntime",
           "StepRecord", "TrainState", "USplitClientTrainer",
           "bubble_fraction", "check_config", "check_supported",
           "compressed_sync_contribution", "evaluate", "evaluate_remote",
           "fedavg_mean", "generate_remote", "greedy_generate", "hop_seq",
           "init_params", "leaves_of", "make_lr", "make_state", "make_tx",
           "maybe_replicate", "rendezvous_pick",
           "onefb_warmup", "pipeline_ticks", "read_latest_extras",
           "restore_state", "sample_generate", "sgd",
           "split_client_stages", "state_tree", "write_extras"]
