from split_learning_tpu_torch.tracking.logger import (
    JsonlLogger, MetricLogger, NoopLogger, StdoutLogger, experiment_name,
    make_logger)

__all__ = ["JsonlLogger", "MetricLogger", "NoopLogger", "StdoutLogger",
           "experiment_name", "make_logger"]
