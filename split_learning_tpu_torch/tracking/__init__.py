from split_learning_tpu_torch.tracking.logger import (
    JsonlLogger, MetricLogger, MlflowLogger, NoopLogger, StdoutLogger,
    default_run_name, experiment_name, make_logger)

__all__ = ["JsonlLogger", "MetricLogger", "MlflowLogger", "NoopLogger",
           "StdoutLogger", "default_run_name", "experiment_name",
           "make_logger"]
