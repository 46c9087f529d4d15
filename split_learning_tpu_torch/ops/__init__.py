from split_learning_tpu_torch.ops.common import LAUNCHES, load_kernels
from split_learning_tpu_torch.ops.cross_entropy import (
    CrossEntropyFunction, fused_cross_entropy)
from split_learning_tpu_torch.ops.sgd import fused_sgd_step, init_trace

__all__ = ["CrossEntropyFunction", "LAUNCHES", "fused_cross_entropy",
           "fused_sgd_step", "init_trace", "load_kernels"]
