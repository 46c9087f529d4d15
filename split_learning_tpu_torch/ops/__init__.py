from split_learning_tpu_torch.ops.common import LAUNCHES, NEG_BIG, load_kernels
from split_learning_tpu_torch.ops.cross_entropy import (
    CrossEntropyFunction, fused_cross_entropy)
# the function flash_attention stays in its module: exporting it here would
# shadow the submodule of the same name
from split_learning_tpu_torch.ops.flash_attention import (
    flash_attention_with_lse)
from split_learning_tpu_torch.ops.ring_attention import full_attention
from split_learning_tpu_torch.ops.sgd import fused_sgd_step, init_trace

__all__ = ["CrossEntropyFunction", "LAUNCHES", "NEG_BIG",
           "flash_attention_with_lse", "full_attention",
           "fused_cross_entropy", "fused_sgd_step", "init_trace",
           "load_kernels"]
