from split_learning_tpu_torch.core.losses import (
    accuracy, cross_entropy, per_example_cross_entropy)
from split_learning_tpu_torch.core.stage import (
    Params, SplitPlan, Stage, flax_like_init, stage_backward)

__all__ = ["Params", "SplitPlan", "Stage", "accuracy", "cross_entropy",
           "flax_like_init", "per_example_cross_entropy", "stage_backward"]
