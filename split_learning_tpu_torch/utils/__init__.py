from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import (
    gpu_name_and_power_limit, resolve_device, set_numerics_policy)

__all__ = ["Config", "gpu_name_and_power_limit", "resolve_device",
           "set_numerics_policy"]
