from split_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    PIPE_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
)
from split_learning_tpu_torch.parallel.distributed import (
    global_mesh,
    init_multi_host,
    is_coordinator,
)

__all__ = [
    "make_mesh", "batch_sharding", "replicated", "DATA_AXIS", "PIPE_AXIS",
    "global_mesh", "init_multi_host", "is_coordinator",
]
