"""Data-parallel training across processes (torch.distributed)."""

from phoonnx_tpu_torch.parallel import multihost  # noqa: F401
from phoonnx_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_mean,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
    shard_train_state,
)
