from flypylib_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
    replicated,
    batch_sharded,
)
from flypylib_tpu_torch.parallel.distributed import (
    ensure_initialized,
    local_batch_size,
)
from flypylib_tpu_torch.parallel.train import make_dp_train_step
from flypylib_tpu_torch.parallel.halo import (
    ShardedMap,
    sharded_infer,
    sharded_nms,
    sharded_components,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_3d",
    "replicated",
    "batch_sharded",
    "ensure_initialized",
    "local_batch_size",
    "make_dp_train_step",
    "ShardedMap",
    "sharded_infer",
    "sharded_nms",
    "sharded_components",
]
