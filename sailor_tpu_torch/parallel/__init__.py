"""Multi-device rendering over screen-row shards (counterpart of
sailor_tpu/parallel)."""

from sailor_tpu_torch.parallel.mesh import (
    Comm,
    Mesh,
    make_mesh,
    sharded_forward_frame,
    sharded_path_trace,
)

__all__ = ["Comm", "Mesh", "make_mesh", "sharded_forward_frame", "sharded_path_trace"]
