from coarse3d_tpu_torch.parallel.mesh import (
    Mesh,
    destroy_mesh,
    make_mesh,
    replicate_to_mesh,
    shard_batch,
)

__all__ = ["Mesh", "destroy_mesh", "make_mesh", "replicate_to_mesh",
           "shard_batch"]
