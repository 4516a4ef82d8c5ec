"""Multi-process training over torch.distributed (counterpart of
hairgs_tpu/parallel/): the (data, gauss) mesh and view-parallel steps
(mesh.py), depth-slab sharding of the Gaussian axis (slab.py), and camera
ownership and sharded checkpoints (multihost.py)."""

from hairgs_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_gaussian_step,
    replicate,
    shard_view_batch,
)
