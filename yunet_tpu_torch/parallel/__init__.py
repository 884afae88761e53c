"""Data parallelism over processes, one card a rank (the counterpart of
``yunet_tpu/parallel/``)."""

from .mesh import (Mesh, initialize_distributed, local_device, make_mesh,
                   shard_batch)

__all__ = ["Mesh", "initialize_distributed", "local_device", "make_mesh",
           "shard_batch"]
