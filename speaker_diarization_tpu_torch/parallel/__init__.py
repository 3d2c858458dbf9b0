"""Data and tensor parallelism over torch.distributed, and ring attention."""

from .mesh import Mesh, init_distributed, make_mesh, replicate, shard_batch  # noqa: F401
