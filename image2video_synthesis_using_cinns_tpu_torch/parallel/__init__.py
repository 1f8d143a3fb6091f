"""Data parallelism (port of ``parallel/``): serving replicas over devices
(``mesh``) and multi-process training (``distributed``). Tensor parallelism
(``tp.py``) and the width-sharded decoder (``spatial.py``) are not ported."""

from .mesh import data_parallel_sharding, make_mesh, replicate, shard_batch

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_sharding",
]
