"""Parallelism (port of ``parallel/``): data-parallel serving replicas over
devices and the 2-D ``data x model`` grid (``mesh``), multi-process training
(``distributed``), the tensor-parallel flow (``tp``) and the width-sharded
decoder (``spatial``)."""

from .mesh import data_parallel_sharding, make_2d_mesh, make_mesh, replicate, shard_batch

__all__ = [
    "make_mesh",
    "make_2d_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_sharding",
]
