"""Meshes of `torch.distributed` ranks: the port's counterpart of
`reviews4rec_tpu/parallel/` (process groups, the data and model axes,
row-sharded tables, the sequence-sharded TextCNN)."""

from .mesh import (Mesh, host_slice, make_mesh, mesh_from_hp, param_spec,
                   shard_cache, shard_model)

__all__ = ["Mesh", "host_slice", "make_mesh", "mesh_from_hp", "param_spec",
           "shard_cache", "shard_model"]
