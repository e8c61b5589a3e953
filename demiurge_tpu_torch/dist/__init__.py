"""Distribution over a (y, x) mesh of processes on ``torch.distributed``:
process groups and block layouts (``mesh``), halo exchanges and the
amortized solvers (``halo``), the two-level flow solve (``flowdist``), the
climate (``climate``) and the advect sampler (``advect``) on blocks.
Nothing here runs at import."""

from .mesh import (Mesh, choose_mesh_shape, gather_field, initialize,
                   local_part, make_mesh, shard_field, sharded_call)

__all__ = ["Mesh", "choose_mesh_shape", "gather_field", "initialize",
           "local_part", "make_mesh", "shard_field", "sharded_call"]
