"""The multi-device path on torch.distributed (reference:
sedumi_tpu/parallel): the mesh and the cone-block formation split
(mesh.py), the Schur-panel factor and solves with kernels K14/K15
(panels.py), the SPMD launcher (launch.py) and the entry points its ranks
run (entry.py)."""

from .mesh import make_mesh, replicate, shard_aop, shard_state

__all__ = ["make_mesh", "shard_aop", "shard_state", "replicate"]
