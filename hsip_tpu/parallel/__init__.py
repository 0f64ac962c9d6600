"""Parallel runtime (L2): device meshes, sharded map phase, process-level
distribution with the MPI-era API.

Parity target: reference ``src/photron/parallel.py`` (MPIVideoProcessor),
rebuilt on JAX — shard_map + device collectives instead of mpi4py.
"""

from .mesh import frame_sharding, make_mesh, video_frame_mesh
from .processor import TPUVideoProcessor, initialize_distributed
from .sharding import make_sharded_profile_fn, sharded_centerline_profiles

__all__ = [
    "TPUVideoProcessor",
    "initialize_distributed",
    "make_mesh",
    "video_frame_mesh",
    "frame_sharding",
    "make_sharded_profile_fn",
    "sharded_centerline_profiles",
]
