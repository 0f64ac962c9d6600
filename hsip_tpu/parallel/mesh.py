"""Device mesh construction for sharded video processing.

The reference's parallelism is MPI data-parallelism over frames/videos
(``src/photron/parallel.py``). The JAX equivalent is a
``jax.sharding.Mesh`` over the local accelerators:

* ``frame`` axis — frames of one video sharded across devices (the map
  phase is embarrassingly parallel; halo exchange handles differencing
  priors at shard boundaries).
* ``video`` axis — whole videos distributed across device groups (the scan
  per video stays serial-identical).

Collectives ride ICI within a slice; multi-host runs add DCN via
``jax.distributed.initialize`` at process level.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "frame_sharding", "video_frame_mesh", "P"]

P = PartitionSpec


def make_mesh(
    axis_name: str = "frame",
    devices: Optional[Sequence] = None,
    n_devices: Optional[int] = None,
) -> Mesh:
    """1-D mesh over all (or the first ``n_devices``) local devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh needs {n_devices} devices, found {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def video_frame_mesh(
    n_video_groups: int,
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("video", "frame"),
) -> Mesh:
    """2-D mesh: ``n_video_groups`` video rows × frame columns.

    Videos are processed concurrently across rows; within a row, each
    video's frames shard across the columns.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % n_video_groups:
        raise ValueError(
            f"{n} devices not divisible into {n_video_groups} video groups"
        )
    grid = np.array(devices).reshape(n_video_groups, n // n_video_groups)
    return Mesh(grid, axis_names)


def frame_sharding(mesh: Mesh, axis_name: str = "frame") -> NamedSharding:
    """Sharding for an (N, H, W) frame batch: split the frame axis."""
    return NamedSharding(mesh, P(axis_name, None, None))
