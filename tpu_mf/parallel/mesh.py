"""Device mesh construction and sharding helpers.

The reference has no distributed backend (SURVEY §2: single-node TBB/OpenMP
only); this layer is designed fresh: a 1-D mesh over which the user axis of
theta/bu is sharded, with item shards rotating over the ring via ppermute
(neighbour exchange; on GPUs every card reaches every other over NVLink, so
the mesh needs no torus shape).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


AXIS = "shard"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (rows, ...) table over its row axis."""
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
