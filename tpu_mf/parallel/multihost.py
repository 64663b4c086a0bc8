"""Multi-host mesh support: jax.distributed init + host-local data staging.

The reference has no
distributed backend at all (single-process TBB/OpenMP — SURVEY §2), so the
semantics are ours to define:

* `init_distributed()` gates `jax.distributed.initialize` on the standard
  coordinator env vars (or explicit args) and is a no-op single-process, so
  every entry point can call it unconditionally.
* The diagonal-block schedule partitions by USER shard first
  (data/blocker.py: axis 0 of the block stack is the user shard), so each
  host only needs the blocks of the user shards its local devices own —
  `local_user_shards` names them.
* `put_host_local` builds a global row-sharded array from each host's local
  per-device stack via `jax.make_array_from_single_device_arrays`: the
  host-side block arrays never leave their host; ppermute moves item shards
  between devices and hosts (XLA inserts the right transport — the
  collective pattern is unchanged from single-host).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from tpu_mf.parallel.mesh import AXIS, row_sharding


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize jax.distributed when configured; return process count.

    Configuration comes from the arguments or the standard environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, the
    names jax.distributed.initialize itself reads). With neither, this is
    a no-op single-process run. Safe to call twice (the second call is
    ignored)."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return jax.process_count()
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return jax.process_count()


def local_user_shards(mesh: Mesh) -> list:
    """Indices p (user shards = mesh positions) owned by THIS process.

    The diagonal-block stack is indexed by user shard p; a host only
    stages the blocks for its own devices' positions."""
    me = jax.process_index()
    return [
        i for i, d in enumerate(mesh.devices.flat) if d.process_index == me
    ]


def put_host_local(
    mesh: Mesh, local_stack: np.ndarray, owned: Sequence[int]
):
    """Global row-sharded array from this host's per-device plan stack.

    ``local_stack`` has leading axis len(owned) — one slab per locally
    owned mesh position (in ``owned`` order). Each host calls this with
    ONLY its own slabs; the returned global jax.Array has shape
    (n_dev * slab, ...) sharded over the mesh axis, without any host ever
    materializing another host's data (the host boundary of SURVEY §2)."""
    devices = list(mesh.devices.flat)
    n_dev = len(devices)
    slab = local_stack.shape[1:]
    # P(AXIS) over axis 0 of (n_dev,)+slab: one slab row per mesh position,
    # so each local piece is a (1,)+slab slice on its own device
    arrs = [
        jax.device_put(local_stack[k : k + 1], devices[p])
        for k, p in enumerate(owned)
    ]
    return jax.make_array_from_single_device_arrays(
        (n_dev,) + slab, row_sharding(mesh), arrs
    )


def put_row_sharded(mesh: Mesh, x: np.ndarray):
    """Row-shard a host array over the mesh, staging only locally-owned rows.

    Single-process this is a plain ``jax.device_put``; under
    ``jax.distributed`` each process uploads ONLY the row chunks of its own
    devices (no host materializes or transfers another host's shard). Requires n_dev | x.shape[0], which every table/plan
    padder in this repo guarantees."""
    shard = row_sharding(mesh)
    if jax.process_count() <= 1:
        return jax.device_put(x, shard)
    devices = list(mesh.devices.flat)
    chunk, rem = divmod(x.shape[0], len(devices))
    assert rem == 0, (x.shape, len(devices))
    me = jax.process_index()
    arrs = [
        jax.device_put(x[i * chunk : (i + 1) * chunk], d)
        for i, d in enumerate(devices)
        if d.process_index == me
    ]
    return jax.make_array_from_single_device_arrays(x.shape, shard, arrs)


def host_pull(x) -> np.ndarray:
    """np.asarray that also works on multi-process (non-fully-addressable)
    arrays: replicate over the array's own mesh first (one all-gather),
    then read the local copy."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.sharding import NamedSharding, PartitionSpec

    rep = jax.jit(
        lambda a: a,
        out_shardings=NamedSharding(x.sharding.mesh, PartitionSpec()),
    )(x)
    return np.asarray(rep)


def assert_host_complete(mesh: Mesh) -> None:
    """Every mesh position must belong to some process (sanity check for
    hand-built meshes under jax.distributed)."""
    for d in mesh.devices.flat:
        assert d.process_index >= 0
