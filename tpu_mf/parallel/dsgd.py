"""Diagonal-block synchronous SGD over a device mesh (Jellyfish/DSGD).

Replaces the reference's Hogwild shared-memory parallelism (reference:
src/mf.h:72-133 races on theta/phi; SURVEY §2 "parallelism strategies") with
the synchronous scheme from SURVEY §7:

* theta/bu shard over the user axis: device p owns rows
  [p*chunk_u, (p+1)*chunk_u).
* phi/bv shard over the item axis and ROTATE: at substep s device p holds
  item shard (p+s) mod P.
* Substep s processes the P blocks of diagonal s — (p, (p+s) mod P) — which
  touch pairwise-disjoint user rows and item rows, so all devices run the
  batched SGD kernel on their local shards race-free, then the item shards
  hop one position around the ring (lax.ppermute; NCCL between GPUs).
* One epoch = P substeps; after the last hop the item shards are home, so
  the epoch output has canonical layout.

Deterministic by construction — same seed, same partition, same result —
which replaces the reference's tolerated data races with a reproducibility
guarantee (SURVEY §5 race-detection row).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tpu_mf.data.blocker import DiagonalBlocks, cdiv
from tpu_mf.models.mf import MFParams
from tpu_mf.ops.sgd import sgd_batch_update
from tpu_mf.parallel.mesh import AXIS, row_sharding


class ShardedMF(NamedTuple):
    """MF parameters laid out for the mesh: row-sharded, padded to P*chunk."""

    theta: jax.Array  # (P*chunk_u, dim) sharded over rows
    phi: jax.Array    # (P*chunk_v, dim) sharded over rows
    bu: jax.Array     # (P*chunk_u,)
    bv: jax.Array     # (P*chunk_v,)
    gb: jax.Array     # () replicated
    nu: int
    nv: int


def init_sharded_mf(
    key: jax.Array,
    mesh: Mesh,
    nu: int,
    nv: int,
    dim: int,
    gb: float = 2.76,
    scale: float = 1e-2,
    dtype=jnp.float32,
) -> ShardedMF:
    """Gaussian init directly into the sharded layout (no host round-trip)."""
    n_dev = mesh.devices.size
    pu = cdiv(nu, n_dev) * n_dev
    pv = cdiv(nv, n_dev) * n_dev
    shard = row_sharding(mesh)
    repl = NamedSharding(mesh, PartitionSpec())
    kt, kp, kbu, kbv = jax.random.split(key, 4)

    def mk(k, shape):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    theta = jax.jit(mk, static_argnums=(1,), out_shardings=shard)(kt, (pu, dim))
    phi = jax.jit(mk, static_argnums=(1,), out_shardings=shard)(kp, (pv, dim))
    bu = jax.jit(mk, static_argnums=(1,), out_shardings=shard)(kbu, (pu,))
    bv = jax.jit(mk, static_argnums=(1,), out_shardings=shard)(kbv, (pv,))
    return ShardedMF(
        theta=theta, phi=phi, bu=bu, bv=bv,
        gb=jax.device_put(jnp.asarray(gb, dtype), repl),
        nu=nu, nv=nv,
    )


@lru_cache(maxsize=None)
def _epoch_shardmap(mesh: Mesh, n_dev: int):
    """Build the shard_mapped epoch function for a P-device mesh."""
    spec_rows = PartitionSpec(AXIS)
    spec_blocks = PartitionSpec(AXIS)
    spec_repl = PartitionSpec()
    perm = [((i + 1) % n_dev, i) for i in range(n_dev)]  # shard p+1 -> p

    def epoch(theta, bu, phi, bv, gb, ul, vl, r, w, eta, lam):
        # Local views: theta (chunk_u, D), blocks (1, P, nb, B) -> (P, nb, B).
        ul, vl, r, w = ul[0], vl[0], r[0], w[0]

        def substep(carry, xs):
            theta, bu, phi, bv = carry
            params = MFParams(theta, phi, bu, bv, gb)

            def step(pp, batch):
                return sgd_batch_update(pp, batch, eta, lam), None

            params, _ = jax.lax.scan(step, params, xs)
            # Rotate item shards one hop around the ring.
            phi_next = jax.lax.ppermute(params.phi, AXIS, perm)
            bv_next = jax.lax.ppermute(params.bv, AXIS, perm)
            return (params.theta, params.bu, phi_next, bv_next), None

        (theta, bu, phi, bv), _ = jax.lax.scan(
            substep, (theta, bu, phi, bv), (ul, vl, r, w)
        )
        return theta, bu, phi, bv

    return jax.jit(
        jax.shard_map(
            epoch,
            mesh=mesh,
            in_specs=(
                spec_rows, spec_rows, spec_rows, spec_rows, spec_repl,
                spec_blocks, spec_blocks, spec_blocks, spec_blocks,
                spec_repl, spec_repl,
            ),
            out_specs=(spec_rows, spec_rows, spec_rows, spec_rows),
        ),
        donate_argnums=(0, 1, 2, 3),
    )


def dsgd_epoch(
    mesh: Mesh,
    state: ShardedMF,
    blocks_dev: Tuple[jax.Array, jax.Array, jax.Array, jax.Array],
    eta: float,
    lam: float,
) -> ShardedMF:
    """One full epoch: P diagonal substeps with ring rotation between them."""
    n_dev = mesh.devices.size
    fn = _epoch_shardmap(mesh, n_dev)
    theta, bu, phi, bv = fn(
        state.theta, state.bu, state.phi, state.bv, state.gb,
        *blocks_dev, jnp.float32(eta), jnp.float32(lam),
    )
    return state._replace(theta=theta, bu=bu, phi=phi, bv=bv)


def put_blocks(mesh: Mesh, blocks: DiagonalBlocks):
    """Device-put the (P, P, nb, B) block arrays sharded over the device axis.

    Under jax.distributed each process stages ONLY the user-shard slabs its
    local devices own (parallel/multihost.py — the leading axis IS the mesh
    position, so slab k of the stack goes to mesh position owned[k])."""
    shard = row_sharding(mesh)
    arrays = (blocks.u_local, blocks.v_local, blocks.r, blocks.w)
    if jax.process_count() > 1:
        from tpu_mf.parallel.multihost import local_user_shards, put_host_local

        owned = local_user_shards(mesh)
        return tuple(put_host_local(mesh, x[owned], owned) for x in arrays)
    return tuple(jax.device_put(x, shard) for x in arrays)


def shard_params(mesh: Mesh, params: MFParams, gb: float) -> ShardedMF:
    """Lay host-side (or single-device) MF params out for the mesh: rows
    zero-padded to a multiple of the device count, then row-sharded. Under
    jax.distributed each process stages only its own devices' row chunks
    (put_row_sharded; params are identical across processes — same seed)."""
    from tpu_mf.parallel.multihost import put_row_sharded

    n_dev = mesh.devices.size
    nu, nv = params.theta.shape[0], params.phi.shape[0]

    def pad(x, n):
        h = np.asarray(x)
        rows = cdiv(n, n_dev) * n_dev
        return put_row_sharded(
            mesh, np.pad(h, ((0, rows - n),) + ((0, 0),) * (h.ndim - 1)))

    return ShardedMF(
        theta=pad(params.theta, nu), phi=pad(params.phi, nv),
        bu=pad(params.bu, nu), bv=pad(params.bv, nv),
        gb=jnp.asarray(gb, params.theta.dtype),
        nu=nu, nv=nv,
    )


def gather_params(state: ShardedMF) -> MFParams:
    """Pull the sharded tables to host layout, trimming row padding.

    Multi-process arrays are replicated (all-gather) before the host read —
    a plain np.asarray would raise on non-fully-addressable arrays."""
    from tpu_mf.parallel.multihost import host_pull

    return MFParams(
        theta=jnp.asarray(host_pull(state.theta)[: state.nu]),
        phi=jnp.asarray(host_pull(state.phi)[: state.nv]),
        bu=jnp.asarray(host_pull(state.bu)[: state.nu]),
        bv=jnp.asarray(host_pull(state.bv)[: state.nv]),
        gb=jnp.asarray(state.gb, jnp.float32),
    )
