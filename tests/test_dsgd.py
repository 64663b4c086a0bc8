"""Multi-chip diagonal-block DSGD tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_mf.data.blocker import partition_diagonal
from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.models.mf import MFParams, rmse
from tpu_mf.ops.sgd import sgd_batch_update
from tpu_mf.parallel.dsgd import (
    dsgd_epoch,
    gather_params,
    init_sharded_mf,
    put_blocks,
)
from tpu_mf.parallel.mesh import make_mesh


def test_blocker_places_every_rating_once():
    ds = synthetic_ratings(101, 53, 4000, seed=0)  # non-divisible sizes
    P = 4
    blocks = partition_diagonal(ds, P, batch_size=64, seed=1)
    assert int(blocks.w.sum()) == len(ds)
    # reconstruct global ids and check the multiset of ratings survives
    got = []
    for p in range(P):
        for s in range(P):
            j = (p + s) % P
            w = blocks.w[p, s].ravel() > 0
            gu = blocks.u_local[p, s].ravel()[w] + p * blocks.chunk_u
            gv = blocks.v_local[p, s].ravel()[w] + j * blocks.chunk_v
            gr = blocks.r[p, s].ravel()[w]
            # shard membership is exactly (p, j)
            assert (gu // blocks.chunk_u == p).all()
            assert (gv // blocks.chunk_v == j).all()
            got.append(np.stack([gu, gv, gr]))
    got = np.concatenate(got, axis=1)
    key_got = np.lexsort((got[2], got[1], got[0]))
    key_ds = np.lexsort((ds.r, ds.v, ds.u))
    np.testing.assert_array_equal(got[0][key_got], ds.u[key_ds])
    np.testing.assert_array_equal(got[1][key_got], ds.v[key_ds])
    np.testing.assert_allclose(got[2][key_got], ds.r[key_ds], rtol=1e-6)


def test_dsgd_single_device_matches_serial_kernel():
    """P=1 mesh epoch == scanning the batched kernel over the same batches."""
    ds = synthetic_ratings(40, 30, 800, seed=2)
    mesh = make_mesh(1)
    blocks = partition_diagonal(ds, 1, batch_size=128, seed=3)
    state = init_sharded_mf(jax.random.PRNGKey(0), mesh, ds.nu, ds.nv, 8, gb=3.0)

    ref = MFParams(
        theta=jnp.asarray(np.asarray(state.theta)),
        phi=jnp.asarray(np.asarray(state.phi)),
        bu=jnp.asarray(np.asarray(state.bu)),
        bv=jnp.asarray(np.asarray(state.bv)),
        gb=jnp.float32(3.0),
    )
    eta, lam = 0.05, 0.01
    out = dsgd_epoch(mesh, state, put_blocks(mesh, blocks), eta, lam)

    for i in range(blocks.u_local.shape[2]):
        batch = (
            jnp.asarray(blocks.u_local[0, 0, i]),
            jnp.asarray(blocks.v_local[0, 0, i]),
            jnp.asarray(blocks.r[0, 0, i]),
            jnp.asarray(blocks.w[0, 0, i]),
        )
        ref = sgd_batch_update(ref, batch, jnp.float32(eta), jnp.float32(lam))

    np.testing.assert_allclose(
        np.asarray(out.theta), np.asarray(ref.theta), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(out.phi), np.asarray(ref.phi), atol=1e-5)


def test_dsgd_8dev_deterministic_and_converges():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    ds = synthetic_ratings(256, 128, 20000, rank=4, noise=0.1, seed=4)
    train, test = ds.split(0.2, seed=5)
    mesh = make_mesh(8)
    blocks = put_blocks(mesh, partition_diagonal(train, 8, batch_size=256, seed=6))

    def run():
        state = init_sharded_mf(
            jax.random.PRNGKey(1), mesh, ds.nu, ds.nv, 8, gb=ds.mean_rating()
        )
        for it in range(1, 10):
            state = dsgd_epoch(mesh, state, blocks, 0.05 / it**0.3, 0.01)
        return state

    s1, s2 = run(), run()
    # determinism: same seed -> bitwise identical factors (SURVEY §5)
    np.testing.assert_array_equal(np.asarray(s1.theta), np.asarray(s2.theta))
    np.testing.assert_array_equal(np.asarray(s1.phi), np.asarray(s2.phi))

    params = gather_params(s1)
    final = rmse(params, test)
    assert final < 0.5, f"8-device DSGD failed to converge: {final}"


def _replay_diagonals(ds, blocks, params, P, eta, lam):
    """The diagonal schedule run one block at a time on whole tables:
    substep s updates block (p, (p+s) mod P) for every p, in order."""
    cu, cv = blocks.chunk_u, blocks.chunk_v
    ref = MFParams(
        theta=jnp.asarray(np.pad(params.theta, ((0, P * cu - ds.nu), (0, 0)))),
        phi=jnp.asarray(np.pad(params.phi, ((0, P * cv - ds.nv), (0, 0)))),
        bu=jnp.asarray(np.pad(params.bu, (0, P * cu - ds.nu))),
        bv=jnp.asarray(np.pad(params.bv, (0, P * cv - ds.nv))),
        gb=jnp.float32(params.gb),
    )
    for s in range(P):
        for p in range(P):
            j = (p + s) % P
            for i in range(blocks.u_local.shape[2]):
                w = blocks.w[p, s, i]
                batch = (
                    jnp.asarray(blocks.u_local[p, s, i] + p * cu),
                    jnp.asarray(blocks.v_local[p, s, i] + j * cv),
                    jnp.asarray(blocks.r[p, s, i]), jnp.asarray(w),
                )
                ref = sgd_batch_update(ref, batch, jnp.float32(eta),
                                       jnp.float32(lam))
    return ref


@pytest.mark.parametrize("dim", [4, 16])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_dsgd_epoch_matches_sequential_diagonal_replay(P, dim):
    """One mesh epoch on P CPU devices == replaying its diagonal blocks one
    by one on unsharded tables (non-divisible table sizes pad the tail)."""
    from tpu_mf.parallel.dsgd import shard_params

    ds = synthetic_ratings(37, 29, 1500, seed=P)
    mesh = make_mesh(P)
    blocks = partition_diagonal(ds, P, batch_size=64, seed=7)
    rng = np.random.default_rng(dim)
    params = MFParams(
        theta=rng.normal(0, 0.1, (ds.nu, dim)).astype(np.float32),
        phi=rng.normal(0, 0.1, (ds.nv, dim)).astype(np.float32),
        bu=rng.normal(0, 0.1, ds.nu).astype(np.float32),
        bv=rng.normal(0, 0.1, ds.nv).astype(np.float32),
        gb=np.float32(3.0),
    )
    eta, lam = 0.05, 0.01
    state = shard_params(mesh, jax.tree.map(jnp.asarray, params), 3.0)
    out = gather_params(
        dsgd_epoch(mesh, state, put_blocks(mesh, blocks), eta, lam))
    ref = _replay_diagonals(ds, blocks, params, P, eta, lam)
    np.testing.assert_allclose(np.asarray(out.theta),
                               np.asarray(ref.theta)[: ds.nu], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.phi),
                               np.asarray(ref.phi)[: ds.nv], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.bu),
                               np.asarray(ref.bu)[: ds.nu], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.bv),
                               np.asarray(ref.bv)[: ds.nv], atol=1e-6)
