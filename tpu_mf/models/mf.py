"""Core biased-MF model state and evaluation.

Equivalent of the reference's ``MF`` class (reference: src/model.h:6-30,
src/model.cc:10-73): factor tables theta (nu, dim) and phi (nv, dim), bias
vectors bu/bv, and a scalar global bias gb, held as a JAX pytree instead of
cache-line-aligned malloc'd row arrays. Gaussian(0, 1e-2) init matches
reference model.cc:22-33.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MFParams(NamedTuple):
    """Biased-MF parameters as a pytree.

    theta: (nu, dim) user factors; phi: (nv, dim) item factors;
    bu: (nu,) user biases; bv: (nv,) item biases; gb: () global bias.
    """

    theta: jax.Array
    phi: jax.Array
    bu: jax.Array
    bv: jax.Array
    gb: jax.Array


def init_mf(
    key: jax.Array,
    nu: int,
    nv: int,
    dim: int,
    gb: float = 2.76,
    scale: float = 1e-2,
    dtype=jnp.float32,
) -> MFParams:
    """Gaussian(0, scale) init of all tables (reference: model.cc:22-33)."""
    kt, kp, kbu, kbv = jax.random.split(key, 4)
    return MFParams(
        theta=(jax.random.normal(kt, (nu, dim), jnp.float32) * scale).astype(dtype),
        phi=(jax.random.normal(kp, (nv, dim), jnp.float32) * scale).astype(dtype),
        bu=(jax.random.normal(kbu, (nu,), jnp.float32) * scale).astype(dtype),
        bv=(jax.random.normal(kbv, (nv,), jnp.float32) * scale).astype(dtype),
        gb=jnp.asarray(gb, dtype),
    )


def predict(params: MFParams, u: jax.Array, v: jax.Array, loss: int = 0) -> jax.Array:
    """Score a batch of (user, item) pairs.

    pred = theta_u . phi_v + bu_u + bv_v + gb, optionally through a sigmoid for
    the logistic loss (reference: util.h:90-95; call sites model.cc:62,
    model.h:87). The reference never exposed this as an API ("inference /
    serving: there is none", SURVEY §3.5); here it is first-class.
    """
    t = params.theta[u]
    p = params.phi[v]
    raw = (
        jnp.sum(t * p, axis=-1, dtype=jnp.float32)
        + params.bu[u].astype(jnp.float32)
        + params.bv[v].astype(jnp.float32)
        + params.gb.astype(jnp.float32)
    )
    if loss == 1:
        return jax.nn.sigmoid(raw)
    return raw


@jax.jit
def _sq_err_sum(params: MFParams, u, v, r, w) -> jax.Array:
    e = (r - predict(params, u, v)) * w
    return jnp.sum(e * e, dtype=jnp.float32)


def calc_mse(params: MFParams, u, v, r, chunk: int = 1 << 20) -> float:
    """Sum of squared errors / n over a rating set, chunked to bound memory.

    Mirrors ``MF::calc_mse`` (reference: src/model.cc:41-73) which returns the
    *sum* and reports counts separately; here we return the mean directly.
    """
    n = int(np.asarray(u).shape[0])
    if n == 0:
        return 0.0
    total = 0.0
    for s in range(0, n, chunk):
        cu = jnp.asarray(u[s : s + chunk])
        cv = jnp.asarray(v[s : s + chunk])
        cr = jnp.asarray(r[s : s + chunk])
        cw = jnp.ones_like(cr)
        total += float(_sq_err_sum(params, cu, cv, cr, cw))
    return total / n


def rmse(params: MFParams, ds, chunk: int = 1 << 20) -> float:
    """Test RMSE as printed per-epoch by the reference (reference: mf.h:35)."""
    return float(np.sqrt(calc_mse(params, ds.u, ds.v, ds.r, chunk)))
