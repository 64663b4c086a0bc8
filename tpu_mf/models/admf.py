"""Adaptive-regularization MF state (Rendle's method).

Equivalent of the reference's ``AdaptRegMF`` (reference:
src/model.h:74-118, src/model.cc:355-415, src/admf.h). Four scalar
regularizers lam_u / lam_v / lam_bu / lam_bv are learned online by
hypergradient steps against a validation sample; full shadow copies of the
factor tables hold pre-update ("old") row values, mirroring the reference's
theta_old_/phi_old_/bias_old_ arrays (init1, model.cc:355-383). The
cache-line padding the reference needs around the racy lam_* scalars
(model.h:110-117) is unnecessary here — updates are synchronous.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_mf.models.mf import MFParams, init_mf


class AdaptRegState(NamedTuple):
    params: MFParams
    theta_old: jax.Array  # (nu, dim) shadow of pre-update rows
    phi_old: jax.Array    # (nv, dim)
    bu_old: jax.Array     # (nu,)
    bv_old: jax.Array     # (nv,)
    lam_u: jax.Array      # () learned regularizers
    lam_v: jax.Array
    lam_bu: jax.Array
    lam_bv: jax.Array


def init_admf(
    key: jax.Array,
    nu: int,
    nv: int,
    dim: int,
    lam: float,
    gb: float = 2.76,
    scale: float = 1e-2,
    dtype=jnp.float32,
) -> AdaptRegState:
    """Init base MF tables + shadow copies; all four lambdas start at --lambda
    (reference: ctor model.h:81-83, init1 model.cc:355-383)."""
    params = init_mf(key, nu, nv, dim, gb=gb, scale=scale, dtype=dtype)
    # Distinct buffers: the epoch step donates its input state, and aliased
    # leaves (theta / theta_old sharing one array) would be donated twice.
    return AdaptRegState(
        params=params,
        theta_old=jnp.copy(params.theta),
        phi_old=jnp.copy(params.phi),
        bu_old=jnp.copy(params.bu),
        bv_old=jnp.copy(params.bv),
        lam_u=jnp.float32(lam),
        lam_v=jnp.float32(lam),
        lam_bu=jnp.float32(lam),
        lam_bv=jnp.float32(lam),
    )
