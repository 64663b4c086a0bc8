"""Batched DP-SGLD update: Langevin noise + privacy-scaled gradient step.

Batched replacement for the reference's ``SgldFilter`` hot loop (reference:
src/dpmf.h:37-92). Per rating the reference does, under a per-item mutex:

1. lazy noise injection: add sqrt(temp*eta*c) * N(0,1) to theta_u / phi_v /
   bu_u / bv_v, where c = global updates since that row was last touched
   (tracked by atomic gcount + per-row counters, dpmf.h:61-70; noise drawn
   from a pregenerated table, model.cc:229-231);
2. gradient step with scale scal = eta * ntrain * bound * lambda_r and
   per-dimension, inverse-frequency-weighted decay:

       err      = scal * (r - theta_u . phi_v - bu_u - bv_v - gb)
       theta_u <- theta_u - eta*ur_u*bound * (lambda_u ∘ theta_u) + err * phi_v
       phi_v   <- phi_v   - eta*vr_v*bound * (lambda_v ∘ phi_v)   + err * theta_u(old)
       bu_u    <- (1 - eta*lambda_ub*ur_u*bound) * bu_u + err
       bv_v    <- (1 - eta*lambda_vb*vr_v*bound) * bv_v + err

Here a batch of B ratings advances the global counter by B; every row touched
in the batch receives ONE noise draw of variance temp*eta*(count since last
touch), which telescopes over an epoch to exactly the noise mass the lazy
per-rating scheme injects (SURVEY §7 design stance). Noise comes from the
threefry PRNG (jax.random) instead of a lookup table — fresh i.i.d. normals, which
is statistically stronger than the reference's recycled table.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tpu_mf.models.dpmf import DPMFState
from tpu_mf.models.mf import MFParams
from tpu_mf.ops.common import decay_factors, occurrence_stats, pad_to_oob

Batch = Tuple[jax.Array, jax.Array, jax.Array, jax.Array]


class SgldHyper(NamedTuple):
    """Per-round scalars for the SGLD step."""

    eta: jax.Array
    temp: jax.Array
    bound: jax.Array
    ntrain: jax.Array


def sgld_batch_update(
    state: DPMFState,
    batch: Batch,
    hyper: SgldHyper,
    key: jax.Array,
) -> DPMFState:
    u, v, r, w = batch
    theta, phi, bu, bv, gb = state.params
    nu = theta.shape[0]
    nv = phi.shape[0]
    dim = theta.shape[1]
    b = u.shape[0]
    eta, temp, bound, ntrain = hyper

    is_real = w > 0
    u_pad = pad_to_oob(u, w, nu)  # padded slots -> spare counter slot
    v_pad = pad_to_oob(v, w, nv)
    first_u, count_u = occurrence_stats(u_pad, nu)
    first_v, count_v = occurrence_stats(v_pad, nv)

    # --- lazy Langevin noise (reference: dpmf.h:61-70) ---
    # The global counter advances by the REAL ratings in the batch (padded
    # slots are not updates; reference counts per processed rating).
    gc_end = state.gcount + jnp.sum(w).astype(jnp.int32)
    cu = (gc_end - state.gcountu[u_pad]).astype(jnp.float32)
    cv = (gc_end - state.gcountv[v_pad]).astype(jnp.float32)
    su = jnp.sqrt(temp * eta * cu) * first_u  # (B,) noise std per slot
    sv = jnp.sqrt(temp * eta * cv) * first_v

    ku, kv, kbu, kbv = jax.random.split(key, 4)
    theta = theta.at[u].add(
        (su[:, None] * jax.random.normal(ku, (b, dim), jnp.float32)).astype(theta.dtype)
    )
    phi = phi.at[v].add(
        (sv[:, None] * jax.random.normal(kv, (b, dim), jnp.float32)).astype(phi.dtype)
    )
    bu = bu.at[u].add((su * jax.random.normal(kbu, (b,), jnp.float32)).astype(bu.dtype))
    bv = bv.at[v].add((sv * jax.random.normal(kbv, (b,), jnp.float32)).astype(bv.dtype))
    gcountu = state.gcountu.at[u_pad].set(gc_end)
    gcountv = state.gcountv.at[v_pad].set(gc_end)

    # --- privacy-scaled gradient step (reference: dpmf.h:72-88) ---
    t = theta[u].astype(jnp.float32)
    p = phi[v].astype(jnp.float32)
    bu_g = bu[u].astype(jnp.float32)
    bv_g = bv[v].astype(jnp.float32)

    scal = eta * ntrain * bound * state.lambda_r
    pred = jnp.sum(t * p, axis=-1) + bu_g + bv_g + gb.astype(jnp.float32)
    err = (scal * w) * (r - pred)

    # Decay applied as the geometric per-occurrence contraction (see
    # ops/common.py): base factors are per-dimension for the factor tables
    # (lambda_u / lambda_v vectors, dpmf.h:77-85) and scalar for the biases.
    ur_g = state.ur[u]
    vr_g = state.vr[v]
    base_t = 1.0 - (eta * bound * ur_g)[:, None] * state.lambda_u[None, :]
    base_p = 1.0 - (eta * bound * vr_g)[:, None] * state.lambda_v[None, :]
    base_bu = 1.0 - eta * state.lambda_ub * bound * ur_g
    base_bv = 1.0 - eta * state.lambda_vb * bound * vr_g
    fac_t = decay_factors(base_t, first_u, count_u)
    fac_p = decay_factors(base_p, first_v, count_v)
    fac_bu = decay_factors(base_bu, first_u, count_u)
    fac_bv = decay_factors(base_bv, first_v, count_v)

    theta = theta.at[u_pad].multiply(fac_t.astype(theta.dtype))
    phi = phi.at[v_pad].multiply(fac_p.astype(phi.dtype))
    bu = bu.at[u_pad].multiply(fac_bu.astype(bu.dtype))
    bv = bv.at[v_pad].multiply(fac_bv.astype(bv.dtype))

    params = MFParams(
        theta=theta.at[u].add((err[:, None] * p).astype(theta.dtype)),
        phi=phi.at[v].add((err[:, None] * t).astype(phi.dtype)),
        bu=bu.at[u].add(err.astype(bu.dtype)),
        bv=bv.at[v].add(err.astype(bv.dtype)),
        gb=gb,
    )
    return state._replace(
        params=params, gcountu=gcountu, gcountv=gcountv, gcount=gc_end
    )


@partial(jax.jit, donate_argnums=(0,))
def sgld_epoch(
    state: DPMFState,
    batches: Batch,
    hyper: SgldHyper,
    key: jax.Array,
) -> DPMFState:
    """Scan the SGLD update over one round of batches (one pass over data)."""
    nb = batches[0].shape[0]

    def step(s, x):
        i, batch = x
        return sgld_batch_update(s, batch, hyper, jax.random.fold_in(key, i)), None

    state, _ = jax.lax.scan(
        step, state, (jnp.arange(nb, dtype=jnp.int32), batches)
    )
    return state


@partial(jax.jit, donate_argnums=(0,))
def finish_noise(state: DPMFState, eta: jax.Array, temp: jax.Array, key: jax.Array) -> DPMFState:
    """Flush outstanding lazy noise for every row and reset counters.

    Reference: DPMF::finish_noise (model.cc:312-332) — called at the end of
    each round so all rows are current before evaluation and Gibbs sampling.
    """
    theta, phi, bu, bv, gb = state.params
    nu, dim = theta.shape
    nv = phi.shape[0]

    cu = (state.gcount - state.gcountu[:nu]).astype(jnp.float32)
    cv = (state.gcount - state.gcountv[:nv]).astype(jnp.float32)
    su = jnp.sqrt(temp * eta * jnp.maximum(cu, 0.0))
    sv = jnp.sqrt(temp * eta * jnp.maximum(cv, 0.0))

    ku, kv, kbu, kbv = jax.random.split(key, 4)
    params = MFParams(
        theta=theta + (su[:, None] * jax.random.normal(ku, (nu, dim), jnp.float32)).astype(theta.dtype),
        phi=phi + (sv[:, None] * jax.random.normal(kv, (nv, dim), jnp.float32)).astype(phi.dtype),
        bu=bu + (su * jax.random.normal(kbu, (nu,), jnp.float32)).astype(bu.dtype),
        bv=bv + (sv * jax.random.normal(kbv, (nv,), jnp.float32)).astype(bv.dtype),
        gb=gb,
    )
    return state._replace(
        params=params,
        gcountu=jnp.zeros_like(state.gcountu),
        gcountv=jnp.zeros_like(state.gcountv),
        gcount=jnp.zeros_like(state.gcount),
    )
