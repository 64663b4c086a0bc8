"""Batched synchronous SGD update for biased MF.

Batched replacement for the reference's Hogwild per-rating inner loop
(reference: src/mf.h:72-133). The per-rating math is identical:

    err       = eta * (r - theta_u . phi_v - bu_u - bv_v - gb)
    theta_u  <- (1 - eta*lambda) * theta_u + err * phi_v(old)
    phi_v    <- (1 - eta*lambda) * phi_v   + err * theta_u(old)
    bu_u     <- (1 - eta*lambda) * bu_u + err
    bv_v     <- (1 - eta*lambda) * bv_v + err

but instead of lock-free racing threads, a batch of B ratings is processed
synchronously: gather rows, compute all residuals against batch-start values,
apply the weight decay as one scatter-multiply of (1-eta*lambda)^k per row
touched k times (the exact geometric contraction k sequential updates apply),
and scatter-add the gradient terms err*phi / err*theta (duplicates accumulate
— the mini-batch analogue of the Hogwild races the reference tolerates by
design). At batch size 1 this reproduces the sequential update exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_mf.models.mf import MFParams
from tpu_mf.ops.common import decay_factors, occurrence_stats, pad_to_oob

Batch = Tuple[jax.Array, jax.Array, jax.Array, jax.Array]  # (u, v, r, w)


def sgd_batch_update(
    params: MFParams,
    batch: Batch,
    eta: jax.Array,
    lam: jax.Array,
) -> MFParams:
    """One synchronous SGD step over a batch of ratings (see module docstring)."""
    u, v, r, w = batch
    theta, phi, bu, bv, gb = params
    cdtype = jnp.float32
    nu = theta.shape[0]
    nv = phi.shape[0]

    t = theta[u].astype(cdtype)          # (B, D) gather
    p = phi[v].astype(cdtype)
    bu_g = bu[u].astype(cdtype)
    bv_g = bv[v].astype(cdtype)

    pred = jnp.sum(t * p, axis=-1) + bu_g + bv_g + gb.astype(cdtype)
    err = (eta * w) * (r - pred)          # (B,) — masked: padded slots are 0

    u_pad = pad_to_oob(u, w, nu)
    v_pad = pad_to_oob(v, w, nv)
    fu, ku = occurrence_stats(u_pad, nu)
    fv, kv = occurrence_stats(v_pad, nv)
    lameta = 1.0 - eta * lam              # per-occurrence factor (mf.h:79)
    fac_u = decay_factors(jnp.full_like(err, lameta), fu, ku)
    fac_v = decay_factors(jnp.full_like(err, lameta), fv, kv)

    theta = theta.at[u_pad].multiply(fac_u[:, None].astype(theta.dtype))
    phi = phi.at[v_pad].multiply(fac_v[:, None].astype(phi.dtype))
    bu = bu.at[u_pad].multiply(fac_u.astype(bu.dtype))
    bv = bv.at[v_pad].multiply(fac_v.astype(bv.dtype))

    return MFParams(
        theta=theta.at[u].add((err[:, None] * p).astype(theta.dtype)),
        phi=phi.at[v].add((err[:, None] * t).astype(phi.dtype)),
        bu=bu.at[u].add(err.astype(bu.dtype)),
        bv=bv.at[v].add(err.astype(bv.dtype)),
        gb=gb,
    )


@partial(jax.jit, donate_argnums=(0,))
def sgd_epoch(
    params: MFParams,
    batches: Batch,
    eta: jax.Array,
    lam: jax.Array,
) -> MFParams:
    """Scan the batched update over one epoch of (nb, B) rating batches.

    This is the jitted analogue of the reference's pipeline body: the TBB
    read/parse filters become host-side prefetch (tpu_mf.io.stream) and the
    epoch loop lives here as a ``lax.scan`` (reference epoch loop:
    src/mf.h:24-47 read-filter rewind logic).
    """

    def step(p, b):
        return sgd_batch_update(p, b, eta, lam), None

    params, _ = jax.lax.scan(step, params, batches)
    return params
