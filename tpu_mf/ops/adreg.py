"""Batched adaptive-regularization SGD update.

Batched replacement for the reference's ``AdRegFilter`` hot loop
(reference: src/admf.h:52-86). Per rating the reference:

1. snapshots theta_u / phi_v / biases into shadow tables (admf.h:67-68,77-78);
2. takes an SGD step like the vanilla kernel but with four separately-learned
   regularizers lam_u, lam_v, lam_bu, lam_bv (admf.h:69-80);
3. after each *user*, draws one random validation record and takes a
   hypergradient step on the lambdas (admf.h:82-83; updateReg/updateUV/
   updateBias model.h:86-102):

       grad   = r_valid - pred_valid
       lam_u  <- max(0, lam_u - eta_reg*eta*grad*<theta_old_u, phi_v>)
       lam_v  <- max(0, lam_v - eta_reg*eta*grad*<theta_u, phi_old_v>)
       lam_bu <- max(0, lam_bu - eta_reg*eta*grad*bu_old_u)
       lam_bv <- max(0, lam_bv - eta_reg*eta*grad*bv_old_v)

Here a batch of B ratings covering U distinct users triggers one vectorized
hypergradient step: K validation records are sampled, per-sample
hypergradients averaged and scaled by U, so the expected total lambda motion
per epoch matches the reference's one-update-per-user cadence. The max(0, .)
clamp applies to the aggregated step instead of after each of the U
sequential micro-steps — the difference vanishes at the eta_reg*eta scale.

The logistic loss path uses pred = sigmoid(score) with grad = r - pred, which
is the exact gradient of the Bernoulli log-likelihood (reference: active
util.h:90-95; cal_grad util.h:96-101 implements the same r - pred).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tpu_mf.models.admf import AdaptRegState
from tpu_mf.models.mf import MFParams
from tpu_mf.ops.common import decay_factors, occurrence_stats, pad_to_oob

Batch = Tuple[jax.Array, jax.Array, jax.Array, jax.Array]


class AdRegHyper(NamedTuple):
    eta: jax.Array
    eta_reg: jax.Array
    loss: int  # static: 0 least squares, 1 logistic


def _activate(score: jax.Array, loss: int) -> jax.Array:
    return jax.nn.sigmoid(score) if loss == 1 else score


def adreg_batch_update(
    state: AdaptRegState,
    batch: Batch,
    valid: Tuple[jax.Array, jax.Array, jax.Array],
    hyper: AdRegHyper,
    key: jax.Array,
    n_reg_samples: int = 64,
) -> AdaptRegState:
    u, v, r, w = batch
    theta, phi, bu, bv, gb = state.params
    eta, eta_reg, loss = hyper.eta, hyper.eta_reg, hyper.loss

    # --- 1. snapshot touched rows into the shadow tables (admf.h:67-68);
    # padded slots are redirected out of bounds so their scatter drops
    # instead of overwriting row 0's snapshot ---
    nu_rows = theta.shape[0]
    nv_rows = phi.shape[0]
    u_pad = pad_to_oob(u, w, nu_rows)
    v_pad = pad_to_oob(v, w, nv_rows)
    t = theta[u].astype(jnp.float32)
    p = phi[v].astype(jnp.float32)
    bu_g = bu[u].astype(jnp.float32)
    bv_g = bv[v].astype(jnp.float32)
    theta_old = state.theta_old.at[u_pad].set(t.astype(theta.dtype))
    phi_old = state.phi_old.at[v_pad].set(p.astype(phi.dtype))
    bu_old = state.bu_old.at[u_pad].set(bu_g.astype(bu.dtype))
    bv_old = state.bv_old.at[v_pad].set(bv_g.astype(bv.dtype))

    # --- 2. SGD step with the four learned regularizers (admf.h:69-80);
    # decay via the geometric per-occurrence contraction (ops/common.py) ---
    score = jnp.sum(t * p, axis=-1) + bu_g + bv_g + gb.astype(jnp.float32)
    err = (eta * w) * (r - _activate(score, loss))

    fu, ku_cnt = occurrence_stats(u_pad, nu_rows)
    fv, kv_cnt = occurrence_stats(v_pad, nv_rows)
    fac_t = decay_factors(jnp.full_like(err, 1.0 - eta * state.lam_u), fu, ku_cnt)
    fac_p = decay_factors(jnp.full_like(err, 1.0 - eta * state.lam_v), fv, kv_cnt)
    fac_bu = decay_factors(jnp.full_like(err, 1.0 - eta * state.lam_bu), fu, ku_cnt)
    fac_bv = decay_factors(jnp.full_like(err, 1.0 - eta * state.lam_bv), fv, kv_cnt)

    theta2 = theta.at[u_pad].multiply(fac_t[:, None].astype(theta.dtype))
    phi2 = phi.at[v_pad].multiply(fac_p[:, None].astype(phi.dtype))
    bu2 = bu.at[u_pad].multiply(fac_bu.astype(bu.dtype))
    bv2 = bv.at[v_pad].multiply(fac_bv.astype(bv.dtype))
    params = MFParams(
        theta=theta2.at[u].add((err[:, None] * p).astype(theta.dtype)),
        phi=phi2.at[v].add((err[:, None] * t).astype(phi.dtype)),
        bu=bu2.at[u].add(err.astype(bu.dtype)),
        bv=bv2.at[v].add(err.astype(bv.dtype)),
        gb=gb,
    )

    # --- 3. hypergradient step on the lambdas (admf.h:82-83, model.h:86-102) ---
    uv_all, vv_all, rv_all = valid
    nvalid = uv_all.shape[0]
    ksel = jax.random.randint(key, (n_reg_samples,), 0, nvalid)
    su, sv, sr = uv_all[ksel], vv_all[ksel], rv_all[ksel]

    t_new = params.theta[su].astype(jnp.float32)
    p_new = params.phi[sv].astype(jnp.float32)
    score_v = (
        jnp.sum(t_new * p_new, axis=-1)
        + params.bu[su].astype(jnp.float32)
        + params.bv[sv].astype(jnp.float32)
        + gb.astype(jnp.float32)
    )
    grad = sr - _activate(score_v, loss)

    inner_u = jnp.sum(theta_old[su].astype(jnp.float32) * p_new, axis=-1)
    inner_v = jnp.sum(t_new * phi_old[sv].astype(jnp.float32), axis=-1)
    # Scale: the reference takes one micro-step per distinct user in the block.
    n_users = jnp.sum(
        (jnp.full((theta.shape[0],), -1, jnp.int32).at[u].max(
            jnp.where(w > 0, 1, -1).astype(jnp.int32)
        ) > 0).astype(jnp.float32)
    )
    scale = (eta_reg * eta) * n_users / n_reg_samples
    lam_u = jnp.maximum(0.0, state.lam_u - scale * jnp.sum(grad * inner_u))
    lam_v = jnp.maximum(0.0, state.lam_v - scale * jnp.sum(grad * inner_v))
    lam_bu = jnp.maximum(
        0.0, state.lam_bu - scale * jnp.sum(grad * bu_old[su].astype(jnp.float32))
    )
    lam_bv = jnp.maximum(
        0.0, state.lam_bv - scale * jnp.sum(grad * bv_old[sv].astype(jnp.float32))
    )

    return AdaptRegState(
        params=params,
        theta_old=theta_old,
        phi_old=phi_old,
        bu_old=bu_old,
        bv_old=bv_old,
        lam_u=lam_u,
        lam_v=lam_v,
        lam_bu=lam_bu,
        lam_bv=lam_bv,
    )


@partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
def adreg_epoch(
    state: AdaptRegState,
    batches: Batch,
    valid: Tuple[jax.Array, jax.Array, jax.Array],
    hyper_arrays: Tuple[jax.Array, jax.Array],
    loss: int,
    key: jax.Array,
) -> AdaptRegState:
    """Scan the adaptive-reg update over one epoch."""
    eta, eta_reg = hyper_arrays
    hyper = AdRegHyper(eta=eta, eta_reg=eta_reg, loss=loss)
    nb = batches[0].shape[0]

    def step(s, x):
        i, batch = x
        return (
            adreg_batch_update(s, batch, valid, hyper, jax.random.fold_in(key, i)),
            None,
        )

    state, _ = jax.lax.scan(
        step, state, (jnp.arange(nb, dtype=jnp.int32), batches)
    )
    return state
