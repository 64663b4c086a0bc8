"""DPMF model state: differentially-private SGLD matrix factorization.

Equivalent of the reference's ``DPMF`` class (reference:
src/model.h:32-72, src/model.cc:197-352; paper arXiv:1505.01419). State beyond
the base MF tables:

* Gibbs-sampled precisions: scalar lambda_r (rating noise), lambda_ub /
  lambda_vb (bias priors), and per-dimension vectors lambda_u / lambda_v
  (inits 1.0 / 1e2 / 1e2 / 1e2: model.h:41, model.cc:228).
* Inverse-frequency regularization weights ur = ntrain/count(u),
  vr = ntrain/count(v) precomputed from one pass over the training set
  (reference: sample_train_and_precompute_weight, model.cc:263-297).
* Lazy Langevin noise bookkeeping: a global update counter and per-row
  last-touch counters. The reference tracks these with an atomic counter plus
  per-item mutexes (dpmf.h:61-66, model.h:58-60); under synchronous batches
  they are exact integer arrays — rows touched in a batch receive one noise
  draw of variance temp*eta*(updates elapsed since last touch), which
  telescopes to the same total noise the reference's per-rating lazy scheme
  injects. Counter arrays have one extra slot (index nu / nv) that absorbs
  padded batch slots.
* Privacy bound: bound = epsilon/(4*25*tau) when epsilon > 0 else 1.0, with
  tau defaulting to nv (reference: model.cc:240-242).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_mf.models.mf import MFParams, init_mf


class DPMFState(NamedTuple):
    params: MFParams
    lambda_r: jax.Array       # () rating precision
    lambda_ub: jax.Array      # () user-bias precision
    lambda_vb: jax.Array      # () item-bias precision
    lambda_u: jax.Array       # (dim,) per-dimension user precisions
    lambda_v: jax.Array       # (dim,)
    ur: jax.Array             # (nu,) inverse-frequency weights
    vr: jax.Array             # (nv,)
    gcountu: jax.Array        # (nu+1,) int32 last-touch counters (+pad slot)
    gcountv: jax.Array        # (nv+1,) int32
    gcount: jax.Array         # () int32 global update counter


def dp_bound(epsilon: float, tau: int, nv: int) -> float:
    """Privacy scale (reference: model.cc:240-242)."""
    if tau <= 0:
        tau = nv
    if epsilon <= 0.0:
        return 1.0
    return float(epsilon / (4.0 * 25.0 * tau))


def init_dpmf(
    key: jax.Array,
    train_ds,
    dim: int,
    gb: float = 2.76,
    scale: float = 1e-2,
    dtype=jnp.float32,
) -> DPMFState:
    """Initialize DPMF state from a training set (computes ur/vr weights)."""
    nu, nv = train_ds.nu, train_ds.nv
    params = init_mf(key, nu, nv, dim, gb=gb, scale=scale, dtype=dtype)
    uc, vc = train_ds.counts()
    ntrain = float(len(train_ds))
    # Inverse frequency; rows with no ratings never appear in a batch, so any
    # finite value works — use ntrain to mirror the reference's ntrain/count
    # with count clamped to 1.
    ur = (ntrain / np.maximum(uc, 1)).astype(np.float32)
    vr = (ntrain / np.maximum(vc, 1)).astype(np.float32)
    return DPMFState(
        params=params,
        lambda_r=jnp.float32(1.0),
        lambda_ub=jnp.float32(1e2),
        lambda_vb=jnp.float32(1e2),
        lambda_u=jnp.full((dim,), 1e2, jnp.float32),
        lambda_v=jnp.full((dim,), 1e2, jnp.float32),
        ur=jnp.asarray(ur),
        vr=jnp.asarray(vr),
        gcountu=jnp.zeros(nu + 1, jnp.int32),
        gcountv=jnp.zeros(nv + 1, jnp.int32),
        gcount=jnp.int32(0),
    )
