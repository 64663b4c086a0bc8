"""Inference / serving API.

The reference has NO serving path — prediction exists only inline in its
eval and hypergradient code (SURVEY §3.5; pred formula at model.cc:62,
model.h:87). Here scoring and top-k recommendation are first-class, jitted,
and batched: score all items for a batch of users with one matmul, mask
already-seen items, and take top-k on device.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from tpu_mf.models.mf import MFParams


@jax.jit
def score_all_items(params: MFParams, users: jax.Array) -> jax.Array:
    """Scores for every item for each user in ``users``: (B, nv).

    pred[b, j] = theta_{u_b} . phi_j + bu_{u_b} + bv_j + gb — one batched
    matmul instead of the reference's per-pair cblas_sdot.

    Precision HIGHEST: a float32 matmul may otherwise run in TF32 on a GPU
    (about three decimal digits), which reorders near-tied items against
    the float32 scores that training and RMSE evaluation compute.
    """
    t = params.theta[users].astype(jnp.float32)            # (B, D)
    scores = jnp.matmul(                                   # (B, nv)
        t, params.phi.astype(jnp.float32).T,
        precision=jax.lax.Precision.HIGHEST,
    )
    return (
        scores
        + params.bu[users].astype(jnp.float32)[:, None]
        + params.bv.astype(jnp.float32)[None, :]
        + params.gb.astype(jnp.float32)
    )


@partial(jax.jit, static_argnames=("k",))
def recommend_topk(
    params: MFParams,
    users: jax.Array,
    k: int,
    seen_v: Optional[jax.Array] = None,
    seen_mask: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k items per user, optionally masking already-rated items.

    seen_v/seen_mask: (B, S) padded per-user lists of seen item ids and a
    {0,1} validity mask; seen items score -inf before the top-k.
    Returns (items (B, k), scores (B, k)).
    """
    scores = score_all_items(params, users)
    if seen_v is not None:
        b = scores.shape[0]
        neg = jnp.float32(-jnp.inf)
        if seen_mask is None:
            seen_mask = jnp.ones_like(seen_v, jnp.float32)
        rows = jnp.arange(b)[:, None]
        # scatter -inf into seen positions (mask-weighted so padding is a no-op)
        scores = scores.at[rows, seen_v].min(
            jnp.where(seen_mask > 0, neg, jnp.inf)
        )
    vals, idx = jax.lax.top_k(scores, k)
    return idx, vals
