"""Ranking evaluation: recall@k, precision@k, NDCG@k.

The reference's only metric is RMSE (``--measure``: "support RMSE",
main.cc:33; calc_mse model.cc:41-73) — matched by tpu_mf.models.mf.rmse.
Production recommenders also gate on ranking quality, so top-k metrics are
provided on top of the batched serving scorer (models/serving.py): score the
full catalog per user with one matmul, mask training items, take top-k, and
compare against each user's held-out positives.

Host-side bookkeeping is fully vectorized (sorted-array membership via
searchsorted, CSR-style per-user histories) — Yahoo-shaped datasets
(1M users x 625k items, reference src/run.py:6-9) evaluate in seconds where
the round-2 per-user Python loops took hours.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tpu_mf.data.coo import RatingsCOO
from tpu_mf.models.mf import MFParams
from tpu_mf.models.serving import recommend_topk


def _user_csr(u: np.ndarray, v: np.ndarray, nu: int):
    """(sorted item array, per-user start offsets): history of each user."""
    order = np.argsort(u, kind="stable")
    vs = v[order].astype(np.int64)
    start = np.searchsorted(u[order], np.arange(nu + 1))
    return vs, start


def ranking_metrics(
    params: MFParams,
    test_ds: RatingsCOO,
    train_ds: Optional[RatingsCOO] = None,
    k: int = 10,
    min_rating: Optional[float] = None,
    user_batch: int = 1024,
    max_seen: int = 512,
) -> Dict[str, float]:
    """recall@k / precision@k / ndcg@k over users with test positives.

    Items the user rated in train_ds are masked out of the candidates
    (standard leave-out protocol). Users whose train history exceeds
    ``max_seen`` items have only their FIRST ``max_seen`` items (in train_ds
    order — RatingsCOO carries no timestamps) masked; the count of such
    truncated users is returned as ``n_truncated`` so callers can raise
    ``max_seen`` when it is nonzero.
    """
    import jax.numpy as jnp

    nv = int(test_ds.nv)
    nu = int(test_ds.nu)
    sel = (
        np.ones(len(test_ds), bool)
        if min_rating is None
        else test_ds.r >= min_rating
    )
    tu = test_ds.u[sel].astype(np.int64)
    tv = test_ds.v[sel].astype(np.int64)
    if tu.size == 0:
        return {"recall@k": 0.0, "precision@k": 0.0, "ndcg@k": 0.0, "k": k}
    # Sorted (user, item) keys: one searchsorted answers "is (u, i) a test
    # positive" for a whole (chunk, k) block at once.
    pos_keys = np.sort(tu * nv + tv)
    users, rel_cnt = np.unique(tu, return_counts=True)
    users = users.astype(np.int32)

    if train_ds is not None:
        seen_v, seen_start = _user_csr(train_ds.u, train_ds.v, nu)
        seen_len_all = (seen_start[1:] - seen_start[:-1])[users]
        n_truncated = int((seen_len_all > max_seen).sum())
    else:
        n_truncated = 0

    log2 = np.log2(np.arange(2, k + 2))  # DCG discounts
    idcg_cum = np.cumsum(1.0 / log2)
    recall = prec = ndcg = 0.0
    for s in range(0, len(users), user_batch):
        chunk = users[s : s + user_batch]
        rc = rel_cnt[s : s + user_batch]
        if train_ds is not None:
            # CSR gather of each user's first max_seen history items.
            st = seen_start[chunk]
            ln = np.minimum(seen_start[chunk + 1] - st, max_seen)
            idx = st[:, None] + np.arange(max_seen)[None, :]
            sm = (np.arange(max_seen)[None, :] < ln[:, None]).astype(
                np.float32
            )
            sv = np.where(
                sm > 0, seen_v[np.minimum(idx, len(seen_v) - 1)], 0
            ).astype(np.int32)
            items_k, _ = recommend_topk(
                params, jnp.asarray(chunk), k,
                seen_v=jnp.asarray(sv), seen_mask=jnp.asarray(sm),
            )
        else:
            items_k, _ = recommend_topk(params, jnp.asarray(chunk), k)
        items_k = np.asarray(items_k, np.int64)

        q = chunk.astype(np.int64)[:, None] * nv + items_k  # (C, k)
        loc = np.searchsorted(pos_keys, q)
        hits = (
            (loc < len(pos_keys)) & (pos_keys[np.minimum(loc, len(pos_keys) - 1)] == q)
        ).astype(np.float32)
        h = hits.sum(1)
        denom = np.minimum(rc, k).astype(np.float32)
        recall += float((h / denom).sum())
        prec += float(h.sum() / k)
        idcg = idcg_cum[np.minimum(rc, k) - 1]
        ndcg += float(((hits / log2).sum(1) / idcg).sum())
    n = float(len(users))
    return {
        "recall@k": recall / n,
        "precision@k": prec / n,
        "ndcg@k": ndcg / n,
        "k": k,
        "n_users": int(n),
        "n_truncated": n_truncated,
    }
