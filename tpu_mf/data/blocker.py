"""Diagonal-block partitioner for multi-device DSGD (Jellyfish-style).

The reference is single-node shared-memory (SURVEY §2: no distributed code);
its Hogwild races don't translate to SPMD hardware. Instead, ratings are
pre-partitioned into a P x P grid of blocks by (user-shard, item-shard): the P
blocks of diagonal s — {(p, (p+s) mod P) : p} — touch pairwise-disjoint user
rows AND item rows, so all P devices update their local shards in parallel
with zero races. One epoch = P diagonal substeps, rotating the item shards
around the ring between substeps (tpu_mf.parallel.dsgd).

Layout produced here (host-side, NumPy):
  u_local, v_local, r, w : (P, P, nb, B) arrays where
    axis 0 = user-shard p (device),
    axis 1 = substep s (the item shard device p holds at substep s is
             (p + s) mod P),
    axes 2,3 = nb batches of B ratings, padded with w=0 slots.
  Indices are shard-local (u_local = u mod chunk_u, v_local = v mod chunk_v).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from tpu_mf.data.coo import RatingsCOO


class DiagonalBlocks(NamedTuple):
    u_local: np.ndarray  # (P, P, nb, B) int32
    v_local: np.ndarray  # (P, P, nb, B) int32
    r: np.ndarray        # (P, P, nb, B) float32
    w: np.ndarray        # (P, P, nb, B) float32
    chunk_u: int         # rows of the user shard on each device
    chunk_v: int
    n_real: int          # total real (unpadded) ratings


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partition_diagonal(
    ds: RatingsCOO, P: int, batch_size: int, seed: int = 0
) -> DiagonalBlocks:
    """Bin ratings into the (P, P) diagonal-block layout described above."""
    chunk_u = cdiv(ds.nu, P)
    chunk_v = cdiv(ds.nv, P)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    u, v, r = ds.u[perm], ds.v[perm], ds.r[perm]

    shard_u = u // chunk_u
    shard_v = v // chunk_v
    substep = (shard_v - shard_u) % P
    # Group ratings by (device, substep) cell.
    cell = (shard_u * P + substep).astype(np.int64)
    order = np.argsort(cell, kind="stable")
    u, v, r, cell = u[order], v[order], r[order], cell[order]
    counts = np.bincount(cell, minlength=P * P)

    nb = max(1, cdiv(int(counts.max()), batch_size))
    cap = nb * batch_size
    ul = np.zeros((P * P, cap), np.int32)
    vl = np.zeros((P * P, cap), np.int32)
    rr = np.zeros((P * P, cap), np.float32)
    ww = np.zeros((P * P, cap), np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for c in range(P * P):
        s, e = offsets[c], offsets[c + 1]
        n = e - s
        ul[c, :n] = u[s:e] % chunk_u
        vl[c, :n] = v[s:e] % chunk_v
        rr[c, :n] = r[s:e]
        ww[c, :n] = 1.0
    shape = (P, P, nb, batch_size)
    return DiagonalBlocks(
        u_local=ul.reshape(shape),
        v_local=vl.reshape(shape),
        r=rr.reshape(shape),
        w=ww.reshape(shape),
        chunk_u=chunk_u,
        chunk_v=chunk_v,
        n_real=len(ds),
    )
