"""Host-side streaming input pipeline — the TBB pipeline's equivalent (C8).

Reference: a 3-stage tbb::pipeline with ``fly`` tokens — serial fread of
length-prefixed frames into a recycled buffer pool, parallel protobuf decode,
parallel Hogwild update (src/mf.h:6-70, src/main.cc:42-50). Here the
analogue is: a background thread parses frames into fixed-size COO batches
and stages them onto the device (``jax.device_put``) up to ``fly`` batches
ahead of the jitted update step, so host I/O and device compute overlap.

Used for datasets too large to pre-stage on device; in-memory datasets go
through the faster scanned epochs (tpu_mf.ops).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


def stream_batches(
    path: str, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (u, v, r, w) batches by incrementally parsing any rating file
    (proto frames / raw / userwise / MovieLens — data/streamfmt.py).

    The tail batch is padded with weight-0 slots, like RatingsCOO.to_batches.
    """
    from tpu_mf.data.streamfmt import iter_ratings

    for u, v, r in iter_ratings(path, chunk=batch_size):
        n = len(u)
        if n == batch_size:
            yield u, v, r, np.ones(batch_size, np.float32)
        else:  # tail
            pad = batch_size - n
            yield (
                np.concatenate([u, np.zeros(pad, np.int32)]),
                np.concatenate([v, np.zeros(pad, np.int32)]),
                np.concatenate([r, np.zeros(pad, np.float32)]),
                np.concatenate(
                    [np.ones(n, np.float32), np.zeros(pad, np.float32)]
                ),
            )


def scan_dims(path: str) -> Tuple[int, int, int]:
    """One bounded-memory pass over any rating file: (nu, nv, n_ratings)."""
    from tpu_mf.data.streamfmt import scan_stats

    return scan_stats(path)


class Prefetcher:
    """Stage batches onto the device from a background thread, ``fly`` ahead.

    The moral equivalent of the reference's pipeline tokens (--fly,
    main.cc:19): bounded lookahead that overlaps host parse/transfer with
    device compute. Iterate it like the source iterator; raises the source's
    exception, if any, at the point of consumption.
    """

    _DONE = object()

    def __init__(self, source, fly: int = 8, device=None):
        import jax

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, fly))
        self._device = device or jax.devices()[0]
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()

        def worker():
            try:
                for item in source:
                    staged = jax.device_put(item, self._device)
                    # bounded put so an abandoned consumer doesn't pin `fly`
                    # device batches forever (see close())
                    while not self._closed.is_set():
                        try:
                            self._q.put(staged, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._closed.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                # the sentinel must not be dropped on a full queue, or the
                # consumer blocks forever; bounded-put like the items
                while not self._closed.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Release the worker and its staged batches (idempotent)."""
        self._closed.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def streaming_batches(path: str, batch_size: int, fly: int = 8):
    """Prefetched device-staged (u, v, r, w) batches from an on-disk stream,
    with a host-side real-rating counter (reads counter after exhaustion)."""
    counts = {"n": 0}

    def counted(src):
        for b in src:
            counts["n"] += int(b[3].sum())
            yield b

    return Prefetcher(counted(stream_batches(path, batch_size)), fly=fly), counts


def streaming_sgld_round(
    state, path: str, hyper, key, batch_size: int = 8192, fly: int = 8
):
    """One DP-SGLD round over an on-disk stream (reference: the TBB pipeline
    feeding DPMF, src/dpmf.h:6-34) — out-of-core dpmf training."""
    import jax

    from tpu_mf.ops.sgld import sgld_batch_update

    step = jax.jit(sgld_batch_update, donate_argnums=(0,))
    pf, counts = streaming_batches(path, batch_size, fly)
    try:
        for i, batch in enumerate(pf):
            state = step(state, batch, hyper, jax.random.fold_in(key, i))
    finally:
        pf.close()
    return state, counts["n"]


def streaming_adreg_epoch(
    state, path: str, valid, hyper, key, batch_size: int = 8192, fly: int = 8
):
    """One AdaptReg epoch over an on-disk stream (reference: src/admf.h:6-46)
    — out-of-core admf training. ``hyper`` is an ops.adreg.AdRegHyper."""
    import jax

    from tpu_mf.ops.adreg import adreg_batch_update

    # hyper.loss is a static Python int (branches in _activate); close over
    # hyper/valid so jit sees them as constants, not traced operands.
    step = jax.jit(
        lambda s, batch, k: adreg_batch_update(s, batch, valid, hyper, k),
        donate_argnums=(0,),
    )
    pf, counts = streaming_batches(path, batch_size, fly)
    try:
        for i, batch in enumerate(pf):
            state = step(state, batch, jax.random.fold_in(key, i))
    finally:
        pf.close()
    return state, counts["n"]


def streaming_mse(params, path: str, batch_size: int = 1 << 16, fly: int = 8):
    """Weighted train MSE over an on-disk stream (drives the Gibbs SSE for
    streamed dpmf; in-memory path: models/mf.calc_mse)."""
    import jax
    import jax.numpy as jnp

    from tpu_mf.models.mf import predict

    @jax.jit
    def chunk_sse(params, u, v, r, w):
        e = (r - predict(params, u, v)) * w
        return jnp.sum(e * e), jnp.sum(w)

    sse = 0.0
    n = 0.0
    pf, _ = streaming_batches(path, batch_size, fly)
    try:
        for u, v, r, w in pf:
            s, c = chunk_sse(params, u, v, r, w)
            sse += float(s)
            n += float(c)
    finally:
        pf.close()
    return sse / max(n, 1.0)


def streaming_sgd_epoch(params, path: str, eta, lam, batch_size: int = 8192, fly: int = 8):
    """One SGD pass over an on-disk block stream without loading it in RAM.

    Mirrors the reference's epoch structure: serial read -> decode ->
    update, with ``fly`` batches in flight (reference: run(MF&),
    src/main.cc:36-52).
    """
    import jax
    import jax.numpy as jnp

    from tpu_mf.ops.sgd import sgd_batch_update

    step = jax.jit(sgd_batch_update, donate_argnums=(0,))
    eta = jnp.float32(eta)
    lam = jnp.float32(lam)
    # Count real ratings host-side as batches flow through the parser, so
    # the device loop never synchronizes per batch.
    counts = {"n": 0}

    def counted(src):
        for b in src:
            counts["n"] += int(b[3].sum())
            yield b

    pf = Prefetcher(counted(stream_batches(path, batch_size)), fly=fly)
    try:
        for batch in pf:
            params = step(params, batch, eta, lam)
    finally:
        pf.close()
    return params, counts["n"]
