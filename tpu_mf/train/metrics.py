"""Structured metrics and profiling (SURVEY §5 observability row).

The reference's observability is two printf formats: per-epoch
``iter#N <time> tRMSE=<x>`` (src/mf.h:35) and per-round
``round #N RMSE=<x> tRMSE=<y> <time>`` (src/model.cc:304-308), plus raw
chrono timestamps. This module keeps those exact lines (train loops emit
them) and adds what a production trainer needs: machine-readable JSONL
metrics (RMSE, eta, updates/sec, lambdas) and jax.profiler trace
capture.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional, TextIO


class MetricsLogger:
    """Append-only JSONL metrics with throughput accounting."""

    def __init__(self, path: Optional[str] = None, stream: Optional[TextIO] = None):
        self._fh = open(path, "a") if path else stream
        self._t0 = time.perf_counter()
        self._updates = 0

    def count_updates(self, n: int) -> None:
        self._updates += int(n)

    @property
    def updates_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._updates / dt if dt > 0 else 0.0

    def log(self, **fields) -> None:
        fields.setdefault("t", round(time.perf_counter() - self._t0, 6))
        if self._updates:
            fields.setdefault("updates_per_sec", round(self.updates_per_sec))
        if self._fh is not None:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None and hasattr(self._fh, "close"):
            self._fh.close()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Capture a jax.profiler trace (TensorBoard-viewable) when logdir is set.

    The reference's only perf tooling is wall-clock prints and a prefetch
    stride knob (SURVEY §5); on a GPU the profiler shows per-kernel device
    time and the gaps between kernels.
    """
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
