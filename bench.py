"""Epoch throughput of the plain XLA epochs on one NVIDIA GPU.

    python bench.py [--seed N] [--trace DIR]

Each cell trains one algorithm at one rank on a seeded stand-in dataset
and prints one JSON line as soon as it finishes: the median epoch time over
REPS timed epochs (after one untimed epoch that compiles), rating
updates per second, and the device. With --trace, one more epoch per cell
runs under jax.profiler and the line adds the trace's busiest device ops
and the device's idle share over that epoch. The last line summarises.

Data is the calibrated MovieLens-10M stand-in (benchmarks/ML10M_STUDY.md)
at 69,878 x 10,677 and 10M ratings, a unique-pair variant of it, and the
Yahoo! Music catalog shape (1,000,990 x 624,961, reference src/run.py:6-9)
at 20M ratings. It is generated from --seed on every run.

Exits non-zero when JAX finds no GPU: a CPU time is not a device number.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

# (cell, algorithm, rank, dataset); the datasets are built once each.
CELLS = [
    ("mf_rank64", "mf", 64, "ml10m"),
    ("mf_rank8", "mf", 8, "ml10m"),
    ("mf_dim128", "mf", 128, "ml10m"),
    ("mf_rank64_unique", "mf", 64, "ml10m_unique"),
    ("dpmf_rank8", "dpmf", 8, "ml10m"),
    ("dpmf_rank64", "dpmf", 64, "ml10m"),
    ("admf_rank8", "admf", 8, "ml10m"),
    ("admf_rank64", "admf", 64, "ml10m"),
    ("mf_yahoo_rank8", "mf", 8, "yahoo"),
]
BATCH = 4096
REPS = 3


def make_data(name: str, seed: int):
    from tpu_mf.data.coo import ML10M_SHAPE, calibrated_ratings, unique_pairs

    if name == "ml10m":
        return calibrated_ratings(*ML10M_SHAPE, seed=seed)
    if name == "ml10m_unique":
        nu, nv, n = ML10M_SHAPE
        return unique_pairs(calibrated_ratings(nu, nv, int(n * 1.3), seed), n)
    return calibrated_ratings(1_000_990, 624_961, 20_000_000, seed=seed + 11)


def epoch_fn(alg: str, dim: int, ds, seed: int):
    """(state, step) where step(state) runs one epoch of the plain op."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    batches = tuple(jnp.asarray(x)
                    for x in ds.to_batches(BATCH, shuffle_seed=seed))
    gb = ds.mean_rating()
    if alg == "mf":
        from tpu_mf.models.mf import init_mf
        from tpu_mf.ops.sgd import sgd_epoch

        eta, lam = jnp.float32(0.02), jnp.float32(5e-3)
        return (init_mf(key, ds.nu, ds.nv, dim, gb=gb),
                lambda s: sgd_epoch(s, batches, eta, lam))
    if alg == "dpmf":
        from tpu_mf.models.dpmf import init_dpmf
        from tpu_mf.ops.sgld import SgldHyper, sgld_epoch

        n = len(ds)
        hyper = SgldHyper(eta=jnp.float32(5e-3 / n), temp=jnp.float32(1e-6),
                          bound=jnp.float32(1.0), ntrain=jnp.float32(n))
        return (init_dpmf(key, ds, dim, gb=gb),
                lambda s: sgld_epoch(s, batches, hyper, key))
    from tpu_mf.models.admf import init_admf
    from tpu_mf.ops.adreg import adreg_epoch

    rng = np.random.default_rng(seed)
    pick = rng.choice(len(ds), size=max(1, len(ds) // 20), replace=False)
    valid = tuple(jnp.asarray(x[pick]) for x in (ds.u, ds.v, ds.r))
    hyp = (jnp.float32(0.01), jnp.float32(1e-3))
    return (init_admf(key, ds.nu, ds.nv, dim, lam=0.02, gb=gb),
            lambda s: adreg_epoch(s, batches, valid, hyp, 0, key))


def reduce_trace(logdir: str, top: int = 8) -> dict:
    """Device time per kernel and the device's idle share from a
    jax.profiler trace. Busy time is the union of kernel intervals on the
    GPU's stream lines; idle share is 1 - busy / (last kernel end - first
    kernel start)."""
    import jax

    (path,) = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                        recursive=True)
    planes = [p for p in jax.profiler.ProfileData.from_file(path).planes
              if p.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError(f"no GPU plane in {path}")
    spans, by_op = [], defaultdict(float)
    for plane in planes:
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
                by_op[e.name] += e.duration_ns
    spans.sort()
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = spans[-1][1] - spans[0][0] if spans else 0
    total = sum(by_op.values()) or 1
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1 - busy / window if window else None,
        "top_ops": [(k, round(v / 1e6, 3), round(v / total, 4)) for k, v in
                    sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
    }


def run_cell(name, alg, dim, ds, args, device) -> dict:
    import jax

    state, step = epoch_fn(alg, dim, ds, args.seed)
    t = time.perf_counter()
    state = jax.block_until_ready(step(state))
    first = time.perf_counter() - t
    times = []
    for _ in range(REPS):
        t = time.perf_counter()
        state = jax.block_until_ready(step(state))
        times.append(time.perf_counter() - t)
    med = float(np.median(times))
    row = {
        "cell": name, "alg": alg, "dim": dim, "users": ds.nu,
        "items": ds.nv, "ratings": len(ds), "batch": BATCH,
        "compile_and_first_epoch_s": first, "epoch_s": times,
        "epoch_s_median": med, "updates_per_s": len(ds) / med, **device,
    }
    if args.trace:
        logdir = os.path.join(args.trace, name)
        with jax.profiler.trace(logdir):
            state = jax.block_until_ready(step(state))
        row["trace"] = reduce_trace(logdir)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace one epoch per cell under DIR")
    args = ap.parse_args(argv)

    import jax

    from tpu_mf.runtime import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"no GPU: JAX reports {d.platform} devices", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    device = {"platform": d.platform, "device_kind": d.device_kind,
              "device_count": len(jax.devices()),
              "xla_flags": os.environ.get("XLA_FLAGS", "")}
    data, rows = {}, {}
    for name, alg, dim, dname in CELLS:
        if dname not in data:
            t = time.perf_counter()
            data[dname] = make_data(dname, args.seed)
            print(f"# {dname}: {len(data[dname])} ratings made in "
                  f"{time.perf_counter() - t:.2f} s", flush=True)
        rows[name] = run_cell(name, alg, dim, data[dname], args, device)
        print(json.dumps(rows[name]), flush=True)
    print(json.dumps({
        "metric": "rating updates/s per GPU, plain XLA epoch",
        "unit": "updates/s",
        "cells": {k: r["updates_per_s"] for k, r in rows.items()},
        **device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
