"""Run the BASELINE.json gate configs on synthetic stand-in data.

Usage:
    python benchmarks/run_configs.py [--config N] [--iters K] [--scale F]
                                     [--mesh P]

--scale shrinks the rating counts (default 0.1 so a full sweep finishes in
minutes); --iters overrides the per-config epoch counts. --mesh applies to
the MF configs only (the other algorithms have no mesh epoch). Real data:
use tpu_mf.tools.prepare + tpu_mf.cli directly.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = [
    # (name, nu, nv, n, dict(cfg overrides))
    # small catalog + zipf skew: keep batch*top_item_share*eta small
    ("ml100k-rank8-mf", 943, 1682, 100_000,
     dict(alg="mf", dim=8, eta=0.015, lam=5e-3, gam=0.3, iters=10,
          batch_size=1024)),
    ("ml1m-rank32-mf", 6040, 3706, 1_000_000,
     dict(alg="mf", dim=32, eta=0.012, lam=5e-3, gam=0.3, iters=10)),
    ("ml10m-rank64-sgld", 69_878, 10_677, 10_000_000,
     dict(alg="dpmf", dim=64, eta=2e-9, temp=1e-11, gam=0.2,
          hyperb=200_000.0, iters=6)),
    ("ml10m-rank64-dpmf-eps1", 69_878, 10_677, 10_000_000,
     dict(alg="dpmf", dim=64, eta=2e-6, temp=1e-11, gam=0.2,
          epsilon=1.0, tau=5000, hyperb=200_000.0, iters=6)),
    ("netflix-rank128-admf", 480_189, 17_770, 100_000_000,
     dict(alg="admf", dim=128, eta=0.01, lam=0.02, eta_reg=1e-3,
          gam=0.3, iters=6)),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=-1, help="-1 = all")
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--scale", type=float, default=0.1,
                    help="fraction of the config's rating count to generate")
    ap.add_argument("--mesh", type=int, default=1)
    args = ap.parse_args()

    import jax

    from tpu_mf.config import TrainConfig
    from tpu_mf.data.coo import synthetic_ratings
    from tpu_mf.train.loop import train_admf, train_dpmf, train_mf

    todo = CONFIGS if args.config < 0 else [CONFIGS[args.config]]
    for name, nu, nv, n, over in todo:
        n_eff = max(10_000, int(n * args.scale))
        print(f"=== {name}: nu={nu} nv={nv} n={n_eff} {over}")
        ds = synthetic_ratings(nu, nv, n_eff, rank=8, noise=0.15, seed=0,
                               zipf=0.9)
        train, rest = ds.split(0.2, seed=1)
        valid, test = rest.split(0.5, seed=2)
        if args.iters:
            over = dict(over, iters=args.iters)
        # SGLD stability (see train_dpmf docstring): both the gradient scale
        # eta*ntrain*lambda_r and the per-occurrence decay
        # eta*invfreq_max*lambda must stay < ~0.5. The reference expects
        # trimmed data (its --tau doc); synthetic stand-ins are untrimmed,
        # so derive eta from the actual count statistics.
        if over["alg"] == "dpmf":
            uc = np.bincount(train.u, minlength=nu)
            vc = np.bincount(train.v, minlength=nv)
            inv_max = len(train) / max(1, min(uc[uc > 0].min(), vc[vc > 0].min()))
            # headroom for the Gibbs-grown lambda_r (equilibrium ~1/mse)
            eta = 0.05 / (max(inv_max, len(train)) * 100.0)
            over = dict(over, eta=float(eta))
        mesh = args.mesh if over["alg"] == "mf" else 1
        cfg = TrainConfig(gb=ds.mean_rating(), seed=0, mesh=mesh,
                          **dict(dict(batch_size=4096), **over))
        t0 = time.perf_counter()
        if cfg.alg == "mf":
            train_mf(cfg, train, test_ds=test)
        elif cfg.alg == "dpmf":
            train_dpmf(cfg, train, test_ds=test)
        else:
            train_admf(cfg, train, valid, test_ds=test)
        dt = time.perf_counter() - t0
        ups = len(train) * cfg.iters / dt
        print(f"--- {name}: {dt:.1f}s total, ~{ups/1e6:.2f}M updates/s "
              f"(incl. compile + eval) on "
              f"{jax.devices()[0].device_kind}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
