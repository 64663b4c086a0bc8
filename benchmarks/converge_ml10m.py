"""North-star convergence study: epochs to test-RMSE 0.86 at ML-10M scale.

BASELINE.json gates on "epochs to test-RMSE 0.86 on ML-10M". The real
MovieLens-10M files are not available in this environment (zero egress), so
this runs the FULL-SCALE ML-10M-shaped stand-in: identical nu/nv/n, item and
user popularity skews matched to the real marginals (top item ~0.35% of
ratings, top user ~0.07%; Zipf-Mandelbrot), and the variance decomposition
matched to the real dataset's published operating points:

  * global-mean RMSE    ~= 1.03   (real ML-10M: 1.060)
  * bias-only baseline  ~= 0.88   (real ML-10M: ~0.914, Koren's BellKor
                                   baseline predictors)
  * regularized-MF best ~= 0.80   (real ML-10M: ~0.79-0.82 for tuned
                                   rank-40..200 biased MF)

so "epochs until test RMSE crosses 0.86" demands the same thing it does on
the real data: learned biases plus a substantial fraction of the factor
structure. Calibration: noise=0.76 (Bayes floor), latent variance
signal^2/rank_true = 0.195, bias std 0.38/side => var 0.289; global
sqrt(.76^2 + .195 + .289) = 1.03; bias-only sqrt(.76^2 + .195) = 0.88.

Runs rank-64 biased MF with the plain SGD epoch (ops/sgd.py) at full
10M-rating scale (90/10 split, the split used for the published 0.86
figures), printing one line per epoch and a JSON summary, and with --out
also one JSON line per epoch to that file. Reference training loop
semantics: run(MF&), main.cc:36-52; eta schedule model.cc:36-38.

Usage: python benchmarks/converge_ml10m.py [--iters N] [--eta E] [--lam L]
           [--out curve.jsonl]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    # Reference default eta (main.cc:100).
    ap.add_argument("--eta", type=float, default=0.02)
    ap.add_argument("--lam", type=float, default=5e-3)
    ap.add_argument("--gam", type=float, default=0.3)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", help="per-epoch JSONL curve file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_mf.data.coo import synthetic_ratings
    from tpu_mf.models.mf import init_mf, rmse
    from tpu_mf.config import TrainConfig

    nu, nv, n = 69_878, 10_677, 10_000_000
    rank_true = 32
    # Popularity calibrated to the real ML-10M marginals: top item ~0.35% of
    # ratings (Zipf-Mandelbrot 1/(j+50)), top user ~0.07% (1/(j+250)) — a
    # pure power law concentrates 5%+ of ratings on one item, which no real
    # catalog does and which distorts SGD staleness far beyond reality.
    ds = synthetic_ratings(
        nu, nv, n, rank=rank_true, noise=0.76, seed=0, gb=3.512,
        zipf=1.0, zipf_q=50.0, zipf_u=1.0, zipf_uq=250.0,
        signal=float(np.sqrt(0.195 * rank_true)), bias_std=0.38,
    )
    train, test = ds.split(0.1, seed=1)  # (1-frac, frac) = 90/10
    gb = train.mean_rating()

    # calibration report (host-side, exact)
    mean_rmse = float(np.sqrt(np.mean((test.r - gb) ** 2)))
    print(f"# ML-10M stand-in: ntrain={len(train)} ntest={len(test)} "
          f"gb={gb:.4f} global-mean test RMSE={mean_rmse:.4f} "
          f"(Bayes floor 0.76)")

    cfg = TrainConfig(alg="mf", dim=args.dim, eta=args.eta, lam=args.lam,
                      gam=args.gam, iters=args.iters, batch_size=args.batch,
                      gb=gb, seed=0)
    params = init_mf(jax.random.PRNGKey(0), nu, nv, cfg.dim, gb=gb)

    from tpu_mf.ops.sgd import sgd_epoch

    rows = []
    crossed = None
    t_train = 0.0
    f = open(args.out, "w") if args.out else None
    for it in range(1, cfg.iters + 1):
        eta = cfg.eta_at(it)
        u, v, r, w = train.to_batches(cfg.batch_size, shuffle_seed=it)
        batches = tuple(jnp.asarray(x) for x in (u, v, r, w))
        t0 = time.perf_counter()
        params = sgd_epoch(params, batches, jnp.float32(eta),
                           jnp.float32(cfg.lam))
        jax.block_until_ready(params.theta)
        dt = time.perf_counter() - t0
        t_train += dt
        tr = float(rmse(params, test))
        trn = float(rmse(params, train))
        row = {"epoch": it, "eta": eta, "test_rmse": tr, "train_rmse": trn,
               "epoch_s": dt, "device": jax.devices()[0].device_kind}
        rows.append(row)
        if f is not None:
            f.write(json.dumps(row) + "\n")
            f.flush()
        print(f"epoch {it:3d}: eta={eta:.5f} train={trn:.4f} test={tr:.4f} "
              f"({dt*1e3:.0f} ms{', includes compilation' if it == 1 else ''})")
        if crossed is None and tr <= 0.86:
            crossed = it
    if f is not None:
        f.close()

    best = min(r["test_rmse"] for r in rows)
    print(json.dumps({
        "metric": "epochs to test-RMSE 0.86 (ML-10M-scale stand-in, rank 64)",
        "value": crossed if crossed is not None else -1,
        "unit": "epochs",
        "best_test_rmse": best,
        "train_s_total": t_train,
        "device": jax.devices()[0].device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
