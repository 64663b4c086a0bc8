"""Command-line trainer mirroring the reference's ``./mf`` flags.

Reference: src/main.cc:6-33 (help text), 95-164 (parser + dispatch). Every
reference flag is accepted with the same name and default; execution knobs
(--batch_size, --seed, --dtype, --mesh) are additive. Training data may be in
any supported format (length-prefixed protobuf frames, raw/userwise text,
MovieLens files) — auto-detected, unlike the reference which requires its
protobuf block format.

Usage:
    python -m tpu_mf.cli --alg mf --train train.pb --test test.pb \
        --nu 480189 --nv 17770 --dim 128 --iter 15 --eta 2e-2
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from tpu_mf.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-mf",
        description="Matrix factorization trainer (SGD / DP-SGLD / AdaptReg)",
    )
    # Reference flags (src/main.cc:106-137) — same names, same defaults.
    p.add_argument("--train", help="training data file (any supported format)")
    p.add_argument("--test", help="test data file")
    p.add_argument("--valid", help="validation data file (admf)")
    p.add_argument("--result", help="checkpoint output prefix")
    p.add_argument("--model", help="warm-start checkpoint to load")
    p.add_argument("--alg", default="mf", choices=["mf", "dpmf", "admf"])
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--iter", type=int, default=15, dest="iters")
    p.add_argument("--nu", type=int, default=0)
    p.add_argument("--nv", type=int, default=0)
    p.add_argument("--fly", type=int, default=8,
                   help="host prefetch depth (reference: TBB pipeline tokens)")
    p.add_argument("--stride", type=int, default=2,
                   help="accepted for parity; software prefetch has no "
                        "meaning here")
    p.add_argument("--eta", type=float, default=2e-2)
    p.add_argument("--lambda", type=float, default=5e-3, dest="lam")
    p.add_argument("--gam", type=float, default=1.0)
    p.add_argument("--bias", type=float, default=2.76, dest="gb")
    p.add_argument("--mineta", type=float, default=1e-13)
    p.add_argument("--epsilon", type=float, default=0.0)
    p.add_argument("--tau", type=int, default=0)
    p.add_argument("--hypera", type=float, default=1.0)
    p.add_argument("--hyperb", type=float, default=100.0)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--noise_size", type=int, default=2_000_000_000,
                   help="accepted for parity; noise comes from jax.random")
    p.add_argument("--eta_reg", type=float, default=2e-3)
    p.add_argument("--loss", type=int, default=0, choices=[0, 1])
    p.add_argument("--measure", type=int, default=0)
    # Execution knobs (no reference counterpart).
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--mesh", type=int, default=1,
                   help="devices for diagonal-block DSGD (1 = one device; "
                        "--alg mf without --stream only)")
    p.add_argument("--stream", action="store_true",
                   help="stream the training file from disk each epoch "
                        "instead of staging it on device (out-of-core; "
                        "reference: the TBB read pipeline, mf.h:6-70)")
    # Observability / failure recovery (SURVEY §5).
    p.add_argument("--metrics", metavar="PATH",
                   help="append machine-readable JSONL metrics per epoch "
                        "(RMSE, eta, updates/sec, lambdas)")
    p.add_argument("--trace", metavar="DIR",
                   help="capture a jax.profiler trace of training "
                        "(TensorBoard-viewable)")
    p.add_argument("--resume", action="store_true",
                   help="checkpoint full training state each round under "
                        "<result>.state.* and auto-resume from the newest "
                        "one on restart (requires --result)")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        train=args.train, test=args.test, valid=args.valid,
        result=args.result, model=args.model, alg=args.alg,
        dim=args.dim, iters=args.iters, nu=args.nu, nv=args.nv,
        fly=args.fly, stride=args.stride, eta=args.eta, lam=args.lam,
        gam=args.gam, gb=args.gb, mineta=args.mineta, epsilon=args.epsilon,
        tau=args.tau, hypera=args.hypera, hyperb=args.hyperb, temp=args.temp,
        noise_size=args.noise_size, eta_reg=args.eta_reg, loss=args.loss,
        measure=args.measure, batch_size=args.batch_size, seed=args.seed,
        dtype=args.dtype, mesh=args.mesh,
        metrics=args.metrics, trace=args.trace, resume=args.resume,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    # Required args, as the reference enforces (src/main.cc:139-142) — except
    # nu/nv, which we can infer from the data.
    if cfg.train is None:
        print("Note that train_data is not optional!", file=sys.stderr)
        build_parser().print_help()
        return 1
    if cfg.resume and not cfg.result:
        print("--resume requires --result (checkpoint prefix)", file=sys.stderr)
        return 1
    try:
        cfg.check_mesh(cfg.alg, stream=args.stream)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1

    from tpu_mf.runtime import enable_compile_cache

    enable_compile_cache()

    # Multi-host: jax.distributed, gated on the standard coordinator env
    # vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) —
    # a no-op single-process. Must run before any backend use.
    from tpu_mf.parallel.multihost import init_distributed

    n_proc = init_distributed()
    primary = True
    if n_proc > 1:
        import jax

        primary = jax.process_index() == 0
        print(
            f"# jax.distributed: process {jax.process_index()}/{n_proc}, "
            f"{jax.local_device_count()} local of "
            f"{jax.device_count()} devices",
            file=sys.stderr,
        )

    # Heavy imports deferred so --help is instant.
    import numpy as np
    from tpu_mf.data.textfmt import read_any
    from tpu_mf.io.checkpoint import (
        load_dpmf_hyper,
        load_mf_binary,
        save_dpmf_binary,
        save_mf_binary,
        save_npz,
    )
    from tpu_mf.train.loop import train_admf, train_dpmf, train_mf

    if args.stream:
        # Out-of-core: never materialize the training file in host RAM. Table
        # sizes come from --nu/--nv or one cheap id-scan of the stream.
        if cfg.nu and cfg.nv:
            nu, nv = cfg.nu, cfg.nv
        else:
            from tpu_mf.io.stream import scan_dims

            nu, nv, _ = scan_dims(cfg.train)
        train_ds = None
    else:
        train_ds = read_any(cfg.train, nu=cfg.nu or None, nv=cfg.nv or None)
        nu, nv = train_ds.nu, train_ds.nv
    test_ds = read_any(cfg.test, nu=nu, nv=nv) if cfg.test else None

    def report_ranking(params):
        # --measure 1: ranking quality on top of RMSE (the reference's
        # --measure only "supports RMSE", main.cc:33 — this is additive).
        if cfg.measure != 1 or test_ds is None:
            return
        from tpu_mf.models.eval import ranking_metrics

        m = ranking_metrics(params, test_ds, train_ds=train_ds, k=10)
        print(
            f"recall@{m['k']}={m['recall@k']:f}\t"
            f"precision@{m['k']}={m['precision@k']:f}\t"
            f"ndcg@{m['k']}={m['ndcg@k']:f}\tn_users={m['n_users']}"
        )

    if cfg.alg == "mf":
        params0 = None
        if cfg.model:
            # Warm start adopts the checkpoint's lambda, as the reference's
            # read_model does (model.cc:81 reads lambda_ into the model).
            params0, lam = load_mf_binary(cfg.model, gb=cfg.gb)
            cfg = dataclasses.replace(cfg, lam=lam)
        if args.stream:
            from tpu_mf.train.loop import train_mf_stream

            params = train_mf_stream(
                cfg, cfg.train, test_ds=test_ds, params=params0, nu=nu, nv=nv
            )
        else:
            params = train_mf(cfg, train_ds, test_ds=test_ds, params=params0)
        report_ranking(params)
        if cfg.result and primary:
            if cfg.result.endswith(".npz"):
                save_npz(cfg.result, params, lam=np.float32(cfg.lam))
            else:
                save_mf_binary(f"{cfg.result}_{cfg.iters}", params, cfg.lam)
    elif cfg.alg == "dpmf":
        state0 = None
        hyper0 = None
        if cfg.model:
            # Hyper-only warm start, as the reference does (main.cc:57).
            hyper0 = load_dpmf_hyper(cfg.model)
        if cfg.model and not args.stream:
            import jax
            from tpu_mf.models.dpmf import init_dpmf
            import jax.numpy as jnp

            lr, lub, lvb, lu, lv = hyper0
            state0 = init_dpmf(
                jax.random.PRNGKey(cfg.seed), train_ds, cfg.dim, gb=cfg.gb
            )._replace(
                lambda_r=jnp.float32(lr),
                lambda_ub=jnp.float32(lub),
                lambda_vb=jnp.float32(lvb),
                lambda_u=jnp.asarray(lu),
                lambda_v=jnp.asarray(lv),
            )

        def save_fn(state, rnd):
            if cfg.result and primary:
                save_dpmf_binary(
                    f"{cfg.result}_{rnd}",
                    state.params,
                    float(state.lambda_r),
                    float(state.lambda_ub),
                    float(state.lambda_vb),
                    np.asarray(state.lambda_u),
                    np.asarray(state.lambda_v),
                )

        if args.stream:
            from tpu_mf.train.loop import train_dpmf_stream

            state = train_dpmf_stream(
                cfg, cfg.train, test_ds=test_ds, save_fn=save_fn,
                hyper0=hyper0,
            )
        else:
            state = train_dpmf(
                cfg, train_ds, test_ds=test_ds, state=state0, save_fn=save_fn
            )
        report_ranking(state.params)
        if cfg.result:
            save_fn(state, cfg.iters)
    else:  # admf
        if not cfg.valid:
            print("admf requires --valid", file=sys.stderr)
            return 1
        valid_ds = read_any(cfg.valid, nu=nu, nv=nv)
        if args.stream:
            from tpu_mf.train.loop import train_admf_stream

            state = train_admf_stream(cfg, cfg.train, valid_ds, test_ds=test_ds)
        else:
            state = train_admf(cfg, train_ds, valid_ds, test_ds=test_ds)
        report_ranking(state.params)
        if cfg.result and primary:
            save_mf_binary(f"{cfg.result}_{cfg.iters}", state.params, float(state.lam_u))
    return 0


if __name__ == "__main__":
    sys.exit(main())
