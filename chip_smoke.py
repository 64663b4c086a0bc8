"""Smoke run of tpu-mf on NVIDIA GPUs.

Drives the three trainers through their public entry points (train_mf,
train_dpmf, train_admf, and the CLI for --stream) at the calibrated
MovieLens-10M shape: 69,878 users x 10,677 items, 10M ratings made from
--seed. Then it compares the GPU epochs with the plain references (the
sequential oracle in tests/oracle.py and the same jitted epoch on the CPU
backend) and prints one JSON object as its last line.

    python chip_smoke.py [--seed N]        # one GPU
    python chip_smoke.py --four-cards      # --alg mf --mesh 4 on four GPUs

It exits non-zero, and prints no result line, when JAX finds no GPU or any
phase fails. Every failure raises; nothing is skipped.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_lines() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output: one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _parse_log(lines, key="tRMSE="):
    """(cumulative elapsed s, tRMSE) per epoch from the trainers' log lines."""
    rows = []
    for ln in lines:
        if key not in ln:
            continue
        f = ln.split("\t")
        t = float(f[-1]) if ln.startswith("round") else float(f[1])
        rows.append((t, float(ln.split(key)[1].split("\t")[0])))
    return rows


def report_epochs(name: str, lines) -> list:
    """Print each epoch's time and tRMSE; check finite and falling."""
    rows = _parse_log(lines)
    prev_t = 0.0
    for i, (t, r) in enumerate(rows, 1):
        print(f"{name} epoch {i}: {t - prev_t:.3f} s"
              f"{' (includes compilation)' if i == 1 else ''}, tRMSE={r:.6f}")
        prev_t = t
    rm = [r for _, r in rows]
    check(len(rm) >= 2, f"{name}: {len(rm)} epochs logged")
    check(all(np.isfinite(rm)), f"{name}: non-finite tRMSE {rm}")
    check(all(b < a for a, b in zip(rm, rm[1:])), f"{name}: tRMSE not falling {rm}")
    return rm


def max_rel(a, b) -> float:
    """max |a - b| over max |b|: the error of a against reference b."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def compare(name: str, err: float, tol: float, why: str) -> None:
    print(f"compare {name}: {err:.3e} (tolerance {tol:g}: {why})")
    check(err <= tol, f"{name}: {err:.3e} > {tol:g}")


def _load_oracle():
    """tests/oracle.py by path: another installed package may own the
    top-level name `tests`."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "oracle.py")
    spec = importlib.util.spec_from_file_location("tpu_mf_test_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _put(tree, dev):
    """Fresh copies of tree's arrays on dev (inputs get donated); Python
    scalars stay as they are (static arguments)."""
    import jax

    def put(x):
        if isinstance(x, (np.ndarray, np.generic, jax.Array)):
            return jax.device_put(np.array(x), dev)
        return x

    return jax.tree.map(put, tree)


# Tolerances of the GPU-vs-CPU epoch comparisons, as max |gpu - cpu| over
# max |cpu| per table. The update math is elementwise float32 in both, but
# a scatter-add on the GPU is a set of atomics whose order differs from the
# CPU's sequential loop, and XLA fuses differently per backend: each step
# can differ in the last bits of rows hit twice in one batch, and ~250
# dependent steps carry that forward without growing it (SGD contracts).
EPOCH_TOL = 1e-4


def run_one_card(nu: int, nv: int, n: int, seed: int) -> None:
    """Phases (b)-(e) at (nu, nv, n); the caller has checked the device."""
    import jax
    import jax.numpy as jnp

    from tpu_mf.cli import main as cli_main
    from tpu_mf.config import TrainConfig
    from tpu_mf.data.coo import RatingsCOO, calibrated_ratings
    from tpu_mf.data.proto import write_block_frames
    from tpu_mf.models.admf import init_admf
    from tpu_mf.models.dpmf import dp_bound, init_dpmf
    from tpu_mf.models.mf import init_mf, rmse
    from tpu_mf.models.serving import score_all_items
    from tpu_mf.ops.adreg import adreg_epoch
    from tpu_mf.ops.sgd import sgd_epoch
    from tpu_mf.ops.sgld import SgldHyper, sgld_epoch
    from tpu_mf.train.loop import train_admf, train_dpmf, train_mf

    sgd_sequential = _load_oracle().sgd_sequential
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    t = time.perf_counter()
    ds = calibrated_ratings(nu, nv, n, seed=seed)
    train, test = ds.split(0.1, seed=seed + 1)
    gb = train.mean_rating()
    print(f"data: {nu} x {nv}, {len(train)} train / {len(test)} test "
          f"ratings, made in {time.perf_counter() - t:.2f} s")

    # (b) MF at the reference's default rank.
    lines = []
    cfg = TrainConfig(alg="mf", dim=128, iters=3, eta=0.02, lam=5e-3,
                      gam=0.3, gb=gb, batch_size=4096, seed=seed)
    train_mf(cfg, train, test_ds=test, log=lines.append)
    report_epochs("mf dim 128", lines)

    # (c) DP-SGLD and AdaptReg at rank 64. eta*ntrain*lambda_r ~ 0.005
    # keeps SGLD inside its stability envelope (train_dpmf docstring);
    # hyperb damps the Gibbs-sampled precisions on untrimmed data.
    lines = []
    cfg = TrainConfig(alg="dpmf", dim=64, iters=3, eta=5e-3 / len(train),
                      gam=0.2, temp=1e-6, hyperb=2e5, gb=gb,
                      batch_size=4096, seed=seed)
    train_dpmf(cfg, train, test_ds=test, log=lines.append)
    report_epochs("dpmf dim 64", lines)

    atrain, avalid = train.split(0.05, seed=seed + 2)
    lines = []
    cfg = TrainConfig(alg="admf", dim=64, iters=3, eta=0.01, lam=0.02,
                      eta_reg=1e-3, gam=0.3, gb=gb, batch_size=4096,
                      seed=seed)
    train_admf(cfg, atrain, avalid, test_ds=test, log=lines.append)
    report_epochs("admf dim 64", lines)

    # 1M-rating slices for the stream epoch and the CPU comparisons.
    m = min(1_000_000, len(train))
    sl = RatingsCOO(train.u[:m], train.v[:m], train.r[:m], nu, nv)
    tsl = RatingsCOO(test.u[:m // 10], test.v[:m // 10], test.r[:m // 10],
                     nu, nv)

    # (d) One --stream epoch through the CLI from protobuf frames. The
    # frames group ratings by user, so a batch holds up to batch_size
    # ratings of one user: eta * batch_size stays below 2 (CLAUDE.md).
    with tempfile.TemporaryDirectory() as td:
        pb, tpb = os.path.join(td, "train.pb"), os.path.join(td, "test.pb")
        write_block_frames(pb, sl)
        write_block_frames(tpb, tsl)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main([
                "--alg", "mf", "--stream", "--train", pb, "--test", tpb,
                "--nu", str(nu), "--nv", str(nv), "--dim", "128",
                "--iter", "1", "--eta", "0.002", "--batch_size", "512",
                "--bias", f"{gb:f}", "--seed", str(seed),
            ])
    check(rc == 0, f"--stream CLI exit code {rc}")
    rows = _parse_log(out.getvalue().splitlines())
    check(len(rows) == 1, f"--stream logged {out.getvalue()!r}")
    p0 = jax.tree.map(np.asarray, init_mf(jax.random.PRNGKey(seed), nu, nv,
                                          128, gb=gb))
    r0 = float(rmse(_put(p0, dev), tsl))
    print(f"stream epoch: {rows[0][0]:.3f} s (includes compilation), "
          f"tRMSE={rows[0][1]:.6f} (untrained {r0:.6f})")
    check(np.isfinite(rows[0][1]) and rows[0][1] < r0,
          "--stream epoch did not improve on the untrained model")

    # (e1) Batch size 1 against the sequential reference loop at dim 128.
    k, eta, lam = 3000, 0.02, 5e-3
    b1 = tuple(x.reshape(k, 1) for x in (
        sl.u[:k], sl.v[:k], sl.r[:k], np.ones(k, np.float32)))
    got = sgd_epoch(_put(p0, dev), _put(b1, dev), jnp.float32(eta),
                    jnp.float32(lam))
    want = sgd_sequential(*p0[:4], gb, sl.u[:k], sl.v[:k], sl.r[:k], eta, lam)
    err = max(float(np.max(np.abs(np.asarray(g, np.float64) - w)))
              for g, w in zip(got[:4], want))
    # The math is elementwise (no matrix product, so TF32 never enters):
    # float32 rounding of values below ~4 over a few updates per row.
    compare("batch-1 SGD vs sequential oracle, max abs", err, 1e-5,
            "float32 rounding; elementwise math, no TF32")

    # (e2) One batched epoch per algorithm, GPU against the CPU backend.
    batches = sl.to_batches(4096, shuffle_seed=seed)

    def both(fn, *args):
        return [jax.tree.map(np.asarray, fn(*_put(args, d))) for d in (dev, cpu)]

    g, c = both(sgd_epoch, p0, batches, jnp.float32(eta), jnp.float32(lam))
    compare("mf epoch GPU vs CPU", max(max_rel(a, b) for a, b in zip(g[:4], c[:4])),
            EPOCH_TOL, "scatter-add order; see EPOCH_TOL")
    g2 = jax.tree.map(np.asarray, sgd_epoch(
        *_put((p0, batches, jnp.float32(eta), jnp.float32(lam)), dev)))
    same = all(np.array_equal(a, b) for a, b in zip(g[:4], g2[:4]))
    print(f"determinism: two GPU epochs from the same inputs are "
          f"{'bit-identical' if same else 'NOT bit-identical'} "
          f"(max rel diff {max(max_rel(a, b) for a, b in zip(g[:4], g2[:4])):.3e})")

    s0 = jax.tree.map(np.asarray,
                      init_dpmf(jax.random.PRNGKey(seed), sl, 64, gb=gb))
    hyper = SgldHyper(eta=jnp.float32(5e-3 / m), temp=jnp.float32(1e-6),
                      bound=jnp.float32(dp_bound(0.0, 0, nv)),
                      ntrain=jnp.float32(m))
    g, c = both(sgld_epoch, s0, batches, hyper, jax.random.PRNGKey(seed + 3))
    compare("dpmf epoch GPU vs CPU",
            max(max_rel(a, b) for a, b in zip(g.params[:4], c.params[:4])),
            EPOCH_TOL, "scatter-add order; threefry noise is the same bits")
    check(np.array_equal(g.gcountu, c.gcountu), "SGLD noise clocks differ")

    a0 = jax.tree.map(np.asarray, init_admf(jax.random.PRNGKey(seed), nu, nv,
                                            64, lam=0.02, gb=gb))
    valid = (avalid.u, avalid.v, avalid.r)
    g, c = both(adreg_epoch, a0, batches, valid,
                (jnp.float32(0.01), jnp.float32(1e-3)), 0,
                jax.random.PRNGKey(seed + 4))
    compare("admf epoch GPU vs CPU",
            max(max_rel(a, b) for a, b in zip(g.params[:4], c.params[:4])),
            EPOCH_TOL, "scatter-add order")
    compare("admf learned lambdas GPU vs CPU",
            max_rel([g.lam_u, g.lam_v, g.lam_bu, g.lam_bv],
                    [c.lam_u, c.lam_v, c.lam_bu, c.lam_bv]),
            EPOCH_TOL, "sums of the same hypergradient terms")

    # Serving: the one float32 matrix product, at precision HIGHEST.
    users = np.arange(0, nu, max(1, nu // 256))[:256].astype(np.int32)
    g, c = both(score_all_items, p0, users)
    compare("score_all_items GPU vs CPU", max_rel(g, c), 1e-5,
            "HIGHEST precision: float32 sums of 128 products")


def run_four_cards(nu: int, nv: int, n: int, seed: int) -> None:
    """Phase (f): --alg mf --mesh 4 on four GPUs against 4 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_mf.config import TrainConfig
    from tpu_mf.data.blocker import partition_diagonal
    from tpu_mf.data.coo import RatingsCOO, calibrated_ratings
    from tpu_mf.models.mf import MFParams, init_mf
    from tpu_mf.parallel.dsgd import (
        dsgd_epoch, gather_params, put_blocks, shard_params,
    )
    from tpu_mf.parallel.mesh import AXIS
    from tpu_mf.train.loop import train_mf

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs, 4 needed")
    ds = calibrated_ratings(nu, nv, n, seed=seed)
    train, test = ds.split(0.1, seed=seed + 1)
    gb = train.mean_rating()
    p0 = jax.tree.map(np.asarray, init_mf(jax.random.PRNGKey(seed), nu, nv,
                                          128, gb=gb))

    def params0():
        return MFParams(*(jnp.asarray(x) for x in p0))

    lines = []
    cfg = TrainConfig(alg="mf", dim=128, iters=3, eta=0.02, lam=5e-3,
                      gam=0.3, gb=gb, batch_size=4096, seed=seed, mesh=4)
    train_mf(cfg, train, test_ds=test, params=params0(), log=lines.append)
    report_epochs("mf dim 128 --mesh 4", lines)

    m = min(1_000_000, len(train))
    sl = RatingsCOO(train.u[:m], train.v[:m], train.r[:m], nu, nv)
    one = TrainConfig(alg="mf", dim=128, iters=1, eta=0.02, lam=5e-3,
                      gb=gb, batch_size=4096, seed=seed, mesh=4)
    got = train_mf(one, sl, params=params0(), log=lambda s: None)
    cpu = Mesh(np.asarray(jax.devices("cpu")[:4]), (AXIS,))
    state = shard_params(cpu, params0(), gb)
    blocks = put_blocks(cpu, partition_diagonal(sl, 4, one.batch_size, seed))
    want = gather_params(dsgd_epoch(cpu, state, blocks, one.eta_at(1), one.lam))
    compare("mf --mesh 4 epoch, 4 GPUs vs 4 CPU devices",
            max(max_rel(a, b) for a, b in zip(got[:4], want[:4])),
            EPOCH_TOL, "same diagonal schedule; scatter-add order")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only --alg mf --mesh 4 and its CPU comparison")
    args = ap.parse_args(argv)

    import jax

    # Four CPU devices for the mesh comparison; must precede backend start.
    jax.config.update("jax_num_cpu_devices", 4)
    from tpu_mf.data.coo import ML10M_SHAPE
    from tpu_mf.runtime import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX reports {devs[0].platform} devices",
              file=sys.stderr)
        return 1
    print(card_lines(), flush=True)
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            run_four_cards(*ML10M_SHAPE, args.seed)
        else:
            run_one_card(*ML10M_SHAPE, args.seed)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
