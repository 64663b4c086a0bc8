"""Training orchestrators — one per algorithm, like the reference's run() overloads.

Reference: src/main.cc:36-93. Each orchestrator initializes the model
(optionally warm-starting from a checkpoint), loads the test set, and runs the
epoch loop, printing the reference's per-epoch line:

    iter#<n>\t<elapsed>\ttRMSE=<rmse>          (reference: src/mf.h:35)

The TBB pipeline (read -> parse -> update, reference src/mf.h:6-70) becomes:
host-side batch preparation + device scan (tpu_mf.ops.sgd.sgd_epoch), or with
--mesh N the diagonal-block scan of parallel/dsgd.py (mf only).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_mf.config import TrainConfig
from tpu_mf.data.coo import RatingsCOO, epoch_batches
from tpu_mf.models.admf import AdaptRegState, init_admf
from tpu_mf.models.dpmf import DPMFState, dp_bound, init_dpmf
from tpu_mf.models.mf import MFParams, calc_mse, init_mf, rmse
from tpu_mf.ops.adreg import adreg_epoch
from tpu_mf.ops.gibbs import sample_hyper
from tpu_mf.ops.sgd import sgd_epoch
from tpu_mf.ops.sgld import SgldHyper, finish_noise, sgld_epoch
from tpu_mf.train.metrics import MetricsLogger, profile_trace


class _Observer:
    """Wires the SURVEY §5 observability/recovery subsystems into the loops.

    The reference's observability is printf only; here --metrics appends
    JSONL (eta, RMSE, updates/sec), --trace captures a jax.profiler trace,
    and --resume writes atomic per-round state checkpoints under
    ``<result>.state.*`` and restarts from the newest one (io/resume.py).
    """

    def __init__(self, cfg: TrainConfig, n_train: int,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.n_train = n_train
        self.ml = MetricsLogger(cfg.metrics) if cfg.metrics else None
        self.prefix = (
            f"{cfg.result}.state" if (cfg.resume and cfg.result) else None
        )
        self._log = log
        self._diverged = False

    def trace(self):
        return profile_trace(self.cfg.trace)

    def resume(self):
        """(start_round, params, extras) from the newest checkpoint, if any."""
        if self.prefix is None:
            return 0, None, None
        from tpu_mf.io.resume import load_round, resume_round

        rnd = resume_round(self.prefix)
        if rnd == 0:
            return 0, None, None
        params, extras = load_round(self.prefix)
        return rnd, params, extras

    def epoch_done(self, rnd: int, params_fn=None, extras_fn=None, **fields):
        """Record one finished round: metrics line + resume checkpoint.

        params_fn/extras_fn are lazy so the mesh path only gathers its
        sharded tables when a checkpoint is actually being written.
        """
        if not self._diverged:
            # Once-per-run divergence diagnosis: batched/Hogwild SGD
            # overshoots when eta x (repeats of one row inside an apply
            # window) is too large — the reference tolerates the same via
            # its lock-free races (src/mf.h:72-133) but a bare nan tRMSE
            # column is a miserable way to learn that.
            for k in ("tRMSE", "RMSE"):
                v = fields.get(k)
                if v is not None and not np.isfinite(v):
                    self._diverged = True
                    self._log(
                        f"# WARNING: non-finite {k} at round {rnd} — SGD "
                        "diverged. A row repeated k times inside one apply "
                        "window takes k gradients computed at the same "
                        "point; at this eta and duplicate density that "
                        "overshoots (bias terms first). Reduce --eta, "
                        "raise --gam (faster decay), or shrink --batch."
                    )
                    break
        if self.ml is not None:
            self.ml.count_updates(self.n_train)
            self.ml.log(round=rnd, **fields)
        if (
            self.prefix is not None
            and params_fn is not None
            and rnd % max(1, self.cfg.resume_every) == 0
        ):
            from tpu_mf.io.resume import save_round

            extras = extras_fn() if extras_fn is not None else {}
            save_round(self.prefix, rnd, params_fn(), **extras)

    def close(self):
        if self.ml is not None:
            self.ml.close()


def train_mf(
    cfg: TrainConfig,
    train_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    params: Optional[MFParams] = None,
    log: Callable[[str], None] = print,
    device_shuffle: bool = True,
) -> MFParams:
    """Vanilla biased-MF SGD training (reference: run(MF&), src/main.cc:36-52).

    Per epoch: reshuffle ratings, scan the batched SGD update, decay the
    learning rate as eta0/round**gam (reference: model.cc:36-38), and report
    test RMSE in the reference's format.
    """
    nu, nv = train_ds.nu, train_ds.nv
    if params is None:
        key = jax.random.PRNGKey(cfg.seed)
        params = init_mf(key, nu, nv, cfg.dim, gb=cfg.gb, dtype=jnp.dtype(cfg.dtype))

    obs = _Observer(cfg, len(train_ds), log)
    start, rparams, _ = obs.resume()
    if rparams is not None:
        params = rparams
        log(f"# resumed from round {start} ({obs.prefix})")
    try:
        with obs.trace():
            if cfg.mesh > 1:
                return _train_mf_sharded(
                    cfg, train_ds, test_ds, params, log, obs, start
                )

            # Static batch layout; per-epoch shuffle permutes within it on
            # device.
            flat, shuffle = _static_batches(train_ds, cfg.batch_size)

            t0 = time.perf_counter()
            for it in range(start + 1, cfg.iters + 1):
                eta_r = jnp.float32(cfg.eta_at(it))
                lam = jnp.float32(cfg.lam)
                if device_shuffle:
                    kshuf = jax.random.fold_in(
                        jax.random.PRNGKey(cfg.seed ^ 0x5F5E), it
                    )
                    batches = shuffle(kshuf, *flat)
                else:
                    eu, ev, er, ew = epoch_batches(
                        train_ds, cfg.batch_size, it, cfg.seed
                    )
                    batches = tuple(jnp.asarray(x) for x in (eu, ev, er, ew))
                params = sgd_epoch(params, batches, eta_r, lam)
                jax.block_until_ready(params.theta)
                elapsed = time.perf_counter() - t0
                t_rmse = None
                if test_ds is not None:
                    t_rmse = float(rmse(params, test_ds))
                    # Reference prints cumulative elapsed (src/mf.h:33-35).
                    log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
                else:
                    log(f"iter#{it}\t{elapsed:f}")
                obs.epoch_done(
                    it, params_fn=lambda: params, alg="mf",
                    eta=float(eta_r), elapsed=elapsed, tRMSE=t_rmse,
                )
            return params
    finally:
        obs.close()


def _train_mf_sharded(cfg, train_ds, test_ds, params, log, obs=None, start=0) -> MFParams:
    """MF training over a --mesh N device mesh (diagonal-block DSGD,
    parallel/dsgd.py)."""
    from tpu_mf.data.blocker import partition_diagonal
    from tpu_mf.parallel.dsgd import (
        dsgd_epoch,
        gather_params,
        put_blocks,
        shard_params,
    )
    from tpu_mf.parallel.mesh import make_mesh

    mesh = make_mesh(cfg.mesh)
    t0 = time.perf_counter()
    blocks = put_blocks(
        mesh, partition_diagonal(train_ds, cfg.mesh, cfg.batch_size, cfg.seed)
    )
    state = shard_params(mesh, params, cfg.gb)
    for it in range(start + 1, cfg.iters + 1):
        state = dsgd_epoch(mesh, state, blocks, cfg.eta_at(it), cfg.lam)
        jax.block_until_ready(state.theta)
        elapsed = time.perf_counter() - t0
        t_rmse = None
        if test_ds is not None:
            t_rmse = float(rmse(gather_params(state), test_ds))
            log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
        else:
            log(f"iter#{it}\t{elapsed:f}")
        if obs is not None:
            obs.epoch_done(
                it, params_fn=lambda: gather_params(state), alg="mf",
                kernel="xla-sharded", eta=cfg.eta_at(it),
                elapsed=elapsed, tRMSE=t_rmse,
            )
    return gather_params(state)


def train_mf_stream(
    cfg: TrainConfig,
    path: str,
    test_ds: Optional[RatingsCOO] = None,
    params: Optional[MFParams] = None,
    nu: Optional[int] = None,
    nv: Optional[int] = None,
    log: Callable[[str], None] = print,
) -> MFParams:
    """Out-of-core MF training from an on-disk stream (any format): the
    per-batch SGD step fed by the prefetching reader (io/stream.py).
    Reference: the TBB read pipeline, src/mf.h:6-70.
    """
    from tpu_mf.data.streamfmt import scan_stats
    from tpu_mf.io.stream import streaming_sgd_epoch

    cfg.check_mesh("mf", stream=True)
    if params is None:
        if not (nu and nv):
            nu, nv, _ = scan_stats(path)
        key = jax.random.PRNGKey(cfg.seed)
        params = init_mf(key, nu, nv, cfg.dim, gb=cfg.gb,
                         dtype=jnp.dtype(cfg.dtype))

    obs = _Observer(cfg, 0, log)
    start, rparams, _ = obs.resume()
    if rparams is not None:
        params = rparams
        log(f"# resumed from round {start} ({obs.prefix})")

    try:
        with obs.trace():
            t0 = time.perf_counter()
            for it in range(start + 1, cfg.iters + 1):
                params, n = streaming_sgd_epoch(
                    params, path, cfg.eta_at(it), cfg.lam,
                    batch_size=cfg.batch_size, fly=cfg.fly,
                )
                jax.block_until_ready(params.theta)
                obs.n_train = n
                elapsed = time.perf_counter() - t0
                t_rmse = None
                if test_ds is not None:
                    t_rmse = float(rmse(params, test_ds))
                    log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
                else:
                    log(f"iter#{it}\t{elapsed:f}")
                obs.epoch_done(
                    it, params_fn=lambda: params, alg="mf",
                    kernel="xla-stream", eta=cfg.eta_at(it),
                    elapsed=elapsed, tRMSE=t_rmse,
                )
            return params
    finally:
        obs.close()


def train_dpmf_stream(
    cfg: TrainConfig,
    path: str,
    test_ds: Optional[RatingsCOO] = None,
    log: Callable[[str], None] = print,
    save_fn=None,
    hyper0=None,
) -> DPMFState:
    """Out-of-core DP-SGLD training from an on-disk stream.

    Per round: streamed SGLD pass (io/stream.streaming_sgld_round), lazy-
    noise flush, streamed train-MSE for the Gibbs SSE, precision resampling —
    the round structure of train_dpmf with every full-data pass streamed
    (reference: src/dpmf.h:6-34).
    """
    from tpu_mf.data.streamfmt import scan_profile
    from tpu_mf.io.stream import streaming_mse, streaming_sgld_round

    cfg.check_mesh("dpmf", stream=True)
    nu, nv, ntrain, uc, vc, rsum = scan_profile(path)
    key = jax.random.PRNGKey(cfg.seed)
    params = init_mf(key, nu, nv, cfg.dim, gb=cfg.gb,
                     dtype=jnp.dtype(cfg.dtype))
    state = DPMFState(
        params=params,
        lambda_r=jnp.float32(1.0),
        lambda_ub=jnp.float32(1e2),
        lambda_vb=jnp.float32(1e2),
        lambda_u=jnp.full((cfg.dim,), 1e2, jnp.float32),
        lambda_v=jnp.full((cfg.dim,), 1e2, jnp.float32),
        ur=jnp.asarray((ntrain / np.maximum(uc, 1)).astype(np.float32)),
        vr=jnp.asarray((ntrain / np.maximum(vc, 1)).astype(np.float32)),
        gcountu=jnp.zeros(nu + 1, jnp.int32),
        gcountv=jnp.zeros(nv + 1, jnp.int32),
        gcount=jnp.int32(0),
    )
    if hyper0 is not None:
        # Hyper-only warm start (reference: read_hyper, model.cc:153-167)
        # composed with streaming: load-before-stream, main.cc:57.
        lr, lub, lvb, lu, lv = hyper0
        state = state._replace(
            lambda_r=jnp.float32(lr),
            lambda_ub=jnp.float32(lub),
            lambda_vb=jnp.float32(lvb),
            lambda_u=jnp.asarray(lu),
            lambda_v=jnp.asarray(lv),
        )
    bound = dp_bound(cfg.epsilon, cfg.tau, nv)
    base_key = jax.random.PRNGKey(cfg.seed ^ 0xD1FF)

    obs = _Observer(cfg, ntrain, log)
    start, rparams, rex = obs.resume()
    if rparams is not None:
        state = state._replace(
            params=rparams,
            lambda_r=jnp.float32(rex["lambda_r"]),
            lambda_ub=jnp.float32(rex["lambda_ub"]),
            lambda_vb=jnp.float32(rex["lambda_vb"]),
            lambda_u=jnp.asarray(rex["lambda_u"]),
            lambda_v=jnp.asarray(rex["lambda_v"]),
            gcountu=jnp.asarray(rex["gcountu"]),
            gcountv=jnp.asarray(rex["gcountv"]),
            gcount=jnp.int32(rex["gcount"]),
        )
        log(f"# resumed from round {start} ({obs.prefix})")

    t0 = time.perf_counter()
    try:
        with obs.trace():
            for rnd in range(start + 1, cfg.iters + 1):
                eta_r = cfg.eta_at_cutoff(rnd)
                hyper = SgldHyper(
                    eta=jnp.float32(eta_r),
                    temp=jnp.float32(cfg.temp),
                    bound=jnp.float32(bound),
                    ntrain=jnp.float32(ntrain),
                )
                state, _ = streaming_sgld_round(
                    state, path, hyper,
                    jax.random.fold_in(base_key, rnd),
                    batch_size=cfg.batch_size, fly=cfg.fly,
                )
                state = finish_noise(
                    state, jnp.float32(eta_r), jnp.float32(cfg.temp),
                    jax.random.fold_in(base_key, rnd + 500_000),
                )
                train_mse = streaming_mse(state.params, path)
                state = sample_hyper(
                    state,
                    jnp.float32(train_mse * ntrain),
                    jnp.float32(ntrain),
                    jnp.float32(cfg.hypera),
                    jnp.float32(cfg.hyperb),
                    jax.random.fold_in(base_key, rnd + 1_000_000),
                )
                elapsed = time.perf_counter() - t0
                t_rmse = None
                if test_ds is not None:
                    t_rmse = float(rmse(state.params, test_ds))
                    log(
                        f"round #{rnd}\tRMSE={np.sqrt(train_mse):f}\t"
                        f"tRMSE={t_rmse:f}\t{elapsed:f}"
                    )
                else:
                    log(f"round #{rnd}\tRMSE={np.sqrt(train_mse):f}\t{elapsed:f}")
                obs.epoch_done(
                    rnd, params_fn=lambda: state.params,
                    extras_fn=lambda: dict(
                        lambda_r=np.float32(state.lambda_r),
                        lambda_ub=np.float32(state.lambda_ub),
                        lambda_vb=np.float32(state.lambda_vb),
                        lambda_u=np.asarray(state.lambda_u),
                        lambda_v=np.asarray(state.lambda_v),
                        gcountu=np.asarray(state.gcountu),
                        gcountv=np.asarray(state.gcountv),
                        gcount=np.int32(state.gcount),
                    ),
                    alg="dpmf", kernel="xla-stream", eta=eta_r,
                    elapsed=elapsed, RMSE=float(np.sqrt(train_mse)),
                    tRMSE=t_rmse,
                )
                if save_fn is not None and rnd >= 100 and rnd % 20 == 0:
                    save_fn(state, rnd)
            return state
    finally:
        obs.close()


def train_admf_stream(
    cfg: TrainConfig,
    path: str,
    valid_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    log: Callable[[str], None] = print,
) -> AdaptRegState:
    """Out-of-core AdaptReg training from an on-disk stream (reference:
    src/admf.h:6-46); the validation sample stays in memory (it is small)."""
    from tpu_mf.data.streamfmt import scan_stats
    from tpu_mf.io.stream import streaming_adreg_epoch
    from tpu_mf.ops.adreg import AdRegHyper

    cfg.check_mesh("admf", stream=True)
    nu, nv, ntrain = scan_stats(path)
    key = jax.random.PRNGKey(cfg.seed)
    state = init_admf(
        key, nu, nv, cfg.dim, lam=cfg.lam, gb=cfg.gb, dtype=jnp.dtype(cfg.dtype)
    )
    obs = _Observer(cfg, ntrain, log)
    start, rparams, rex = obs.resume()
    if rparams is not None:
        state = state._replace(
            params=rparams,
            theta_old=jnp.copy(rparams.theta),
            phi_old=jnp.copy(rparams.phi),
            bu_old=jnp.copy(rparams.bu),
            bv_old=jnp.copy(rparams.bv),
            lam_u=jnp.float32(rex["lam_u"]),
            lam_v=jnp.float32(rex["lam_v"]),
            lam_bu=jnp.float32(rex["lam_bu"]),
            lam_bv=jnp.float32(rex["lam_bv"]),
        )
        log(f"# resumed from round {start} ({obs.prefix})")

    valid = (
        jnp.asarray(valid_ds.u),
        jnp.asarray(valid_ds.v),
        jnp.asarray(valid_ds.r),
    )
    base_key = jax.random.PRNGKey(cfg.seed ^ 0xADF0)
    t0 = time.perf_counter()
    try:
        with obs.trace():
            for it in range(start + 1, cfg.iters + 1):
                hyper = AdRegHyper(
                    eta=jnp.float32(cfg.eta_at(it)),
                    eta_reg=jnp.float32(cfg.eta_reg_at(it)),
                    loss=cfg.loss,
                )
                state, _ = streaming_adreg_epoch(
                    state, path, valid, hyper,
                    jax.random.fold_in(base_key, it),
                    batch_size=cfg.batch_size, fly=cfg.fly,
                )
                elapsed = time.perf_counter() - t0
                t_rmse = None
                if test_ds is not None:
                    t_rmse = float(rmse(state.params, test_ds))
                    log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
                else:
                    log(f"iter#{it}\t{elapsed:f}")
                obs.epoch_done(
                    it, params_fn=lambda: state.params,
                    extras_fn=lambda: _admf_extras(state),
                    alg="admf", kernel="xla-stream", eta=cfg.eta_at(it),
                    elapsed=elapsed, tRMSE=t_rmse,
                )
            return state
    finally:
        obs.close()


def _static_batches(ds: RatingsCOO, batch_size: int):
    u, v, r, w = ds.to_batches(batch_size)
    nb, bsz = u.shape
    flat = tuple(
        jnp.asarray(x.reshape(-1)) for x in (u, v, r, w)
    )

    @jax.jit
    def shuffle(key, fu, fv, fr, fw):
        p = jax.random.permutation(key, fu.shape[0])
        return tuple(x[p].reshape(nb, bsz) for x in (fu, fv, fr, fw))

    return flat, shuffle


def train_dpmf(
    cfg: TrainConfig,
    train_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    state: Optional[DPMFState] = None,
    log: Callable[[str], None] = print,
    save_fn: Optional[Callable[[DPMFState, int], None]] = None,
) -> DPMFState:
    """DP-SGLD training (reference: run(DPMF&) src/main.cc:55-74).

    Per round: one pass over the data with the batched SGLD step
    (ops/sgld.py), then the round finalization of DPMF::finish_round
    (model.cc:299-310): flush lazy noise, report train/test RMSE,
    Gibbs-resample the precisions, decay eta with the mineta clamp, and
    checkpoint on the reference's cadence (round >= 100 and round % 20 == 0).

    Stability note (inherent to the algorithm, same as the reference's math,
    dpmf.h:50): the effective per-rating step is eta*ntrain*bound*lambda_r
    and the per-occurrence decay is eta*bound*invfreq*lambda; keep
    eta*ntrain*lambda_r below ~0.1 and raise --hyperb to damp the Gibbs
    growth of lambda_r as the fit improves, or training diverges.
    """
    cfg.check_mesh("dpmf")
    if state is None:
        key = jax.random.PRNGKey(cfg.seed)
        state = init_dpmf(
            key, train_ds, cfg.dim, gb=cfg.gb, dtype=jnp.dtype(cfg.dtype)
        )
    ntrain = len(train_ds)
    bound = dp_bound(cfg.epsilon, cfg.tau, train_ds.nv)

    obs = _Observer(cfg, ntrain, log)
    start, rparams, rex = obs.resume()
    if rparams is not None:
        # Full SGLD state round-trips: params + Gibbs precisions + lazy-noise
        # counters (ur/vr are recomputed deterministically by init_dpmf).
        state = state._replace(
            params=rparams,
            lambda_r=jnp.float32(rex["lambda_r"]),
            lambda_ub=jnp.float32(rex["lambda_ub"]),
            lambda_vb=jnp.float32(rex["lambda_vb"]),
            lambda_u=jnp.asarray(rex["lambda_u"]),
            lambda_v=jnp.asarray(rex["lambda_v"]),
            gcountu=jnp.asarray(rex["gcountu"]),
            gcountv=jnp.asarray(rex["gcountv"]),
            gcount=jnp.int32(rex["gcount"]),
        )
        log(f"# resumed from round {start} ({obs.prefix})")

    flat, shuffle = _static_batches(train_ds, cfg.batch_size)
    base_key = jax.random.PRNGKey(cfg.seed ^ 0xD1FF)

    def dpmf_extras(s: DPMFState) -> dict:
        return dict(
            lambda_r=np.float32(s.lambda_r),
            lambda_ub=np.float32(s.lambda_ub),
            lambda_vb=np.float32(s.lambda_vb),
            lambda_u=np.asarray(s.lambda_u),
            lambda_v=np.asarray(s.lambda_v),
            gcountu=np.asarray(s.gcountu),
            gcountv=np.asarray(s.gcountv),
            gcount=np.int32(s.gcount),
        )

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.callback(obs.close)
        stack.enter_context(obs.trace())
        for rnd in range(start + 1, cfg.iters + 1):
            eta_r = cfg.eta_at_cutoff(rnd)
            hyper = SgldHyper(
                eta=jnp.float32(eta_r),
                temp=jnp.float32(cfg.temp),
                bound=jnp.float32(bound),
                ntrain=jnp.float32(ntrain),
            )
            kshuf = jax.random.fold_in(
                jax.random.PRNGKey(cfg.seed ^ 0x5A5A), rnd
            )
            batches = shuffle(kshuf, *flat)
            knoise = jax.random.fold_in(base_key, rnd)
            state = sgld_epoch(state, batches, hyper, knoise)
            state = finish_noise(
                state,
                jnp.float32(eta_r),
                jnp.float32(cfg.temp),
                jax.random.fold_in(base_key, rnd + 500_000),
            )
            # Train-sample SSE drives the lambda_r posterior; the reference's
            # "sample" is the full train set (model.cc:273-274 quirk, SURVEY §7).
            train_mse = calc_mse(
                state.params, train_ds.u, train_ds.v, train_ds.r, cfg.eval_batch
            )
            sse = train_mse * ntrain
            state = sample_hyper(
                state,
                jnp.float32(sse),
                jnp.float32(ntrain),
                jnp.float32(cfg.hypera),
                jnp.float32(cfg.hyperb),
                jax.random.fold_in(base_key, rnd + 1_000_000),
            )
            elapsed = time.perf_counter() - t0
            t_rmse = None
            if test_ds is not None:
                t_rmse = float(rmse(state.params, test_ds))
                log(
                    f"round #{rnd}\tRMSE={np.sqrt(train_mse):f}\t"
                    f"tRMSE={t_rmse:f}\t{elapsed:f}"
                )
            else:
                log(f"round #{rnd}\tRMSE={np.sqrt(train_mse):f}\t{elapsed:f}")
            obs.epoch_done(
                rnd,
                params_fn=lambda: state.params,
                extras_fn=lambda: dpmf_extras(state),
                alg="dpmf", eta=eta_r, elapsed=elapsed,
                RMSE=float(np.sqrt(train_mse)), tRMSE=t_rmse,
                lambda_r=float(state.lambda_r),
            )
            if save_fn is not None and rnd >= 100 and rnd % 20 == 0:
                save_fn(state, rnd)
    return state


def train_admf(
    cfg: TrainConfig,
    train_ds: RatingsCOO,
    valid_ds: RatingsCOO,
    test_ds: Optional[RatingsCOO] = None,
    state: Optional[AdaptRegState] = None,
    log: Callable[[str], None] = print,
) -> AdaptRegState:
    """Adaptive-regularization training (reference: run(AdaptRegMF&)
    src/main.cc:77-93). The validation set plays the role of the reference's
    shuffled Record vector (plain_read_valid, model.cc:390-415)."""
    cfg.check_mesh("admf")
    nu, nv = train_ds.nu, train_ds.nv
    if state is None:
        key = jax.random.PRNGKey(cfg.seed)
        state = init_admf(
            key, nu, nv, cfg.dim, lam=cfg.lam, gb=cfg.gb, dtype=jnp.dtype(cfg.dtype)
        )

    obs = _Observer(cfg, len(train_ds), log)
    start, rparams, rex = obs.resume()
    if rparams is not None:
        # Shadow tables restart as copies of the restored params — the same
        # "no previous update yet" state a fresh epoch begins with.
        state = state._replace(
            params=rparams,
            theta_old=jnp.copy(rparams.theta),
            phi_old=jnp.copy(rparams.phi),
            bu_old=jnp.copy(rparams.bu),
            bv_old=jnp.copy(rparams.bv),
            lam_u=jnp.float32(rex["lam_u"]),
            lam_v=jnp.float32(rex["lam_v"]),
            lam_bu=jnp.float32(rex["lam_bu"]),
            lam_bv=jnp.float32(rex["lam_bv"]),
        )
        log(f"# resumed from round {start} ({obs.prefix})")

    valid = (
        jnp.asarray(valid_ds.u),
        jnp.asarray(valid_ds.v),
        jnp.asarray(valid_ds.r),
    )
    flat, shuffle = _static_batches(train_ds, cfg.batch_size)
    base_key = jax.random.PRNGKey(cfg.seed ^ 0xADF0)

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.callback(obs.close)
        stack.enter_context(obs.trace())
        for it in range(start + 1, cfg.iters + 1):
            kshuf = jax.random.fold_in(jax.random.PRNGKey(cfg.seed ^ 0x7E57), it)
            batches = shuffle(kshuf, *flat)
            state = adreg_epoch(
                state,
                batches,
                valid,
                (jnp.float32(cfg.eta_at(it)), jnp.float32(cfg.eta_reg_at(it))),
                cfg.loss,
                jax.random.fold_in(base_key, it),
            )
            jax.block_until_ready(state.params.theta)
            elapsed = time.perf_counter() - t0
            t_rmse = None
            if test_ds is not None:
                t_rmse = float(rmse(state.params, test_ds))
                log(f"iter#{it}\t{elapsed:f}\ttRMSE={t_rmse:f}")
            else:
                log(f"iter#{it}\t{elapsed:f}")
            obs.epoch_done(
                it,
                params_fn=lambda: state.params,
                extras_fn=lambda: _admf_extras(state),
                alg="admf", eta=cfg.eta_at(it), elapsed=elapsed, tRMSE=t_rmse,
            )
    return state


def _admf_extras(s: AdaptRegState) -> dict:
    return dict(
        lam_u=np.float32(s.lam_u), lam_v=np.float32(s.lam_v),
        lam_bu=np.float32(s.lam_bu), lam_bv=np.float32(s.lam_bv),
    )
