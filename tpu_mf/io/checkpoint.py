"""Checkpoint save/load.

Two formats:

1. **Reference-binary** — byte-compatible with the reference's dumps so models
   can move between the CPU trainer and this framework. Layout (reference:
   MF::save_model model.cc:98-122 / read_model model.cc:75-97):

       int32 nv, int32 nu, int32 dim, float lambda,
       float bv[nv], float phi[nv][dim], float bu[nu], float theta[nu][dim]

   The DPMF variant inserts the sampled hyperparameters after the header
   (reference: model.cc:123-151 / 169-195):

       int32 nv, nu, dim, float lambda_r, lambda_ub, lambda_vb,
       float lambda_u[dim], float lambda_v[dim], then bv/phi/bu/theta as above

   Files are named ``{result}_{round}`` when saved periodically (reference:
   model.cc:100; cadence round>=100 && round%20==0 at model.cc:309).

2. **Native npz** — full training state (params + hyper state + RNG key +
   round counter) for exact resume; the native default.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from tpu_mf.models.mf import MFParams


def _params_to_host(params: MFParams):
    return (
        np.asarray(params.theta, np.float32),
        np.asarray(params.phi, np.float32),
        np.asarray(params.bu, np.float32),
        np.asarray(params.bv, np.float32),
        float(np.asarray(params.gb)),
    )


def save_mf_binary(path: str, params: MFParams, lam: float) -> None:
    theta, phi, bu, bv, _ = _params_to_host(params)
    nu, dim = theta.shape
    nv = phi.shape[0]
    with open(path, "wb") as f:
        np.asarray([nv, nu, dim], np.int32).tofile(f)
        np.asarray([lam], np.float32).tofile(f)
        bv.tofile(f)
        phi.tofile(f)
        bu.tofile(f)
        theta.tofile(f)


def load_mf_binary(path: str, gb: float = 2.76) -> Tuple[MFParams, float]:
    """Load a reference-format MF checkpoint. Returns (params, lambda).

    The reference file does not store gb (commented out, model.cc:106-107),
    so it must be supplied, as the reference does via --bias.
    """
    with open(path, "rb") as f:
        nv, nu, dim = np.fromfile(f, np.int32, 3)
        (lam,) = np.fromfile(f, np.float32, 1)
        bv = np.fromfile(f, np.float32, nv)
        phi = np.fromfile(f, np.float32, nv * dim).reshape(nv, dim)
        bu = np.fromfile(f, np.float32, nu)
        theta = np.fromfile(f, np.float32, nu * dim).reshape(nu, dim)
    params = MFParams(
        theta=jnp.asarray(theta),
        phi=jnp.asarray(phi),
        bu=jnp.asarray(bu),
        bv=jnp.asarray(bv),
        gb=jnp.float32(gb),
    )
    return params, float(lam)


def save_dpmf_binary(
    path: str,
    params: MFParams,
    lambda_r: float,
    lambda_ub: float,
    lambda_vb: float,
    lambda_u: np.ndarray,
    lambda_v: np.ndarray,
) -> None:
    theta, phi, bu, bv, _ = _params_to_host(params)
    nu, dim = theta.shape
    nv = phi.shape[0]
    with open(path, "wb") as f:
        np.asarray([nv, nu, dim], np.int32).tofile(f)
        np.asarray([lambda_r, lambda_ub, lambda_vb], np.float32).tofile(f)
        np.asarray(lambda_u, np.float32).tofile(f)
        np.asarray(lambda_v, np.float32).tofile(f)
        bv.tofile(f)
        phi.tofile(f)
        bu.tofile(f)
        theta.tofile(f)


def load_dpmf_hyper(path: str):
    """Hyperparameter-only warm start (reference: DPMF::read_hyper model.cc:153-167)."""
    with open(path, "rb") as f:
        nv, nu, dim = np.fromfile(f, np.int32, 3)
        lambda_r, lambda_ub, lambda_vb = np.fromfile(f, np.float32, 3)
        lambda_u = np.fromfile(f, np.float32, dim)
        lambda_v = np.fromfile(f, np.float32, dim)
    return (
        float(lambda_r),
        float(lambda_ub),
        float(lambda_vb),
        lambda_u,
        lambda_v,
    )


def load_dpmf_binary(path: str, gb: float = 2.76):
    """Full DPMF checkpoint load (reference: DPMF::read_model model.cc:169-195)."""
    with open(path, "rb") as f:
        nv, nu, dim = np.fromfile(f, np.int32, 3)
        lambda_r, lambda_ub, lambda_vb = np.fromfile(f, np.float32, 3)
        lambda_u = np.fromfile(f, np.float32, dim)
        lambda_v = np.fromfile(f, np.float32, dim)
        bv = np.fromfile(f, np.float32, nv)
        phi = np.fromfile(f, np.float32, nv * dim).reshape(nv, dim)
        bu = np.fromfile(f, np.float32, nu)
        theta = np.fromfile(f, np.float32, nu * dim).reshape(nu, dim)
    params = MFParams(
        theta=jnp.asarray(theta),
        phi=jnp.asarray(phi),
        bu=jnp.asarray(bu),
        bv=jnp.asarray(bv),
        gb=jnp.float32(gb),
    )
    return params, (
        float(lambda_r),
        float(lambda_ub),
        float(lambda_vb),
        lambda_u,
        lambda_v,
    )


def save_npz(path: str, params: MFParams, **extra) -> None:
    """Native full-state checkpoint (params + any algorithm state)."""
    theta, phi, bu, bv, gb = _params_to_host(params)
    np.savez(path, theta=theta, phi=phi, bu=bu, bv=bv, gb=gb, **extra)


def load_npz(path: str):
    """Load a native checkpoint. Returns (params, dict-of-extras)."""
    with np.load(path, allow_pickle=False) as z:
        params = MFParams(
            theta=jnp.asarray(z["theta"]),
            phi=jnp.asarray(z["phi"]),
            bu=jnp.asarray(z["bu"]),
            bv=jnp.asarray(z["bv"]),
            gb=jnp.asarray(z["gb"], jnp.float32),
        )
        extras = {
            k: z[k] for k in z.files if k not in ("theta", "phi", "bu", "bv", "gb")
        }
    return params, extras


def save_orbax(path: str, params: MFParams, **extra) -> None:
    """Orbax checkpoint of the full state (directory-based, async-capable).

    The production-grade alternative to npz for large sharded tables
    (SURVEY §5 checkpoint row). Requires orbax-checkpoint (baked into the
    environment); extras must be array-like.
    """
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    state = {
        "theta": params.theta,
        "phi": params.phi,
        "bu": params.bu,
        "bv": params.bv,
        "gb": params.gb,
        **extra,
    }
    ckptr.save(os.path.abspath(path), state, force=True)
    ckptr.wait_until_finished()


def load_orbax(path: str):
    """Load an Orbax checkpoint. Returns (params, dict-of-extras)."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    state = ckptr.restore(os.path.abspath(path))
    params = MFParams(
        theta=jnp.asarray(state["theta"]),
        phi=jnp.asarray(state["phi"]),
        bu=jnp.asarray(state["bu"]),
        bv=jnp.asarray(state["bv"]),
        gb=jnp.asarray(state["gb"], jnp.float32),
    )
    extras = {k: v for k, v in state.items()
              if k not in ("theta", "phi", "bu", "bv", "gb")}
    return params, extras
