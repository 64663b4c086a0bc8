"""NumPy sequential-SGD oracle: golden model for kernel tests.

Implements the reference's per-rating math exactly as written in the Hogwild
inner loop (reference: src/mf.h:94-109), but strictly sequentially — the
ground truth that both the batched JAX op (at batch size 1) and the Pallas
kernels are validated against (SURVEY §4 test strategy).
"""

from __future__ import annotations

import numpy as np


def sgd_sequential(theta, phi, bu, bv, gb, u, v, r, eta, lam):
    """Run sequential biased-MF SGD over ratings in order. Mutates copies."""
    theta = theta.astype(np.float64).copy()
    phi = phi.astype(np.float64).copy()
    bu = bu.astype(np.float64).copy()
    bv = bv.astype(np.float64).copy()
    lameta = 1.0 - eta * lam
    for i in range(len(u)):
        uu, vv = int(u[i]), int(v[i])
        err = eta * (
            r[i] - theta[uu] @ phi[vv] - bu[uu] - bv[vv] - gb
        )
        t_old = theta[uu].copy()
        theta[uu] = lameta * theta[uu] + err * phi[vv]
        phi[vv] = lameta * phi[vv] + err * t_old
        bu[uu] = lameta * bu[uu] + err
        bv[vv] = lameta * bv[vv] + err
    return theta, phi, bu, bv


def sgd_sequential_scan(theta, phi, bu, bv, gb, u, v, r, eta, lam):
    """The SAME per-rating sequential loop as sgd_sequential, expressed as a
    lax.scan so million-rating oracles finish in seconds. Math is float32,
    exactly like the reference's `float` tables (src/mf.h:94-109); the scan
    carries the full tables and each step updates one (user, item) pair —
    strictly sequential, no batching semantics anywhere.
    """
    import jax
    import jax.numpy as jnp

    lameta = np.float32(1.0 - eta * lam)
    eta = np.float32(eta)
    gb = np.float32(gb)

    def step(carry, x):
        theta, phi, bu, bv = carry
        uu, vv, rr = x
        t = theta[uu]
        p = phi[vv]
        err = eta * (rr - t @ p - bu[uu] - bv[vv] - gb)
        theta = theta.at[uu].set(lameta * t + err * p)
        phi = phi.at[vv].set(lameta * p + err * t)
        bu = bu.at[uu].set(lameta * bu[uu] + err)
        bv = bv.at[vv].set(lameta * bv[vv] + err)
        return (theta, phi, bu, bv), None

    carry = (
        jnp.asarray(theta, jnp.float32), jnp.asarray(phi, jnp.float32),
        jnp.asarray(bu, jnp.float32), jnp.asarray(bv, jnp.float32),
    )
    xs = (
        jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32),
        jnp.asarray(r, jnp.float32),
    )
    carry, _ = jax.jit(lambda c, x: jax.lax.scan(step, c, x))(carry, xs)
    return tuple(np.asarray(a) for a in carry)


def predict(theta, phi, bu, bv, gb, u, v):
    return np.einsum("nd,nd->n", theta[u], phi[v]) + bu[u] + bv[v] + gb


def rmse(theta, phi, bu, bv, gb, u, v, r):
    e = r - predict(theta, phi, bu, bv, gb, u, v)
    return float(np.sqrt(np.mean(e * e)))


def _act(score, loss):
    return 1.0 / (1.0 + np.exp(-score)) if loss == 1 else score


def sgld_sequential(params, lams, ur, vr, u, v, r, eta, temp, bound, ntrain,
                    noise, gcount=0, gcountu=None, gcountv=None):
    """Sequential DP-SGLD (reference: SgldFilter, src/dpmf.h:37-92).

    Per rating, in order: advance the global update counter; inject the lazy
    Langevin noise sqrt(temp*eta*c) * N(0,1) into theta_u/phi_v/bu_u/bv_v,
    c = updates since that row was last touched (dpmf.h:61-70); stamp the
    rows; then the privacy-scaled gradient step with inverse-frequency,
    per-dimension decay (dpmf.h:72-88).

    params = (theta, phi, bu, bv, gb); lams = (lambda_u (D,), lambda_v (D,),
    lambda_ub, lambda_vb, lambda_r). noise(i) returns the four standard
    normal draws (theta (D,), phi (D,), bu, bv) for rating i. Returns
    ((theta, phi, bu, bv), gcountu, gcountv, gcount) in float64.
    """
    theta, phi, bu, bv = (np.asarray(x, np.float64).copy() for x in params[:4])
    gb = float(params[4])
    lam_u, lam_v, lam_ub, lam_vb, lam_r = (np.asarray(x, np.float64) for x in lams)
    gcountu = np.zeros(len(bu), np.int64) if gcountu is None else np.array(gcountu[:len(bu)], np.int64)
    gcountv = np.zeros(len(bv), np.int64) if gcountv is None else np.array(gcountv[:len(bv)], np.int64)
    scal = eta * ntrain * bound * lam_r
    for i in range(len(u)):
        uu, vv = int(u[i]), int(v[i])
        gcount += 1
        cu, cv = gcount - gcountu[uu], gcount - gcountv[vv]
        nt, nphi, nbu, nbv = noise(i)
        theta[uu] += np.sqrt(temp * eta * cu) * nt
        phi[vv] += np.sqrt(temp * eta * cv) * nphi
        bu[uu] += np.sqrt(temp * eta * cu) * nbu
        bv[vv] += np.sqrt(temp * eta * cv) * nbv
        gcountu[uu] = gcountv[vv] = gcount
        err = scal * (r[i] - theta[uu] @ phi[vv] - bu[uu] - bv[vv] - gb)
        t_old = theta[uu].copy()
        theta[uu] = theta[uu] - eta * ur[uu] * bound * (lam_u * theta[uu]) + err * phi[vv]
        phi[vv] = phi[vv] - eta * vr[vv] * bound * (lam_v * phi[vv]) + err * t_old
        bu[uu] = (1 - eta * lam_ub * ur[uu] * bound) * bu[uu] + err
        bv[vv] = (1 - eta * lam_vb * vr[vv] * bound) * bv[vv] + err
    return (theta, phi, bu, bv), gcountu, gcountv, gcount


def adreg_sequential(params, shadow, lams, valid, u, v, r, eta, eta_reg, loss,
                     samples):
    """Sequential adaptive-regularization SGD (reference: AdRegFilter,
    src/admf.h:52-86; updateReg/updateUV/updateBias, model.h:86-102).

    Per rating: snapshot the rows into the shadow tables, take the SGD step
    with the four learned regularizers, then one hypergradient step on the
    lambdas, averaged over the validation records samples[i] (the reference
    draws one record per user; a batch of one rating has one user).

    params = (theta, phi, bu, bv, gb); shadow = (theta_old, phi_old,
    bu_old, bv_old); lams = (lam_u, lam_v, lam_bu, lam_bv); valid =
    (u, v, r). Returns (params4, shadow4, lams4) in float64.
    """
    theta, phi, bu, bv = (np.asarray(x, np.float64).copy() for x in params[:4])
    gb = float(params[4])
    to, po, buo, bvo = (np.asarray(x, np.float64).copy() for x in shadow)
    lam_u, lam_v, lam_bu, lam_bv = (float(x) for x in lams)
    vu, vv_, vr = (np.asarray(x) for x in valid)
    for i in range(len(u)):
        uu, vv = int(u[i]), int(v[i])
        t, p, b_u, b_v = theta[uu].copy(), phi[vv].copy(), bu[uu], bv[vv]
        to[uu], po[vv], buo[uu], bvo[vv] = t, p, b_u, b_v
        err = eta * (r[i] - _act(t @ p + b_u + b_v + gb, loss))
        theta[uu] = (1 - eta * lam_u) * t + err * p
        phi[vv] = (1 - eta * lam_v) * p + err * t
        bu[uu] = (1 - eta * lam_bu) * b_u + err
        bv[vv] = (1 - eta * lam_bv) * b_v + err
        k = np.asarray(samples[i])
        su, sv, sr = vu[k], vv_[k], vr[k]
        t_new, p_new = theta[su], phi[sv]
        grad = sr - _act(np.einsum("kd,kd->k", t_new, p_new) + bu[su] + bv[sv] + gb, loss)
        scale = eta_reg * eta / len(k)
        lam_u = max(0.0, lam_u - scale * np.sum(grad * np.einsum("kd,kd->k", to[su], p_new)))
        lam_v = max(0.0, lam_v - scale * np.sum(grad * np.einsum("kd,kd->k", t_new, po[sv])))
        lam_bu = max(0.0, lam_bu - scale * np.sum(grad * buo[su]))
        lam_bv = max(0.0, lam_bv - scale * np.sum(grad * bvo[sv]))
    return (theta, phi, bu, bv), (to, po, buo, bvo), (lam_u, lam_v, lam_bu, lam_bv)
