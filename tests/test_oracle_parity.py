"""Batched epochs against the sequential per-rating oracles (tests/oracle.py).

At batch size 1 every algorithm's batched step is the reference's sequential
update; these tests hold each plain epoch (ops/sgd.py, ops/sgld.py,
ops/adreg.py) to that over the ranks the reference sweeps (src/run.py:13,
up to 2048) and over duplicate patterns. They also pin the two rules a batch
of B > 1 adds: geometric decay (1-d)^k for a row touched k times, and
weight-0 padding slots that change nothing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.oracle import adreg_sequential, sgd_sequential, sgld_sequential
from tpu_mf.models.admf import AdaptRegState
from tpu_mf.models.dpmf import DPMFState
from tpu_mf.models.mf import MFParams
from tpu_mf.ops.adreg import AdRegHyper, adreg_batch_update, adreg_epoch
from tpu_mf.ops.common import occurrence_stats, pad_to_oob
from tpu_mf.ops.sgd import sgd_batch_update, sgd_epoch
from tpu_mf.ops.sgld import SgldHyper, finish_noise, sgld_batch_update, sgld_epoch

NU, NV, N = 13, 9, 40
PATTERNS = ["distinct", "one_user", "one_item", "one_pair", "skewed"]


def ids(pattern, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if pattern == "distinct":
        u, v = np.arange(n) % NU, (np.arange(n) * 5) % NV
    elif pattern == "one_user":
        u, v = np.full(n, 3), rng.integers(0, NV, n)
    elif pattern == "one_item":
        u, v = rng.integers(0, NU, n), np.full(n, 2)
    elif pattern == "one_pair":
        u, v = np.full(n, 7), np.full(n, 4)
    else:  # skewed: a Zipf-like head of users and items
        u = np.minimum(rng.geometric(0.4, n) - 1, NU - 1)
        v = np.minimum(rng.geometric(0.5, n) - 1, NV - 1)
    r = rng.normal(3.5, 1.0, n).astype(np.float32)
    return u.astype(np.int32), v.astype(np.int32), r


def tables(dim, seed=1, scale=0.1):
    rng = np.random.default_rng(seed)
    return MFParams(
        theta=rng.normal(0, scale, (NU, dim)).astype(np.float32),
        phi=rng.normal(0, scale, (NV, dim)).astype(np.float32),
        bu=rng.normal(0, scale, NU).astype(np.float32),
        bv=rng.normal(0, scale, NV).astype(np.float32),
        gb=np.float32(3.5),
    )


def one_per_batch(u, v, r):
    n = len(u)
    return tuple(jnp.asarray(x.reshape(n, 1)) for x in
                 (u, v, r, np.ones(n, np.float32)))


def dev(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=atol)


# float32 against the float64 oracle: a sum of dim products per rating and
# a few dozen dependent updates per row; 2e-5 covers that rounding up to
# dim 2048 (values stay below ~5).
ATOL = 2e-5


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("dim", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                 1024, 2048])
def test_sgd_batch1_matches_sequential(dim, pattern):
    p = tables(dim)
    u, v, r = ids(pattern)
    eta, lam = 0.05, 0.02
    want = sgd_sequential(*p[:4], float(p.gb), u, v, r, eta, lam)
    got = sgd_epoch(dev(p), one_per_batch(u, v, r), jnp.float32(eta),
                    jnp.float32(lam))
    assert_close(got[:4], want, ATOL)


def sgld_case(dim, pattern, temp, seed=2):
    p = tables(dim, seed=seed)
    u, v, r = ids(pattern, seed=seed)
    rng = np.random.default_rng(seed)
    counts_u = np.bincount(u, minlength=NU)
    counts_v = np.bincount(v, minlength=NV)
    state = DPMFState(
        params=dev(p),
        lambda_r=jnp.float32(1.3),
        lambda_ub=jnp.float32(0.7),
        lambda_vb=jnp.float32(0.9),
        lambda_u=jnp.asarray(rng.uniform(0.5, 2.0, dim).astype(np.float32)),
        lambda_v=jnp.asarray(rng.uniform(0.5, 2.0, dim).astype(np.float32)),
        ur=jnp.asarray((N / np.maximum(counts_u, 1)).astype(np.float32)),
        vr=jnp.asarray((N / np.maximum(counts_v, 1)).astype(np.float32)),
        gcountu=jnp.zeros(NU + 1, jnp.int32),
        gcountv=jnp.zeros(NV + 1, jnp.int32),
        gcount=jnp.int32(0),
    )
    hyper = SgldHyper(eta=jnp.float32(2e-3), temp=jnp.float32(temp),
                      bound=jnp.float32(0.5), ntrain=jnp.float32(N))
    return state, hyper, u, v, r


def sgld_noise(key, dim):
    """The normals sgld_epoch draws for rating i at batch size 1."""
    def draw(i):
        ku, kv, kbu, kbv = jax.random.split(jax.random.fold_in(key, i), 4)
        return (np.asarray(jax.random.normal(ku, (1, dim)))[0],
                np.asarray(jax.random.normal(kv, (1, dim)))[0],
                float(jax.random.normal(kbu, (1,))[0]),
                float(jax.random.normal(kbv, (1,))[0]))
    return draw


@pytest.mark.parametrize("temp", [0.0, 1e-2])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("dim", [1, 8, 64, 512])
def test_sgld_batch1_matches_sequential(dim, pattern, temp):
    state, hyper, u, v, r = sgld_case(dim, pattern, temp)
    key = jax.random.PRNGKey(5)
    p = jax.tree.map(np.asarray, state.params)
    lams = tuple(np.asarray(x) for x in (
        state.lambda_u, state.lambda_v, state.lambda_ub, state.lambda_vb,
        state.lambda_r))
    want, gu, gv, gc = sgld_sequential(
        p, lams, np.asarray(state.ur), np.asarray(state.vr), u, v, r,
        2e-3, temp, 0.5, N, sgld_noise(key, dim))
    got = sgld_epoch(state, one_per_batch(u, v, r), hyper, key)
    assert_close(got.params[:4], want, ATOL)
    # Lazy-noise clocks: every row stamped at its last touch, exactly.
    np.testing.assert_array_equal(np.asarray(got.gcountu)[:NU], gu)
    np.testing.assert_array_equal(np.asarray(got.gcountv)[:NV], gv)
    assert int(got.gcount) == gc == N


@pytest.mark.parametrize("batch", [1, 4, 16, 64])
def test_sgld_lazy_noise_telescopes(batch):
    """Whatever the batch size, a row's injected noise over a round plus
    the final flush has variance temp*eta*n: the per-touch counts
    telescope to the round's total update count (dpmf.h:61-70,
    model.cc:312-332)."""
    dim, n, temp, eta = 4096, 64, 0.5, 1e-3
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, n).astype(np.int32)   # two users, touched often
    v = rng.integers(0, 3, n).astype(np.int32)
    state = DPMFState(
        params=MFParams(jnp.zeros((2, dim)), jnp.zeros((3, dim)),
                        jnp.zeros(2), jnp.zeros(3), jnp.float32(0.0)),
        lambda_r=jnp.float32(0.0), lambda_ub=jnp.float32(0.0),
        lambda_vb=jnp.float32(0.0), lambda_u=jnp.zeros(dim),
        lambda_v=jnp.zeros(dim), ur=jnp.ones(2), vr=jnp.ones(3),
        gcountu=jnp.zeros(3, jnp.int32), gcountv=jnp.zeros(4, jnp.int32),
        gcount=jnp.int32(0),
    )
    hyper = SgldHyper(jnp.float32(eta), jnp.float32(temp), jnp.float32(1.0),
                      jnp.float32(n))
    b = tuple(jnp.asarray(x.reshape(n // batch, batch)) for x in
              (u, v, np.zeros(n, np.float32), np.ones(n, np.float32)))
    state = sgld_epoch(state, b, hyper, jax.random.PRNGKey(batch))
    state = finish_noise(state, jnp.float32(eta), jnp.float32(temp),
                         jax.random.PRNGKey(99))
    var = np.var(np.asarray(state.params.theta), axis=1)
    np.testing.assert_allclose(var, temp * eta * n, rtol=0.15)
    assert int(state.gcount) == 0 and not np.asarray(state.gcountu).any()


def adreg_case(dim, pattern, seed=4):
    p = tables(dim, seed=seed)
    u, v, r = ids(pattern, seed=seed)
    rng = np.random.default_rng(seed)
    sh = tables(dim, seed=seed + 1)
    state = AdaptRegState(
        params=dev(p), theta_old=jnp.asarray(sh.theta),
        phi_old=jnp.asarray(sh.phi), bu_old=jnp.asarray(sh.bu),
        bv_old=jnp.asarray(sh.bv), lam_u=jnp.float32(0.05),
        lam_v=jnp.float32(0.04), lam_bu=jnp.float32(0.03),
        lam_bv=jnp.float32(0.02),
    )
    nval = 17
    valid = (rng.integers(0, NU, nval).astype(np.int32),
             rng.integers(0, NV, nval).astype(np.int32),
             rng.normal(3.5, 1.0, nval).astype(np.float32))
    return state, valid, u, v, r


@pytest.mark.parametrize("loss", [0, 1])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("dim", [1, 8, 64, 512])
def test_adreg_batch1_matches_sequential(dim, pattern, loss):
    state, valid, u, v, r = adreg_case(dim, pattern)
    if loss == 1:
        r = (r > 3.5).astype(np.float32)
        valid = (valid[0], valid[1], (valid[2] > 3.5).astype(np.float32))
    eta, eta_reg = 0.05, 0.5
    key = jax.random.PRNGKey(11)
    nval = len(valid[0])
    samples = [np.asarray(jax.random.randint(jax.random.fold_in(key, i),
                                             (64,), 0, nval))
               for i in range(len(u))]
    p = jax.tree.map(np.asarray, state.params)
    shadow = tuple(np.asarray(x) for x in state[1:5])
    lams = tuple(float(x) for x in state[5:])
    want_p, want_sh, want_l = adreg_sequential(
        p, shadow, lams, valid, u, v, r, eta, eta_reg, loss, samples)
    got = adreg_epoch(state, one_per_batch(u, v, r),
                      tuple(jnp.asarray(x) for x in valid),
                      (jnp.float32(eta), jnp.float32(eta_reg)), loss, key)
    assert_close(got.params[:4], want_p, ATOL)
    assert_close(got[1:5], want_sh, ATOL)
    np.testing.assert_allclose(
        [float(x) for x in got[5:]], want_l, rtol=1e-4, atol=1e-7)


# --- geometric decay: a row touched k times in one batch contracts by
# (1-d)^k, never by 1-k*d (ops/common.py). phi = 0 removes the gradient
# term from theta's update, leaving the decay alone.

def _dup_batch(k):
    u = np.full(k, 2, np.int32)
    v = np.arange(k, dtype=np.int32) % NV
    r = np.linspace(1.0, 5.0, k).astype(np.float32)
    return u, v, r, np.ones(k, np.float32)


def _zero_phi(dim=6):
    p = tables(dim, seed=7)
    return p._replace(phi=np.zeros_like(p.phi))


@pytest.mark.parametrize("k", range(1, 9))
def test_sgd_decay_is_geometric(k):
    p = _zero_phi()
    u, v, r, w = _dup_batch(k)
    eta, lam = 0.3, 0.5
    out = sgd_batch_update(dev(p), tuple(map(jnp.asarray, (u, v, r, w))),
                           jnp.float32(eta), jnp.float32(lam))
    base = (1 - eta * lam) ** k
    np.testing.assert_allclose(np.asarray(out.theta)[2], base * p.theta[2],
                               rtol=1e-5)
    # the bias gets the same contraction plus every stale-point error
    err = eta * (r - (p.bu[2] + p.bv[v] + p.gb))
    np.testing.assert_allclose(float(out.bu[2]), base * p.bu[2] + err.sum(),
                               rtol=1e-5)


@pytest.mark.parametrize("k", range(1, 9))
def test_sgld_decay_is_geometric(k):
    dim = 6
    p = _zero_phi(dim)
    lam_u = np.linspace(0.5, 1.5, dim).astype(np.float32)
    state = DPMFState(
        params=dev(p), lambda_r=jnp.float32(1.0), lambda_ub=jnp.float32(0.3),
        lambda_vb=jnp.float32(0.3), lambda_u=jnp.asarray(lam_u),
        lambda_v=jnp.ones(dim), ur=jnp.full(NU, 2.0), vr=jnp.full(NV, 2.0),
        gcountu=jnp.zeros(NU + 1, jnp.int32),
        gcountv=jnp.zeros(NV + 1, jnp.int32), gcount=jnp.int32(0),
    )
    eta, bound = 0.1, 0.5
    hyper = SgldHyper(jnp.float32(eta), jnp.float32(0.0), jnp.float32(bound),
                      jnp.float32(100.0))
    out = sgld_batch_update(state, tuple(map(jnp.asarray, _dup_batch(k))),
                            hyper, jax.random.PRNGKey(0))
    base = (1 - eta * bound * 2.0 * lam_u) ** k
    np.testing.assert_allclose(np.asarray(out.params.theta)[2],
                               base * p.theta[2], rtol=1e-5)
    assert int(out.gcount) == k and int(out.gcountu[2]) == k


@pytest.mark.parametrize("k", range(1, 9))
def test_adreg_decay_is_geometric(k):
    p = _zero_phi()
    state = AdaptRegState(
        params=dev(p), theta_old=jnp.asarray(p.theta),
        phi_old=jnp.asarray(p.phi), bu_old=jnp.asarray(p.bu),
        bv_old=jnp.asarray(p.bv), lam_u=jnp.float32(0.4),
        lam_v=jnp.float32(0.4), lam_bu=jnp.float32(0.2),
        lam_bv=jnp.float32(0.2),
    )
    eta = 0.3
    valid = (jnp.zeros(3, jnp.int32), jnp.zeros(3, jnp.int32),
             jnp.full(3, 3.0))
    out = adreg_batch_update(state, tuple(map(jnp.asarray, _dup_batch(k))),
                             valid, AdRegHyper(jnp.float32(eta),
                                               jnp.float32(0.0), 0),
                             jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(out.params.theta)[2],
                               (1 - eta * 0.4) ** k * p.theta[2], rtol=1e-5)
    # the shadow row holds the batch-start value, not a partly updated one
    np.testing.assert_allclose(np.asarray(out.theta_old)[2], p.theta[2])


# --- padding: weight-0 slots (RatingsCOO.to_batches tails, diagonal-block
# fill) are redirected out of bounds and must change nothing.

def _padded(where):
    real = (np.array([1, 4, 4], np.int32), np.array([2, 2, 5], np.int32),
            np.array([4.0, 2.5, 3.0], np.float32))
    pad_u, pad_v = {"row0": (0, 0), "real_row": (4, 2),
                    "last_row": (NU - 1, NV - 1)}[where]
    u = np.insert(real[0], 1, pad_u)
    v = np.insert(real[1], 1, pad_v)
    r = np.insert(real[2], 1, 9.9)
    w = np.array([1, 0, 1, 1], np.float32)
    return (tuple(map(jnp.asarray, (*real, np.ones(3, np.float32)))),
            tuple(map(jnp.asarray, (u, v, r, w))))


PADS = ["row0", "real_row", "last_row"]


@pytest.mark.parametrize("where", PADS)
def test_sgd_padding_is_noop(where):
    real, padded = _padded(where)
    p = dev(tables(5))
    a = sgd_batch_update(p, real, jnp.float32(0.1), jnp.float32(0.02))
    b = sgd_batch_update(p, padded, jnp.float32(0.1), jnp.float32(0.02))
    assert_close(b[:4], [np.asarray(x, np.float64) for x in a[:4]], 1e-7)


@pytest.mark.parametrize("where", PADS)
def test_sgld_padding_is_noop(where):
    real, padded = _padded(where)
    state, hyper, *_ = sgld_case(5, "distinct", 1e-2)
    a = sgld_batch_update(state, real, hyper, jax.random.PRNGKey(1))
    b = sgld_batch_update(state, padded, hyper, jax.random.PRNGKey(1))
    # noise draws are per slot, so only the deterministic parts compare
    # bit-for-bit: the clocks advance by real ratings only, and a padded
    # slot stamps only the spare counter past the last row
    assert int(a.gcount) == int(b.gcount) == 3
    np.testing.assert_array_equal(np.asarray(a.gcountu)[:NU],
                                  np.asarray(b.gcountu)[:NU])
    np.testing.assert_array_equal(np.asarray(a.gcountv)[:NV],
                                  np.asarray(b.gcountv)[:NV])
    hyper0 = hyper._replace(temp=jnp.float32(0.0))
    a = sgld_batch_update(state, real, hyper0, jax.random.PRNGKey(1))
    b = sgld_batch_update(state, padded, hyper0, jax.random.PRNGKey(1))
    assert_close(b.params[:4], [np.asarray(x, np.float64) for x in a.params[:4]],
                 1e-7)


@pytest.mark.parametrize("where", PADS)
def test_adreg_padding_is_noop(where):
    real, padded = _padded(where)
    state, valid, *_ = adreg_case(5, "distinct")
    valid = tuple(map(jnp.asarray, valid))
    hyper = AdRegHyper(jnp.float32(0.05), jnp.float32(0.5), 0)
    a = adreg_batch_update(state, real, valid, hyper, jax.random.PRNGKey(2))
    b = adreg_batch_update(state, padded, valid, hyper, jax.random.PRNGKey(2))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-7)


@pytest.mark.parametrize("idx,w", [
    ([0, 1, 2, 3], [1, 1, 1, 1]),
    ([2, 2, 2, 2], [1, 1, 1, 1]),
    ([5, 0, 5, 1], [1, 1, 1, 1]),
    ([3, 3, 0, 0], [1, 1, 0, 0]),
    ([0, 0, 0, 0], [0, 0, 0, 0]),
    ([4, 1, 4, 4], [1, 0, 1, 0]),
])
def test_occurrence_stats_matches_numpy(idx, w):
    """First-occurrence flags and per-row counts over real slots only;
    padded slots point past the table and count nowhere."""
    n_rows = 6
    idx, w = np.array(idx, np.int32), np.array(w, np.float32)
    pad = np.asarray(pad_to_oob(jnp.asarray(idx), jnp.asarray(w), n_rows))
    np.testing.assert_array_equal(pad, np.where(w > 0, idx, n_rows))
    first, counts = occurrence_stats(jnp.asarray(pad), n_rows)
    real = pad < n_rows
    want_first = np.array([real[i] and pad[i] not in pad[:i] for i in range(4)])
    want_counts = np.array([np.sum(pad[real] == pad[i]) if real[i] else 0
                            for i in range(4)])
    np.testing.assert_array_equal(np.asarray(first), want_first)
    np.testing.assert_array_equal(np.asarray(counts)[real], want_counts[real])
