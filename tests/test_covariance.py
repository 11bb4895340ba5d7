"""Covariance assembly, analytic NLML gradients and the blocked posterior.

The XLA composition is the only covariance path, so it is pinned here
against a NumPy f64 oracle written independently of ops.kernels (explicit
broadcast differences, no matmul expansion)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfgp_jax.models import gp as gpm
from mfgp_jax.models import mfgp as mf
from mfgp_jax.ops import covariance as cov

D = 3


def _np_base(X1, X2, ls, kernel):
    r = np.sqrt(np.sum(((X1[:, None, :] - X2[None, :, :]) / ls) ** 2, -1))
    if kernel == "rbf":
        return np.exp(-0.5 * r**2)
    return (1.0 + np.sqrt(3.0) * r) * np.exp(-np.sqrt(3.0) * r)


def _np_ar1(X1, f1, X2, f2, variances, ls, rhos, kernel):
    """cov(f_i, f_j) = sum_{m <= min(i, j)} W[m,i] W[m,j] k_m, with
    W[m, f] = prod_{l=m+1..f} rho_l."""
    F = len(variances)
    W = np.zeros((F, F))
    for m in range(F):
        for f in range(m, F):
            W[m, f] = np.prod(rhos[m:f])
    K = np.zeros((X1.shape[0], X2.shape[0]))
    for m in range(F):
        K += (variances[m] * np.outer(W[m][f1], W[m][f2])
              * _np_base(X1, X2, ls[m], kernel))
    return K


def _data(rng, n, F):
    X = rng.uniform(0.0, 4.0, (n, D))
    fid = rng.integers(0, F, n)
    return X, fid


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("noise", [False, True])
def test_covariance_matches_numpy_oracle(rng, kernel, F, noise):
    X, fid = _data(rng, 23, F)
    X2, fid2 = _data(rng, 17, F)
    variances = rng.uniform(0.5, 3.0, F)
    ls = rng.uniform(0.7, 2.5, (F, D))
    rhos = rng.uniform(0.5, 1.5, F - 1)
    noises = rng.uniform(0.05, 0.5, F)
    j = jnp.asarray
    if F == 1:
        if noise:
            got = cov.sf_train_cov(variances[0], j(ls[0]), noises[0], j(X),
                                   kernel)
            want = (_np_ar1(X, fid, X, fid, variances, ls, rhos, kernel)
                    + noises[0] * np.eye(len(X)))
        else:
            got = cov.sf_cross_cov(variances[0], j(ls[0]), j(X), j(X2),
                                   kernel)
            want = _np_ar1(X, fid, X2, fid2, variances, ls, rhos, kernel)
    elif noise:
        got = cov.mf_train_cov(j(variances), j(ls), j(rhos), j(noises),
                               j(X), j(fid), 1e-6, kernel)
        want = (_np_ar1(X, fid, X, fid, variances, ls, rhos, kernel)
                + np.diag(noises[fid] + 1e-6))
    else:
        got = cov.mf_cross_cov(j(variances), j(ls), j(rhos), j(X), j(fid),
                               j(X2), j(fid2), kernel)
        want = _np_ar1(X, fid, X2, fid2, variances, ls, rhos, kernel)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10,
                               atol=1e-12)


def _mf_problem(rng, n=30):
    X, fid = _data(rng, n, 3)
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(n)
    params = mf.MFGPParams(jnp.log(jnp.array([1.5, 0.8, 0.4])),
                           jnp.log(jnp.asarray(rng.uniform(0.8, 2.0,
                                                           (3, D)))),
                           jnp.array([1.0, 0.9]),
                           jnp.log(jnp.array([0.2, 0.1, 0.05])))
    return params, jnp.asarray(X), jnp.asarray(fid, jnp.int32), \
        jnp.asarray(y)


@pytest.mark.parametrize("model", ["mfgp", "gp"])
@pytest.mark.parametrize("inv_mode", [None, "high", "highest"])
@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_analytic_gradient_matches_autodiff(rng, model, inv_mode, kernel):
    """The trace-identity gradient (solve or explicit-inverse K^-1) equals
    jax.grad of the exact NLML; rhos are held fixed, so their analytic
    gradient is zero by contract."""
    params, X, fid, y = _mf_problem(rng)
    if model == "mfgp":
        val, g, *_ = mf._nlml_vg_core(params, X, fid, y, kernel, 1e-6,
                                      inv_mode=inv_mode)
        ref_val = mf.nlml(params, X, fid, y, kernel=kernel, jitter=1e-6)
        ref = jax.grad(mf.nlml)(params, X, fid, y, kernel=kernel,
                                jitter=1e-6)
        pairs = [(g.log_variances, ref.log_variances),
                 (g.log_lengthscales, ref.log_lengthscales),
                 (g.log_noises, ref.log_noises)]
    else:
        p = gpm.GPParams(params.log_variances[0],
                         params.log_lengthscales[0], params.log_noises[0])
        val, g, *_ = gpm._gp_vg_core(p, X, y, 0.0, kernel, 1e-6,
                                     inv_mode=inv_mode)
        ref_val = gpm.nlml(p, X, y, kernel=kernel, jitter=1e-6)
        ref = jax.grad(gpm.nlml)(p, X, y, kernel=kernel, jitter=1e-6)
        pairs = [(g.log_variance, ref.log_variance),
                 (g.log_lengthscales, ref.log_lengthscales),
                 (g.log_noise, ref.log_noise)]
    np.testing.assert_allclose(float(val), float(ref_val), rtol=1e-10)
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
@pytest.mark.parametrize("include_noise", [True, False])
def test_mfgp_predict_blocked_inv_matches_predict(rng, kernel,
                                                  include_noise):
    """M=37 with block_size=16: the padded tail block is dropped and every
    real row equals the unblocked substitution posterior."""
    params, X, fid, y = _mf_problem(rng)
    _, _, state = mf.nlml_value_grad_state_inv(params, X, fid, y,
                                               kernel=kernel, jitter=1e-6)
    Xs, fs = _data(rng, 37, 3)
    Xs, fs = jnp.asarray(Xs), jnp.asarray(fs, jnp.int32)
    mu, var = mf.predict_blocked_inv(params, state, Xs, fs, kernel=kernel,
                                     include_noise=include_noise,
                                     block_size=16)
    ref_state = mf.condition(params, X, fid, y, kernel=kernel, jitter=1e-6)
    mu_r, var_r = mf.predict(params, ref_state, Xs, fs, kernel=kernel,
                             include_noise=include_noise)
    assert mu.shape == (37,) and var.shape == (37,)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_r),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(var), np.asarray(var_r),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_gp_predict_blocked_inv_matches_predict(rng, kernel):
    params, X, _, y = _mf_problem(rng)
    p = gpm.GPParams(params.log_variances[0], params.log_lengthscales[0],
                     params.log_noises[0])
    _, _, state = gpm.nlml_value_grad_state_inv(p, X, y, kernel=kernel,
                                                jitter=1e-6)
    Xs = jnp.asarray(_data(rng, 37, 1)[0])
    mu, var = gpm.predict_blocked_inv(p, state, Xs, kernel=kernel,
                                      block_size=16)
    ref = gpm.condition(p, X, y, kernel=kernel, jitter=1e-6)
    mu_r, var_r = gpm.predict(p, ref, Xs, kernel=kernel)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_r),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(var), np.asarray(var_r),
                               rtol=1e-9, atol=1e-10)
