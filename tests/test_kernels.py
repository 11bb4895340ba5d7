"""Kernel-level unit tests vs numpy oracles (SURVEY.md §4 test pyramid #1)."""

import numpy as np
import jax.numpy as jnp

from mfgp_jax.ops import kernels as k


def np_rbf(X1, X2, var, ls):
    d = X1[:, None, :] - X2[None, :, :]
    r2 = np.sum(d**2 / np.asarray(ls) ** 2, axis=-1)
    return var * np.exp(-0.5 * r2)


def np_matern32(X1, X2, var, ls):
    d = X1[:, None, :] - X2[None, :, :]
    r = np.sqrt(np.sum(d**2 / np.asarray(ls) ** 2, axis=-1))
    return var * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)


def test_rbf_matches_oracle(rng):
    X1 = rng.uniform(0, 20, (40, 3))
    X2 = rng.uniform(0, 20, (25, 3))
    ls = np.array([1.2, 3.4, 0.7])
    K = np.asarray(k.rbf(jnp.asarray(X1), jnp.asarray(X2), 2.5, jnp.asarray(ls)))
    np.testing.assert_allclose(K, np_rbf(X1, X2, 2.5, ls), rtol=1e-10, atol=1e-12)


def test_rbf_scalar_lengthscale(rng):
    X = rng.uniform(0, 5, (10, 3))
    K1 = np.asarray(k.rbf(X, X, 1.0, 2.0))
    K2 = np_rbf(X, X, 1.0, [2.0, 2.0, 2.0])
    np.testing.assert_allclose(K1, K2, rtol=1e-10, atol=1e-12)


def test_matern32_matches_oracle(rng):
    X1 = rng.uniform(0, 20, (30, 3))
    X2 = rng.uniform(0, 20, (20, 3))
    ls = np.array([2.0, 1.0, 5.0])
    K = np.asarray(k.matern32(X1, X2, 1.7, ls))
    np.testing.assert_allclose(K, np_matern32(X1, X2, 1.7, ls), rtol=1e-8,
                               atol=1e-10)


def test_sqdist_nonnegative_identical_points(rng):
    X = rng.uniform(0, 100, (50, 3))
    r2 = np.asarray(k.sqdist(X, X, jnp.ones(3)))
    assert (r2 >= 0).all()
    np.testing.assert_allclose(np.diag(r2), 0.0, atol=1e-8)


def test_ar1_weights_rho_one():
    W = np.asarray(k.ar1_fidelity_weights(jnp.ones(2), 3))
    np.testing.assert_allclose(W, [[1, 1, 1], [0, 1, 1], [0, 0, 1]])


def test_ar1_weights_general():
    r1, r2 = 0.5, 2.0
    W = np.asarray(k.ar1_fidelity_weights(jnp.array([r1, r2]), 3))
    np.testing.assert_allclose(
        W, [[1, r1, r1 * r2], [0, 1, r2], [0, 0, 1]], rtol=1e-12)


def test_ar1_cov_matches_explicit_sum(rng):
    """AR1 covariance equals the Kennedy-O'Hagan explicit block formula."""
    X = rng.uniform(0, 10, (30, 3))
    fid = rng.integers(0, 3, 30)
    variances = np.array([1.0, 2.0, 0.5])
    ls = rng.uniform(0.5, 3.0, (3, 3))
    rhos = np.array([0.8, 1.3])
    K = np.asarray(k.ar1_cov(X, fid, X, fid, jnp.asarray(variances),
                             jnp.asarray(ls), jnp.asarray(rhos)))
    # oracle: per-pair sum over m <= min(i,j) of prod-rho weights
    W = np.asarray(k.ar1_fidelity_weights(jnp.asarray(rhos), 3))
    Ko = np.zeros((30, 30))
    for m in range(3):
        Km = np_rbf(X, X, variances[m], ls[m])
        Ko += np.outer(W[m][fid], W[m][fid]) * Km
    np.testing.assert_allclose(K, Ko, rtol=1e-10, atol=1e-12)
    # spot check symmetry & PSD-ish
    np.testing.assert_allclose(K, K.T, rtol=1e-10)
    assert np.linalg.eigvalsh(K + 1e-9 * np.eye(30)).min() > -1e-8


def test_rbf_dx1_finite_difference(rng):
    X1 = rng.uniform(0, 5, (5, 3))
    X2 = rng.uniform(0, 5, (7, 3))
    ls = np.array([1.5, 0.8, 2.2])
    g = np.asarray(k.rbf_dx1(X1, X2, 1.3, ls))
    eps = 1e-6
    for d in range(3):
        Xp = X1.copy(); Xp[:, d] += eps
        Xm = X1.copy(); Xm[:, d] -= eps
        fd = (np_rbf(Xp, X2, 1.3, ls) - np_rbf(Xm, X2, 1.3, ls)) / (2 * eps)
        np.testing.assert_allclose(g[:, :, d], fd, rtol=1e-5, atol=1e-8)


def test_ar1_weights_rho_zero_no_nan():
    """rho = 0 (decoupled fidelities) must yield exact zeros/ones, not the
    0/0 NaNs of a cumprod-ratio formulation (code-review finding)."""
    import jax.numpy as jnp

    from mfgp_jax.ops.kernels import ar1_fidelity_weights

    W = np.asarray(ar1_fidelity_weights(jnp.asarray([0.0, 0.5]), 3))
    assert np.isfinite(W).all()
    np.testing.assert_allclose(np.diag(W), 1.0)
    np.testing.assert_allclose(W[1, 2], 0.5)
    np.testing.assert_allclose(W[0, 1], 0.0)  # decoupled by rho_1 = 0
    np.testing.assert_allclose(W[0, 2], 0.0)
    # lower triangle zero
    assert W[1, 0] == 0.0 and W[2, 0] == 0.0 and W[2, 1] == 0.0
