"""NIGP tests: gradient math, NLML semantics, end-to-end recovery.

Mirrors the reference's own informal self-check (reference/NIGP.py:339-365:
1D sin with known input/output noise) as a real assertion-based test.
"""

import numpy as np
import jax.numpy as jnp

from mfgp_jax.models import nigp as nm


def np_rbf(X1, X2, var, ls):
    d = X1[:, None, :] - X2[None, :, :]
    return var * np.exp(-0.5 * np.sum(d**2 / np.asarray(ls) ** 2, axis=-1))


def test_posterior_mean_grads_match_loop_oracle(rng):
    """Matmul-contracted gradients == the reference's per-point loop formula
    (reference/NIGP.py:55-64)."""
    N, D = 25, 3
    X = rng.uniform(0, 5, (N, D))
    y = rng.standard_normal(N)
    ls = np.array([1.0, 2.0, 0.7])
    sf, sy = 1.5, 0.3
    mean, grads = nm.posterior_mean_grads(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(ls), sf, sy)
    K = np_rbf(X, X, sf, ls)
    alpha = np.linalg.solve(K + sy**2 * np.eye(N), y)
    mean_o = K @ alpha
    grads_o = np.zeros((N, D))
    for i in range(N):
        diffs = X[i : i + 1, :] - X
        w = (K[i, :, None] * alpha[:, None]) * (-(diffs) / ls[None, :] ** 2)
        grads_o[i] = w.sum(axis=0)
    np.testing.assert_allclose(np.asarray(mean), mean_o, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(grads), grads_o, rtol=1e-8,
                               atol=1e-10)


def test_nlml_input_noise_inflation(rng):
    """NLML must equal the plain-GP NLML with obs var sigma_y^2 + v_i,
    v_i = sum_d grad^2 sigma_x^2 (reference/NIGP.py:144-162)."""
    N, D = 20, 2
    X = rng.uniform(0, 5, (N, D))
    y = rng.standard_normal(N)
    grads = rng.standard_normal((N, D))
    ls = np.array([1.0, 2.0]); sf, sy = 1.2, 0.4; sx = np.array([0.3, 0.1])
    log_hyp = np.log(np.concatenate([ls, [sf, sy], sx]))
    got = float(nm.nlml(jnp.asarray(log_hyp), jnp.asarray(X), jnp.asarray(y),
                        jnp.asarray(grads)))
    v = np.sum(grads**2 * sx[None, :] ** 2, axis=1)
    K = np_rbf(X, X, sf, ls) + np.diag(sy**2 + v) + 1e-8 * np.eye(N)
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(K, y)
    want = (0.5 * y @ alpha + np.sum(np.log(np.diag(L)))
            + 0.5 * N * np.log(2 * np.pi))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_fit_1d_sin_recovers_noise_scales(rng):
    """End-to-end on the reference's own synthetic benchmark."""
    N = 40
    X_true = np.linspace(0, 6, N)[:, None]
    y_true = np.sin(X_true).ravel()
    sigma_x_true, sigma_y_true = 0.2, 0.05
    X_obs = X_true + sigma_x_true * rng.standard_normal((N, 1))
    y_obs = y_true + sigma_y_true * rng.standard_normal(N)

    m = nm.NIGP(n_restarts=2, iters=4, seed=1)
    m.fit(X_obs, y_obs)
    # learned input-noise std should land in the right order of magnitude
    assert 0.02 < float(m.sigma_x_[0]) < 1.0
    # prediction with input-noise-corrected variance covers the truth
    Xt = np.linspace(0.5, 5.5, 50)[:, None]
    mu, var = m.predict(Xt, Xs_input_noise=np.ones_like(Xt) * m.sigma_x_)
    rmse = np.sqrt(np.mean((mu - np.sin(Xt.ravel())) ** 2))
    assert rmse < 0.3
    inside = np.abs(mu - np.sin(Xt.ravel())) < 3 * np.sqrt(var)
    assert inside.mean() > 0.9


def test_predict_cov_has_no_output_noise(rng):
    """reference/NIGP.py:299-327: predictive cov excludes sigma_y^2 (only a
    1e-12 floor is added)."""
    N = 15
    X = rng.uniform(0, 5, (N, 1))
    y = rng.standard_normal(N)
    m = nm.NIGP()
    m.X_train_ = jnp.asarray(X)
    m.y_train_ = jnp.asarray(y)
    m.lengthscales_ = np.array([1.0])
    m.sigma_f_ = 1.0
    m.sigma_y_ = 0.5
    m.sigma_x_ = np.array([0.0])
    m.noise_diag_train_ = None
    mu, cov = m.predict(X, return_cov=True)
    K = np_rbf(X, X, 1.0, [1.0])
    Kn = K + 0.25 * np.eye(N)
    cov_o = K - K @ np.linalg.solve(Kn, K) + 1e-12 * np.eye(N)
    np.testing.assert_allclose(cov, cov_o, rtol=1e-6, atol=1e-9)


def test_get_params_layout(rng):
    m = nm.NIGP()
    m.sigma_x_ = np.array([0.1, 0.2, 0.3])
    m.sigma_f_ = 1.5
    m.sigma_y_ = 0.05
    m.lengthscales_ = np.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(
        m.get_params(), [0.1, 0.2, 0.3, 1.5, 0.05, 1.0, 2.0, 3.0])


def test_native_fit_recovers_input_noise(rng):
    """fit_native (fully-coupled jax.grad objective, no alternating loop)
    must recover sigma_x comparably to the alternating parity mode on the
    reference's own self-check setup (reference/NIGP.py:339-365)."""
    from mfgp_jax.models.nigp import NIGP

    N = 100
    X = np.sort(rng.uniform(0, 10, N))[:, None]
    Xn = X + 0.3 * rng.standard_normal(X.shape)
    y = np.sin(Xn[:, 0]) + 0.1 * rng.standard_normal(N)
    m = NIGP(n_restarts=3)
    m.fit_native(X, y)
    assert 0.1 < m.sigma_x_[0] < 0.8  # true 0.3
    mu, var = m.predict(np.linspace(0, 10, 100)[:, None])
    rmse = np.sqrt(np.mean((mu - np.sin(np.linspace(0, 10, 100))) ** 2))
    assert rmse < 0.2
    assert (np.asarray(var) > 0).all()


def test_predict_blocked_matches_predict(rng):
    """The explicit-inverse blocked path (tri_inv + matmuls, the
    GP/MFGP predict_blocked_inv pattern) equals the tri_solve marginal
    path to near-machine precision, across block boundaries."""
    N = 60
    X = rng.standard_normal((N, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(N)
    m = nm.NIGP(n_restarts=1, iters=2, seed=0)
    m.fit(X, y)
    Xt = rng.standard_normal((37, 2))
    mu_ref, var_ref = m.predict(Xt)
    mu_b, var_b = m.predict_blocked(Xt, block_size=16)
    np.testing.assert_allclose(mu_b, np.asarray(mu_ref).reshape(-1),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(var_b, np.asarray(var_ref).reshape(-1),
                               rtol=1e-8, atol=1e-10)
    # include_noise adds exactly sigma_y^2
    _, var_n = m.predict_blocked(Xt, block_size=16, include_noise=True)
    np.testing.assert_allclose(var_n - var_b, m.sigma_y_**2,
                               rtol=1e-6, atol=1e-10)
