"""Multi-fidelity AR1 GP tests: oracle parity + MF behavior properties."""

import jax
import numpy as np
import jax.numpy as jnp

from mfgp_jax.models import mfgp as mf


def np_rbf(X1, X2, var, ls):
    d = X1[:, None, :] - X2[None, :, :]
    return var * np.exp(-0.5 * np.sum(d**2 / np.asarray(ls) ** 2, axis=-1))


def oracle_mf_cov(X1, f1, X2, f2, variances, ls, rhos):
    W = np.zeros((3, 3))
    rho_ext = np.concatenate([[1.0], rhos])
    C = np.cumprod(rho_ext)
    for m in range(3):
        for f in range(3):
            if f >= m:
                W[m, f] = C[f] / C[m]
    K = np.zeros((X1.shape[0], X2.shape[0]))
    for m in range(3):
        K += np.outer(W[m][f1], W[m][f2]) * np_rbf(X1, X2, variances[m], ls[m])
    return K


def make_mf_data(rng, ns=(40, 25, 15)):
    """Three-fidelity synthetic data: low fid = biased coarse field."""
    f_hi = lambda X: np.sin(X[:, 0]) + 0.4 * np.cos(X[:, 1])
    Xs, ys = [], []
    for i, n in enumerate(ns):
        X = rng.uniform(0, 10, (n, 3))
        bias = (2 - i) * 0.3
        noise = (2 - i) * 0.1 + 0.02
        ys.append(f_hi(X) + bias + noise * rng.standard_normal(n))
        Xs.append(X)
    return Xs, ys  # ordered lowest -> highest fidelity


def test_stack_fidelity_lists(rng):
    Xs, ys = make_mf_data(rng)
    X, fid, y = mf.stack_fidelity_lists(Xs, ys)
    assert X.shape == (80, 3)
    np.testing.assert_array_equal(
        np.asarray(fid), np.concatenate([[0] * 40, [1] * 25, [2] * 15]))


def test_mf_predict_matches_oracle(rng):
    Xs_l, ys_l = make_mf_data(rng)
    model = mf.MFGP.from_fidelity_lists(Xs_l, ys_l)
    variances = np.array([1.0, 0.5, 0.3])
    ls = np.array([[2.0, 2.0, 2.0], [1.5, 1.0, 2.5], [1.0, 1.0, 1.0]])
    rhos = np.array([0.9, 1.1])
    noises = np.array([0.1, 0.05, 0.01])
    vec = np.concatenate([np.concatenate([[v], l]) for v, l in zip(variances, ls)]
                         + [rhos, noises])
    model.set_param_array(vec)
    np.testing.assert_allclose(model.param_array, vec, rtol=1e-12)

    Xt = rng.uniform(0, 10, (12, 3))
    X = np.asarray(model.X); fid = np.asarray(model.fid); y = np.asarray(model.y)
    ft = np.full(12, 2)
    Ktr = oracle_mf_cov(X, fid, X, fid, variances, ls, rhos) + np.diag(noises[fid])
    Kxs = oracle_mf_cov(Xt, ft, X, fid, variances, ls, rhos)
    Kss = oracle_mf_cov(Xt, ft, Xt, ft, variances, ls, rhos)
    mu_o = Kxs @ np.linalg.solve(Ktr, y)
    cov_o = Kss - Kxs @ np.linalg.solve(Ktr, Kxs.T) + noises[2] * np.eye(12)

    mu, var = model.predict(Xt)
    np.testing.assert_allclose(np.asarray(mu), mu_o, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(var), np.diag(cov_o), rtol=1e-7,
                               atol=1e-9)
    cov = model.predict_covariance(Xt)
    np.testing.assert_allclose(np.asarray(cov), cov_o, rtol=1e-7, atol=1e-9)


def test_mf_augmented_input_convention(rng):
    """emukit-style [X | fid] inputs (reference/GPTrainers.py:119)."""
    Xs_l, ys_l = make_mf_data(rng)
    model = mf.MFGP.from_fidelity_lists(Xs_l, ys_l)
    Xt = rng.uniform(0, 10, (8, 3))
    mu1, v1 = model.predict(Xt)  # defaults to highest fidelity
    mu2, v2 = model.predict(np.hstack([Xt, 2 * np.ones((8, 1))]))
    np.testing.assert_allclose(np.asarray(mu1), np.asarray(mu2))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2))


def test_mf_optimize_improves(rng):
    Xs_l, ys_l = make_mf_data(rng)
    model = mf.MFGP.from_fidelity_lists(Xs_l, ys_l, jitter=1e-8)
    ll0 = model.log_likelihood()
    model.optimize(maxiter=200, fix_rhos=True, lengthscale_bounds=(1e-4, 100))
    assert model.log_likelihood() > ll0
    np.testing.assert_allclose(np.asarray(model.params.rhos), [1.0, 1.0])


def test_mf_uses_low_fidelity_information(rng):
    """With rho=1 the high-fidelity posterior must benefit from low-fid data
    in regions only covered by low fidelity — the core MF capability."""
    f_true = lambda X: np.sin(X[:, 0])
    X_lo = np.column_stack([np.linspace(0, 10, 60),
                            np.full(60, 5.0), np.full(60, 5.0)])
    y_lo = f_true(X_lo) + 0.05 * rng.standard_normal(60)
    X_hi = X_lo[:6]  # high fidelity only at one end
    y_hi = f_true(X_hi)
    model = mf.MFGP.from_fidelity_lists([X_lo, X_hi], [y_lo, y_hi])
    model.params = mf.MFGPParams(
        jnp.log(jnp.array([1.0, 0.05])),
        jnp.log(jnp.full((2, 3), 2.0)),
        jnp.ones(1),
        jnp.log(jnp.array([0.01, 0.001])),
    )
    Xt = np.column_stack([np.linspace(7, 9, 10), np.full(10, 5.0),
                          np.full(10, 5.0)])
    mu, _ = model.predict(Xt)
    err_mf = np.sqrt(np.mean((np.asarray(mu) - f_true(Xt)) ** 2))
    # a high-fid-only GP with the same hyps has no data near x in [7, 9]
    from mfgp_jax.models import gp as gpm
    sf = gpm.GP(X_hi, y_hi)
    sf.set_param_array(np.array([1.0, 2.0, 2.0, 2.0, 0.001]))
    mu_sf, _ = sf.predict(Xt)
    err_sf = np.sqrt(np.mean((np.asarray(mu_sf) - f_true(Xt)) ** 2))
    assert err_mf < 0.5 * err_sf


def test_mfgp_optimize_restarts(rng):
    X = rng.uniform(0, 5, (36, 2))
    y = np.sin(X[:, 0]) + 0.05 * rng.standard_normal(36)
    fid = rng.integers(0, 3, 36)
    from mfgp_jax.models.mfgp import MFGP

    m = MFGP(X, fid, y, jitter=1e-8)
    f0 = -m.log_likelihood()
    f = m.optimize_restarts(n_restarts=4, maxiter=150,
                            lengthscale_bounds=(1e-4, 100.0))
    assert f < f0  # improved over the default-hyps NLML
    # rhos untouched (reference kern.scale.fix)
    np.testing.assert_array_equal(np.asarray(m.params.rhos), [1.0, 1.0])
    # lengthscale bounds respected
    ls = np.asarray(m.params.lengthscales)
    assert (ls >= 1e-4 - 1e-12).all() and (ls <= 100.0 + 1e-9).all()


def test_analytic_gradient_matches_autodiff(rng):
    """nlml_value_and_grad's trace-identity gradients must equal autodiff
    exactly (var/lengthscale/noise; rhos fixed)."""
    import jax

    N, D, F = 60, 3, 3
    X = jnp.asarray(rng.uniform(0, 10, (N, D)))
    fid = jnp.asarray(rng.integers(0, F, N), jnp.int32)
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)))
    params = mf.MFGPParams(
        jnp.log(jnp.asarray([2.0, 1.0, 0.5])),
        jnp.log(jnp.asarray(rng.uniform(0.5, 3, (F, D)))),
        jnp.asarray([1.2, 0.8]),
        jnp.log(jnp.asarray([0.3, 0.1, 0.05])))
    for kern in ("rbf", "matern32"):
        v_ad, g_ad = jax.value_and_grad(
            lambda p: mf.nlml(p, X, fid, y, kernel=kern, jitter=1e-8))(params)
        v_an, g_an = mf.nlml_value_and_grad(params, X, fid, y, kernel=kern,
                                            jitter=1e-8)
        np.testing.assert_allclose(float(v_an), float(v_ad), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(g_an.log_variances),
                                   np.asarray(g_ad.log_variances), atol=1e-10)
        np.testing.assert_allclose(np.asarray(g_an.log_lengthscales),
                                   np.asarray(g_ad.log_lengthscales),
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(g_an.log_noises),
                                   np.asarray(g_ad.log_noises), atol=1e-12)


def test_mfgp_extend_data_matches_full_recondition(rng):
    X = rng.uniform(0, 10, (30, 3))
    y = np.sin(X.sum(1))
    fid = rng.integers(0, 3, 30)
    Xn = rng.uniform(0, 10, (6, 3))
    yn = np.sin(Xn.sum(1))
    fn = rng.integers(0, 3, 6)
    m1 = mf.MFGP(X, fid, y, jitter=1e-8)
    m1.extend_data(Xn, fn, yn)
    m2 = mf.MFGP(np.vstack([X, Xn]), np.concatenate([fid, fn]),
                 np.concatenate([y, yn]), jitter=1e-8)
    m2.params = m1.params
    Xs = rng.uniform(0, 10, (12, 3))
    mu1, var1 = m1.predict(Xs)
    mu2, var2 = m2.predict(Xs)
    np.testing.assert_allclose(mu1, mu2, rtol=1e-9)
    np.testing.assert_allclose(var1, var2, rtol=1e-8, atol=1e-10)


def test_inv_state_path_matches_standard(rng):
    """nlml_value_grad_state_inv + predict_blocked_inv (the explicit-inverse
    fast path the bench rides) match the substitution path at f64."""
    import jax.numpy as jnp

    N, D, M = 60, 3, 37
    X = rng.normal(size=(N, D))
    y = np.sin(X.sum(axis=1))
    fid = rng.integers(0, 3, N)
    grid = rng.normal(size=(M, D))
    gfid = np.full(M, 2)
    params = mf.MFGPParams.default(3, D, jnp.float64)

    v0, g0, s0 = mf.nlml_value_grad_state(params, jnp.asarray(X),
                                          jnp.asarray(fid), jnp.asarray(y),
                                          jitter=1e-10)
    for mode in ("high", "highest"):
        v1, g1, s1 = mf.nlml_value_grad_state_inv(
            params, jnp.asarray(X), jnp.asarray(fid), jnp.asarray(y),
            jitter=1e-10, inv_mode=mode)
        np.testing.assert_allclose(float(v1), float(v0), rtol=1e-12)
        for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-8, atol=1e-10)
        mu0, var0 = mf.predict_blocked(params, s0, jnp.asarray(grid),
                                       jnp.asarray(gfid), block_size=16)
        mu1, var1 = mf.predict_blocked_inv(params, s1, jnp.asarray(grid),
                                           jnp.asarray(gfid), block_size=16,
                                           precision=mode)
        np.testing.assert_allclose(np.asarray(mu1), np.asarray(mu0),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(var1), np.asarray(var0),
                                   rtol=1e-8, atol=1e-10)
