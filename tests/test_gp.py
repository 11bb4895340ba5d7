"""Single-fidelity GP: NLML/posterior oracles + fit behavior."""

import numpy as np
import jax
import jax.numpy as jnp

from mfgp_jax.models import gp as gpm


def np_rbf(X1, X2, var, ls):
    d = X1[:, None, :] - X2[None, :, :]
    return var * np.exp(-0.5 * np.sum(d**2 / np.asarray(ls) ** 2, axis=-1))


def make_data(rng, n=60, d=3, noise=0.05):
    X = rng.uniform(0, 10, (n, d))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1] * 0.7) + noise * rng.standard_normal(n)
    return X, y


def oracle_nlml(X, y, var, ls, noise):
    n = X.shape[0]
    K = np_rbf(X, X, var, ls) + noise * np.eye(n)
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(K, y)
    return (0.5 * y @ alpha + np.sum(np.log(np.diag(L)))
            + 0.5 * n * np.log(2 * np.pi))


def test_nlml_matches_oracle(rng):
    X, y = make_data(rng)
    p = gpm.GPParams(jnp.log(1.3), jnp.log(jnp.array([1.0, 2.0, 0.5])),
                     jnp.log(0.1))
    got = float(gpm.nlml(p, jnp.asarray(X), jnp.asarray(y)))
    want = oracle_nlml(X, y, 1.3, [1.0, 2.0, 0.5], 0.1)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_nlml_grad_matches_fd(rng):
    X, y = make_data(rng, n=30)
    p = gpm.GPParams(jnp.log(1.0), jnp.zeros(3), jnp.log(0.1))

    def f(vec):
        pp = gpm.GPParams(vec[0], vec[1:4], vec[4])
        return gpm.nlml(pp, jnp.asarray(X), jnp.asarray(y))

    vec = jnp.concatenate([p.log_variance[None], p.log_lengthscales,
                           p.log_noise[None]])
    g = np.asarray(jax.grad(f)(vec))
    eps = 1e-6
    for i in range(5):
        vp = np.asarray(vec).copy(); vp[i] += eps
        vm = np.asarray(vec).copy(); vm[i] -= eps
        fd = (float(f(jnp.asarray(vp))) - float(f(jnp.asarray(vm)))) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=1e-5, atol=1e-7)


def test_predict_matches_oracle(rng):
    X, y = make_data(rng, n=50)
    Xs = rng.uniform(0, 10, (20, 3))
    var, ls, noise = 2.0, np.array([1.5, 1.0, 3.0]), 0.2
    model = gpm.GP(X, y)
    model.set_param_array(np.concatenate([[var], ls, [noise]]))

    mu, v = model.predict(Xs)
    mu_fc, cov = model.predict(Xs, full_cov=True)

    K = np_rbf(X, X, var, ls) + noise * np.eye(50)
    Kxs = np_rbf(Xs, X, var, ls)
    mu_o = Kxs @ np.linalg.solve(K, y)
    cov_o = (np_rbf(Xs, Xs, var, ls) - Kxs @ np.linalg.solve(K, Kxs.T)
             + noise * np.eye(20))
    np.testing.assert_allclose(np.asarray(mu), mu_o, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(mu_fc), mu_o, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(cov), cov_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(v), np.diag(cov_o), rtol=1e-7,
                               atol=1e-9)
    # latent (noise-free) variance
    _, v_lat = model.predict(Xs, include_noise=False)
    np.testing.assert_allclose(np.asarray(v_lat), np.diag(cov_o) - noise,
                               rtol=1e-6, atol=1e-9)


def test_optimize_improves_and_recovers(rng):
    X, y = make_data(rng, n=80, noise=0.1)
    model = gpm.GP(X, y, jitter=1e-8)
    ll0 = model.log_likelihood()
    model.optimize()
    assert model.log_likelihood() > ll0
    # fitted noise should be near the true observation noise variance (0.01)
    assert 1e-4 < float(model.params.noise) < 0.1


def test_matern32_model_runs(rng):
    X, y = make_data(rng, n=40)
    model = gpm.GP(X, y, kernel="matern32", jitter=1e-8)
    model.optimize(maxiter=50)
    mu, v = model.predict(X[:5])
    assert np.all(np.isfinite(np.asarray(mu)))
    assert np.all(np.asarray(v) > 0)


def test_param_array_roundtrip(rng):
    X, y = make_data(rng, n=10)
    model = gpm.GP(X, y)
    vec = np.array([2.0, 1.1, 2.2, 3.3, 0.5])
    model.set_param_array(vec)
    np.testing.assert_allclose(model.param_array, vec, rtol=1e-12)


def test_optimize_restarts_matches_scipy_quality(rng):
    """Device-batched vmapped L-BFGS must reach (or beat) the scipy
    host-loop optimum on a small problem."""
    X = rng.uniform(0, 5, (40, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(40)
    from mfgp_jax.models.gp import GP

    g1 = GP(X, y, jitter=1e-8)
    f_scipy = g1.optimize()
    g2 = GP(X, y, jitter=1e-8)
    f_dev = g2.optimize_restarts(n_restarts=4, maxiter=150, seed=1)
    assert f_dev <= f_scipy + 0.5
    mu1, _ = g1.predict(X[:5])
    mu2, _ = g2.predict(X[:5])
    np.testing.assert_allclose(mu1, mu2, atol=0.2)


def test_gp_analytic_gradient_matches_autodiff(rng):
    import jax

    from mfgp_jax.models import gp as g

    X = jnp.asarray(rng.uniform(0, 10, (50, 3)))
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)))
    p = g.GPParams(jnp.log(jnp.asarray(2.0)),
                   jnp.log(jnp.asarray([1.5, 0.7, 2.2])),
                   jnp.log(jnp.asarray(0.1)))
    for kern in ("rbf", "matern32"):
        v1, g1 = jax.value_and_grad(
            lambda q: g.nlml(q, X, y, kernel=kern, jitter=1e-8))(p)
        v2, g2 = g.nlml_value_and_grad(p, X, y, kernel=kern, jitter=1e-8)
        np.testing.assert_allclose(float(v2), float(v1), rtol=1e-12)
        for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       atol=1e-9)


def test_extend_data_matches_full_recondition(rng):
    """Online bordered-block conditioning == full refactorization."""
    from mfgp_jax.models.gp import GP

    X = rng.uniform(0, 10, (30, 3))
    y = np.sin(X.sum(1))
    Xn = rng.uniform(0, 10, (7, 3))
    yn = np.sin(Xn.sum(1))
    g1 = GP(X, y, jitter=1e-8)
    g1.extend_data(Xn, yn)
    g2 = GP(np.vstack([X, Xn]), np.concatenate([y, yn]), jitter=1e-8)
    g2.params = g1.params
    Xs = rng.uniform(0, 10, (12, 3))
    mu1, var1 = g1.predict(Xs)
    mu2, var2 = g2.predict(Xs)
    np.testing.assert_allclose(mu1, mu2, rtol=1e-9)
    np.testing.assert_allclose(var1, var2, rtol=1e-8, atol=1e-10)


def test_gp_value_grad_state_shares_factorization(rng):
    from mfgp_jax.models import gp as g

    X = rng.uniform(0, 10, (30, 3))
    y = np.sin(X.sum(1))
    p = g.GPParams.default(3)
    v, grad, state = g.nlml_value_grad_state(p, jnp.asarray(X),
                                             jnp.asarray(y), jitter=1e-8)
    state2 = g.condition(p, jnp.asarray(X), jnp.asarray(y), jitter=1e-8)
    np.testing.assert_allclose(np.asarray(state.L), np.asarray(state2.L),
                               atol=1e-14)
    v2, g2 = g.nlml_value_and_grad(p, jnp.asarray(X), jnp.asarray(y),
                                   jitter=1e-8)
    np.testing.assert_allclose(float(v), float(v2), rtol=1e-14)


def test_gp_inv_state_path_matches_standard(rng):
    """GP explicit-inverse fast path (nlml_value_grad_state_inv +
    predict_blocked_inv) matches the substitution path at f64."""
    import jax

    from mfgp_jax.models import gp as gpm

    N, D, M = 50, 3, 23
    X = rng.normal(size=(N, D))
    y = np.sin(X.sum(axis=1))
    grid = rng.normal(size=(M, D))
    params = gpm.GPParams.default(D, jnp.float64)
    v0, g0, s0 = gpm.nlml_value_grad_state(params, jnp.asarray(X),
                                           jnp.asarray(y), jitter=1e-10)
    v1, g1, s1 = gpm.nlml_value_grad_state_inv(params, jnp.asarray(X),
                                               jnp.asarray(y), jitter=1e-10)
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-8, atol=1e-10)
    mu0, var0 = gpm.predict_blocked(params, s0, jnp.asarray(grid),
                                    block_size=8)
    mu1, var1 = gpm.predict_blocked_inv(params, s1, jnp.asarray(grid),
                                        block_size=8)
    np.testing.assert_allclose(np.asarray(mu1), np.asarray(mu0), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(var1), np.asarray(var0),
                               rtol=1e-8, atol=1e-10)
