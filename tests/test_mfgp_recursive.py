"""Recursive multi-fidelity GP tests (Le Gratiet formulation)."""

import numpy as np
import pytest

from mfgp_jax.models.mfgp import MFGP
from mfgp_jax.models.mfgp_recursive import RecursiveMFGP


@pytest.fixture
def nested(rng):
    X0 = rng.uniform(0, 10, (50, 2))
    X1, X2 = X0[:25], X0[:10]
    flo = lambda x: np.sin(x[:, 0]) + 0.3 * np.cos(x[:, 1])
    y0 = flo(X0)
    y1 = flo(X1) + 0.15 * np.sin(2 * X1[:, 1])
    y2 = y1[:10] + 0.1 * np.cos(3 * X2[:, 0])
    return [X0, X1, X2], [y0, y1, y2]


def test_matches_joint_ar1_on_nested_noiseless(nested, rng):
    """Le Gratiet equivalence: for nested noise-free designs with observed
    residuals, the recursive posterior equals the joint AR1 posterior."""
    Xs_list, ys_list = nested
    eps = 1e-10
    joint = MFGP.from_fidelity_lists(Xs_list, ys_list, jitter=0.0)
    joint.set_param_array(
        np.array([1.0, 2, 2, 0.5, 2, 2, 0.25, 2, 2, 1, 1, eps, eps, eps]))
    rec = RecursiveMFGP.from_fidelity_lists(
        Xs_list, ys_list, jitter=0.0, residual_mode="observed")
    hyps = [[1.0, 2, 2, eps], [0.5, 2, 2, eps], [0.25, 2, 2, eps]]
    for m, gp in enumerate(rec.levels):
        gp.set_param_array(hyps[m])
    rec._build()
    for m, gp in enumerate(rec.levels):
        gp.set_param_array(hyps[m])
    Xs = rng.uniform(0, 10, (40, 2))
    mu_j, var_j = joint.predict(Xs, include_noise=False)
    mu_r, var_r = rec.predict(Xs, include_noise=False)
    np.testing.assert_allclose(mu_r, np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(var_r, np.asarray(var_j), atol=1e-5)


def test_trained_recursive_beats_single_fidelity(nested, rng):
    """With few high-fidelity points, fusing the low-fidelity level must
    beat an SFGP trained on the high-fidelity points alone."""
    from mfgp_jax.models.gp import GP

    Xs_list, ys_list = nested
    truth = lambda x: (np.sin(x[:, 0]) + 0.3 * np.cos(x[:, 1])
                       + 0.15 * np.sin(2 * x[:, 1])
                       + 0.1 * np.cos(3 * x[:, 0]))
    rec = RecursiveMFGP.from_fidelity_lists(Xs_list, ys_list)
    rec.optimize(n_restarts=2, maxiter=100)
    sf = GP(Xs_list[2], ys_list[2], jitter=1e-8)
    sf.optimize_restarts(n_restarts=2, maxiter=100)
    Xt = rng.uniform(0, 10, (60, 2))
    mu_r, _ = rec.predict(Xt)
    mu_s, _ = sf.predict(Xt)
    rmse_r = np.sqrt(np.mean((mu_r - truth(Xt)) ** 2))
    rmse_s = np.sqrt(np.mean((np.asarray(mu_s) - truth(Xt)) ** 2))
    assert rmse_r < rmse_s


def test_handles_empty_level(rng):
    X = rng.uniform(0, 5, (12, 2))
    y = np.sin(X[:, 0])
    rec = RecursiveMFGP.from_fidelity_lists([X[:0], X[:6], X[6:]],
                                            [y[:0], y[:6], y[6:]])
    mu, var = rec.predict(X[:4])
    assert np.isfinite(mu).all() and (var >= 0).all()


def test_rho_estimation(rng):
    """fix_rhos=False recovers the true AR1 scale by least squares."""
    X0 = rng.uniform(0, 10, (60, 1))
    X1 = X0[:30]
    y0 = np.sin(X0[:, 0])
    y1 = 2.5 * np.sin(X1[:, 0]) + 0.01 * rng.standard_normal(30)
    rec = RecursiveMFGP.from_fidelity_lists([X0, X1], [y0, y1],
                                            fix_rhos=False)
    rec.optimize(n_restarts=2, maxiter=100)
    assert abs(rec.rhos[0] - 2.5) < 0.2
