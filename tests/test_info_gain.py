"""Information-gain identity tests.

Generalizes the reference's only real numerical test
(reference/informationGainTest.py): the closed-form Cholesky scorers must
reproduce an explicit sequential GP-refit loop, and the mutual-information
identity 0.5 log(|K_prior|/|K_post|) == sum of sequential terms must hold.
"""

import numpy as np
import jax.numpy as jnp

from mfgp_jax.metrics.info_gain import (sequential_gain_from_cov,
                                        sequential_gain_cross,
                                        batch_logdet_gain, logdet)
from mfgp_jax.models import gp as gpm


def np_rbf(X1, X2, var, ls):
    d = X1[:, None, :] - X2[None, :, :]
    return var * np.exp(-0.5 * np.sum(d**2 / np.asarray(ls) ** 2, axis=-1))


def np_posterior_cov(Xs, Xtr, var, ls, noise):
    K = np_rbf(Xtr, Xtr, var, ls) + noise * np.eye(len(Xtr))
    Kxs = np_rbf(Xs, Xtr, var, ls)
    return np_rbf(Xs, Xs, var, ls) - Kxs @ np.linalg.solve(K, Kxs.T)


def explicit_sequential_loop(Xtr, ytr, path, var, ls, noise,
                             first_self_conditioned=True):
    """The reference's algorithm verbatim in numpy: add each path point as a
    noisy dummy observation, accumulate log(1 + predictive_var/noise)."""
    X = Xtr.copy()
    I = 0.0
    for i, x in enumerate(path):
        if first_self_conditioned and i == 0:
            X = np.vstack([X, x[None]])
            v = np_posterior_cov(x[None], X, var, ls, noise)[0, 0] + noise
            I += np.log(1 + v / noise)
            continue
        v = np_posterior_cov(x[None], X, var, ls, noise)[0, 0] + noise
        I += np.log(1 + v / noise)
        X = np.vstack([X, x[None]])
    return I


def test_sequential_closed_form_matches_refit_loop(rng):
    Xtr = rng.uniform(0, 10, (30, 3))
    path = rng.uniform(0, 10, (12, 3))
    var, ls, noise = 1.5, np.array([2.0, 1.0, 3.0]), 0.05
    Sigma = np_posterior_cov(path, Xtr, var, ls, noise)
    got = float(sequential_gain_from_cov(jnp.asarray(Sigma), noise))
    want = explicit_sequential_loop(Xtr, None, path, var, ls, noise)
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_sequential_without_self_conditioning(rng):
    Xtr = rng.uniform(0, 10, (20, 3))
    path = rng.uniform(0, 10, (8, 3))
    var, ls, noise = 1.0, np.array([1.0, 1.0, 1.0]), 0.1
    Sigma = np_posterior_cov(path, Xtr, var, ls, noise)
    got = float(sequential_gain_from_cov(jnp.asarray(Sigma), noise,
                                         first_self_conditioned=False))
    want = explicit_sequential_loop(Xtr, None, path, var, ls, noise,
                                    first_self_conditioned=False)
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_sequential_mask_equals_truncation(rng):
    Xtr = rng.uniform(0, 10, (15, 3))
    path = rng.uniform(0, 10, (10, 3))
    var, ls, noise = 1.0, np.array([1.5, 1.5, 1.5]), 0.2
    Sig_full = np_posterior_cov(path, Xtr, var, ls, noise)
    mask = np.array([True] * 6 + [False] * 4)
    got = float(sequential_gain_from_cov(jnp.asarray(Sig_full), noise,
                                         mask=jnp.asarray(mask)))
    Sig6 = np_posterior_cov(path[:6], Xtr, var, ls, noise)
    want = float(sequential_gain_from_cov(jnp.asarray(Sig6), noise))
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_mutual_information_identity(rng):
    """Exact MI identity: 0.5 log(|K + sig_n I| / |sig_n I|) equals the sum
    of sequential latent-conditional terms; the reference's predictive-variance
    sequential sum (reference/informationGainTest.py:37-53) approximates it.
    """
    from mfgp_jax.metrics.info_gain import exact_mutual_information

    X = rng.uniform(-3, 3, (10, 1))
    var, ls, noise = 0.74, np.array([1.57]), 0.001
    K = np_rbf(X, X, var, ls)
    # exact: determinant form == entropy difference H(y) - H(y|f)
    mi = float(exact_mutual_information(jnp.asarray(K), noise))
    lhs = float(batch_logdet_gain(jnp.asarray(K + noise * np.eye(10)),
                                  jnp.asarray(noise * np.eye(10))))
    np.testing.assert_allclose(mi, lhs, rtol=1e-9)
    # exact sequential form: latent conditional variances u_k = L_kk^2 - noise
    L = np.linalg.cholesky(K + noise * np.eye(10))
    u = np.diag(L) ** 2 - noise
    np.testing.assert_allclose(mi, 0.5 * np.sum(np.log(1 + u / noise)),
                               rtol=1e-7)
    # the reference's predictive-variance sum is an upper bound within
    # P*log(2) and close for small noise
    ref_style = float(sequential_gain_from_cov(
        jnp.asarray(K), noise, first_self_conditioned=False, factor=0.5))
    assert mi < ref_style < mi + 10 * np.log(2) * 0.5
    np.testing.assert_allclose(ref_style, mi, rtol=0.25)


def test_sequential_cross_reduces_to_same_set(rng):
    """When predicted and conditioning points coincide (same noise), the
    cross-set scorer equals the same-set closed form without
    self-conditioning."""
    Xtr = rng.uniform(0, 10, (25, 3))
    path = rng.uniform(0, 10, (9, 3))
    var, ls, noise = 2.0, np.array([1.0, 2.0, 1.0]), 0.1
    Sigma = np_posterior_cov(path, Xtr, var, ls, noise)
    C_cond = Sigma + noise * np.eye(9)
    got = float(sequential_gain_cross(
        jnp.asarray(np.diag(Sigma)), jnp.asarray(Sigma), jnp.asarray(C_cond),
        noise, noise))
    want = float(sequential_gain_from_cov(jnp.asarray(Sigma), noise,
                                          first_self_conditioned=False))
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_gain_via_model_api(rng):
    """End-to-end: GP model predict(full_cov, include_noise=False) feeds the
    scorer; more path points => more information."""
    Xtr = rng.uniform(0, 10, (40, 3))
    ytr = rng.standard_normal(40)
    model = gpm.GP(Xtr, ytr)
    model.set_param_array(np.array([1.0, 2.0, 2.0, 2.0, 0.1]))
    path = rng.uniform(0, 10, (10, 3))
    _, Sig = model.predict(path, full_cov=True, include_noise=False)
    I10 = float(sequential_gain_from_cov(Sig, float(model.params.noise)))
    _, Sig5 = model.predict(path[:5], full_cov=True, include_noise=False)
    I5 = float(sequential_gain_from_cov(Sig5, float(model.params.noise)))
    assert I10 > I5 > 0


def test_logdet_cache_helper(rng):
    A = rng.standard_normal((12, 12))
    K = A @ A.T + 12 * np.eye(12)
    np.testing.assert_allclose(float(logdet(jnp.asarray(K))),
                               np.linalg.slogdet(K)[1], rtol=1e-9)


def test_mf_sequential_matches_refit_loop(rng):
    """MFInfoGainCost's one-Cholesky closed form vs a literal per-point MF
    model refit loop (the reference's calculatePathInfoEmu procedure,
    reference/GraceRIGV3.py:525-562): condition on each path point at its
    accrued-variance fidelity with a dummy observation, predict the next
    at fidelity 0, accumulate log(1 + v/noise_0)."""
    from mfgp_jax.models.mfgp import MFGP
    from mfgp_jax.planning.scoring import MFInfoGainCost

    X = rng.uniform(0, 10, (25, 3))
    y = np.sin(X.sum(1))
    fid = rng.integers(0, 3, 25)
    m = MFGP(X, fid, y, jitter=0.0)
    fid_levels = [0.25, 2.25, 6.25]
    cost = MFInfoGainCost(model=m, fid_levels=fid_levels)

    P = 7
    path = np.column_stack([rng.uniform(0, 10, (P, 3)), np.arange(P),
                            rng.uniform(0, 8, P)])
    got = cost(path)

    # oracle: explicit refit per point
    fids_c = cost._fids_from_var(path[:, 4])
    noise0 = float(np.asarray(m.params.noises)[0])
    Xc, fc, yc = X.copy(), fid.copy(), y.copy()
    total = 0.0
    for i in range(P):
        m2 = MFGP(Xc, fc, yc, jitter=0.0)
        m2.params = m.params
        _, var = m2.predict(path[i : i + 1, :3], fid=0,
                            include_noise=True)
        v = float(np.asarray(var)[0])  # latent + fid-0 noise
        total += np.log(1 + v / noise0)
        Xc = np.vstack([Xc, path[i : i + 1, :3]])
        fc = np.concatenate([fc, [fids_c[i]]])
        yc = np.concatenate([yc, [0.0]])
    np.testing.assert_allclose(got, total, rtol=1e-7)
