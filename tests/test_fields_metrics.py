"""WRBF fields, ergodic KL, Fourier/Sobolev, and EID tests."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.stats

from mfgp_jax.fields import (WRBFField, random_field, write_field_settings,
                             parse_field_settings)
from mfgp_jax.fields.wrbf import default_sim_field
from mfgp_jax.metrics import (softmax, config_grid, trajectory_distribution,
                              kl_divergence, gaussian_sensor,
                              expected_information_density,
                              config_k, basis_norms, sobolev_weights,
                              fourier_basis, fourier_coefficients,
                              merge_coefficients, sobolev_norm)


# -- fields -----------------------------------------------------------------
def np_wrbf(x, p, L, s, w):
    d = s * np.linalg.norm((x - p) * w, axis=1)
    return np.sum(L * np.exp(-d**2))


def test_wrbf_matches_oracle(rng):
    p = rng.uniform(0, 10, (5, 3))
    w = np.array([1.5, 1.0, 0.5])
    f = WRBFField(p=jnp.asarray(p), L=jnp.asarray(10.0), s=jnp.asarray(0.5),
                  w=jnp.asarray(w))
    X = rng.uniform(0, 10, (20, 3))
    got = np.asarray(f(X))
    want = np.array([np_wrbf(x, p, 10.0, 0.5, w) for x in X])
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert f.column(X).shape == (20, 1)


def test_default_sim_field_source_layout():
    f = default_sim_field([[0, 10], [0, 20]], 10)
    p = np.asarray(f.p)
    np.testing.assert_allclose(p[0], [7.0, 14.0, 5.0])
    assert p.shape == (5, 3)


def test_field_settings_roundtrip(tmp_path, rng):
    f = random_field(rng, [[0, 10], [0, 20]], 10)
    path = tmp_path / "FieldSettings0.txt"
    write_field_settings(path, f, WS=[[0, 10], [0, 20]], max_depth=10,
                        meas_noise=0.125)
    g = parse_field_settings(path)
    np.testing.assert_allclose(np.asarray(g.p), np.asarray(f.p), rtol=1e-4)
    np.testing.assert_allclose(float(g.L), float(f.L), rtol=1e-4)
    X = rng.uniform(0, 10, (5, 3))
    np.testing.assert_allclose(np.asarray(g(X)), np.asarray(f(X)), rtol=1e-3)


def test_parse_reference_field_settings(reference_root):
    """Our parser must read the reference's committed artifacts."""
    f = parse_field_settings(
        f"{reference_root}/Data/TrajectoriesAndEstimates/FieldData/FieldSettings0.txt")
    assert np.asarray(f.p).shape == (5, 3)
    assert float(f.L) > 0


# -- ergodic ----------------------------------------------------------------
def test_softmax_is_distribution(rng):
    a = rng.standard_normal(50) * 10
    p = np.asarray(softmax(a))
    assert abs(p.sum() - 1) < 1e-12 and (p > 0).all()
    # shift invariance (the overflow-safe form)
    np.testing.assert_allclose(p, np.asarray(softmax(a + 500)), rtol=1e-10)


def test_gaussian_sensor_matches_scipy(rng):
    x = rng.uniform(0, 2, (7, 2))
    s = np.array([1.0, 0.5])
    var = np.array([0.01, 0.04])
    got = np.asarray(gaussian_sensor(x, s, var))
    want = scipy.stats.multivariate_normal(mean=s, cov=np.diag(var)).pdf(x)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def reference_style_integrand(t, x, ss, var):
    """Per-grid-cell loop + trapz, as the reference computes it."""
    p = np.zeros(ss.shape[0])
    for i in range(ss.shape[0]):
        dens = scipy.stats.multivariate_normal(
            mean=ss[i], cov=np.diag(var)).pdf(x)
        p[i] = np.trapezoid(dens, t)
    return p / (t[-1] - t[0])


def test_trajectory_distribution_matches_loop(rng):
    ss, *_ = config_grid([0, 4, 12], [0, 2, 9])
    x = np.array([[0, 0], [0, 1], [2, 1], [2, 2], [3, 1]], float)
    t = np.arange(5.0)
    var = np.array([0.01, 0.01])
    got = np.asarray(trajectory_distribution(t, x, ss, var))
    want = reference_style_integrand(t, x, ss, var)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-30)
    # parity quirk: reference leaves the last grid cell at 0
    got_q = np.asarray(trajectory_distribution(t, x, ss, var,
                                               parity_drop_last=True))
    assert got_q[-1] == 0
    np.testing.assert_allclose(got_q[:-1], want[:-1], rtol=1e-9, atol=1e-30)


def test_trajectory_distribution_mask_equals_truncation(rng):
    """Padded+masked == computed on the unpadded trajectory."""
    ss, *_ = config_grid([0, 4, 8], [0, 2, 6])
    x = rng.uniform(0, 3, (6, 2))
    t = np.sort(rng.uniform(0, 10, 6))
    var = np.array([0.05, 0.05])
    full = np.asarray(trajectory_distribution(t[:4], x[:4], ss, var))
    xp = np.vstack([x[:4], np.zeros((2, 2))])
    tp = np.concatenate([t[:4], t[3] + np.arange(1, 3)])
    mask = np.array([1, 1, 1, 1, 0, 0], bool)
    got = np.asarray(trajectory_distribution(tp, xp, ss, var, mask=mask))
    np.testing.assert_allclose(got, full, rtol=1e-9, atol=1e-30)


def test_kl_matches_scipy(rng):
    p = rng.random(30) + 1e-3
    q = rng.random(30) + 1e-3
    got = float(kl_divergence(p, q))
    np.testing.assert_allclose(got, scipy.stats.entropy(p, q), rtol=1e-10)


# -- Fourier/Sobolev --------------------------------------------------------
def test_config_k_and_norm_shapes():
    k = config_k([5, 4.0], [3, 2.0])
    assert k.shape == (15, 2)
    hk = np.asarray(basis_norms(k))
    assert hk.shape == (15,) and np.isfinite(hk).all()
    # k = 0 row has h = 1
    zero_row = np.where((k == 0).all(axis=1))[0][0]
    np.testing.assert_allclose(hk[zero_row], 1.0)


def test_fourier_basis_matches_loop(rng):
    x = rng.uniform(0, 2, (6, 2))
    k = config_k([4, 2.0], [4, 2.0])
    got = np.asarray(fourier_basis(x, k))
    want = np.zeros((k.shape[0], x.shape[0]))
    for i in range(k.shape[0]):
        want[i] = np.prod(np.cos(x * k[i] * np.pi), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_sobolev_metric_discriminates(rng):
    """A trajectory matching the target density scores lower than one far
    from it — the property the reference's demo exercises."""
    sources = rng.uniform(0, 2, (4, 2))
    ss, *_ = config_grid([0, 4, 20], [0, 2, 20])
    dens = np.sum(25 * np.exp(-25 * np.linalg.norm(
        ss[:, None, :] - sources[None], axis=2) ** 2), axis=1)
    k = config_k([8, 4.0], [8, 2.0])
    phik = np.asarray(fourier_coefficients(ss, dens, k))
    on_target = np.asarray(fourier_coefficients(
        sources, np.ones(4), k))
    off_target = np.asarray(fourier_coefficients(
        np.full((4, 2), [3.9, 0.05]), np.ones(4), k))
    assert float(sobolev_norm(phik, on_target, k)) < float(
        sobolev_norm(phik, off_target, k))
    # streaming merge == batch coefficients
    c1 = fourier_coefficients(sources[:2], np.ones(2), k)
    c2 = fourier_coefficients(sources[2:], np.ones(2), k)
    np.testing.assert_allclose(np.asarray(merge_coefficients(c1, c2, 2, 2)),
                               on_target, rtol=1e-9)


# -- EID --------------------------------------------------------------------
def test_eid_is_distribution_and_prefers_high_ucb(rng):
    mu = rng.random(40)
    sig = rng.random(40) * 0.5
    eid = np.asarray(expected_information_density(mu, sig, prior_sig=1.0,
                                                  alpha=0.5))
    assert abs(eid.sum() - 1) < 1e-12
    ucb = 0.5 * mu + 0.5 * np.sqrt(sig)
    assert eid.argmax() == ucb.argmax()


def test_eid_neg_var_guards():
    mu = np.linspace(0, 1, 10)
    sig = np.ones(10); sig[3] = -0.5
    uni = np.asarray(expected_information_density(mu, sig, 1.0,
                                                  neg_var_guard="uniform"))
    np.testing.assert_allclose(uni, 0.1)
    cl = np.asarray(expected_information_density(mu, sig, 1.0,
                                                 neg_var_guard="clamp"))
    assert abs(cl.sum() - 1) < 1e-12 and not np.allclose(cl, 0.1)
    # clamping replaces only the negative entry, so the clamped EID equals
    # the EID of the repaired variance vector
    sig_fixed = sig.copy(); sig_fixed[3] = 1.0
    np.testing.assert_allclose(
        cl, np.asarray(expected_information_density(mu, sig_fixed, 1.0)),
        rtol=1e-10)


def test_eid_auto_alpha():
    mu = np.linspace(0, 1, 10)
    sig = np.full(10, 0.25)
    # auto alpha = 1 - mean(sig)/prior = 0.75 -> equals explicit alpha
    a = np.asarray(expected_information_density(mu, sig, 1.0, auto=True))
    b = np.asarray(expected_information_density(mu, sig, 1.0, alpha=0.75))
    np.testing.assert_allclose(a, b, rtol=1e-10)
