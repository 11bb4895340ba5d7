"""Kalman filter tests: step oracles + scanned trajectory filter."""

import numpy as np
import jax
import jax.numpy as jnp

from mfgp_jax.estimation import kalman as kf


def np_kf_update(x, P, z, H, R):
    S = H @ P @ H.T + R
    K = P @ H.T @ np.linalg.inv(S)
    return x + K @ (z - H @ x), (np.eye(P.shape[0]) - K @ H) @ P


def test_update_matches_oracle(rng):
    n, m = 6, 6
    x = rng.standard_normal((n, 1))
    A = rng.standard_normal((n, n))
    P = A @ A.T + np.eye(n)
    z = rng.standard_normal((m, 1))
    H = np.diag(rng.random(m))
    R = np.diag(rng.random(m) + 0.1)
    xg, Pg = kf.kf_update(*map(jnp.asarray, (x, P, z, H, R)))
    xo, Po = np_kf_update(x, P, z, H, R)
    np.testing.assert_allclose(np.asarray(xg), xo, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(Pg), Po, rtol=1e-9)


def test_predict_matches_oracle(rng):
    n = 4
    x = rng.standard_normal((n, 1))
    u = rng.standard_normal((n, 1))
    A = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    B = np.eye(n)
    P = np.eye(n)
    Q = 0.01 * np.eye(n)
    xg, Pg = kf.kf_predict(*map(jnp.asarray, (x, u, A, B, P, Q)))
    np.testing.assert_allclose(np.asarray(xg), A @ x + B @ u, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(Pg), A @ P @ A.T + Q, rtol=1e-10)
    # no-input form
    xg2, _ = kf.kf_predict(jnp.asarray(x), None, jnp.asarray(A), None,
                           jnp.asarray(P), jnp.asarray(Q))
    np.testing.assert_allclose(np.asarray(xg2), A @ x, rtol=1e-10)


def _sim_model():
    return kf.KFModel(
        P0=jnp.asarray(0.001 * np.eye(6)),
        Q=jnp.asarray(np.diag([0.005, 0.005, 0.005, 0.05, 0.05, 0.05])),
        R=jnp.asarray(np.diag([0.1, 0.1, 0.05, 0.25, 0.25, 0.25])),
        meas_noise_std=jnp.asarray([0.05, 0.05, 0.02, 0.2, 0.2, 0.2]),
        at_surface=0.2,
    )


def _dive_trajectory(T=400, dt=0.5):
    t = np.arange(T) * dt
    x = 0.02 * t
    y = 0.01 * t
    z = 2.5 * (1 - np.cos(t * 2 * np.pi / 100))  # dive cycles to ~5m
    return t, np.column_stack([x, y, z])


def test_filter_trajectory_tracks_truth():
    t, pos = _dive_trajectory()
    out = kf.filter_trajectory(_sim_model(), jnp.asarray(t), jnp.asarray(pos),
                               jax.random.PRNGKey(0))
    err = np.asarray(out["err"])
    assert np.sqrt(np.mean(err**2)) < 0.5
    # depth is always measured -> z error small everywhere
    assert np.sqrt(np.mean(err[:, 2] ** 2)) < 0.1


def test_gps_gating_grows_xy_uncertainty_underwater():
    """Position sigma must grow while submerged and collapse at the surface
    (the mechanism that drives fidelity binning, SURVEY C16/C18)."""
    t, pos = _dive_trajectory()
    out = kf.filter_trajectory(_sim_model(), jnp.asarray(t), jnp.asarray(pos),
                               jax.random.PRNGKey(1))
    sig = np.asarray(out["sig"])
    under = pos[:-1, 2] > 0.2
    assert sig[under, 0].mean() > 3 * sig[~under, 0].mean()


def test_fidelity_bin_thresholds():
    fidlevels = (0.25, 2.25, 6.25)
    c = jnp.asarray([0.1, 0.25, 1.0, 2.25, 10.0])
    np.testing.assert_array_equal(
        np.asarray(kf.fidelity_bin(c, fidlevels)), [1, 2, 2, 3, 3])


def test_filter_vmaps_over_noise_seeds():
    """Batched trajectory sweeps: vmap over PRNG keys (replaces the
    reference's serial 88-run loop)."""
    t, pos = _dive_trajectory(T=100)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    outs = jax.vmap(lambda k: kf.filter_trajectory(
        _sim_model(), jnp.asarray(t), jnp.asarray(pos), k))(keys)
    assert outs["xh"].shape == (4, 99, 3)
    # different seeds -> different estimates
    assert not np.allclose(np.asarray(outs["xh"][0]), np.asarray(outs["xh"][1]))
