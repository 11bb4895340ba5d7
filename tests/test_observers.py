"""Body-velocity observer + rotation utility tests (SURVEY C6)."""

import jax.numpy as jnp
import numpy as np

from mfgp_jax.estimation.observers import (BodyVelocityObserver,
                                           GliderParams, body_velocity_observer,
                                           buoyancy_mass, euler_rate_matrix,
                                           euler_to_rotm, flow_frame,
                                           rotm_to_euler, skew)


def test_rotation_roundtrip(rng):
    for _ in range(5):
        r, p, y = rng.uniform(-1.2, 1.2, 3)
        R = euler_to_rotm(r, p, y)
        # orthonormality
        np.testing.assert_allclose(np.asarray(R @ R.T), np.eye(3),
                                   atol=1e-12)
        # convention pin: the reference's eulerToRotm composes the
        # *world->body* (passive) rotation, while rot2eul extracts angles
        # from an active body->world matrix — the roundtrip negates the
        # angles (reference/GraceObservers.py:37-51). Documented behavior.
        rr, pp, yy = rotm_to_euler(R)
        np.testing.assert_allclose([float(rr), float(pp), float(yy)],
                                   [-r, -p, -y], atol=1e-10)


def test_skew_cross_product(rng):
    a = rng.normal(size=3)
    b = rng.normal(size=3)
    np.testing.assert_allclose(np.asarray(skew(jnp.asarray(a)) @ b),
                               np.cross(a, b), atol=1e-12)


def test_flow_frame_structure():
    # at zero angle of attack / sideslip the flow frame is the body frame
    np.testing.assert_allclose(np.asarray(flow_frame(0.0, 0.0)), np.eye(3),
                               atol=1e-12)
    # the reference's Rbv is NOT orthonormal in general
    # (reference/GraceObservers.py:53-54) — structural pin only
    F = np.asarray(flow_frame(0.3, -0.2))
    assert F[1, 2] == 0.0
    np.testing.assert_allclose(F[0, 2], -np.sin(0.3), atol=1e-12)


def test_euler_rate_matrix_identity_at_level():
    E = euler_rate_matrix(0.0, 0.0)
    np.testing.assert_allclose(np.asarray(E), np.eye(3), atol=1e-12)


def test_buoyancy_sign():
    p = GliderParams()
    assert float(buoyancy_mass(1.0, p)) > 0  # pumped full -> heavy
    assert float(buoyancy_mass(0.0, p)) < 0  # empty -> buoyant
    assert float(buoyancy_mass(p.bc, p)) == 0.0  # neutral


def test_observer_heavy_glider_accelerates_down():
    """With positive ballast and zero velocity, the only force is ballast
    gravity -> downward (body +z when level) acceleration."""
    p = GliderParams()
    R = jnp.eye(3)
    dPos, dvb = body_velocity_observer(
        R, jnp.zeros(3), jnp.zeros(3), z=0.0, zhat=0.0, ppx=1.0,
        delta=0.0, p=p)
    assert float(dvb[2]) > 0  # z-down body convention
    np.testing.assert_allclose(np.asarray(dPos), 0.0, atol=1e-12)


def test_observer_depth_error_correction_direction():
    """If the true depth exceeds the estimate, the correction must push the
    estimated position/velocity downward."""
    p = GliderParams()
    R = jnp.eye(3)
    dPos, dvb = body_velocity_observer(
        R, jnp.zeros(3), jnp.zeros(3), z=2.0, zhat=1.0, ppx=p.bc,
        delta=0.0, p=p)
    assert float(dPos[2]) > 0
    assert float(dvb[2]) > 0


def test_observer_drag_opposes_motion():
    p = GliderParams()
    R = jnp.eye(3)
    v = jnp.array([0.5, 0.0, 0.0])
    _, dvb = body_velocity_observer(R, jnp.zeros(3), v, 0.0, 0.0,
                                    ppx=p.bc, delta=0.0, p=p)
    assert float(dvb[0]) < 0  # forward drag decelerates


def test_stateful_observer_integrates(rng):
    obs = BodyVelocityObserver(params=GliderParams())
    vb = obs.init()
    assert np.asarray(vb).shape == (3,)
    meas = (jnp.eye(3), jnp.zeros(3), 1.0, 0.8, 0.7, 0.0)
    vb2 = obs.step(vb, meas, dt=0.1)
    assert np.isfinite(np.asarray(vb2)).all()
    assert not np.allclose(np.asarray(vb2), np.asarray(vb))
