"""Device-resident primitive synthesis/rollout (planning/primitives_device).

Pins the host invariants (reference/GraceRIGV3.py:86-294 semantics): every
synthesized trajectory ends at the surface and covers the commanded
distance exactly; rollout accounting (time, distance, max underwater time,
variance resets, budget) matches the host evaluate_trajectory on the SAME
primitive sequences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfgp_jax.planning import primitives as host
from mfgp_jax.planning.primitives import AgentConfig, Leg
from mfgp_jax.planning.primitives_device import (
    NOOP, evaluate_trajectory_device, generate_trajectories_batch,
    generate_trajectory_device, padded_to_prims)


@pytest.fixture(scope="module")
def cfg():
    return AgentConfig.sim_defaults()


_to_host_prims = padded_to_prims  # shared converter (product code)


def test_synthesis_invariants_batch(cfg, rng):
    """200 random candidates: surface finish + exact distance coverage,
    verified by the HOST rollout on the device-synthesized sequences."""
    B, n = 200, cfg.num_legs
    choices = jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32)
    dists = jnp.asarray(rng.uniform(0.5, 6.0, B))
    prims = generate_trajectories_batch(jax.random.key(0), choices, dists,
                                        cfg)
    assert prims.shape == (B, 2 * n + 1, 4)
    for b in range(B):
        seq = _to_host_prims(prims[b])
        assert seq, f"empty sequence at {b}"
        t, dist, tuw, pts, budget = host.evaluate_trajectory(seq, cfg)
        assert abs(dist - float(dists[b])) < 1e-3, (b, dist, float(dists[b]))
        assert abs(pts[-1, 1]) < 0.011, (b, pts[-1, 1], seq)
        assert t > 0 and budget > 0


def test_device_rollout_matches_host(cfg, rng):
    """evaluate_trajectory_device == host evaluate_trajectory on the same
    padded sequences (time, dist, max tuw, budget, final waypoint)."""
    B, n = 64, cfg.num_legs
    choices = jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32)
    dists = jnp.asarray(rng.uniform(0.5, 6.0, B))
    cfg_var = AgentConfig.sim_defaults()
    cfg_var.variance_rate = 0.01  # exercise variance accrual + resets
    prims = generate_trajectories_batch(jax.random.key(1), choices, dists,
                                        cfg_var)
    ev = jax.vmap(lambda p: evaluate_trajectory_device(p, cfg_var))
    t_d, dist_d, tuw_d, pts_d, budget_d = ev(prims)
    for b in range(B):
        seq = _to_host_prims(prims[b])
        t, dist, tuw, pts, budget = host.evaluate_trajectory(seq, cfg_var)
        np.testing.assert_allclose(float(t_d[b]), t, rtol=1e-9)
        np.testing.assert_allclose(float(dist_d[b]), dist, rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(float(tuw_d[b]), tuw, rtol=1e-9)
        np.testing.assert_allclose(float(budget_d[b]), budget, rtol=1e-9)
        # final non-padding waypoint matches the host's last row
        np.testing.assert_allclose(np.asarray(pts_d[b, -1]), pts[-1],
                                   rtol=1e-9, atol=1e-12)


def test_determinism(cfg):
    choices = jnp.asarray([[2, 1, 0], [3, 2, 2]], jnp.int32)
    dists = jnp.asarray([3.0, 5.0])
    a = generate_trajectories_batch(jax.random.key(7), choices, dists, cfg)
    b = generate_trajectories_batch(jax.random.key(7), choices, dists, cfg)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_synthesis_invariants_spiral_surfacing(rng):
    """surface_by_spiral=True exercises the spiral surfacing branch
    (reference/GraceRIGV3.py:217-227's other arm)."""
    cfg2 = AgentConfig.sim_defaults()
    cfg2.surface_by_spiral = True
    B, n = 60, cfg2.num_legs
    choices = jnp.asarray(rng.integers(0, 4, (B, n)), jnp.int32)
    dists = jnp.asarray(rng.uniform(0.5, 6.0, B))
    prims = generate_trajectories_batch(jax.random.key(2), choices, dists,
                                        cfg2)
    for b in range(B):
        seq = _to_host_prims(prims[b])
        t, dist, tuw, pts, budget = host.evaluate_trajectory(seq, cfg2)
        assert abs(dist - float(dists[b])) < 1e-3
        assert abs(pts[-1, 1]) < 0.011
