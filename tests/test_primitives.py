"""Motion-primitive synthesis and rollout tests (SURVEY C8)."""

import math

import numpy as np
import pytest

from mfgp_jax.planning import primitives as pr
from mfgp_jax.planning.primitives import AgentConfig, Leg


@pytest.fixture
def cfg():
    return AgentConfig.sim_defaults()


def test_swim_energy_quirk_preserved(cfg):
    """The reference calls SwimEnergy(duration, amp, freq) against a
    (t, f, a) signature; our swim_energy must reproduce those numerics."""
    t = 37.0
    f, a = cfg.tail_amp, cfg.tail_freq  # amp lands in f's slot
    wt = 4 * math.pi * f * t
    want = 0.5 * math.pi * a**2 * f * (math.sin(wt) + wt)
    assert abs(pr.swim_energy(t, cfg) - want) < 1e-12


def test_evaluate_single_swim(cfg):
    t, d, tuw, pts, bu = pr.evaluate_trajectory(
        [(Leg.SWIM, 6.0, cfg.swim_speed)], cfg)
    assert abs(t - 6.0 / cfg.swim_speed) < 1e-9
    assert abs(d - 6.0) < 1e-9
    assert tuw == 0.0  # surface swim accrues no underwater time
    assert pts.shape == (2, 4)
    assert abs(bu - (pr.swim_energy(t, cfg) * cfg.tail_energy_scale
                     + cfg.time_energy * t)) < 1e-9


def test_evaluate_dive_cycle_variance_resets(cfg):
    """Dive then resurface: variance accrues underwater, resets at surface;
    underwater time counted per submersion segment."""
    prims = [(Leg.FLATDIVE, 5.0, cfg.flat_dive_speed),
             (Leg.SWIM, 3.0, cfg.swim_speed),
             (Leg.FLATDIVE, -5.0, -cfg.flat_dive_speed)]
    t, d, tuw, pts, bu = pr.evaluate_trajectory(prims, cfg)
    dive_t = 5.0 / cfg.flat_dive_speed
    swim_t = 3.0 / cfg.swim_speed
    assert abs(tuw - (2 * dive_t + swim_t)) < 1e-9
    # variance accrued mid-dive, reset to zero once surfaced
    assert pts[1, 3] > 0 and pts[2, 3] > pts[1, 3]
    assert pts[-1, 3] == 0.0
    assert abs(pts[-1, 1]) < 1e-12  # back at surface


def test_glide_advances_distance(cfg):
    gp = math.radians(45)
    t, d, _, _, _ = pr.evaluate_trajectory(
        [(Leg.GLIDE, gp, 5.0, cfg.vert_glide_speed)], cfg)
    assert abs(d - 5.0 / math.tan(gp)) < 1e-9


@pytest.mark.parametrize("seed", range(20))
def test_generate_trajectory_invariants(cfg, seed):
    """Any composition must end at the surface having covered the distance
    exactly (the invariant the reference checks interactively,
    reference/GraceRIGV3.py:228-231)."""
    rng = np.random.default_rng(seed)
    legs = [Leg.SPIRAL, Leg.GLIDE, Leg.SWIM, Leg.FLATDIVE]
    choices = rng.choice(4, 3, p=cfg.leg_probs)
    distance = 1.0 + rng.random() * 9
    t, prims = pr.generate_trajectory(rng, [legs[c] for c in choices],
                                      distance, cfg)
    tt, dist, tuw, pts, bu = pr.evaluate_trajectory(prims, cfg)
    assert abs(dist - distance) < 1e-3
    assert abs(pts[-1, 1]) < 0.01  # surfaced
    assert t > 0 and bu > 0


def test_generate_deterministic(cfg):
    a = pr.generate_trajectory(np.random.default_rng(7),
                               [Leg.GLIDE, Leg.SWIM, Leg.FLATDIVE], 5.0, cfg)
    b = pr.generate_trajectory(np.random.default_rng(7),
                               [Leg.GLIDE, Leg.SWIM, Leg.FLATDIVE], 5.0, cfg)
    assert a == b


def test_edge_points_resampling(cfg):
    prims = [(Leg.FLATDIVE, 4.0, cfg.flat_dive_speed),
             (Leg.SWIM, 5.0, cfg.swim_speed),
             (Leg.FLATDIVE, -4.0, -cfg.flat_dive_speed)]
    _, _, _, wpnts, _ = pr.evaluate_trajectory(prims, cfg)
    ps, pf = np.array([1.0, 2.0]), np.array([6.0, 2.0])  # bearing = +x
    pts = pr.edge_points_to_traj_points(ps, pf, wpnts, meas_rate=0.05)
    # x advances from ps along bearing; y constant; depth within [0, 4]
    assert pts[0, 0] == 1.0 and np.allclose(pts[:, 1], 2.0)
    assert pts[:, 2].max() <= 4.0 + 1e-9 and pts[:, 2].min() >= -1e-9
    assert np.all(np.diff(pts[:, 3]) > 0)  # strictly increasing time
    # 0.05 Hz sampling
    assert np.allclose(np.diff(pts[:, 3]), 20.0)


def test_path_to_traj_points_concatenates_time(cfg):
    prims = [(Leg.SWIM, 3.0, cfg.swim_speed)]
    states = {0: np.array([[0.0], [0.0]]), 1: np.array([[3.0], [0.0]]),
              2: np.array([[3.0], [3.0]])}
    edges = [(0, 1, tuple(prims)), (1, 2, tuple(prims))]
    pts = pr.path_to_traj_points(states, edges, cfg, dense=True)
    assert np.all(np.diff(pts[:, 3]) >= 0)
    # second edge heads +y from node 1
    late = pts[pts[:, 3] > 3.0 / cfg.swim_speed]
    assert np.allclose(late[:, 0], 3.0, atol=1e-9)
