"""Robot runtime loop tests (SURVEY L4/C25).

The reference's main experiment loop (reference/PhysicalExperimentCode/
GraceExplorationExperiments_MFEGP.py:761-1033) is rebuilt in
hw/runtime.py; these tests fly planned primitive trajectories through the
full sense->estimate->control stack against the glider plant and check the
contracts the physical drivers relied on.
"""

import math

import numpy as np
import pytest

from mfgp_jax.hw.plant import GliderPlant, PlantParams
from mfgp_jax.hw.runtime import (FlightLog, RobotRuntime, RuntimeConfig,
                                 flight_plan, mass_spd_control,
                                 pump_spd_control2, traj_point)
from mfgp_jax.planning.primitives import (AgentConfig, Leg,
                                          evaluate_trajectory,
                                          generate_trajectory)


def _plan(seed=0, choices=(Leg.GLIDE, Leg.SWIM, Leg.FLATDIVE), dist=10.0,
          cfg=None):
    cfg = cfg or AgentConfig.sim_defaults()
    rng = np.random.default_rng(seed)
    _, prims = generate_trajectory(rng, list(choices), dist, cfg)
    _, _, _, wpnts, budget = evaluate_trajectory(prims, cfg)
    d = wpnts[:, 0]
    way = np.column_stack([d, np.zeros_like(d), wpnts[:, 1], wpnts[:, 2]])
    return way, list(prims), budget, cfg


def test_control_laws_signs():
    """pumpSpdControl2: too deep -> positive u1 (pump up); massSpdControl:
    pitch below target -> positive u2 (mass aft)."""
    gains = np.asarray((100.0, 3000.0, 20.0, 3.0))
    e_state = np.array([[0.5], [0.0], [0.0], [0.0]])  # 0.5 m too deep
    assert pump_spd_control2(1.0, e_state, gains, 5e5, 10.0) > 0
    # beyond max depth the hard term saturates the command upward
    assert pump_spd_control2(10.2, -e_state, gains, 5e5, 10.0) == 100.0
    assert mass_spd_control(0.0, 0.3, 0.0, (5.0, 0.5)) > 0
    assert mass_spd_control(0.3, 0.0, 0.0, (5.0, 0.5)) < 0


def test_plant_actuator_dynamics():
    p = GliderPlant(PlantParams())
    p.set_mass_pos(80.0)
    p.set_pump_pos(10.0)
    for _ in range(10):
        p.step(0.1)
    # slew-limited (20 %/s * 1 s = 20 %), not teleported
    assert p.mass_pos == pytest.approx(66.0, abs=1e-6)
    assert p.pump_pos == pytest.approx(35.0, abs=1e-6)
    # pump below neutral sinks the glider
    assert p.depth > 0.0
    # mass above neutral pitched it up
    assert p.pitch > 0.0


def test_runtime_flies_plan_with_nonzero_tracking_error():
    """One full plan through the control loop: tracking error nonzero but
    bounded; the glider ends near the planned endpoint; the position KF
    stays consistent (error within a few sigma of its covariance)."""
    way, legs, _, cfg = _plan()
    rt = RobotRuntime(cfg, RuntimeConfig(dt=0.1), seed=1)
    log = rt.fly(way, legs)
    assert isinstance(log, FlightLog)
    assert 0.05 < log.tracking_rmse < 5.0  # imperfect control, not chaos
    end_err = np.linalg.norm(rt.plant.position[:2] - way[-1, :2])
    assert end_err < 4.0
    # estimator consistency at the end of the flight
    est_err = np.linalg.norm(rt.xhat[:3, 0] - rt.plant.position)
    sigma = np.sqrt(np.trace(rt.xhat_P[:3, :3]))
    assert est_err < 6.0 * max(sigma, 0.05)
    # telemetry schemas populated every tick
    n = log.estimates.shape[0]
    assert n > 100
    assert log.control.shape[0] == n
    assert log.traj_info.shape[0] == n
    assert log.measurements.shape[0] == n
    assert np.isfinite(log.estimates).all()


def test_runtime_budget_within_tolerance_of_planner_model():
    """Integrated actuator-rate energy (reference :800-806) must agree
    with the planner's evaluate_trajectory budget model to within +/-15%
    on representative paths. The tail weight is DERIVED from the
    planner's SwimEnergy model (derived_tail_weight), not calibrated."""
    for seed, choices, dist in [
            (0, (Leg.GLIDE, Leg.SWIM, Leg.FLATDIVE), 10.0),
            (3, (Leg.SWIM, Leg.SWIM, Leg.GLIDE), 8.0),
            (5, (Leg.FLATDIVE, Leg.GLIDE, Leg.SWIM), 12.0)]:
        way, legs, budget, cfg = _plan(seed, choices, dist)
        rt = RobotRuntime(cfg, RuntimeConfig(dt=0.1), seed=1)
        log = rt.fly(way, legs)
        ratio = log.plan_budget / budget
        assert 0.85 < ratio < 1.15, (seed, ratio)


def test_derived_tail_weight_matches_continuous_model():
    """derived_tail_weight for a SIN gait approaches the continuous-time
    closed form w = tail_energy_scale * (k^2 + omega^2) / k^2 as dt -> 0
    (the estimator is a first-order lag: ddelta = k s/(s+k) delta, so
    E[ddelta^2]/E[delta_dot^2] = k^2/(k^2+omega^2))."""
    from mfgp_jax.hw.runtime import derived_tail_weight

    cfg = AgentConfig.sim_defaults()
    k = 5.0
    omega = 2.0 * np.pi * cfg.tail_freq
    analytic = cfg.tail_energy_scale * (k * k + omega * omega) / (k * k)
    w = derived_tail_weight(cfg, dt=0.002, k_delta=k, wave="sin",
                            horizon=120.0)
    # the sin-gait SwimEnergy linear term equals int delta_dot^2 exactly
    # (quirk included — it is symmetric in amp/freq); the bounded sin
    # ripple and discretization account for the tolerance
    np.testing.assert_allclose(w, analytic, rtol=0.05)


def test_runtime_fidelity_binning_uses_kf_covariance():
    """Samples carry fidelity labels from tr(Pxhat_xy) against the agent
    fid levels (reference :809-819); a long underwater stretch must
    produce lower-fidelity samples than the surface portion."""
    way, legs, _, cfg = _plan(5, (Leg.FLATDIVE, Leg.GLIDE, Leg.SWIM), 12.0)
    rt = RobotRuntime(cfg, RuntimeConfig(dt=0.1), seed=1)
    log = rt.fly(way, legs)
    assert log.samples.shape[0] > 3
    fids = log.samples[:, 8].astype(int)
    assert set(fids) <= {1, 2, 3}
    assert fids.max() > 1  # underwater drift produced degraded fidelity


def test_runtime_velocity_observer_bounded():
    way, legs, _, cfg = _plan()
    rt = RobotRuntime(cfg, RuntimeConfig(dt=0.1), seed=1)
    log = rt.fly(way, legs)
    vb = log.estimates[:, 17:20]
    assert np.isfinite(vb).all()
    assert np.abs(vb).max() <= rt.cfg.vb_cap


def test_flight_log_save_schemas(tmp_path):
    way, legs, _, cfg = _plan(3, (Leg.SWIM,), 3.0)
    rt = RobotRuntime(cfg, RuntimeConfig(dt=0.1), seed=1)
    log = rt.fly(way, legs)
    log.save(str(tmp_path), suffix="0")
    for name, cols in [("estimates0.csv", 21), ("control0.csv", 10),
                       ("trajInfo0.csv", 9), ("measurements0.csv", 12)]:
        arr = np.loadtxt(tmp_path / name, delimiter=",", skiprows=1)
        assert arr.shape[1] == cols, name


def test_traj_point_interpolation():
    way = np.array([[0.0, 0.0, 0.0, 0.0], [10.0, 0.0, 2.0, 10.0]])
    np.testing.assert_allclose(traj_point(5.0, way), [5.0, 0.0, 1.0])


def test_runtime_state_persists_across_plans():
    """Budget and KF state carry over plans like the reference's single
    long-running process; plan_budget isolates the increment."""
    way, legs, _, cfg = _plan(3, (Leg.SWIM,), 3.0)
    rt = RobotRuntime(cfg, RuntimeConfig(dt=0.1), seed=1)
    log1 = rt.fly(way, legs)
    log2 = rt.fly(way + np.array([3.0, 0, 0, 0.0]), legs)
    assert log2.budget_used > log1.budget_used
    assert log2.plan_budget == pytest.approx(
        log2.budget_used - log1.budget_used)


def test_exploration_sim_dynamic_flight_mfegp_end_to_end(tmp_path):
    """The MFEGP variant (MF model + ergodic cost) completes a full
    closed-loop run flying through the dynamic runtime: plans are flown
    with real tracking error, samples are fidelity-binned from the live
    KF covariance, the model retrains, and artifacts are emitted."""
    from mfgp_jax.sim import ExplorationSim
    from mfgp_jax.utils.configs import ExperimentConfig

    exp = ExperimentConfig(multi_fidelity=True, ergodic=True, B=20.0, BD=2)
    sim = ExplorationSim(exp, seed=0, plan_iters=8, flight="dynamic",
                         out_dir=str(tmp_path))
    res = sim.run(max_replans=2)
    assert len(res.replans) >= 1
    rec = res.replans[0]
    assert rec.tracking_rmse is not None and rec.tracking_rmse > 0.01
    assert rec.flown_budget is not None and rec.flown_budget > 0
    assert res.gp_data.data.shape[0] >= 4
    assert res.rmse is not None and np.isfinite(res.rmse)
    assert (tmp_path / "plannedTraj0.csv").exists()
    assert (tmp_path / "estimates0.csv").exists()
    assert (tmp_path / "control0.csv").exists()
