"""Device runtime (hw/runtime_device.py): the sense->estimate->control
loop as one lax.scan.

Correctness anchor: with every sensor-noise scale at zero the device scan
must integrate the SAME closed-loop trajectory as the host
``RobotRuntime.fly`` (identical tick order, gates, saturations) — an
end-to-end parity check of plant dynamics, all four KFs, the observer,
and the four control laws at once. Noisy behavior is checked
statistically (bounded tracking, budget model agreement)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfgp_jax.hw.runtime import RobotRuntime, RuntimeConfig
from mfgp_jax.hw.runtime_device import DeviceRuntime
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


def _zero_noise(dt=0.1):
    return RuntimeConfig(dt=dt, fix_noise=0.0, fix_vel_noise=0.0,
                         depth_noise=0.0, euler_noise=0.0, gyro_noise=0.0)


@pytest.mark.parametrize("seed,choices,dist", [
    (0, (Leg.GLIDE, Leg.SWIM, Leg.FLATDIVE), 10.0),
    (3, (Leg.SWIM, Leg.SWIM, Leg.GLIDE), 8.0),
    (12, (Leg.FLATDIVE, Leg.GLIDE, Leg.SWIM), 6.0),
])
def test_device_runtime_zero_noise_parity(seed, choices, dist):
    """Zero-noise closed loop: device scan == host loop (trajectory,
    budget, tracking RMSE, sample schedule and fidelity labels).

    Plans are kept under ~100 s: the closed loop is exponentially
    sensitive (a 1e-13 rounding difference between numpy and XLA linalg
    doubles every ~3 s of flight — measured), so samplewise parity is
    asserted where it is numerically meaningful;
    test_device_runtime_long_flight_statistics covers the long-horizon
    regime with aggregate contracts."""
    way, legs, _, cfg = _plan(seed, choices, dist)
    host = RobotRuntime(cfg, _zero_noise(), seed=1)
    hlog = host.fly(way, legs)

    dev = DeviceRuntime(cfg, _zero_noise())
    dlog = dev.fly_log(way, legs, seed=1)

    # samplewise window: the first 60 s (600 ticks), before rounding
    # differences between numpy and XLA linalg amplify through the
    # closed loop
    n = min(600, hlog.truth.shape[0])
    assert dlog["truth"].shape[0] == hlog.truth.shape[0]
    # same closed-loop trajectory (host truth rows: t,x,y,depth,vx,vy,vz)
    np.testing.assert_allclose(dlog["truth"][:, 0], hlog.truth[:, 0],
                               rtol=0, atol=1e-9)  # tick clock
    np.testing.assert_allclose(dlog["truth"][:n, 1:4],
                               hlog.truth[:n, 1:4],
                               rtol=1e-6, atol=1e-6)
    # whole-flight aggregates: loose (chaotic tail of long flights)
    np.testing.assert_allclose(dlog["tracking_rmse"], hlog.tracking_rmse,
                               rtol=5e-2)
    np.testing.assert_allclose(dlog["budget_used"], hlog.budget_used,
                               rtol=2e-2)
    # same position-KF estimate trace
    np.testing.assert_allclose(dlog["estimates"][:n, 1:7],
                               hlog.estimates[:n, 5:11],
                               rtol=1e-5, atol=1e-5)
    # same sample schedule, estimates, and fidelity labels in the window
    # (GPData rows: t,x,y,z,xh,yh,zh,field,fidLev)
    assert dlog["samples"].shape[0] == hlog.samples.shape[0]
    t_win = hlog.truth[n - 1, 0]
    sm = hlog.samples[:, 0] <= t_win
    np.testing.assert_allclose(dlog["samples"][sm, 0],
                               hlog.samples[sm, 0], atol=1e-9)
    np.testing.assert_allclose(dlog["samples"][sm, 1:7],
                               hlog.samples[sm, 1:7],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dlog["samples"][sm, 8].astype(int),
                                  hlog.samples[sm, 8].astype(int))


def test_device_runtime_long_flight_statistics():
    """A 200 s flight: samplewise parity is lost to closed-loop chaos
    (see above), but the flight-level quantities the mission consumes —
    integrated energy, tracking RMSE, sample count — must still agree
    with the host loop tightly."""
    way, legs, _, cfg = _plan(5, (Leg.FLATDIVE, Leg.GLIDE, Leg.SWIM), 12.0)
    host = RobotRuntime(cfg, _zero_noise(), seed=1)
    hlog = host.fly(way, legs)
    dev = DeviceRuntime(cfg, _zero_noise())
    dlog = dev.fly_log(way, legs, seed=1)
    assert hlog.truth.shape[0] == dlog["truth"].shape[0]
    np.testing.assert_allclose(dlog["budget_used"], hlog.budget_used,
                               rtol=5e-2)
    np.testing.assert_allclose(dlog["tracking_rmse"], hlog.tracking_rmse,
                               rtol=0.05)
    assert abs(dlog["samples"].shape[0] - hlog.samples.shape[0]) <= 2


def test_device_runtime_budget_within_tolerance_of_planner_model():
    """Same contract as the host runtime: integrated actuator-rate energy
    agrees with the planner's evaluate_trajectory budget within +/-15%
    (tail weight DERIVED from SwimEnergy, reference :800-806)."""
    way, legs, budget, cfg = _plan(3, (Leg.SWIM, Leg.SWIM, Leg.GLIDE), 8.0)
    dev = DeviceRuntime(cfg, RuntimeConfig(dt=0.1))
    dlog = dev.fly_log(way, legs, seed=1)
    assert 0.85 < dlog["plan_budget"] / budget < 1.15


def test_device_runtime_noisy_tracking_bounded():
    """With the default sensor noise the loop still tracks: nonzero but
    bounded tracking error, KF-consistent endpoint (host test contract)."""
    way, legs, _, cfg = _plan()
    dev = DeviceRuntime(cfg, RuntimeConfig(dt=0.1))
    dlog = dev.fly_log(way, legs, seed=1)
    assert 0.05 < dlog["tracking_rmse"] < 5.0
    carry = dlog["carry"]
    end_err = float(jnp.linalg.norm(jnp.stack(
        [carry["px"], carry["py"]]) - way[-1, :2]))
    assert end_err < 4.0
    est_err = float(jnp.linalg.norm(
        carry["xhat"][:3] - jnp.stack([carry["px"], carry["py"],
                                       carry["pz"]])))
    sigma = float(jnp.sqrt(jnp.trace(carry["xhat_P"][:3, :3])))
    assert est_err < 6.0 * max(sigma, 0.05)


def test_device_runtime_state_persists_across_plans():
    way, legs, _, cfg = _plan(3, (Leg.SWIM,), 3.0)
    dev = DeviceRuntime(cfg, RuntimeConfig(dt=0.1))
    log1 = dev.fly_log(way, legs, seed=1)
    log2 = dev.fly_log(way + np.array([3.0, 0, 0, 0.0]), legs,
                       carry=log1["carry"], seed=2)
    assert log2["budget_used"] > log1["budget_used"]
    assert log2["plan_budget"] == pytest.approx(
        log2["budget_used"] - log1["budget_used"], rel=1e-9)


def test_device_runtime_vmapped_flight_ensemble():
    """The whole closed-loop flight vmaps over noise keys: a Monte-Carlo
    tracking study in one launch."""
    way, legs, _, cfg = _plan(3, (Leg.SWIM, Leg.GLIDE), 6.0)
    dev = DeviceRuntime(cfg, RuntimeConfig(dt=0.1))
    plan = dev.pack_plan(way, legs)
    carry = dev.init_carry(way[0][0], way[0][1])
    t_cap = int(math.ceil(way[-1][3] / 0.1)) + 1
    keys = jax.random.split(jax.random.key(0), 4)
    carry_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (4,) + a.shape),
                           carry)
    fc, logs = jax.vmap(
        lambda cr, k: dev._fly_impl(plan, cr, k, t_cap))(carry_b, keys)
    assert np.isfinite(np.asarray(logs["err2"])).all()
    # different noise keys -> genuinely different flights
    ends = np.stack([np.asarray(fc["px"]), np.asarray(fc["py"])], -1)
    assert np.unique(ends, axis=0).shape[0] == 4
    # frozen ticks beyond each plan's horizon leave carries finite
    assert np.isfinite(np.asarray(fc["budget"])).all()


def test_glide_stride_multirate_bounded_divergence():
    """glide_stride>1 (opt-in multi-rate): windows wholly inside a GLIDE
    leg advance with ONE coarse tick — same discretizations, longer
    step; the input-rate estimators sub-step at the fine dt (their
    rate-squared terms feed the energy integral), the increment control
    laws scale to per-second authority, and everything else (swims,
    flat dives, leg transitions, the plan tail) takes the exact fine
    path. Zero-noise contract vs the fine scan: the flight lands at the
    same place, keeps the sample schedule, stays within a bounded
    energy band, and the live tick count drops substantially on
    glide-heavy plans."""
    for seed, mix, dist in ((0, (Leg.GLIDE, Leg.GLIDE, Leg.SWIM), 12.0),
                            (3, (Leg.GLIDE, Leg.FLATDIVE, Leg.GLIDE),
                             10.0)):
        way, legs, _, cfg = _plan(seed, mix, dist)
        fine = DeviceRuntime(cfg, _zero_noise()).fly_log(way, legs,
                                                         seed=1)
        multi = DeviceRuntime(cfg, _zero_noise(),
                              glide_stride=4).fly_log(way, legs, seed=1)
        # scan shrinks on glide-heavy plans
        assert multi["truth"].shape[0] < 0.7 * fine["truth"].shape[0]
        # same destination within coarse-integration tolerance
        np.testing.assert_allclose(multi["truth"][-1, 1:4],
                                   fine["truth"][-1, 1:4], atol=1.0)
        # identical sample schedule length; fidelity labels within one
        # bin (the position-KF covariance that bins them propagates in
        # coarser steps)
        assert multi["samples"].shape[0] == fine["samples"].shape[0]
        assert np.max(np.abs(multi["samples"][:, -1]
                             - fine["samples"][:, -1])) <= 1
        # energy model within a bounded band (closed-loop divergence
        # included — the fine loop itself is chaotic at 1e-13/3s)
        assert 0.7 * fine["budget_used"] < multi["budget_used"] \
            < 1.3 * fine["budget_used"]
        # tracking stays comparable
        assert multi["tracking_rmse"] < 2.0 * fine["tracking_rmse"] + 0.5


def test_glide_stride_one_is_default_scan():
    """stride=1 keeps the original single-rate scan (same executable
    path): results must be bitwise-identical to a default runtime."""
    way, legs, _, cfg = _plan(0, (Leg.GLIDE, Leg.SWIM), 8.0)
    a = DeviceRuntime(cfg, _zero_noise()).fly_log(way, legs, seed=1)
    b = DeviceRuntime(cfg, _zero_noise(), glide_stride=1).fly_log(
        way, legs, seed=1)
    np.testing.assert_array_equal(a["truth"], b["truth"])
    np.testing.assert_array_equal(a["budget_used"], b["budget_used"])


def test_zero_noise_parity_coarse_config_dt():
    """Host parity must hold at ANY configured dt on the default
    stride-1 path — a config with dt * control_rate > 1 must not
    trigger the multi-rate increment scaling (regression: g_ctrl
    scaled by absolute dt*rate instead of per-window firings)."""
    way, legs, _, cfg = _plan(0, (Leg.GLIDE, Leg.SWIM), 8.0)
    host = RobotRuntime(cfg, _zero_noise(dt=0.2), seed=1)
    hlog = host.fly(way, legs)
    dev = DeviceRuntime(cfg, _zero_noise(dt=0.2))
    dlog = dev.fly_log(way, legs, seed=1)
    # 40 s window: dt=0.2 doubles the per-tick step, so the chaotic
    # amplification window shrinks vs the dt=0.1 tests
    n = min(200, hlog.truth.shape[0])
    np.testing.assert_allclose(dlog["truth"][:n, 1:4],
                               hlog.truth[:n, 1:4], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dlog["budget_used"], hlog.budget_used,
                               rtol=2e-2)
