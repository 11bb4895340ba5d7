"""Robot-runtime layer tests (SURVEY C23/C24)."""

import numpy as np
import pytest

from mfgp_jax.hw import (KPID, PID, AprilFusion, AprilFusionConfig,
                         SimulatedRobotIO, TagDetection, angle_wrap,
                         gps_bearing_distance, m0_to_act_pos, rp1_to_act_pos,
                         saturate, tail_wave, vec_to_tf, tf_to_vec,
                         yaw_correction, zyx_rotm)
from mfgp_jax.hw.apriltag import rotm_to_euler, rp_to_tf


def test_saturate_and_angle_wrap():
    assert saturate(5, 0, 1) == 1 and saturate(-5, 0, 1) == 0
    assert angle_wrap(190, 180) == pytest.approx(-170)
    assert angle_wrap(-190, 180) == pytest.approx(170)
    assert yaw_correction(100, 0, 180, k=1) == 70  # clipped


def test_pid_converges_on_first_order_plant():
    pid = PID(kp=2.0, ki=0.5, kd=0.1, clip=(-5, 5))
    x, dt = 0.0, 0.05
    for _ in range(400):
        u = pid.run(1.0 - x, dt)
        x += dt * (-x + u)
    assert abs(x - 1.0) < 0.05


def test_kpid_derivative_tracks():
    kpid = KPID(kp=1.0, ki=0.0, kd=0.0)
    # feed a ramp error; the internal KF rate state should approach slope
    for i in range(200):
        kpid.run(0.1 * i, 0.1)
    assert kpid.state.x[1, 0] == pytest.approx(1.0, abs=0.1)


def test_tail_wave_shapes():
    t = np.linspace(0, 4, 801)
    sq = tail_wave(t, bias=50, amp=20, freq=0.5, wave="square")
    assert set(np.unique(sq)) == {30.0, 70.0}
    si = tail_wave(t, bias=50, amp=20, freq=0.5, wave="sin")
    assert si.max() <= 70 + 1e-9 and si.min() >= 30 - 1e-9


def test_actuator_maps_clamp():
    par = (0.1, 2.0, 0.2, 3.0)
    assert rp1_to_act_pos(100.0, par) == 95.0  # 0.95 cap * 100
    assert m0_to_act_pos(100.0, par) == 100.0
    assert rp1_to_act_pos(-100.0, par) == 0.0


def test_se3_roundtrip():
    vec = np.array([1.0, -2.0, 3.0, 10.0, -20.0, 30.0])
    np.testing.assert_allclose(tf_to_vec(vec_to_tf(vec)), vec, atol=1e-9)
    R = zyx_rotm(0.1, -0.2, 0.3)
    np.testing.assert_allclose(rotm_to_euler(R), (0.1, -0.2, 0.3),
                               atol=1e-12)


def test_gps_bearing_distance_known_case():
    # ~111 km per degree latitude; due north bearing ~0
    b, d = gps_bearing_distance(0.0, 0.0, 1.0, 0.0)
    assert b == pytest.approx(0.0, abs=1e-9)
    assert d == pytest.approx(111195, rel=0.01)


def test_april_fusion_converges_to_tag_fix():
    tag_world = vec_to_tf([5.0, 3.0, 0.0, 0.0, 0.0, 0.0])
    fusion = AprilFusion({7: tag_world},
                         cfg=AprilFusionConfig(window_time=100.0))
    true_pos = np.array([4.0, 2.5, 1.2])
    # camera == imu frame; tag pose in camera frame from true robot pose
    imu_in_world = rp_to_tf(np.eye(3), true_pos)
    tag_in_cam = np.linalg.inv(imu_in_world) @ tag_world
    det = TagDetection(7, tag_in_cam[:3, :3], tag_in_cam[:3, 3])
    for i in range(50):
        x, var = fusion.step(0.1 * i, 0.1, depth=true_pos[2], yaw=0.0,
                             detections=[det])
    np.testing.assert_allclose(x[:3, 0], true_pos, atol=0.05)
    assert var[0] < 0.1


def test_april_fusion_rejects_outlier_fix():
    tag_world = vec_to_tf([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    fusion = AprilFusion({1: tag_world})
    true_pos = np.array([1.0, 1.0, 0.5])
    imu_in_world = rp_to_tf(np.eye(3), true_pos)
    good = np.linalg.inv(imu_in_world) @ tag_world
    det_good = TagDetection(1, good[:3, :3], good[:3, 3])
    for i in range(10):
        fusion.step(0.1 * i, 0.1, depth=0.5, yaw=0.0, detections=[det_good])
    x_before = fusion.x.copy()
    # a teleported fix 10 m away must be window-rejected
    far = rp_to_tf(np.eye(3), true_pos + np.array([10.0, 0, 0]))
    bad = np.linalg.inv(far) @ tag_world
    det_bad = TagDetection(1, bad[:3, :3], bad[:3, 3])
    x_after, _ = fusion.step(1.1, 0.1, depth=0.5, yaw=0.0,
                             detections=[det_bad])
    assert abs(x_after[0, 0] - x_before[0, 0]) < 0.5


def test_simulated_robot_io_surface():
    io = SimulatedRobotIO()
    io.attach_field(lambda x, y, z: 42.0)
    assert io.read_rgb() == (42.0, 42.0, 42.0)
    io.set_actuators(pump_pos=80.0)
    assert io.read_depth() > 0.0
    r, p, y = io.read_euler()
    assert (r, p, y) == (0.0, 0.0, 0.0)
    assert len(io.read_imu()) == 9


def test_reference_trajectories():
    """Named curves (SURVEY C26 backsteppingConfig): shapes, bounds,
    workspace scaling."""
    from mfgp_jax.hw.trajectories import (TRAJECTORIES,
                                          reference_trajectory,
                                          scale_to_workspace)

    t = np.linspace(0, 540, 200)
    for name in TRAJECTORIES:
        out = reference_trajectory(name, t)
        assert out.shape == (200, 4)
        assert np.isfinite(out).all()
    fig8 = reference_trajectory("fig8", t)
    wp = scale_to_workspace(fig8, [[0, 10], [0, 20]], 10.0)
    assert wp[:, 0].min() >= 0 and wp[:, 0].max() <= 10
    assert wp[:, 1].max() <= 20 and wp[:, 2].max() <= 10
    with pytest.raises(KeyError):
        reference_trajectory("nope", t)


def test_april_fusion_yaw_wrap_stability():
    """State yaw stays wrapped and a near-pi compass measurement produces a
    small innovation, not a ~2*pi yank (code-review finding)."""
    tag_world = vec_to_tf([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    fusion = AprilFusion({1: tag_world})
    # drive the yaw estimate near +pi via repeated wrapped measurements
    for i in range(60):
        yaw_meas = np.pi - 0.05 if i % 2 == 0 else -np.pi + 0.05
        x, _ = fusion.step(0.1 * i, 0.1, depth=0.5, yaw=yaw_meas,
                           detections=[TagDetection(1, np.eye(3),
                                                    np.zeros(3))])
        assert -np.pi <= x[3, 0] < np.pi + 1e-9
    # estimate settled near the +/-pi seam rather than diverging
    assert abs(abs(x[3, 0]) - np.pi) < 0.3


def test_fids_from_variance_general_f():
    """Generalized fidelity binning (code-review finding: the old copies
    hardcoded F=3)."""
    from mfgp_jax.planning.scoring import fids_from_variance

    # F=3, reference semantics
    np.testing.assert_array_equal(
        fids_from_variance([0.1, 1.0, 9.0], [0.25, 2.25, 6.25], 3),
        [2, 1, 0])
    # F=2: below threshold -> highest (1), above -> 0
    np.testing.assert_array_equal(
        fids_from_variance([0.1, 9.0], [0.25], 2), [1, 0])
    with pytest.raises(ValueError):
        fids_from_variance([0.1], [], 3)
