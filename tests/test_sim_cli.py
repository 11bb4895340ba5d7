"""Closed-loop simulator + CLI tests (SURVEY §7 step 8, BASELINE configs)."""

import json
import os

import numpy as np
import pytest

from mfgp_jax.sim import ExplorationSim
from mfgp_jax.utils.configs import ExperimentConfig, SimConfig


@pytest.fixture(scope="module")
def small_run():
    exp = ExperimentConfig(multi_fidelity=True, ergodic=True, B=20, BD=2)
    sim = ExplorationSim(exp, seed=0, plan_iters=8)
    return sim.run()


def test_explore_terminates_within_budget(small_run):
    res = small_run
    assert res.budget_used <= 20.0 + 1e-9
    assert len(res.replans) >= 1
    assert res.gp_data.data.shape[1] == 9  # GPData schema


def test_explore_gathers_fidelity_binned_data(small_run):
    levs = set(np.unique(small_run.gp_data.col("fidLev")).astype(int))
    assert levs <= {1, 2, 3} and levs
    # telemetry matches the estimate schema width
    assert small_run.estimates.shape[1] == 13


def test_explore_final_model_learns_field(small_run):
    # prior-only RMSE on this field is ~3.2 (field max ~10); after ~1 tranche
    # of data the model must beat a constant-zero predictor
    assert small_run.rmse is not None and small_run.rmse < 3.0


def test_explore_deterministic():
    exp = ExperimentConfig(multi_fidelity=False, ergodic=False, B=10, BD=1)
    r1 = ExplorationSim(exp, seed=5, plan_iters=6).run()
    r2 = ExplorationSim(exp, seed=5, plan_iters=6).run()
    assert r1.budget_used == r2.budget_used
    np.testing.assert_array_equal(r1.gp_data.data, r2.gp_data.data)


def test_explore_artifacts(tmp_path):
    exp = ExperimentConfig(multi_fidelity=False, ergodic=True, B=10, BD=1)
    res = ExplorationSim(exp, seed=2, plan_iters=6,
                         out_dir=str(tmp_path)).run()
    if res.replans:
        assert (tmp_path / "plannedTraj0.csv").exists()
        eid = np.loadtxt(tmp_path / "EID0.csv", delimiter=",")
        assert eid.shape[1] == 4  # x, y, z, density
        np.testing.assert_allclose(eid[:, 3].sum(), 1.0, rtol=1e-6)


def test_cli_infogain_identity(capsys):
    from mfgp_jax.cli import main

    main(["infogain-test"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["rel_err"] < 1e-10


def test_cli_explore_variant_mapping(capsys):
    from mfgp_jax.cli import main

    main(["explore", "--variant", "SFGP", "--budget", "8", "--bd", "1",
          "--plan-iters", "5"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["variant"] == "SFGP"
    assert out["budget_used"] <= 8.0


REF_GPDATA = ("/root/reference/Data/TrajectoriesAndEstimates/GPDataSets/"
              "GPData_0.2_fieldMeas_0_T0_0.csv")


@pytest.mark.skipif(not os.path.exists(REF_GPDATA),
                    reason="reference artifacts unavailable")
def test_cli_sfgp_reference_parity(capsys):
    """BASELINE config 1 end-to-end: RMSE within 0.01 of the recorded run
    (reference MSE_0.2_fieldMeas_0_T0_0.txt: RMSE sf 5.2475)."""
    from mfgp_jax.cli import main

    main(["sfgp", REF_GPDATA, "--field-settings",
          "/root/reference/Data/TrajectoriesAndEstimates/FieldData/"
          "FieldSettings0.txt"])
    out = json.loads(capsys.readouterr().out.strip())
    assert abs(out["rmse"] - 5.2475) < 0.01


def test_manual_variant_collects_and_trains(tmp_path):
    """The Manual teleop run: no planner, waypoint chain flown, end-of-run
    model trained and checkpointed (SURVEY C25 Manual)."""
    wp = np.array([[1, 1, 0], [8, 4, 3], [3, 15, 5]], float)
    exp = ExperimentConfig(multi_fidelity=False, ergodic=False)
    sim = ExplorationSim(exp, seed=0, out_dir=str(tmp_path))
    res = sim.run_manual(wp)
    assert len(res.replans) == 0  # zero plan() calls, like the reference
    assert res.gp_data.data.shape[0] > 50
    assert res.budget_used > 0
    assert res.rmse is not None and res.rmse < 3.0
    assert (tmp_path / "manual_model.npz").exists()
    # the saved model restores and predicts
    from mfgp_jax.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(str(tmp_path / "manual_model"))
    m = ck.model.restore()
    mu, var = m.predict(wp)
    assert np.isfinite(np.asarray(mu)).all()


def test_frozen_hyps_online_extension_runs(tmp_path):
    """update_hyps=False uses the online bordered-block extension across
    replans (BASELINE config 4's online GP update): later replans must take
    the ``extend`` path, its posterior must equal a from-scratch
    recondition of the same data, and the fit stats must be logged in the
    sim artifacts (reference replan: set_data + re-optimize,
    reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:385-397)."""
    exp = ExperimentConfig(multi_fidelity=True, ergodic=False, B=20, BD=2,
                           update_hyps=False)
    sim = ExplorationSim(exp, seed=1, plan_iters=8, out_dir=str(tmp_path))
    res = sim.run()
    assert len(res.replans) >= 1
    assert res.rmse is None or np.isfinite(res.rmse)
    modes = [r.fit_mode for r in res.replans]
    assert modes[0] == "refit"
    if len(modes) > 1:
        assert "extend" in modes[1:]
        # posterior equality: the online-extended model vs a fresh model
        # reconditioned from scratch on the same data + same hyps
        rows = res.gp_data.data
        fresh = sim._make_model(rows[:, 4:7], rows[:, 8].astype(int),
                                rows[:, 7])
        tp = sim.cfg.test_points()[::17]
        mu_o, var_o = res.model.predict(tp)
        mu_f, var_f = fresh.predict(tp)
        np.testing.assert_allclose(np.asarray(mu_o), np.asarray(mu_f),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(var_o), np.asarray(var_f),
                                   rtol=1e-6, atol=1e-8)
    # replan fit stats land in the artifact set
    txt = (tmp_path / "replans.csv").read_text().splitlines()
    assert txt[0].startswith("planNum,") and "fitMode" in txt[0]
    assert len(txt) == 1 + len(res.replans)


def test_toy_dynamics_integrate():
    """rk4 + toy models (SURVEY C22's broken unused dynamics, working)."""
    import jax.numpy as jnp

    from mfgp_jax.sim.dynamics import (glider_simple, rk4_step,
                                       single_integrator_3d, unicycle_3d)

    # single integrator moves linearly
    x = jnp.zeros(3)
    for _ in range(10):
        x = rk4_step(single_integrator_3d, x, jnp.asarray([1.0, 0.0, 0.5]),
                     0.1)
    np.testing.assert_allclose(np.asarray(x), [1.0, 0.0, 0.5], atol=1e-9)
    # unicycle turning in place keeps position
    u = jnp.asarray([0.0, 0.0, 1.0])
    s = jnp.zeros(4)
    for _ in range(10):
        s = rk4_step(unicycle_3d, s, u, 0.1)
    np.testing.assert_allclose(np.asarray(s[:3]), 0.0, atol=1e-9)
    np.testing.assert_allclose(float(s[3]), 1.0, atol=1e-9)
    # glider under gravity falls
    g0 = jnp.asarray([0.0, 10.0, 1.0, 0.0])
    g1 = rk4_step(glider_simple, g0, jnp.zeros(2), 0.1)
    assert float(g1[3]) < 0


def test_plan_wallclock_stopwatch_wired():
    """ExperimentConfig.plan_wallclock bounds each replan by wall-clock
    (the reference's 45 s stopwatch, exploreExpSettings.py:214-215)."""
    import time

    exp = ExperimentConfig(multi_fidelity=False, ergodic=False, B=10, BD=1,
                           plan_wallclock=0.5)
    t0 = time.time()
    res = ExplorationSim(exp, seed=0, plan_iters=10**6).run(max_replans=1)
    elapsed = time.time() - t0
    # planning was stopped by the stopwatch, not the (huge) iteration cap
    assert elapsed < 60.0
    assert len(res.replans) <= 1


def test_orbax_checkpoint_roundtrip(tmp_path):
    """The orbax backend (SURVEY §5 'orbax-style' checkpointing) restores
    an identical ExplorationCheckpoint, autodetected at load."""
    import jax
    import numpy as np

    from mfgp_jax.models.gp import GP
    from mfgp_jax.utils import checkpoint as ckpt

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 5, (12, 3))
    gp = GP(X, np.cos(X[:, 1]), jitter=1e-8)
    ck = ckpt.ExplorationCheckpoint(
        plan_num=3, t_now=12.5, planned_budget=7.25,
        x0=np.ones((2, 1)), model=ckpt.capture_model(gp),
        data_rows=rng.normal(size=(5, 9)),
        rng_state=rng.bit_generator.state,
        jax_key_data=np.asarray(jax.random.key_data(jax.random.key(4))),
        graph_nodes={"0": [0.0, 1.0]}, graph_edges={"0": [0, 1]})
    for backend in ("npz", "orbax"):
        p = str(tmp_path / f"ck_{backend}")
        ckpt.save_checkpoint(p, ck, backend=backend)
        back = ckpt.load_checkpoint(p)
        assert back.plan_num == 3 and back.t_now == 12.5
        np.testing.assert_array_equal(back.data_rows, ck.data_rows)
        np.testing.assert_array_equal(back.model.X, ck.model.X)
        assert back.model.kind == "gp" and back.model.kernel == gp.kernel
        assert back.graph_nodes == ck.graph_nodes
        assert back.rng_state == ck.rng_state
        m = back.model.restore()
        # rtol bounded by the param_array log/exp roundtrip, not the
        # serialization (same as test_server_from_checkpoint)
        np.testing.assert_allclose(np.asarray(m.predict(X[:3])[0]),
                                   np.asarray(gp.predict(X[:3])[0]),
                                   rtol=1e-4)
    # overwrite is safe (second save to the same orbax path)
    ckpt.save_checkpoint(str(tmp_path / "ck_orbax"), ck, backend="orbax")
    # when BOTH backends exist at one path, the newer write wins
    import dataclasses
    import time
    p = str(tmp_path / "both")
    ckpt.save_checkpoint(p, ck, backend="orbax")
    time.sleep(0.05)
    ckpt.save_checkpoint(p, dataclasses.replace(ck, plan_num=9))
    assert ckpt.load_checkpoint(p).plan_num == 9
