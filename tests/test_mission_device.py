"""DeviceMission: the whole exploration experiment as one XLA program.

Correctness anchors:
* the masked bordered-Cholesky training arena must be EXACT — a host
  model conditioned from scratch on the harvested rows (same frozen
  hyperparameters) must reproduce the mission's in-graph test-grid
  posterior to factorization tolerance;
* the mission's loop semantics (budget tranches, termination, replan
  records) must match the host ``ExplorationSim`` contract.
"""

import jax.numpy as jnp
import numpy as np

from mfgp_jax.models.gp import GP
from mfgp_jax.models.mfgp import MFGP
from mfgp_jax.sim.mission_device import DeviceMission
from mfgp_jax.utils.configs import ExperimentConfig, SimConfig

SMALL = dict(plan_iters=6, e_max=6, max_nodes=16, samples_per_edge=6,
             dtype=jnp.float64)


def _exp(**kw):
    base = dict(B=20.0, BD=2, update_hyps=False)
    base.update(kw)
    return ExperimentConfig(sim=SimConfig(), **base)


def test_mission_runs_ergodic_mf():
    m = DeviceMission(_exp(multi_fidelity=True, ergodic=True), seed=0,
                      **SMALL)
    res = m.run()
    assert res.n_replans >= 1
    assert not res.chain_overflow
    assert np.isfinite(res.rmse)
    assert res.gp_data.data.shape[0] > 0
    assert 0.0 < res.budget_used <= 20.0 + 1e-9
    for r in res.replans:
        assert np.isfinite(r["info"])
        assert r["nodes"] >= 1 and r["edges"] >= 1
        assert 0.0 < r["budget"] <= 20.0 / 2 + 1e-9  # within the tranche
    # flown rows are valid prefix-masked trajectories with increasing time
    for k in range(res.n_replans):
        mask = res.flown_mask[k]
        t = res.flown[k][mask, 3]
        assert t.shape[0] > 1 and np.all(np.diff(t) > 0)


def test_mission_arena_matches_host_model_mf():
    """The padded arena + masked bordered extensions = a host MFGP
    conditioned from scratch on the same rows (machine-precision check of
    the whole in-graph GP algebra)."""
    m = DeviceMission(_exp(multi_fidelity=True, ergodic=True), seed=1,
                      **SMALL)
    res = m.run()
    X, fid, y = m.harvested(res)
    assert X.shape[0] >= 4
    # dummy initial point (the mission arena starts with it, like the host
    # loop's initial model)
    X0 = np.array([[m._x0[0], m._x0[1], 0.0]])
    Xs = [np.concatenate([X[fid == 0]]),
          np.concatenate([X[fid == 1]]),
          np.concatenate([X0, X[fid == 2]])]
    ys = [y[fid == 0], y[fid == 1], np.concatenate([[0.0], y[fid == 2]])]
    host = MFGP.from_fidelity_lists(Xs, ys, kernel="rbf", jitter=1e-6)
    tp = np.asarray(m.cfg.test_points())
    mu, var = host.predict(tp)
    np.testing.assert_allclose(np.asarray(mu).reshape(-1), res.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var).reshape(-1), res.test_var,
                               rtol=1e-7, atol=1e-8)


def test_mission_arena_matches_host_model_sf():
    # seed matters at toy budgets: some seeds draw only over-tranche first
    # edges and legitimately terminate with zero replans (the host loop
    # breaks the same way); seed 0 plans
    m = DeviceMission(_exp(multi_fidelity=False, ergodic=True, B=30.0),
                      seed=0, **SMALL)
    res = m.run()
    X, fid, y = m.harvested(res)
    assert X.shape[0] >= 4
    X0 = np.array([[m._x0[0], m._x0[1], 0.0]])
    host = GP(np.concatenate([X0, X]), np.concatenate([[0.0], y]),
              kernel="rbf", jitter=1e-6)
    tp = np.asarray(m.cfg.test_points())
    mu, var = host.predict(tp)
    np.testing.assert_allclose(np.asarray(mu).reshape(-1), res.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var).reshape(-1), res.test_var,
                               rtol=1e-7, atol=1e-8)


def test_mission_gain_mode_sf():
    """Sequential-gain scoring feeds the planner the mission's own
    training arena as its conditioned GP state."""
    m = DeviceMission(_exp(multi_fidelity=False, ergodic=False), seed=3,
                      **SMALL)
    res = m.run()
    assert res.n_replans >= 1
    assert np.isfinite(res.rmse)
    for r in res.replans:
        assert np.isfinite(r["info"])


def test_mission_budget_termination():
    """A one-tranche budget stops after the first replan (host loop's
    while-condition: remaining > half a tranche)."""
    m = DeviceMission(_exp(B=8.0, BD=1), seed=0, **SMALL)
    res = m.run(max_replans=3)
    assert res.n_replans <= 2  # tranche 8.0; second replan only if >4 left
    assert res.budget_used <= 8.0 + 1e-9


def test_mission_update_hyps_sf():
    """In-graph L-BFGS refits (the reference drivers' update_hyps regime):
    hyperparameters move, and the final posterior equals a host GP
    conditioned AT THE REFITTED PARAMS on the harvested rows — an exactness
    check of the masked-NLML fit + arena refactorization."""
    m = DeviceMission(_exp(multi_fidelity=False, ergodic=True,
                           update_hyps=True), seed=0, **SMALL)
    res = m.run()
    assert res.n_replans >= 1
    assert np.isfinite(res.rmse)
    assert not np.allclose(res.theta, np.asarray(m._theta0))
    assert np.all(np.exp(res.theta) <= 90.0 + 1e-9)  # blow-up recovery
    X, fid, y = m.harvested(res)
    X0 = np.array([[m._x0[0], m._x0[1], 0.0]])
    host = GP(np.concatenate([X0, X]), np.concatenate([[0.0], y]),
              kernel="rbf", jitter=1e-6, params=m.host_params(res.theta))
    tp = np.asarray(m.cfg.test_points())
    mu, var = host.predict(tp)
    np.testing.assert_allclose(np.asarray(mu).reshape(-1), res.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var).reshape(-1), res.test_var,
                               rtol=1e-7, atol=1e-8)
    # the refit IMPROVES the fit: host log-likelihood at the refitted
    # theta >= at the initial theta (same data)
    nl_fit = float(host.log_likelihood())
    host.params = m.host_params(m._theta0)
    host._state = None
    nl_init = float(host.log_likelihood())
    assert nl_fit >= nl_init  # log-likelihood, higher is better


def test_mission_update_hyps_mf():
    """MF refit: lengthscales respect the host _fit's (1e-4, 100) box,
    rhos stay fixed (fix_rhos=True), and host-parity holds at the
    refitted params."""
    m = DeviceMission(_exp(multi_fidelity=True, ergodic=True,
                           update_hyps=True), seed=1, **SMALL)
    res = m.run()
    assert res.n_replans >= 1
    assert not np.allclose(res.theta, np.asarray(m._theta0))
    F, D = m.F, m.D
    ls = np.exp(res.theta[F:F + F * D])
    assert np.all(ls <= 100.0 + 1e-9) and np.all(ls >= 1e-4 - 1e-12)
    X, fid, y = m.harvested(res)
    X0 = np.array([[m._x0[0], m._x0[1], 0.0]])
    Xs = [X[fid == 0], X[fid == 1], np.concatenate([X0, X[fid == 2]])]
    ys = [y[fid == 0], y[fid == 1], np.concatenate([[0.0], y[fid == 2]])]
    host = MFGP.from_fidelity_lists(Xs, ys, kernel="rbf", jitter=1e-6)
    host.params = m.host_params(res.theta)
    host._state = None
    np.testing.assert_allclose(np.asarray(host.params.rhos),
                               np.asarray(m._rhos0))
    tp = np.asarray(m.cfg.test_points())
    mu, var = host.predict(tp)
    np.testing.assert_allclose(np.asarray(mu).reshape(-1), res.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var).reshape(-1), res.test_var,
                               rtol=1e-7, atol=1e-8)


def test_mission_dynamic_flight_sf():
    """flight="dynamic": the device runtime scan (hw/runtime_device) flies
    each plan through the full sense->estimate->control stack INSIDE the
    mission program. Closed-loop stats are recorded, and the arena parity
    contract is unchanged: a host GP conditioned from scratch on the
    harvested (estimated-position) rows reproduces the mission's in-graph
    test-grid posterior."""
    m = DeviceMission(_exp(multi_fidelity=False, ergodic=True), seed=0,
                      flight="dynamic", **SMALL)
    res = m.run()
    assert res.n_replans >= 1
    assert np.isfinite(res.rmse)
    assert not res.meas_overflow
    for r in res.replans:
        assert r["tracking_rmse"] > 0.01  # real control, nonzero error
        assert r["flown_budget"] > 0.0
        assert r["t_flown"] > 1.0
    X, fid, y = m.harvested(res)
    assert X.shape[0] >= 4
    X0 = np.array([[m._x0[0], m._x0[1], 0.0]])
    host = GP(np.concatenate([X0, X]), np.concatenate([[0.0], y]),
              kernel="rbf", jitter=1e-6)
    tp = np.asarray(m.cfg.test_points())
    mu, var = host.predict(tp)
    np.testing.assert_allclose(np.asarray(mu).reshape(-1), res.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var).reshape(-1), res.test_var,
                               rtol=1e-7, atol=1e-8)


def test_mission_dynamic_flight_mf_fidelity_from_live_kf():
    """MF dynamic mission: fidelity labels come from the LIVE position-KF
    covariance inside the runtime scan (reference :809-819), not the
    kinematic filter; harvested rows carry a valid {1,2,3} mix and the
    model retrains on estimated positions."""
    m = DeviceMission(_exp(multi_fidelity=True, ergodic=True), seed=0,
                      flight="dynamic", **SMALL)
    res = m.run()
    assert res.n_replans >= 1
    d = res.gp_data.data
    assert d.shape[0] >= 4
    fids = set(d[:, 8].astype(int))
    assert fids <= {1, 2, 3} and len(fids) >= 1
    # estimated positions differ from truth (real localization error)
    assert np.abs(d[:, 4:7] - d[:, 1:4]).max() > 1e-4
    assert np.isfinite(res.rmse)


def test_mission_run_ensemble_matches_individual_runs():
    """run_ensemble(n): n COMPLETE missions as one vmapped launch; member
    i equals a solo mission at seed+i to near-machine tolerance (same
    per-mission key; the vmapped executable only reorders reductions), so
    Monte-Carlo members are reproducible runs."""
    exp = _exp(multi_fidelity=False, ergodic=True)
    m = DeviceMission(exp, seed=0, **SMALL)
    ens = m.run_ensemble(2)
    assert len(ens) == 2
    for i, r in enumerate(ens):
        solo = DeviceMission(_exp(multi_fidelity=False, ergodic=True),
                             seed=i, **SMALL)
        solo._run_jit = m._run_jit
        sres = solo.run()
        assert r.n_replans == sres.n_replans
        np.testing.assert_allclose(r.test_mu, sres.test_mu,
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(r.gp_data.data, sres.gp_data.data,
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(r.rmse, sres.rmse, rtol=1e-10)


def test_mission_stepped_equals_one_launch():
    """run(mode="stepped"): budget-tranche SPANS as separate launches of
    one traced-bounds executable with carried device state, sized under
    an optional per-launch wall-clock ceiling. The spans run the SAME
    traced tranche body as the one-launch program, so every artifact
    matches to factorization tolerance."""
    exp = _exp(multi_fidelity=True, ergodic=True)
    m = DeviceMission(exp, seed=0, **SMALL)
    one = m.run(mode="one")
    assert m.last_run_launches == 1
    stepped = m.run(mode="stepped")
    # no ceiling given: forced-stepped stays one tranche per span
    # (+ the finish launch)
    assert m.last_run_launches == exp.BD + 1
    assert stepped.n_replans == one.n_replans
    np.testing.assert_allclose(stepped.rmse, one.rmse, rtol=1e-10)
    np.testing.assert_allclose(stepped.test_mu, one.test_mu,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(stepped.gp_data.data, one.gp_data.data,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(stepped.theta, one.theta, rtol=1e-12)
    np.testing.assert_allclose(stepped.budget_used, one.budget_used,
                               rtol=1e-12)
    # a finite-but-huge ceiling grows the span after the warm
    # measurement: auto mode then takes the stepped path
    m2 = DeviceMission(_exp(multi_fidelity=True, ergodic=True), seed=0,
                       launch_ceiling_s=1e9, **SMALL)
    m2._span_jit, m2._finish_jit = m._span_jit, m._finish_jit
    auto = m2.run()
    assert 2 <= m2.last_run_launches <= exp.BD + 1
    np.testing.assert_allclose(auto.test_mu, one.test_mu,
                               rtol=1e-10, atol=1e-12)


def test_mission_run_ensemble_seed_chunked_stepped():
    """run_ensemble(seed_chunk=..., mode="stepped"): the seed axis splits
    into fixed-width vmapped launches (tail chunks pad and drop) and each
    chunk advances by tranche spans — member results still equal the
    plain one-launch ensemble's."""
    exp = _exp(multi_fidelity=False, ergodic=True)
    m = DeviceMission(exp, seed=0, **SMALL)
    plain = m.run_ensemble(3)
    chunked = m.run_ensemble(3, mode="stepped", seed_chunk=2)
    assert len(chunked) == 3
    for a, b in zip(chunked, plain):
        assert a.n_replans == b.n_replans
        np.testing.assert_allclose(a.rmse, b.rmse, rtol=1e-10)
        np.testing.assert_allclose(a.test_mu, b.test_mu,
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(a.gp_data.data, b.gp_data.data,
                                   rtol=1e-10, atol=1e-12)


def test_mission_update_hyps_restart_batched():
    """fit_restarts>1: restart-batched in-graph refits (the host
    optimize_restarts sampling — warm start + N(0, spread) log-space
    perturbations as ONE vmapped launch, best finite NLML kept). The
    flight/measurement RNG streams are split independently of the refit
    stream, so at one replan both runs see identical data — the selected
    theta can then never have a worse NLML than the single-start refit,
    and posterior exactness at the refitted params is preserved."""
    from mfgp_jax.models import GP

    exp = dict(multi_fidelity=False, ergodic=True, update_hyps=True)
    m1 = DeviceMission(_exp(**exp), seed=0, **SMALL)
    r1 = m1.run(max_replans=1)
    m4 = DeviceMission(_exp(**exp), seed=0, fit_restarts=4, **SMALL)
    r4 = m4.run(max_replans=1)
    assert r1.n_replans == 1 and r4.n_replans == 1
    # identical harvested data (the refit stream is independent)
    np.testing.assert_allclose(r4.gp_data.data, r1.gp_data.data,
                               rtol=1e-12, atol=1e-12)
    X, fid, y = m1.harvested(r1)
    X0 = np.array([[m1._x0[0], m1._x0[1], 0.0]])
    Xf, yf = np.concatenate([X0, X]), np.concatenate([[0.0], y])
    h1 = GP(Xf, yf, kernel="rbf", jitter=1e-6,
            params=m1.host_params(r1.theta))
    h4 = GP(Xf, yf, kernel="rbf", jitter=1e-6,
            params=m4.host_params(r4.theta))
    assert float(h4.log_likelihood()) >= float(h1.log_likelihood()) - 1e-6
    # posterior exactness at the restart-refitted params
    tp = np.asarray(m4.cfg.test_points())
    mu, var = h4.predict(tp)
    np.testing.assert_allclose(np.asarray(mu).reshape(-1), r4.test_mu,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var).reshape(-1), r4.test_var,
                               rtol=1e-7, atol=1e-8)


def test_mission_run_ensemble_mesh_sharded():
    """run_ensemble(mesh=...): the member axis shards over the mesh's dp
    extent (independent programs, zero collectives) and the results match
    the single-device ensemble to near-machine tolerance."""
    from mfgp_jax.parallel.mesh import make_mesh

    exp = _exp(multi_fidelity=False, ergodic=True)
    m = DeviceMission(exp, seed=0, **SMALL)
    mesh = make_mesh(4, mp=1)
    ens = m.run_ensemble(4, mesh=mesh)
    plain = DeviceMission(_exp(multi_fidelity=False, ergodic=True),
                          seed=0, **SMALL)
    ref = plain.run_ensemble(4)
    assert len(ens) == 4
    for a, b in zip(ens, ref):
        assert a.n_replans == b.n_replans
        np.testing.assert_allclose(a.test_mu, b.test_mu,
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(a.rmse, b.rmse, rtol=1e-10)


def test_run_campaign_two_variants():
    """run_campaign: the reference's driver campaign as one vmapped
    launch per variant; member 0 equals a solo mission at the same seed
    (the run_ensemble reproducibility contract)."""
    from mfgp_jax.sim.mission_device import run_campaign

    camp = run_campaign(variants=("SFEGP", "SFGP"), n_seeds=2, seed=0,
                        exp_kw=dict(B=20.0, BD=2, update_hyps=False),
                        **SMALL)
    assert set(camp) == {"SFEGP", "SFGP"}
    for v, c in camp.items():
        assert len(c["rmse"]) == 2 and all(np.isfinite(c["rmse"]))
        assert c["seconds"] > 0
        assert all(b <= 20.0 + 1e-9 for b in c["budget_used"])
    solo = DeviceMission(_exp(multi_fidelity=False, ergodic=True),
                         seed=0, **SMALL).run()
    np.testing.assert_allclose(camp["SFEGP"]["results"][0].test_mu,
                               solo.test_mu, rtol=1e-10, atol=1e-12)
    assert camp["SFEGP"]["replans"][0] == solo.n_replans


def test_mission_dynamic_glide_stride():
    """Dynamic missions accept glide_stride (the multi-rate runtime
    scan): the experiment completes with comparable outcomes and the
    same measurement capacity contract."""
    exp = _exp(multi_fidelity=False, ergodic=True, B=12.0, BD=1)
    m1 = DeviceMission(exp, seed=0, flight="dynamic", t_cap=4096,
                       **SMALL)
    r1 = m1.run()
    m4 = DeviceMission(_exp(multi_fidelity=False, ergodic=True, B=12.0,
                            BD=1), seed=0, flight="dynamic", t_cap=4096,
                       glide_stride=4, **SMALL)
    r4 = m4.run()
    assert r4.n_replans == r1.n_replans
    assert not r4.meas_overflow
    assert np.isfinite(r4.rmse)
    if r1.n_replans:
        # flown energy stays within the multi-rate band
        f1 = sum(r["flown_budget"] for r in r1.replans)
        f4 = sum(r["flown_budget"] for r in r4.replans)
        assert 0.6 * f1 < f4 < 1.4 * f1


def test_mission_glide_stride_outcome_distribution():
    """Mission-LEVEL multi-rate contract: over an ensemble of seeds,
    stride=4 missions must track stride=1 outcome DISTRIBUTIONS, not just
    flight-level kinematics — multi-rate plans are re-chosen on slightly
    different data and drift compounds across replans (ROADMAP measured
    rmse 1.67 vs 1.56 on one run), so the contract is on ensemble means:

    * mean RMSE within 25% of the exact-rate mean,
    * mean flown energy in a 0.8-1.25 band (tightened from the
      per-flight 0.7-1.3 band: per-seed energy differences are dominated
      by the fine loop's chaotic divergence and partly average out
      across seeds — measured 1.20 on this 8-seed ensemble, so the
      upper edge sits just past the per-seed-mean noise floor).
    """
    n_seeds = 8
    kw = dict(flight="dynamic", t_cap=2048, **SMALL)
    r1, r4 = [], []
    for s in range(n_seeds):
        e = dict(multi_fidelity=False, ergodic=True, B=12.0, BD=1)
        r1.append(DeviceMission(_exp(**e), seed=s, **kw).run())
        r4.append(DeviceMission(_exp(**e), seed=s, glide_stride=4,
                                **kw).run())
    rm1 = np.array([r.rmse for r in r1])
    rm4 = np.array([r.rmse for r in r4])
    assert np.all(np.isfinite(rm1)) and np.all(np.isfinite(rm4))
    assert abs(rm4.mean() - rm1.mean()) <= 0.25 * rm1.mean()
    f1 = np.array([sum(x["flown_budget"] for x in r.replans)
                   for r in r1])
    f4 = np.array([sum(x["flown_budget"] for x in r.replans)
                   for r in r4])
    if f1.sum() > 0:
        assert 0.8 <= f4.mean() / f1.mean() <= 1.25


def test_mission_save_artifacts(tmp_path):
    """save_artifacts writes the reference's per-replan artifact set in
    the host sim's schemas: plannedTraj rows equal the mission's valid
    flown rows, EID files carry the grid the replan planned on, hyps.csv
    has one positive row per replan, replans.csv parses with the host
    header."""
    m = DeviceMission(_exp(multi_fidelity=False, ergodic=True), seed=0,
                      **SMALL)
    res = m.run()
    assert res.n_replans >= 1
    out = str(tmp_path / "arts")
    m.save_artifacts(res, out)
    import os

    for r in res.replans:
        n = r["plan_num"]
        pts = np.loadtxt(os.path.join(out, f"plannedTraj{n}.csv"),
                         delimiter=",")
        np.testing.assert_allclose(pts, res.flown[n][res.flown_mask[n]])
        eid = np.loadtxt(os.path.join(out, f"EID{n}.csv"), delimiter=",")
        assert eid.shape == (m.grid.shape[0], 4)
        assert np.all(eid[:, 3] >= 0)
    hyps = np.atleast_2d(np.loadtxt(os.path.join(out, "hyps.csv"),
                                    delimiter=","))
    assert hyps.shape[0] == res.n_replans and np.all(hyps > 0)
    with open(os.path.join(out, "replans.csv")) as f:
        header = f.readline().strip().split(",")
        rows = [ln.strip().split(",") for ln in f]
    assert header[:6] == ["planNum", "tStart", "tranche", "bestInfo",
                          "nodes", "edges"]
    assert len(rows) == res.n_replans
    gp = np.loadtxt(os.path.join(out, "GPData.csv"), delimiter=",",
                    skiprows=1)
    assert np.atleast_2d(gp).shape[0] == res.gp_data.data.shape[0]


def test_plot_campaign(tmp_path):
    """viz.plot_campaign renders a campaign dict to a figure file."""
    from mfgp_jax.viz import plot_campaign

    camp = {"SFEGP": {"rmse": [1.7, 1.8, 1.75]},
            "SFGP": {"rmse": [1.72, 1.81]}}
    out = plot_campaign(camp, str(tmp_path / "camp.png"))
    import os

    assert os.path.getsize(out) > 1000
