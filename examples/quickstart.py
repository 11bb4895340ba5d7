"""Quickstart: the five workflows a reference user needs, end to end.

Run on CPU (f64) by default; drop the two config lines to run on the GPU.

    python examples/quickstart.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


# 1. Fit a single-fidelity GP on a fidelity-binned dataset ------------------
def example_sfgp():
    import jax.numpy as jnp

    from mfgp_jax.fields.wrbf import default_sim_field
    from mfgp_jax.models import GP

    rng = np.random.default_rng(0)
    field = default_sim_field([[0, 10], [0, 20]], 10.0)
    X = rng.uniform(0, 10, (200, 3)) * [1, 2, 1]
    y = np.asarray(field(jnp.asarray(X))) + 0.1 * rng.standard_normal(200)
    gp = GP(X, y, jitter=1e-6)
    gp.optimize_restarts(n_restarts=4)  # one device launch, all restarts
    mu, var = gp.predict(X[:5])
    print("SFGP:", "nlml", round(-gp.log_likelihood(), 2),
          "hyps", np.round(gp.param_array, 3))


# 2. Multi-fidelity (AR1) on localization-binned data -----------------------
def example_mfgp():
    import jax.numpy as jnp

    from mfgp_jax.fields.wrbf import default_sim_field
    from mfgp_jax.models import MFGP

    rng = np.random.default_rng(1)
    field = default_sim_field([[0, 10], [0, 20]], 10.0)
    X = rng.uniform(0, 10, (240, 3)) * [1, 2, 1]
    y = np.asarray(field(jnp.asarray(X)))
    # noisy positions -> lower fidelity (more position error)
    sig = rng.choice([0.02, 0.3, 1.0], 240)
    Xh = X + sig[:, None] * rng.standard_normal((240, 3))
    fid = np.select([sig < 0.1, sig < 0.5], [1, 2], 3)  # 1 = best
    m = MFGP.from_fidelity_lists(
        [Xh[fid == 3], Xh[fid == 2], Xh[fid == 1]],
        [y[fid == 3], y[fid == 2], y[fid == 1]], jitter=1e-6)
    m.optimize_restarts(n_restarts=4, lengthscale_bounds=(1e-4, 100))
    mu, var = m.predict(X[:5])
    print("MFGP:", "nlml", round(-m.log_likelihood(), 2),
          "posterior head", np.round(np.asarray(mu), 2))


# 3. Offline pipeline: trajectory -> estimates -> GP dataset ----------------
def example_pipeline(tmp="/tmp/mfgp_quickstart"):
    from mfgp_jax.data import Table, run_pipeline
    from mfgp_jax.utils.configs import SimConfig

    t = np.arange(0, 900, 0.1)
    traj = Table(["t", "x", "y", "z"], np.column_stack([
        t, 5 + 4 * np.sin(2 * np.pi * t / 300),
        10 + 8 * np.sin(2 * np.pi * t / 400),
        np.clip(5 * np.sin(2 * np.pi * t / 150) ** 2 - 0.4, 0, None)]))
    est, meas, gpd, field = run_pipeline(traj, SimConfig(), out_dir=tmp)
    print("pipeline:", gpd.data.shape[0], "binned rows ->", tmp)


# 4. Closed-loop adaptive exploration (flagship) ----------------------------
def example_explore():
    from mfgp_jax.sim import ExplorationSim
    from mfgp_jax.utils.configs import ExperimentConfig

    exp = ExperimentConfig(multi_fidelity=True, ergodic=True, B=20, BD=2)
    res = ExplorationSim(exp, seed=0, plan_iters=10).run()
    print("explore:", len(res.replans), "replans,",
          res.gp_data.data.shape[0], "points, final RMSE",
          round(res.rmse, 3))


# 5. Multi-chip sharded fit (runs on however many devices exist) ------------
def example_sharded():
    from mfgp_jax.parallel import fit_sharded, make_mesh

    rng = np.random.default_rng(2)
    X = rng.uniform(0, 10, (120, 3))
    y = np.sin(X.sum(1))
    fid = rng.integers(0, 3, 120)
    grid = rng.uniform(0, 10, (64, 3))
    mesh = make_mesh()  # all available devices
    best, losses, mu, var = fit_sharded(mesh, X, fid, y, grid, steps=50)
    print("sharded:", dict(mesh.shape), "best loss",
          round(float(np.min(np.asarray(losses))), 2))


# 6. One-launch on-device planner (planning/rig_device) ---------------------
def example_device_planner():
    import jax

    from mfgp_jax.metrics.eid import eid_grid
    from mfgp_jax.planning.primitives import AgentConfig
    from mfgp_jax.planning.rig_device import DeviceRIG

    grid = np.asarray(eid_grid([[0, 10], [0, 20]], 5.0))
    eid = np.ones(grid.shape[0]) / grid.shape[0]
    planner = DeviceRIG(AgentConfig.sim_defaults(), delta=2.0, B=20.0,
                        WS=[[0, 10], [0, 20]], R=3.0, Rd=2.0,
                        same_node_distance=0.5, budget_cutoff=0.5,
                        max_iter=24, eid=eid, grid=grid)
    res = planner.plan(np.array([1.0, 1.0]), jax.random.key(0))
    print("device planner:", res.n_nodes, "nodes, best info",
          round(res.info, 3), "budget", round(res.budget, 2))


# 7. Whole-mission-as-one-program + Monte-Carlo ensembles --------------------
def example_mission():
    import jax.numpy as jnp

    from mfgp_jax.sim.mission_device import DeviceMission
    from mfgp_jax.utils.configs import ExperimentConfig

    exp = ExperimentConfig(B=24.0, BD=2, update_hyps=False,
                           multi_fidelity=False, ergodic=True)
    mission = DeviceMission(exp, seed=0, plan_iters=8, e_max=6,
                            max_nodes=16, samples_per_edge=6,
                            dtype=jnp.float64)
    res = mission.run()  # the ENTIRE experiment: one device launch
    ens = mission.run_ensemble(3)  # 3 complete missions, one launch
    print("mission:", res.n_replans, "replans, rmse",
          round(res.rmse, 3), "| ensemble rmse",
          [round(e.rmse, 3) for e in ens])


# 8. Serving: batched HTTP posterior queries, multi-model routing ------------
def example_serving():
    import json
    import http.client
    import threading

    from mfgp_jax.models.gp import GP
    from mfgp_jax.serve import ModelRouter, ModelServer, make_http_server

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 10, (30, 3))
    router = ModelRouter({"sin": ModelServer(GP(X, np.sin(X[:, 0]),
                                                jitter=1e-8))})
    srv = make_http_server(router, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection(*srv.server_address)
    conn.request("POST", "/models/sin/predict",
                 body=json.dumps({"points": X[:2].tolist()}))
    print("serving:", conn.getresponse().status,
          "(concurrent requests coalesce into one device launch)")
    srv.shutdown()


# 9. Replan-as-a-service: POST /plan answers the robot's replan ------------
def example_plan_service():
    import json
    import http.client
    import threading

    from mfgp_jax.models.gp import GP
    from mfgp_jax.serve import (ModelServer, PlannerService,
                                make_http_server)

    rng = np.random.default_rng(0)
    X = np.column_stack([rng.uniform(0, 10, 25), rng.uniform(0, 20, 25),
                         rng.uniform(0, 10, 25)])
    svc = PlannerService(ModelServer(GP(X, np.sin(X[:, 0]), jitter=1e-8)),
                         cost="ergodic", plan_iters=12)
    srv = make_http_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection(*srv.server_address)
    conn.request("POST", "/plan", body=json.dumps(
        {"start": [1.0, 1.0], "budget": 20.0, "seed": 0}))
    out = json.loads(conn.getresponse().read())
    print("plan service:", len(out["path"]), "path points,",
          f"budget {out['budget']:.2f} (the reference robot spends 45 s "
          "on-board per replan)")
    srv.shutdown()
    svc.close()


if __name__ == "__main__":
    example_sfgp()
    example_mfgp()
    example_pipeline()
    example_explore()
    example_sharded()
    example_device_planner()
    example_mission()
    example_serving()
    example_plan_service()
