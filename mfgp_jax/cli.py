"""Command-line entry points for the five BASELINE.json configurations.

The reference has no CLI — variant selection is "which script you run" plus
in-file literals (SURVEY §5 config). Here each BASELINE config is a
subcommand over the same library surface:

  python -m mfgp_jax.cli sfgp     <GPData.csv> [--field-settings F] [--out D]
  python -m mfgp_jax.cli nigp     <GPData.csv> [--out D]
  python -m mfgp_jax.cli mfgp     <GPData.csv> [--field-settings F] [--out D]
  python -m mfgp_jax.cli pipeline <traj.csv> --out D [--seed S] [--vmn V]
  python -m mfgp_jax.cli trainers --data-dir D --field-dir F --out O
  python -m mfgp_jax.cli explore  [--variant MFEGP|MFGP|SFEGP|SFGP] --out D
  python -m mfgp_jax.cli aggregate 'GPResults/MSE_*.txt' --out results.csv
  python -m mfgp_jax.cli infogain-test      # info-gain identity check
  python -m mfgp_jax.cli bench …            # forwards to bench harness
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def platform_for(args) -> str:
    """JAX platform a command runs on: ``cuda`` with ``--gpu`` (a missing
    card is then an error at first use, never a quiet CPU run), otherwise
    the CPU, where offline runs and tests use f64."""
    return "cuda" if args.gpu else "cpu"


def _cpu(args):
    """Select the platform (see platform_for) and enable the persistent
    compilation cache."""
    import jax

    platform = platform_for(args)
    jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        jax.config.update("jax_enable_x64", True)
    from mfgp_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()


def cmd_sfgp(args):
    """BASELINE config 1: SFGP fit + posterior grid on one dataset."""
    _cpu(args)
    from mfgp_jax.data.io import load_gp_dataset
    from mfgp_jax.models.gp import GP
    from mfgp_jax.utils.configs import SimConfig

    ds = load_gp_dataset(args.dataset)
    gp = GP(ds.X_est, ds.y, kernel=args.kernel, jitter=1e-6)
    gp.optimize()
    tp = SimConfig().test_points()
    mu, var = gp.predict(tp)
    out = {"model": "sfgp", "n": ds.n,
           "nlml": -float(gp.log_likelihood()),
           "param_array": gp.param_array.tolist()}
    if args.field_settings:
        import jax.numpy as jnp

        from mfgp_jax.fields.wrbf import parse_field_settings

        f = parse_field_settings(args.field_settings)
        err = np.asarray(mu) - np.asarray(f(jnp.asarray(tp)))
        out["rmse"] = float(np.sqrt(np.mean(err**2)))
    print(json.dumps(out))


def cmd_nigp(args):
    """BASELINE config 2: NIGP with KF localization input noise."""
    _cpu(args)
    from mfgp_jax.data.io import load_gp_dataset
    from mfgp_jax.models.nigp import NIGP

    ds = load_gp_dataset(args.dataset)
    m = NIGP(n_restarts=2, iters=args.iters)
    m.fit(ds.X_est, ds.y)
    mu, var = m.predict(ds.X_est[:10])
    print(json.dumps({"model": "nigp", "n": ds.n,
                      "params": m.get_params().tolist(),
                      "mu_head": np.asarray(mu)[:3].tolist()}))


def cmd_mfgp(args):
    """BASELINE config 3: AR1 MFGP on fidelity-binned data."""
    _cpu(args)
    from mfgp_jax.data.io import load_gp_dataset
    from mfgp_jax.models.mfgp import MFGP
    from mfgp_jax.utils.configs import SimConfig

    ds = load_gp_dataset(args.dataset)
    Xs, ys = ds.fidelity_lists()
    m = MFGP.from_fidelity_lists(Xs, ys, kernel=args.kernel, jitter=1e-6)
    m.optimize(fix_rhos=True)
    tp = SimConfig().test_points()
    mu, var = m.predict(tp)
    out = {"model": "mfgp", "n": ds.n,
           "nlml": -float(m.log_likelihood()),
           "param_array": m.param_array.tolist()}
    if args.field_settings:
        import jax.numpy as jnp

        from mfgp_jax.fields.wrbf import parse_field_settings

        f = parse_field_settings(args.field_settings)
        err = np.asarray(mu) - np.asarray(f(jnp.asarray(tp)))
        out["rmse"] = float(np.sqrt(np.mean(err**2)))
    print(json.dumps(out))


def cmd_pipeline(args):
    """Stages 1-3: trajectory -> estimates -> measurements -> GP dataset."""
    _cpu(args)
    from mfgp_jax.data import load_table, run_pipeline
    from mfgp_jax.utils.configs import SimConfig

    cfg = SimConfig(seed=args.seed, vmn=args.vmn)
    traj = load_table(args.trajectory)
    est, meas, gpd, _ = run_pipeline(traj, cfg, out_dir=args.out)
    print(json.dumps({"estimates": est.data.shape[0],
                      "gp_rows": gpd.data.shape[0], "out": args.out}))


def cmd_trainers(args):
    """GPTrainers sweep over a GPDataSets directory."""
    _cpu(args)
    from mfgp_jax.data import process_directory

    res = process_directory(args.data_dir, args.field_dir, args.out,
                            kernel=args.kernel, resume=not args.no_resume,
                            fit_mode=args.fit_mode, verbose=True,
                            dtype=(np.float32
                                   if args.fit_mode.startswith("device")
                                   else np.float64))
    print(json.dumps({k: v for k, v in res.items()}, indent=1))


def cmd_explore(args):
    """BASELINE config 5: full closed-loop adaptive exploration."""
    _cpu(args)
    from mfgp_jax.sim import ExplorationSim
    from mfgp_jax.utils.configs import ExperimentConfig

    variant = args.variant.upper()
    exp = ExperimentConfig(multi_fidelity=variant.startswith("MF"),
                           ergodic=variant in ("MFEGP", "SFEGP"),
                           ergodic_metric=args.ergodic_metric,
                           info_cost=args.info_cost,
                           B=args.budget, BD=args.bd)
    sim = ExplorationSim(exp, seed=args.seed, out_dir=args.out,
                         plan_iters=args.plan_iters, flight=args.flight,
                         planner_backend=args.planner,
                         plan_ensemble=args.plan_ensemble)
    if variant == "MANUAL":
        if args.waypoints:
            wp = np.loadtxt(args.waypoints, delimiter=",", ndmin=2)[:, :3]
        elif args.trajectory_name:
            from mfgp_jax.hw.trajectories import (reference_trajectory,
                                                  scale_to_workspace)

            t = np.linspace(0, 540, 40)
            curve = reference_trajectory(args.trajectory_name, t)
            wp = scale_to_workspace(curve, exp.sim.WS, exp.sim.max_depth)
        else:  # default lawnmower-ish demo chain
            wp = np.array([[1, 1, 0], [8, 4, 3], [3, 15, 5], [8, 18, 0]],
                          float)
        res = sim.run_manual(wp)
        name = "Manual"
    else:
        res = sim.run(checkpoint_path=args.checkpoint,
                      resume_from=args.resume_from)
        name = exp.variant
    out = {
        "variant": name, "replans": len(res.replans),
        "n_data": int(res.gp_data.data.shape[0]),
        "budget_used": res.budget_used, "rmse": res.rmse,
    }
    if args.flight == "dynamic" and res.replans:
        out["tracking_rmse"] = [r.tracking_rmse for r in res.replans]
        out["flown_budget"] = sum(r.flown_budget or 0.0 for r in res.replans)
    print(json.dumps(out))


def cmd_mission_server(args):
    """Long-lived mission-submission server (serve.MissionService)."""
    _cpu(args)
    from mfgp_jax.serve import serve_missions

    serve_missions(host=args.host, port=args.port)


def _submit_mission(args):
    """POST the mission spec to a mission server and poll to completion —
    time-to-first-result excludes the server's warm executable's compile
    (see serve.MissionService)."""
    import time
    import urllib.request

    spec = {"variant": args.variant, "seed": args.seed,
            "budget": args.budget, "bd": args.bd,
            "plan_iters": args.plan_iters, "e_max": args.e_max,
            "update_hyps": args.update_hyps, "flight": args.flight,
            "ergodic_metric": args.ergodic_metric,
            "info_cost": args.info_cost,
            "fit_restarts": args.fit_restarts,
            "glide_stride": args.glide_stride}
    url = args.submit.rstrip("/")
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url + "/mission", json.dumps(spec).encode(),
        {"Content-Type": "application/json"})
    sub = json.loads(urllib.request.urlopen(req).read())
    while True:
        job = json.loads(urllib.request.urlopen(
            f"{url}/mission/{sub['job']}").read())
        if job["state"] in ("done", "error"):
            break
        time.sleep(0.5)
    job["client_seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(job))


def cmd_mission(args):
    """The whole exploration experiment as ONE device launch
    (sim.mission_device.DeviceMission). ``--update-hyps`` switches from the
    frozen-hyperparameter regime to in-graph per-replan L-BFGS refits.
    ``--submit URL`` sends the run to a mission server instead."""
    import time

    if args.submit:
        return _submit_mission(args)
    _cpu(args)
    from mfgp_jax.sim.mission_device import DeviceMission
    from mfgp_jax.utils.configs import ExperimentConfig

    variant = args.variant.upper()
    exp = ExperimentConfig(multi_fidelity=variant.startswith("MF"),
                           ergodic=variant in ("MFEGP", "SFEGP"),
                           ergodic_metric=args.ergodic_metric,
                           info_cost=args.info_cost,
                           update_hyps=args.update_hyps,
                           B=args.budget, BD=args.bd)
    mission = DeviceMission(exp, seed=args.seed, flight=args.flight,
                            plan_iters=args.plan_iters, e_max=args.e_max,
                            fit_restarts=args.fit_restarts,
                            glide_stride=args.glide_stride)
    t0 = time.perf_counter()
    res = mission.run(mode=args.mode)
    compile_and_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    mission2 = DeviceMission(exp, seed=args.seed + 1, flight=args.flight,
                             plan_iters=args.plan_iters, e_max=args.e_max,
                             fit_restarts=args.fit_restarts,
                             glide_stride=args.glide_stride)
    # warm executables, new seed (one-launch + stepped-span forms)
    mission2._run_jit = mission._run_jit
    mission2._span_jit = mission._span_jit
    mission2._finish_jit = mission._finish_jit
    res2 = mission2.run(mode=args.mode)
    warm = time.perf_counter() - t0
    out = {
        "variant": variant, "replans": res.n_replans,
        "n_data": int(res.gp_data.data.shape[0]),
        "budget_used": res.budget_used, "rmse": res.rmse,
        "replans2": res2.n_replans, "rmse2": res2.rmse,
        "launches": mission.last_run_launches,
        "launch_seconds_cold": round(compile_and_run, 3),
        "launch_seconds_warm": round(warm, 3),
    }
    if args.flight == "dynamic" and res.replans:
        out["tracking_rmse"] = [round(r["tracking_rmse"], 4)
                                for r in res.replans]
        out["flown_budget"] = round(
            sum(r["flown_budget"] for r in res.replans), 3)
    if args.ensemble > 1:
        t0 = time.perf_counter()
        ens = mission.run_ensemble(args.ensemble, mode=args.mode,
                                   seed_chunk=args.seed_chunk)
        out["ensemble_seconds"] = round(time.perf_counter() - t0, 3)
        out["ensemble_rmse"] = [round(e.rmse, 4) for e in ens]
        out["ensemble_replans"] = [e.n_replans for e in ens]
    if args.out:
        mission.save_artifacts(res, args.out)
        out["artifacts"] = args.out
    print(json.dumps(out))


def cmd_campaign(args):
    """The reference's 4-driver experiment campaign (SURVEY C25) x repeat
    seeds as ONE vmapped DeviceMission launch per variant."""
    import time

    _cpu(args)
    from mfgp_jax.sim.mission_device import run_campaign

    t0 = time.perf_counter()
    camp = run_campaign(
        variants=[v.strip() for v in args.variants.split(",")],
        n_seeds=args.seeds, seed=args.seed,
        exp_kw=dict(B=args.budget, BD=args.bd,
                    update_hyps=args.update_hyps),
        mode=args.mode, seed_chunk=args.seed_chunk,
        plan_iters=args.plan_iters, e_max=args.e_max)
    out = {"campaign_seconds": round(time.perf_counter() - t0, 3),
           "runs": sum(len(c["rmse"]) for c in camp.values())}
    if args.plot:
        from mfgp_jax.viz import plot_campaign

        out["plot"] = plot_campaign(camp, args.plot)
    for v, c in camp.items():
        out[v] = {"rmse_mean": round(float(np.mean(c["rmse"])), 4),
                  "rmse": [round(r, 4) for r in c["rmse"]],
                  "replans": c["replans"],
                  "budget_used": [round(b, 2) for b in c["budget_used"]],
                  "seconds": round(c["seconds"], 3)}
    print(json.dumps(out))


def cmd_aggregate(args):
    _cpu(args)
    from mfgp_jax.data import collect_results, summary

    rows = collect_results(args.pattern, args.out)
    print(json.dumps(summary(rows), indent=1))


def cmd_infogain_test(args):
    """BASELINE config 4 sanity: the mutual-information identity
    (reference/informationGainTest.py) as a quick numerical check."""
    _cpu(args)
    import jax.numpy as jnp

    from mfgp_jax.metrics import info_gain as ig
    from mfgp_jax.ops import kernels as k

    rng = np.random.default_rng(args.seed)
    X = rng.uniform(0, 5, (30, 1))
    K = np.asarray(k.rbf(jnp.asarray(X), jnp.asarray(X), 2.0,
                         jnp.asarray([0.8])))
    sig_n = 0.1
    exact = float(ig.exact_mutual_information(jnp.asarray(K), sig_n))
    # sequential factorization: |K + s I| = prod_k v_k with v_k the noisy
    # conditional variances -> MI = 0.5 sum log(v_k / s)
    L = np.linalg.cholesky(K + sig_n * np.eye(K.shape[0]))
    seq = float(0.5 * np.sum(np.log(np.diag(L) ** 2 / sig_n)))
    # the reference's scorer accumulates log(1 + v_k/s) instead (documented
    # overshoot, metrics/info_gain.py) — reported for comparison
    ref_style = float(ig.sequential_gain_from_cov(
        jnp.asarray(K), sig_n, first_self_conditioned=False, factor=0.5))
    print(json.dumps({"exact": exact, "sequential": seq,
                      "rel_err": abs(exact - seq) / abs(exact),
                      "reference_style_score": ref_style}))


def cmd_study(args):
    """Full study sweep: trajectories -> pipeline -> 4-model training ->
    aggregation (the reference's entire manual workflow as one command)."""
    _cpu(args)
    from mfgp_jax.data.study import run_study

    import numpy as np

    rep = run_study(
        args.out,
        traj_seeds=tuple(range(args.trajectories)),
        vmn_levels=tuple(args.vmn),
        field_seeds=tuple(args.field_seeds),
        closed_loop=args.closed_loop,
        duration=args.duration,
        fit_mode=args.fit_mode,
        dtype=(np.float32 if args.fit_mode.startswith("device")
               else np.float64),
        fit_chunk=args.fit_chunk, eval_chunk=args.eval_chunk,
        ftol=args.ftol)
    print(json.dumps(rep, indent=1))


def cmd_serve(args):
    """Serve trained model checkpoint(s) over HTTP (posterior + EID).

    One positional checkpoint serves single-model; repeat ``name=path``
    pairs route multiple models (/models/<name>/predict)."""
    _cpu(args)
    from mfgp_jax.serve import serve_checkpoint, serve_checkpoints

    def is_pair(c):
        # name=path where the name is a bare identifier — a lone path that
        # merely CONTAINS '=' (e.g. /data/run=3/ck.npz) is not a pair
        name, sep, _ = c.partition("=")
        return bool(sep) and name.isidentifier()

    if all(is_pair(c) for c in args.checkpoint):
        if args.plan_cost:
            raise SystemExit("--plan-cost serves ONE model (no name=path "
                             "routing)")
        paths = dict(c.split("=", 1) for c in args.checkpoint)
        serve_checkpoints(paths, host=args.host, port=args.port)
    else:
        if len(args.checkpoint) != 1:
            raise SystemExit("either ONE checkpoint or name=path pairs")
        serve_checkpoint(args.checkpoint[0], host=args.host, port=args.port,
                         plan_cost=args.plan_cost,
                         plan_iters=args.plan_iters)


def cmd_plot(args):
    """Headless CSV/GPRes plotting (the reference dataPlotter capability)."""
    from mfgp_jax.viz import plot_csv, plot_gpres

    if args.gpres:
        out = plot_gpres(args.csv, args.out)
    else:
        def conv(c):
            return int(c) if c.isdigit() else c

        out = plot_csv(args.csv, args.out, x=conv(args.x),
                       y=[conv(c) for c in args.y], kind=args.kind)
    print(json.dumps({"figure": out}))


def build_parser():
    ap = argparse.ArgumentParser(prog="mfgp_jax",
                                 description="MFGP adaptive exploration")
    ap.add_argument("--gpu", action="store_true",
                    help="run on the CUDA GPU, f32 (default: CPU f64)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sfgp");  p.set_defaults(fn=cmd_sfgp)
    p.add_argument("dataset"); p.add_argument("--field-settings")
    p.add_argument("--kernel", default="rbf")

    p = sub.add_parser("nigp"); p.set_defaults(fn=cmd_nigp)
    p.add_argument("dataset"); p.add_argument("--iters", type=int, default=10)

    p = sub.add_parser("mfgp"); p.set_defaults(fn=cmd_mfgp)
    p.add_argument("dataset"); p.add_argument("--field-settings")
    p.add_argument("--kernel", default="rbf")

    p = sub.add_parser("pipeline"); p.set_defaults(fn=cmd_pipeline)
    p.add_argument("trajectory"); p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vmn", type=float, default=0.2)

    p = sub.add_parser("trainers"); p.set_defaults(fn=cmd_trainers)
    p.add_argument("--fit-mode", default="scipy",
                   choices=["scipy", "device", "device-batched"])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--field-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--kernel", default="rbf")
    p.add_argument("--no-resume", action="store_true")

    p = sub.add_parser("explore"); p.set_defaults(fn=cmd_explore)
    p.add_argument("--variant", default="MFEGP",
                   type=lambda s: s.upper(),
                   choices=["MFEGP", "MFGP", "SFEGP", "SFGP", "MANUAL"])
    p.add_argument("--out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget", type=float, default=150.0)
    p.add_argument("--bd", type=int, default=10)
    p.add_argument("--plan-iters", type=int, default=40)
    p.add_argument("--checkpoint", help="write a checkpoint after each replan")
    p.add_argument("--resume-from", help="resume from a checkpoint file")
    p.add_argument("--planner", default="host", choices=["host", "device"],
                   help="device = whole RIG loop as one jitted launch "
                        "(all four variants; kinematic or dynamic flight)")
    p.add_argument("--plan-ensemble", type=int, default=1,
                   help="device planner: vmapped instances per replan, "
                        "best plan wins")
    p.add_argument("--ergodic-metric", default="kl",
                   choices=["kl", "fourier"],
                   help="ergodic variants: trajectory-distribution KL "
                        "(reference) or Fourier/Sobolev spectral cost "
                        "(host + device planners)")
    p.add_argument("--info-cost", default="sequential",
                   choices=["sequential", "batch"],
                   help="info-gain variants: sequential entropy or the "
                        "grid log-det the reference's physical drivers "
                        "use (host + device planners)")
    p.add_argument("--waypoints", help="CSV of x,y,z rows (MANUAL variant)")
    p.add_argument("--trajectory-name",
                   help="named reference curve for MANUAL (circle, fig8, ...)")
    p.add_argument("--flight", default="kinematic",
                   choices=["kinematic", "dynamic"],
                   help="dynamic = fly plans through the full "
                        "sense->estimate->control runtime (hw/runtime.py)")

    p = sub.add_parser(
        "mission", help="whole experiment as ONE device launch")
    p.set_defaults(fn=cmd_mission)
    p.add_argument("--variant", default="MFEGP",
                   type=lambda s: s.upper(),
                   choices=["MFEGP", "MFGP", "SFEGP", "SFGP"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget", type=float, default=80.0)
    p.add_argument("--bd", type=int, default=4)
    p.add_argument("--plan-iters", type=int, default=40)
    p.add_argument("--e-max", type=int, default=16,
                   help="best-path edge capacity per replan")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "one", "stepped"],
                   help="one = whole mission as a single device launch; "
                        "stepped = budget-tranche spans as separate "
                        "launches of one shared executable; auto = one")
    p.add_argument("--seed-chunk", type=int, default=None,
                   help="with --ensemble: seeds per vmapped launch "
                        "(default: the whole ensemble in one launch)")
    p.add_argument("--ergodic-metric", default="kl",
                   choices=["kl", "fourier"])
    p.add_argument("--info-cost", default="sequential",
                   choices=["sequential", "batch"])
    p.add_argument("--update-hyps", action="store_true",
                   help="per-replan in-graph L-BFGS hyperparameter refits "
                        "(the reference drivers' default regime) instead "
                        "of frozen hyperparameters")
    p.add_argument("--flight", default="kinematic",
                   choices=["kinematic", "dynamic"],
                   help="dynamic = fly each plan through the IN-GRAPH "
                        "sense->estimate->control runtime scan "
                        "(hw/runtime_device.py) — the whole closed loop, "
                        "vehicle dynamics included, in one launch")
    p.add_argument("--ensemble", type=int, default=1,
                   help="also run K COMPLETE missions (seeds seed..seed+"
                        "K-1) as one vmapped launch — a Monte-Carlo of "
                        "whole experiments")
    p.add_argument("--fit-restarts", type=int, default=1,
                   help="with --update-hyps: restart-batched in-graph "
                        "refits (warm start + K-1 perturbed log-space "
                        "starts as one vmapped launch, best finite NLML "
                        "kept)")
    p.add_argument("--glide-stride", type=int, default=1,
                   help="with --flight dynamic: multi-rate runtime scan "
                        "(steady GLIDE windows advance with one coarse "
                        "tick of K*dt; everything else stays at the "
                        "host's fine tick)")
    p.add_argument("--out", default=None,
                   help="write the reference's per-replan artifact set "
                        "(plannedTraj{n}.csv, EID{n}.csv, hyps.csv, "
                        "GPData.csv, replans.csv) to this directory")
    p.add_argument("--submit", default=None, metavar="URL",
                   help="submit to a long-lived mission server "
                        "(cli mission-server) instead of running locally "
                        "— repeat configs reuse its compiled executable, "
                        "skipping the whole-mission compile")

    p = sub.add_parser(
        "mission-server",
        help="long-lived mission-submission server (serve.MissionService):"
             " holds compiled whole-mission executables across POST "
             "/mission submissions")
    p.set_defaults(fn=cmd_mission_server)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)

    p = sub.add_parser(
        "campaign", help="the reference's whole 4-driver experiment "
        "campaign x seeds as one vmapped mission launch per variant")
    p.set_defaults(fn=cmd_campaign)
    p.add_argument("--variants", default="MFEGP,MFGP,SFEGP,SFGP")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget", type=float, default=20.0)
    p.add_argument("--bd", type=int, default=2)
    p.add_argument("--plan-iters", type=int, default=40)
    p.add_argument("--e-max", type=int, default=16)
    p.add_argument("--update-hyps", action="store_true")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "one", "stepped"],
                   help="forwarded to run_ensemble: one = each variant's "
                        "seeds as one launch; stepped = tranche spans; "
                        "auto = one")
    p.add_argument("--seed-chunk", type=int, default=None,
                   help="seeds per vmapped launch (default: all seeds at "
                        "once)")
    p.add_argument("--plot", default=None,
                   help="also render the per-variant RMSE figure to "
                        "this PNG")

    p = sub.add_parser("aggregate"); p.set_defaults(fn=cmd_aggregate)
    p.add_argument("pattern"); p.add_argument("--out")

    p = sub.add_parser("infogain-test"); p.set_defaults(fn=cmd_infogain_test)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("study"); p.set_defaults(fn=cmd_study)
    p.add_argument("--out", required=True)
    p.add_argument("--trajectories", type=int, default=2)
    p.add_argument("--vmn", type=float, nargs="+", default=[0.0, 0.1, 0.2])
    p.add_argument("--field-seeds", type=int, nargs="+", default=[0])
    p.add_argument("--closed-loop", action="store_true",
                   help="generate trajectories with the closed-loop sim")
    p.add_argument("--duration", type=float, default=1200.0)
    p.add_argument("--fit-mode", default="scipy",
                   choices=["scipy", "device", "device-batched"],
                   help="device = restart-batched on-device fits (f32; "
                        "the datasets share a static shape so the 4 "
                        "executables compile once for the whole sweep); "
                        "device-batched = the WHOLE matrix as four "
                        "vmapped launches (data.study_batched — the "
                        "accelerator path)")
    p.add_argument("--fit-chunk", type=int, default=8,
                   help="device-batched only: datasets per fit launch "
                        "(x n_restarts lanes each; one executable either "
                        "way — larger chunks amortize the while_loop's "
                        "sequential iteration cost)")
    p.add_argument("--eval-chunk", type=int, default=8,
                   help="device-batched only: datasets per eval launch "
                        "(bounds the live (chunk, M, M) posterior "
                        "covariances per launch)")
    p.add_argument("--ftol", type=float, default=1e-6,
                   help="device-batched only: relative-f stagnation stop "
                        "for the restart-batched L-BFGS lanes (cuts the "
                        "straggler-lane tail; 0.0 restores the pure "
                        "max|g|<tol criterion of the per-run fits)")

    p = sub.add_parser("serve"); p.set_defaults(fn=cmd_serve)
    p.add_argument("checkpoint", nargs="+",
                   help="one checkpoint path, or name=path pairs for "
                        "multi-model routing")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--plan-cost", default=None,
                   choices=("ergodic", "fourier", "sf_gain", "mf_gain",
                            "sf_logdet", "mf_logdet"),
                   help="enable POST /plan (replan-as-a-service via the "
                        "one-launch device planner) with this scoring "
                        "family")
    p.add_argument("--plan-iters", type=int, default=100,
                   help="device-planner iterations per /plan request")

    p = sub.add_parser("plot"); p.set_defaults(fn=cmd_plot)
    p.add_argument("csv"); p.add_argument("--out", required=True)
    p.add_argument("--x", default="0")
    p.add_argument("--y", nargs="+", default=["1"])
    p.add_argument("--kind", default="line", choices=["line", "scatter"])
    p.add_argument("--gpres", action="store_true",
                   help="treat input as a GPRes artifact (scatter vs truth)")

    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
