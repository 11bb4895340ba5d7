"""End-to-end smoke check of the main path on the GPU.

    python chip_smoke.py             # one card: model, planner, mission
    python chip_smoke.py --chips 4   # four cards: the mesh paths only

One process drives every phase through the entry points a user calls and
compares each with a plain reference at a stated tolerance:

1. model — the N=20k AR1 MFGP train step (NLML + analytic gradient +
   conditioning, explicit-inverse fast path) and the 10,571-point grid
   posterior, for rbf and matern32, f32 at HIGHEST matmul precision;
   the NLML against the recorded f64 NumPy value, and NLML, gradient and
   posterior at N=4,096 against NumPy/SciPy f64 computed here;
2. planner — one 200-iteration DeviceRIG replan at sim defaults with the
   ergodic and the mf_gain cost, then an 8-lane plan_batch whose lane 0
   carries the solo key;
3. mission — ``cli --gpu mission --variant MFEGP --update-hyps`` at the
   CLI defaults, in process; it must be one launch, and its final
   posterior must equal an f64 NumPy refit on the harvested rows.

``--chips 4`` runs only what exists across cards: a mesh-sharded planner
ensemble, a dp-sharded mission ensemble and the mesh-sharded N=20k NLML
gradient, each against the same computation on one card.

It refuses to run without a GPU. Every earlier line is a report; the last
line is one JSON object, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
import traceback

import numpy as np

# The CLI's own mission defaults (mfgp_jax/cli.py `mission`): B=80, BD=4.
MISSION_ARGV = ["mission", "--variant", "MFEGP", "--update-hyps"]

# Tolerances, each with the reason it holds (see the phase docstrings).
TOL_NLML_RECORDED = 1e-3  # f32 N=20k vs the recorded f64 NLML
TOL_NLML = 1e-3           # f32 vs f64 NLML at the check size
TOL_GRAD = 5e-3           # max |g - g64| / max |g64|
TOL_MU = 1e-3             # max |mu - mu64| / max |mu64|
TOL_VAR = 5e-3            # max |var - var64| / max var64
TOL_LANE = 1e-4           # vmapped lane vs solo plan, info and budget
TOL_MISSION_MU = 1e-2     # f32 mission posterior vs f64 refit
TOL_MISSION_VAR = 1e-2
TOL_MESH = 1e-4           # mesh-sharded vs one-card results, f32
TOL_MESH_GRAD = 1e-3      # sharded vs one-card NLML gradient, f32
TOL_MESH_F64 = 1e-8       # sharded mission ensemble vs solo runs, f64


class CheckFailed(AssertionError):
    pass


def check(ok, what: str, log=print):
    """Report one comparison; raise when it fails."""
    log(("  ok   " if ok else "  FAIL ") + what)
    if not ok:
        raise CheckFailed(what)


def rel_max(a, b, scale=None) -> float:
    """max |a - b| over the scale (max |b| by default)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.max(np.abs(b)) if scale is None else scale
    return float(np.max(np.abs(a - b)) / max(s, 1e-300))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def last_line(devices) -> str:
    """The closing JSON line for the devices JAX reports."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _bench_params(dtype):
    import jax.numpy as jnp

    import bench
    from mfgp_jax.models import mfgp as mf

    v, l, r, nz = bench._theta()
    return mf.MFGPParams(jnp.log(jnp.asarray(v, dtype)),
                         jnp.log(jnp.asarray(l, dtype)),
                         jnp.asarray(r, dtype),
                         jnp.log(jnp.asarray(nz, dtype)))


def _device_unit(kernel, N, M, log=print):
    """The bench unit on the device: compiled train step + posterior.

    Returns (nlml, grad vector in log-parameter order, mu, var, problem)."""
    import jax
    import jax.numpy as jnp

    import bench
    from mfgp_jax.models import mfgp as mf

    prob = bench.build_problem(N, M)
    X, fid, y, grid, gfid = (jnp.asarray(a) for a in prob)
    params = _bench_params(jnp.float32)
    step = jax.jit(lambda p, X, f, y: mf.nlml_value_grad_state_inv(
        p, X, f, y, kernel=kernel, jitter=1e-6, inv_mode="highest"))
    t0 = time.perf_counter()
    compiled = step.lower(params, X, fid, y).compile()
    log(f"  N={N} train step compiled in {time.perf_counter() - t0:.1f} s;"
        f" memory_analysis: {_mem(compiled)}")
    val, g, state = compiled(params, X, fid, y)
    mu, var = mf.predict_blocked_inv(params, state, grid, gfid,
                                     kernel=kernel)
    jax.block_until_ready((val, g, mu, var))
    grad = np.concatenate([np.asarray(g.log_variances),
                           np.asarray(g.log_lengthscales).reshape(-1),
                           np.asarray(g.log_noises)])
    return float(val), grad, np.asarray(mu), np.asarray(var), prob


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "unavailable"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{k.replace('_size_in_bytes', '')}="
                     f"{getattr(m, k, 0) / 2**30:.3f} GiB" for k in keys)


def phase_model(kernel: str, n_full: int | None = None,
                n_check: int = 4096, m: int | None = None, log=print):
    """The AR1 MFGP train step and grid posterior at full width.

    f32 at HIGHEST precision (true f32 FMAs, no TF32). The NLML is checked
    at 1e-3 relative, against the recorded f64 value at N=20k and against
    NumPy f64 at the check size: its log-det sums N logs of the f32
    Cholesky diagonal, and XLA's f32 Cholesky on the card is far less
    accurate than LAPACK's (half log-det off by 1.5 at N=4096, K's
    condition number 1.4e5, where LAPACK's f32 factor is off by 4e-7).
    The gradient, whose trace identity subtracts alpha alpha^T from K^-1
    (cancellation of f32 K^-1 entries), is checked at 5e-3 of its largest
    entry; the mean at 1e-3; the variance, ``kss - |V|^2`` with f32
    cancellation, at 5e-3 of its largest value. The CPU's own f32 run of
    this code on the same inputs errs by 2e-5 (NLML), 1.5e-4, 1e-4 and
    5e-4."""
    import bench

    n_full = bench.N_TRAIN if n_full is None else n_full
    m = bench.M_GRID if m is None else m
    val, grad, mu, var, _ = _device_unit(kernel, n_full, m, log)
    check(np.isfinite(val) and np.all(np.isfinite(grad)),
          f"{kernel} N={n_full}: NLML {val:.2f} and gradient finite", log)
    check(mu.shape == (m,) and var.shape == (m,)
          and np.all(np.isfinite(mu)) and np.all(np.isfinite(var)),
          f"{kernel} N={n_full}: posterior finite, shape ({m},)", log)
    if n_full == bench.N_TRAIN:
        rec = (bench.BASELINE_CPU_NLML if kernel == "rbf"
               else bench.BASELINE_CPU_NLML_MATERN32)
        err = abs(val - rec) / abs(rec)
        check(err <= TOL_NLML_RECORDED,
              f"{kernel} N={n_full}: NLML vs recorded f64 {rec}: rel err "
              f"{err:.2e} <= {TOL_NLML_RECORDED:.0e}", log)

    val, grad, mu, var, prob = _device_unit(kernel, n_check, m, log)
    ref = bench.numpy_unit(*prob, kernel=kernel)
    errs = {
        "nlml": (abs(val - ref["nlml"]) / abs(ref["nlml"]), TOL_NLML),
        "grad": (rel_max(grad, ref["grad"]), TOL_GRAD),
        "mu": (rel_max(mu, ref["mu"]), TOL_MU),
        "var": (rel_max(var, ref["var"], np.max(ref["var"])), TOL_VAR),
    }
    for name, (e, tol) in errs.items():
        check(e <= tol, f"{kernel} N={n_check}: {name} vs NumPy f64: "
              f"rel err {e:.2e} <= {tol:.0e}", log)
    return {k: e for k, (e, _) in errs.items()}


def _sim_planner(cost, iters, **kw):
    from mfgp_jax.metrics.eid import eid_grid
    from mfgp_jax.planning.rig_device import DeviceRIG
    from mfgp_jax.utils.configs import SimConfig

    cfg = SimConfig()
    grid = np.asarray(eid_grid([list(b) for b in cfg.WS], cfg.max_depth))
    eid = np.random.default_rng(0).random(grid.shape[0])
    # one replan plans one budget tranche, B / BD of the sim's budget
    planner = DeviceRIG(
        cfg=cfg.agent(), delta=cfg.step_size, B=cfg.B / cfg.BD,
        WS=np.asarray(cfg.WS, float), R=cfg.near_rad, Rd=cfg.Rd,
        same_node_distance=cfg.same_node_distance, budget_cutoff=0.9,
        max_iter=iters, grid=grid, eid=eid / eid.sum(), cost=cost, **kw)
    return cfg, planner


def _mf_gain_state(cfg, n_train, n_max):
    """A conditioned AR1 MFGP on sim-field samples, padded for mf_gain."""
    import jax.numpy as jnp

    from mfgp_jax.fields.wrbf import default_sim_field
    from mfgp_jax.models.mfgp import MFGP
    from mfgp_jax.planning.rig_device import prepare_mf_gain_state

    rng = np.random.default_rng(1)
    ws = np.asarray(cfg.WS, float)
    lo = np.array([ws[0, 0], ws[1, 0], 0.0])
    hi = np.array([ws[0, 1], ws[1, 1], cfg.max_depth])
    X = (lo + (hi - lo) * rng.random((n_train, 3))).astype(np.float32)
    field = default_sim_field(cfg.WS, cfg.max_depth)
    y = np.asarray(field(jnp.asarray(X)), np.float32)
    y = y + 0.1 * rng.standard_normal(n_train).astype(np.float32)
    fid = rng.integers(0, 3, n_train)
    model = MFGP(X, fid, y, jitter=1e-6)
    return prepare_mf_gain_state(model, cfg.agent().fid_levels, n_max,
                                 jnp.float32)


def phase_planner(iters: int = 200, lanes: int = 8, n_train: int = 300,
                  n_max: int = 384, log=print):
    """One replan per cost at sim defaults, then a fleet plan_batch.

    Each plan must find a path (finite info) inside its budget tranche
    (the sim's B / BD = 15). Lane 0 of the batch carries the solo key, so
    it runs the same arithmetic as the solo plan with the index reads
    lowered as gathers instead of exact one-hot contractions; reordered
    f32 reductions bound the difference, checked at 1e-4 relative on info
    and budget."""
    import jax

    out = {}
    for cost in ("ergodic", "mf_gain"):
        cfg, planner = _sim_planner(cost, iters)
        gp = _mf_gain_state(cfg, n_train, n_max) if cost == "mf_gain" \
            else None
        x0 = np.array([1.0, 1.0])
        key = jax.random.key(0)
        t0 = time.perf_counter()
        solo = planner.plan(x0, key, gp=gp)
        log(f"  {cost}: solo plan (compile + run) "
            f"{time.perf_counter() - t0:.1f} s, info {solo.info:.6g}, "
            f"budget {solo.budget:.4f}, {solo.points.shape[0]} points")
        check(np.isfinite(solo.info) and solo.points.shape[0] > 0,
              f"{cost}: solo plan found a path (finite info)", log)
        check(0.0 < solo.budget <= planner.B * (1 + 1e-6),
              f"{cost}: path cost {solo.budget:.4f} within budget "
              f"{planner.B}", log)
        keys = jax.random.split(jax.random.key(1), lanes)
        keys = keys.at[0].set(key)
        batch = planner.plan_batch(np.tile(x0, (lanes, 1)), keys,
                                   np.full(lanes, planner.B), gp=gp)
        infos = np.array([b.info for b in batch])
        check(np.all(np.isfinite(infos)),
              f"{cost}: all {lanes} batch lanes found a path", log)
        e_info = abs(batch[0].info - solo.info) / abs(solo.info)
        e_budget = abs(batch[0].budget - solo.budget) / solo.budget
        check(max(e_info, e_budget) <= TOL_LANE,
              f"{cost}: lane 0 vs solo: info rel err {e_info:.2e}, "
              f"budget rel err {e_budget:.2e} <= {TOL_LANE:.0e}", log)
        out[cost] = dict(info=solo.info, lane_err=max(e_info, e_budget))
    return out


@contextlib.contextmanager
def _recorded_missions(runs: list):
    """Record each DeviceMission the CLI builds, with its result and the
    number of device launches it took."""
    from unittest import mock

    from mfgp_jax.sim import mission_device as md

    class Recorded(md.DeviceMission):
        def run(self, *a, **kw):
            res = super().run(*a, **kw)
            runs.append((self, res, self.last_run_launches))
            return res

    with mock.patch.object(md, "DeviceMission", Recorded):
        yield


def mission_refit_errors(mission, res, kernel="rbf"):
    """(mean, variance) errors of the mission's final test-grid posterior
    against an f64 NumPy model conditioned from scratch on the harvested
    rows (plus the start-pose row the arena keeps) at the mission's final
    hyperparameters."""
    import bench

    X, fid, y = mission.harvested(res)
    x0 = np.array([[mission._x0[0], mission._x0[1], 0.0]])
    hp = mission.host_params(res.theta)
    top = mission.F - 1
    Xa = np.concatenate([x0, X])
    fa = np.concatenate([[top], fid])
    ya = np.concatenate([[0.0], y])
    tp = np.asarray(mission.cfg.test_points())
    mu, var = bench.numpy_posterior(
        Xa, fa, ya, tp, np.full(tp.shape[0], top),
        np.asarray(hp.variances), np.asarray(hp.lengthscales),
        np.asarray(hp.rhos), np.asarray(hp.noises), kernel=kernel)
    return (rel_max(res.test_mu, mu),
            rel_max(res.test_var, var, np.max(var)))


def phase_mission(argv, log=print):
    """The whole MFEGP mission through the CLI, with in-graph refits.

    It must resolve to ONE device launch and replan at least once. The
    final posterior comes from an f32 arena grown by bordered Cholesky
    updates and refactorized after every refit (jitter 1e-6); against an
    f64 from-scratch refit the mean is checked at 1e-2 of its largest
    value and the variance at 1e-2 of its largest value, the room f32
    leaves at the arena's condition numbers."""
    from mfgp_jax import cli

    runs = []
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _recorded_missions(runs), contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    wall = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  cli {' '.join(argv)}: {wall:.1f} s (two missions, cold + "
        f"warm); output {json.dumps(out)}")
    mission, res, launches = runs[0]
    check(launches == 1 and out["launches"] == 1,
          f"mission ran as one launch (launches={launches})", log)
    check(res.n_replans >= 1 and np.isfinite(res.rmse),
          f"mission replanned {res.n_replans}x, rmse {res.rmse:.4f} "
          "finite", log)
    e_mu, e_var = mission_refit_errors(mission, res,
                                       kernel=mission.exp.kernel)
    check(e_mu <= TOL_MISSION_MU,
          f"mission posterior mean vs f64 refit: rel err {e_mu:.2e} <= "
          f"{TOL_MISSION_MU:.0e}", log)
    check(e_var <= TOL_MISSION_VAR,
          f"mission posterior var vs f64 refit: rel err {e_var:.2e} <= "
          f"{TOL_MISSION_VAR:.0e}", log)
    return dict(rmse=res.rmse, n_replans=res.n_replans, mu_err=e_mu,
                var_err=e_var)


def phase_mesh(n_devices: int = 4, n_train: int | None = None,
               plan_iters: int = 200, mission_kw: dict | None = None,
               log=print):
    """The multi-device paths against the same work on one device.

    (a) plan_ensemble over the mesh vs on one device: the same vmapped
    program with the same keys, members partitioned over dp with no
    collectives — 1e-4 relative on the winning plan's info and budget.
    (b) a dp-sharded 4-seed mission ensemble vs four solo missions, in
    f64 with frozen hyperparameters: in f32 a reordered reduction can flip
    a planner tie-break, and an in-graph L-BFGS refit can stop one step
    apart, after which a mission follows another path; f64 without refits
    makes member-vs-solo a sharp check (as in the CPU tests) — 1e-8
    relative on the final posterior mean and RMSE. (c) the mesh-sharded N=20k NLML and gradient
    vs the one-device analytic gradient, f32: both solve K^-1 by blocked
    substitution against the same factor, but over other column splits
    and GEMM tilings, and the gradient sums N^2 products — value at 1e-4,
    gradient at 1e-3 of its largest entry."""
    import jax
    import jax.numpy as jnp

    import bench
    from mfgp_jax.models.mfgp import nlml_value_and_grad
    from mfgp_jax.parallel.mesh import make_mesh
    from mfgp_jax.parallel.sharded import make_sharded_nlml_value_and_grad
    from mfgp_jax.sim.mission_device import DeviceMission
    from mfgp_jax.utils.configs import ExperimentConfig

    jax.config.update("jax_enable_x64", True)  # for (b); (a), (c) stay f32
    mesh = make_mesh(n_devices)
    log(f"  mesh {dict(mesh.shape)} over {n_devices} devices")
    dp = mesh.shape["dp"]

    _, planner = _sim_planner("ergodic", plan_iters)
    x0, key = np.array([1.0, 1.0]), jax.random.key(0)
    sharded = planner.plan_ensemble(x0, key, n_plans=n_devices, mesh=mesh)
    one = planner.plan_ensemble(x0, key, n_plans=n_devices)
    e = max(abs(sharded.info - one.info) / abs(one.info),
            abs(sharded.budget - one.budget) / one.budget)
    check(np.isfinite(one.info) and e <= TOL_MESH,
          f"plan_ensemble({n_devices}) mesh vs one device: rel err "
          f"{e:.2e} <= {TOL_MESH:.0e}", log)

    kw = dict(B=80.0, BD=4, multi_fidelity=True, ergodic=True,
              update_hyps=False)
    kw.update(mission_kw or {})
    mkw = dict(dtype=jnp.float64, **kw.pop("mission", {}))
    exp = ExperimentConfig(**kw)
    ens = DeviceMission(exp, seed=0, **mkw).run_ensemble(
        2 * dp, mesh=mesh)
    worst, run_jit = 0.0, None
    for i, r in enumerate(ens):
        m = DeviceMission(exp, seed=i, **mkw)
        if run_jit is not None:
            m._run_jit = run_jit  # one compile serves every solo seed
        solo = m.run()
        run_jit = m._run_jit
        check(r.n_replans == solo.n_replans,
              f"mission seed {i}: {r.n_replans} replans in the ensemble "
              f"and solo", log)
        worst = max(worst, rel_max(r.test_mu, solo.test_mu),
                    abs(r.rmse - solo.rmse) / solo.rmse)
    check(worst <= TOL_MESH_F64, f"{len(ens)}-seed dp-sharded mission "
          f"ensemble vs solo runs (f64): rel err {worst:.2e} <= "
          f"{TOL_MESH_F64:.0e}", log)

    n = bench.N_TRAIN if n_train is None else n_train
    X, fid, y, _, _ = (jnp.asarray(a) for a in bench.build_problem(n, 8))
    params = _bench_params(X.dtype)
    v_s, g_s = make_sharded_nlml_value_and_grad(mesh, jitter=1e-6)(
        params, X, fid, y)
    v_1, g_1 = nlml_value_and_grad(params, X, fid, y, jitter=1e-6)
    e_v = abs(float(v_s) - float(v_1)) / abs(float(v_1))
    flat = [np.concatenate([np.ravel(a) for a in jax.tree.leaves(g)])
            for g in (g_s, g_1)]
    e_g = rel_max(flat[0], flat[1])
    check(e_v <= TOL_MESH and e_g <= TOL_MESH_GRAD,
          f"sharded NLML N={n}: value rel err {e_v:.2e} <= "
          f"{TOL_MESH:.0e}, gradient rel err {e_g:.2e} <= "
          f"{TOL_MESH_GRAD:.0e}", log)
    return dict(plan_err=e, mission_err=worst, nlml_err=e_v, grad_err=e_g)


def run_phases(phases, log=print) -> list:
    """Run every phase, report each, return the names that failed."""
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        log(f"phase {name}: {'FAILED' if name in failed else 'passed'} "
            f"in {time.perf_counter() - t0:.1f} s")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4 = only the multi-card paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices only",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs, JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 2

    from mfgp_jax.utils.cache import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}")
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; devices {len(devices)} x "
          f"{devices[0].device_kind}; jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision}")
    if args.chips == 4:
        phases = [("mesh", lambda: phase_mesh(4))]
    else:
        phases = [
            ("model rbf", lambda: phase_model("rbf")),
            ("model matern32", lambda: phase_model("matern32")),
            ("planner", phase_planner),
            ("mission", lambda: phase_mission(["--gpu"] + MISSION_ARGV)),
        ]
    failed = run_phases(phases)
    if failed:
        print(f"FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(last_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
