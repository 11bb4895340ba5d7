"""Study drivers: the end-to-end sweep (§3.5) and the training-set-size
study (C22). Formerly split across study.py/studies.py; merged because two
adjacent modules one character apart invited import mistakes.

End-to-end study driver (the reference's §3.5 workflow, completed).

The reference's simulation study is four scripts run by hand over a
ground-truth trajectory CSV whose *generator is missing from the repo*
(SURVEY §3.5: ``mfgpSimSimp.csv`` came from an absent closed-loop sim).
This driver closes the loop end to end:

  for each (trajectory seed x velocity-noise level):
      1. fly a closed-loop exploration run (sim.ExplorationSim) or a
         scripted reference curve -> ground-truth trajectory
      2. pipeline: KF estimates -> field measurements -> fidelity binning
      3. trainers: fit {MFGP, SFGP, SFGP-TP, NIGP}, RMSE/WMSE
      4. aggregate -> results.csv + summary

reproducing the reference's 10 x 3 x 3 study design
(reference/resultParser.py:44-55) at any scale.
"""

from __future__ import annotations

import os
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from mfgp_jax.data.aggregate import collect_results, summary
from mfgp_jax.data.io import Table
from mfgp_jax.data.pipeline import run_pipeline
from mfgp_jax.data.trainers import process_dataset
from mfgp_jax.fields.wrbf import WRBFField, default_sim_field, random_field
from mfgp_jax.models.gp import GP
from mfgp_jax.utils.configs import SimConfig


# -- training-set-size study (SURVEY C22, reference/HowManyPoints.py:62-109)
#
# How many (grid-sampled) training points does the SFGP need for a target
# test-grid RMSE on a WRBF field? The reference fits one model per size
# serially; here every size in the sweep shares one jitted fit/predict
# pair. (The reference file also contains unused toy dynamics with
# undefined-var bugs — graceSimple/Unicycle3D/singleIntegrator3D — dead
# code, not ported; SURVEY §2 C22.)

def grid_samples(WS, max_depth, nums=(8, 16, 8)) -> np.ndarray:
    """The reference's 8x16x8 grid-sampled candidate training set."""
    axes = [np.linspace(WS[0][0], WS[0][1], nums[0]),
            np.linspace(WS[1][0], WS[1][1], nums[1]),
            np.linspace(0.0, max_depth, nums[2])]
    g = np.meshgrid(*axes)
    return np.array([a.ravel() for a in g]).T


def training_size_study(sizes: Sequence[int], cfg: SimConfig | None = None,
                        field: WRBFField | None = None, noise: float = 0.125,
                        seed: int = 0, optimize: bool = True,
                        restarts: int = 4):
    """RMSE on the sim test grid vs number of training points.

    Returns a list of dicts {n, rmse, nlml}. Training points are drawn
    without replacement from the dense candidate grid (matching the
    reference's random grid subset), targets from the WRBF field + noise.
    """
    cfg = cfg or SimConfig()
    field = field or default_sim_field(cfg.WS, cfg.max_depth)
    rng = np.random.default_rng(seed)
    cand = grid_samples(cfg.WS, cfg.max_depth)
    y_cand = np.asarray(field(jnp.asarray(cand)))
    y_cand = y_cand + noise * rng.standard_normal(y_cand.shape[0])
    tp = cfg.test_points()
    f_true = np.asarray(field(jnp.asarray(tp)))

    out = []
    for n in sizes:
        idx = rng.choice(cand.shape[0], size=min(n, cand.shape[0]),
                         replace=False)
        gp = GP(cand[idx], y_cand[idx], jitter=1e-6)
        if optimize:
            gp.optimize_restarts(n_restarts=restarts, maxiter=150,
                                 seed=seed)
        mu, _ = gp.predict(tp)
        rmse = float(np.sqrt(np.mean((np.asarray(mu) - f_true) ** 2)))
        out.append({"n": int(len(idx)), "rmse": rmse,
                    "nlml": -gp.log_likelihood()})
    return out


# -- end-to-end sweep driver -------------------------------------------------


def scripted_trajectory(seed: int, cfg: SimConfig, duration: float = 1200.0,
                        dt: float = 0.1) -> Table:
    """A smooth seeded survey trajectory over the workspace (stand-in for a
    full closed-loop flight when speed matters)."""
    rng = np.random.default_rng(seed)
    t = np.arange(0.0, duration, dt)
    xs, ys = cfg.WS[0][1], cfg.WS[1][1]
    f1, f2, f3 = rng.uniform(1 / 600, 1 / 200, 3)
    ph = rng.uniform(0, 2 * np.pi, 3)
    x = xs * (0.5 + 0.4 * np.sin(2 * np.pi * f1 * t + ph[0]))
    y = ys * (0.5 + 0.4 * np.sin(2 * np.pi * f2 * t + ph[1]))
    z = np.clip(cfg.max_depth * (0.55 + 0.5 * np.sin(
        2 * np.pi * f3 * t + ph[2])) - 0.1 * cfg.max_depth, 0.0, None)
    return Table(["t", "x", "y", "z"], np.column_stack([t, x, y, z]))


def closed_loop_trajectory(seed: int, cfg: SimConfig, budget: float = 30.0,
                           plan_iters: int = 10) -> Table:
    """Ground-truth trajectory from an actual closed-loop exploration run
    (the missing generator of the reference's mfgpSimSimp.csv)."""
    from mfgp_jax.sim import ExplorationSim
    from mfgp_jax.utils.configs import ExperimentConfig

    exp = ExperimentConfig(sim=cfg, multi_fidelity=False, ergodic=True,
                           B=budget, BD=3)
    sim = ExplorationSim(exp, seed=seed, plan_iters=plan_iters)
    res = sim.run()
    est = res.estimates
    if est.shape[0] < 10:
        return scripted_trajectory(seed, cfg)
    return Table(["t", "x", "y", "z"], est[:, :4])


def run_study(out_dir: str, traj_seeds=(0, 1), vmn_levels=(0.0, 0.2),
              field_seeds=(0,), cfg: SimConfig | None = None,
              closed_loop: bool = False, optimize: bool = True,
              duration: float = 1200.0, fit_mode: str = "scipy",
              dtype=None, fit_chunk: int = 8, eval_chunk: int = 8,
              ftol: float = 1e-6):
    """The full sweep. Returns the aggregate summary dict; writes the
    reference's artifact tree under ``out_dir``.

    ``fit_mode="device-batched"``: stage the WHOLE matrix first (pipeline
    per run), then fit + evaluate every dataset with four vmapped device
    launches total (data.study_batched) — the accelerator path; the 90-run matrix
    becomes one compile + one execution per model family instead of 360
    sequential fits. ``ftol`` (device-batched only) is the batched
    L-BFGS stagnation stop — 0.0 restores the per-run fits' pure
    max|g|<tol criterion."""
    base_cfg = cfg or SimConfig()
    os.makedirs(out_dir, exist_ok=True)
    res_dir = os.path.join(out_dir, "GPResults")
    os.makedirs(res_dir, exist_ok=True)
    batched = fit_mode == "device-batched"
    staged: list[tuple[str, str]] = []

    from mfgp_jax.data.pipeline import generate_estimates_batch

    for fseed in field_seeds:
        frng = np.random.default_rng(1000 + fseed)
        field = random_field(frng, base_cfg.WS, base_cfg.max_depth)
        traj_cfg = SimConfig(seed=fseed, vmn=0.0)
        trajs = [(closed_loop_trajectory(tseed, traj_cfg)
                  if closed_loop
                  else scripted_trajectory(tseed, traj_cfg,
                                           duration=duration))
                 for tseed in traj_seeds]
        for vmn in vmn_levels:
            run_cfg = SimConfig(seed=fseed, vmn=vmn)
            # stage 1 for the whole trajectory sweep in ONE vmapped launch
            ests = generate_estimates_batch(
                trajs, run_cfg, seeds=[fseed] * len(trajs))
            for tseed, traj, est in zip(traj_seeds, trajs, ests):
                name = f"T{tseed}_{vmn:g}"
                run_pipeline(traj, run_cfg, out_dir=out_dir, traj_name=name,
                             field=field, est=est,
                             field_rng=np.random.default_rng(
                                 7 * tseed + fseed))
                ds_name = (f"GPData_{run_cfg.meas_rate:g}_fieldMeas_"
                           f"{fseed}_{name}.csv")
                gpdata_path = os.path.join(out_dir, "GPDataSets", ds_name)
                settings_path = os.path.join(out_dir, "FieldData",
                                             f"FieldSettings{fseed}.txt")
                if batched:
                    staged.append((gpdata_path, settings_path))
                    continue
                process_dataset(
                    gpdata_path, settings_path,
                    out_dir=res_dir, cfg=run_cfg, optimize=optimize,
                    fit_mode=fit_mode,
                    dtype=dtype if dtype is not None else np.float64)

    if batched:
        from mfgp_jax.data.study_batched import process_datasets_batched

        # eval-relevant cfg fields (test grid, t_cut, WMSE normalization)
        # are identical across the matrix's per-run (seed, vmn) configs
        process_datasets_batched(
            [p for p, _ in staged], [s for _, s in staged],
            out_dir=res_dir, cfg=base_cfg,
            dtype=dtype if dtype is not None else np.float32,
            verbose=True, fit_chunk=fit_chunk, eval_chunk=eval_chunk,
            ftol=ftol)

    rows = collect_results(os.path.join(res_dir, "MSE_*.txt"),
                           os.path.join(res_dir, "results.csv"))
    return summary(rows)
