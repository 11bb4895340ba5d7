"""GP training & evaluation harness (SURVEY C19, reference/GPTrainers.py).

Per dataset, train four model families and evaluate on the test grid:

* MFGP  — 3-fidelity AR1 on KF-estimated positions
* SFGP  — single-fidelity on estimated positions
* SFGP-TP — single-fidelity on true positions (oracle baseline)
* NIGP  — input-noise GP on estimated positions

Metrics: RMSE and the precision-weighted WMSE
``e^T (Sigma^-1/|Sigma^-1|_F) e / n`` (reference/GPTrainers.py:121-137) —
computed via Cholesky solves (ops.linalg.weighted_mse), never an explicit
inverse. Artifacts (hyp vectors, GPRes grids, MSE summaries) are written in
the reference's exact formats so its result parser and plotters work
unchanged on our outputs.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from mfgp_jax.data.io import (GPDataset, load_gp_dataset, save_gpres,
                              save_hyp_vector, save_mse)
from mfgp_jax.fields.wrbf import WRBFField, parse_field_settings
from mfgp_jax.models.gp import GP
from mfgp_jax.models.mfgp import MFGP
from mfgp_jax.models.nigp import NIGP
from mfgp_jax.ops.linalg import weighted_mse
from mfgp_jax.utils.configs import SimConfig


class TrainedModels(NamedTuple):
    mf: MFGP
    sf: GP
    sf_tp: GP
    nigp: NIGP


def train_models(ds: GPDataset, kernel: str = "rbf", jitter: float = 1e-6,
                 optimize: bool = True, nigp_restarts: int = 2,
                 nigp_iters: int = 10, dtype=np.float64,
                 fit_mode: str = "scipy") -> TrainedModels:
    """Fit the four model families on one dataset
    (reference/GPTrainers.py:60-104).

    ``fit_mode="scipy"`` is the reference-style L-BFGS driver (one
    host<->device round trip per NLML eval — fine on CPU, latency bound
    on an accelerator). ``fit_mode="device"`` runs every fit as ONE
    restart-batched device launch (``optimize_restarts`` /
    ``NIGP.fit_native``): since the study's datasets share a static
    shape, all 4 executables compile once and serve the whole sweep —
    the accelerator path for the 90-run experiment matrix.
    """
    if fit_mode not in ("scipy", "device"):
        raise ValueError(fit_mode)
    Xs, ys = ds.fidelity_lists(use_estimates=True)
    mf = MFGP.from_fidelity_lists(
        [x.astype(dtype) for x in Xs], [y.astype(dtype) for y in ys],
        kernel=kernel, jitter=jitter)
    sf = GP(ds.X_est.astype(dtype), ds.y.astype(dtype), kernel=kernel,
            jitter=jitter)
    sf_tp = GP(ds.X_true.astype(dtype), ds.y.astype(dtype), kernel=kernel,
               jitter=jitter)
    if optimize:
        nigp = NIGP(n_restarts=nigp_restarts, iters=nigp_iters)
        if fit_mode == "device":
            # f32 fits never reach the 1e-6 gradient norm, so the default
            # tol runs every lane to maxiter; 1e-3 exits at f32
            # convergence (summary metrics unchanged, PARITY r3)
            tol = 1e-3 if np.dtype(dtype) == np.float32 else 1e-6
            mf.optimize_restarts(fix_rhos=True, tol=tol)
            sf.optimize_restarts(tol=tol)
            sf_tp.optimize_restarts(tol=tol)
            nigp.fit_native(ds.X_est.astype(dtype), ds.y.astype(dtype),
                            n_restarts=max(nigp_restarts, 1))
            return TrainedModels(mf, sf, sf_tp, nigp)
        mf.optimize(fix_rhos=True)  # kern.scale.fix([1,1]), GPTrainers.py:67
        sf.optimize()
        sf_tp.optimize()
    else:
        # zero-iteration fit: condition on the data at the heuristic init
        # hyperparameters without any NLML optimization
        nigp = NIGP(n_restarts=0, iters=0)
    nigp.fit(ds.X_est.astype(dtype), ds.y.astype(dtype))
    return TrainedModels(mf, sf, sf_tp, nigp)


def wmse_host64(err, cov, normalize: bool = True) -> float:
    """Precision-weighted MSE in host f64 numpy — the fallback for lanes
    whose f32 posterior covariance is numerically indefinite (same
    mathematics as ops.linalg.weighted_mse; trace-scaled jitter retries)."""
    from scipy.linalg import cho_factor, cho_solve, solve_triangular

    cov = np.asarray(cov, np.float64)
    err = np.asarray(err, np.float64)
    n = err.shape[0]
    jit = 1e-12
    for _ in range(6):
        try:
            cf = cho_factor(cov + jit * np.eye(n), lower=True)
            break
        except np.linalg.LinAlgError:
            jit = max(jit * 1e3, 1e-10 * np.trace(cov) / n)
    else:
        return float("nan")
    quad = float(err @ cho_solve(cf, err))
    if normalize:
        A = solve_triangular(np.tril(cf[0]), np.eye(n), lower=True)
        quad /= float(np.linalg.norm(A.T @ A))
    return quad / n


def evaluate_models(models: TrainedModels, test_points: np.ndarray,
                    true_field: WRBFField, normalize: bool = True):
    """Posterior grids + RMSE/WMSE for all four models
    (reference/GPTrainers.py:107-170). Returns (metrics, grids)."""
    tp = np.asarray(test_points, np.float64)
    f_true = np.asarray(true_field(jnp.asarray(tp)))

    mu_mf, cov_mf = models.mf.predict(tp, full_cov=True)
    mu_sf, cov_sf = models.sf.predict(tp, full_cov=True)
    mu_tp, cov_tp = models.sf_tp.predict(tp, full_cov=True)
    mu_ni, cov_ni = models.nigp.predict(tp, return_cov=True,
                                        as_numpy=False)

    metrics = {}
    grids = {}
    for key, mu, cov in (("mf", mu_mf, cov_mf), ("sf", mu_sf, cov_sf),
                         ("nisf", mu_ni, cov_ni), ("sfTP", mu_tp, cov_tp)):
        err = np.asarray(mu).reshape(-1) - f_true
        metrics[f"RMSE {key}"] = float(np.sqrt(np.mean(err**2)))
        # keep the (M, M) covariance ON DEVICE: the WMSE solve consumes it
        # where it lives and only scalars/diagonals come back
        cov_dev = jnp.asarray(cov)
        errj = jnp.asarray(err, cov_dev.dtype)
        w = float(weighted_mse(errj, cov_dev, normalize=normalize))
        if not np.isfinite(w):
            # near-singular posterior covariance (NIGP with vanishing
            # noise does this on some datasets — the reference's explicit
            # inverse returns garbage-but-finite values there): redo this
            # one metric in host f64, where the Kss - V^T V cancellation
            # stays below the jitter (the pre-r3 path did ALL of them
            # there; now it is the rare-lane fallback)
            w = wmse_host64(err, np.asarray(cov_dev), normalize)
        metrics[f"WRMSE {key}"] = w
        grids[key] = (np.asarray(mu).reshape(-1),
                      np.asarray(jnp.diagonal(cov_dev)))
    return metrics, grids


def process_dataset(gpdata_path: str, field_settings_path: str,
                    out_dir: str | None = None, cfg: SimConfig | None = None,
                    kernel: str = "rbf", optimize: bool = True,
                    fit_mode: str = "scipy", dtype=np.float64):
    """One full GPTrainers unit: load -> fit x4 -> evaluate -> artifacts.

    Artifact names mirror the reference (reference/GPTrainers.py:70-170):
    ``<base>_emuGP.txt / _sfGP.txt / _sfGPTP.txt / _nisfGP.txt``,
    ``GPRes_*.csv``, ``MSE_*.txt``.
    """
    cfg = cfg or SimConfig()
    ds = load_gp_dataset(gpdata_path, t_cut=cfg.t_cut)
    field = parse_field_settings(field_settings_path)
    models = train_models(ds, kernel=kernel, optimize=optimize,
                          fit_mode=fit_mode, dtype=dtype)
    metrics, grids = evaluate_models(models, cfg.test_points(), field,
                                     normalize=cfg.normalize_wmse)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.basename(gpdata_path).replace(".csv", "_")
        save_hyp_vector(os.path.join(out_dir, base + "emuGP.txt"),
                        models.mf.param_array, row=True)
        save_hyp_vector(os.path.join(out_dir, base + "sfGP.txt"),
                        models.sf.param_array)
        save_hyp_vector(os.path.join(out_dir, base + "sfGPTP.txt"),
                        models.sf_tp.param_array)
        save_hyp_vector(os.path.join(out_dir, base + "nisfGP.txt"),
                        models.nigp.get_params())
        tp = cfg.test_points()
        f_true = np.asarray(field(jnp.asarray(tp)))
        save_gpres(
            os.path.join(out_dir, os.path.basename(gpdata_path)
                         .replace("GPData", "GPRes")),
            tp, f_true, grids["sf"][0], grids["sf"][1],
            grids["mf"][0], grids["mf"][1])
        save_mse(os.path.join(out_dir, os.path.basename(gpdata_path)
                              .replace("GPData", "MSE")
                              .replace(".csv", ".txt")), metrics)
    return models, metrics


def dataset_task(fname: str, gpdata_dir: str, field_dir: str, out_dir: str,
                 resume: bool = True):
    """Resolve one ``GPData_*.csv`` into (done, gpdata_path, settings_path).

    The single source of truth for the sweep conventions: resume by
    MSE-output existence (the reference's skip-to-last-file logic,
    reference/GPTrainers.py:21-22) and the ``fieldMeas_<seed>`` filename ->
    FieldSettings mapping. Shared by process_directory and
    parallel.sweep.trainer_sweep."""
    mse_name = fname.replace("GPData", "MSE").replace(".csv", ".txt")
    done = resume and os.path.exists(os.path.join(out_dir, mse_name))
    field_seed = fname.split("_")[3]
    settings = os.path.join(field_dir, f"FieldSettings{field_seed}.txt")
    return done, os.path.join(gpdata_dir, fname), settings


def process_directory(gpdata_dir: str, field_dir: str, out_dir: str,
                      cfg: SimConfig | None = None, kernel: str = "rbf",
                      resume: bool = True, optimize: bool = True,
                      fit_mode: str = "scipy", dtype=np.float64,
                      verbose: bool = False):
    """Sweep a GPDataSets directory (resumable by output existence).

    ``fit_mode="device-batched"``: the whole sweep runs as FOUR vmapped
    device launches per same-shape group (data.study_batched) — the
    accelerator path for the full experiment matrix."""
    tasks = []
    for fname in sorted(os.listdir(gpdata_dir)):
        if not fname.endswith(".csv"):
            continue
        done, gpdata_path, settings = dataset_task(
            fname, gpdata_dir, field_dir, out_dir, resume)
        if done:
            continue
        tasks.append((fname, gpdata_path, settings))
    if fit_mode == "device-batched":
        from mfgp_jax.data.study_batched import process_datasets_batched

        return process_datasets_batched(
            [t[1] for t in tasks], [t[2] for t in tasks], out_dir,
            cfg=cfg, kernel=kernel, dtype=dtype, verbose=verbose)
    results = {}
    for fname, gpdata_path, settings in tasks:
        _, metrics = process_dataset(gpdata_path, settings, out_dir, cfg,
                                     kernel=kernel, optimize=optimize,
                                     fit_mode=fit_mode, dtype=dtype)
        results[fname] = metrics
    return results
