"""Offline data pipeline: trajectory -> KF estimates -> field measurements
-> fidelity-binned GP datasets (SURVEY C16-C18, call stack §3.5).

The reference runs three scripts with per-row Python loops
(reference/trajectoryEstimateGenerator.py, measFieldData.py, prepGPData.py);
here each stage is one device launch over the whole trajectory:

* estimates: ``lax.scan`` Kalman filter (estimation.kalman.filter_trajectory)
* measurements: one batched WRBF field evaluation + noise
* binning: vectorized downsample + fidelity thresholding

Stages read/write the reference's CSV schemas (data.io) so our artifacts and
the reference's are interchangeable at every pipeline boundary.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.data.io import (EST_HEADER, FIELD_HEADER, GPDATA_HEADER,
                              Table)
from mfgp_jax.estimation.kalman import filter_trajectory
from mfgp_jax.fields.wrbf import WRBFField, random_field, write_field_settings
from mfgp_jax.utils.configs import SimConfig


def generate_estimates(traj: Table, cfg: SimConfig, seed: int | None = None,
                       t_cut: float = 3600.0) -> Table:
    """KF-estimate a ground-truth trajectory (stage 1, C16).

    traj columns must include t,x,y,z. Returns the reference's
    ``T<seed>_<vmn>.csv`` schema. The time cutoff matches the generator's
    early break (reference/trajectoryEstimateGenerator.py:54-55).
    """
    seed = cfg.seed if seed is None else seed
    t = traj.col("t")
    pos = traj.cols("x", "y", "z")
    # the reference breaks before writing a row with t > t_cut
    # (reference/trajectoryEstimateGenerator.py:54-55): every output row
    # satisfies t <= t_cut, so keep exactly that many rows (+1 for the
    # filter's finite-difference lookahead)
    n_keep = int(np.searchsorted(t, t_cut, side="right"))
    t = t[: n_keep + 1]
    pos = pos[: n_keep + 1]
    model = cfg.kf_model()
    out = filter_trajectory(model, jnp.asarray(t), jnp.asarray(pos),
                            jax.random.key(seed))
    cols = np.column_stack([
        np.asarray(out["t"]), np.asarray(out["pos"]), np.asarray(out["xh"]),
        np.asarray(out["sig"]), np.asarray(out["err"]),
    ])
    return Table(EST_HEADER.split(","), cols)


def generate_estimates_batch(trajs, cfg: SimConfig, seeds=None,
                             t_cut: float = 3600.0):
    """Batched stage 1: one vmapped ``lax.scan`` filters a whole sweep.

    The reference runs its 10-trajectory x 3-noise study one file at a time
    (reference/trajectoryEstimateGenerator.py); here every trajectory's KF
    runs as one device launch. Variable lengths are padded to the longest
    (positions repeat the last row with a constant dt tail) and outputs are
    truncated per trajectory.

    trajs: list of Tables with t/x/y/z columns. Returns a list of estimate
    Tables matching :func:`generate_estimates` row for row.
    """
    seeds = seeds if seeds is not None else [cfg.seed + i
                                             for i in range(len(trajs))]
    model = cfg.kf_model()

    ts, poss, lengths = [], [], []
    for traj in trajs:
        t = traj.col("t")
        pos = traj.cols("x", "y", "z")
        n_keep = int(np.searchsorted(t, t_cut, side="right"))
        t, pos = t[: n_keep + 1], pos[: n_keep + 1]
        lengths.append(t.shape[0])
        ts.append(t)
        poss.append(pos)
    T = max(lengths)
    tpad = np.zeros((len(trajs), T))
    ppad = np.zeros((len(trajs), T, 3))
    for i, (t, pos) in enumerate(zip(ts, poss)):
        n = t.shape[0]
        tpad[i, :n] = t
        ppad[i, :n] = pos
        if n < T:  # constant-dt tail keeps the scan's divisions finite
            dt = t[-1] - t[-2] if n >= 2 else 1.0
            tpad[i, n:] = t[-1] + dt * np.arange(1, T - n + 1)
            ppad[i, n:] = pos[-1]

    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    out = jax.vmap(filter_trajectory, in_axes=(None, 0, 0, 0))(
        model, jnp.asarray(tpad), jnp.asarray(ppad), keys)

    tables = []
    for i, n in enumerate(lengths):
        cols = np.column_stack([
            np.asarray(out["t"][i][: n - 1]),
            np.asarray(out["pos"][i][: n - 1]),
            np.asarray(out["xh"][i][: n - 1]),
            np.asarray(out["sig"][i][: n - 1]),
            np.asarray(out["err"][i][: n - 1]),
        ])
        tables.append(Table(EST_HEADER.split(","), cols))
    return tables


def generate_field_measurements(est: Table, field: WRBFField,
                                cfg: SimConfig, rng: np.random.Generator
                                ) -> Table:
    """Sample the field along the (true) trajectory + noise (stage 2, C17).

    One batched field evaluation; the clamp-at-zero matches
    ``max(0, f + eps)`` (reference/measFieldData.py:70).
    """
    pos = est.cols("x", "y", "z")
    vals = np.asarray(field(jnp.asarray(pos)))
    noisy = np.maximum(0.0, vals + cfg.meas_noise * rng.standard_normal(
        vals.shape[0]))
    cols = np.column_stack([est.col("t"), pos, noisy])
    return Table(FIELD_HEADER.split(","), cols)


def bin_fidelity(est: Table, meas: Table, cfg: SimConfig) -> Table:
    """Downsample to ``meas_rate`` and label fidelity by localization
    covariance (stage 3, C18; reference/prepGPData.py:50-69).

    Reference semantics preserved exactly: the sample clock compares row
    j-1's time against the last *accepted* sample (a sequential dependency —
    computed with a tiny host loop over the boolean decision only), the
    covariance is read from row j while positions come from row j-1, and
    ``covComp = 0.5 (sigx + sigy)``.
    """
    t = est.col("t")
    lev1, lev2, _ = cfg.fidlevels
    period = 1.0 / cfg.meas_rate

    # sequential accept clock (reference/prepGPData.py:56-59)
    accept = np.zeros(t.shape[0], bool)
    last = t[0]
    for j in range(1, t.shape[0]):
        if t[j - 1] - last > period:
            last = t[j - 1]
            accept[j] = True
    idx = np.nonzero(accept)[0]

    cov_comp = 0.5 * (est.col("sigx")[idx] + est.col("sigy")[idx])
    fid = np.where(cov_comp < lev1, 1, np.where(cov_comp < lev2, 2, 3))
    jm1 = idx - 1
    cols = np.column_stack([
        t[jm1], est.cols("x", "y", "z")[jm1], est.cols("xh", "yh", "zh")[jm1],
        meas.col("fieldVal")[jm1], fid.astype(float),
    ])
    return Table(GPDATA_HEADER.split(","), cols)


def write_run_settings(path: str, cfg: SimConfig, origin: str = ""):
    """``T<seed>_<vmn>Settings.txt`` provenance artifact: ground-truth
    origin, seed, measurement-noise vector, and the KF matrices — the
    reference's per-run settings dump
    (reference/trajectoryEstimateGenerator.py:16-43)."""
    model = cfg.kf_model()
    A = np.asarray(type(model).A(cfg.dt))
    with open(path, "w") as f:
        f.write(f"Groundtruth Origin: {origin}\n")
        f.write(f"Random Seed: {cfg.seed}\n")
        f.write("Meas Noise:\n "
                + str(np.asarray(cfg.kf_meas_noise).reshape(-1, 1)) + "\n")
        f.write(f"KF A({cfg.dt}) Matrix:\n {A}\n")
        f.write("KF B Matrix:\n 0\n")
        f.write(f"KF Pinit Matrix:\n {np.asarray(model.P0)}\n")
        f.write(f"KF Q Matrix:\n {np.asarray(model.Q)}\n")
        f.write(f"KF R Matrix:\n {np.asarray(model.R)}\n")


def run_pipeline(traj: Table, cfg: SimConfig, out_dir: str | None = None,
                 traj_name: str | None = None, field: WRBFField | None = None,
                 field_rng: np.random.Generator | None = None,
                 est: Table | None = None):
    """Full stage 1-3 sweep for one ground-truth trajectory.

    Returns (estimates, measurements, gp_data, field). When ``out_dir`` is
    given, writes the reference's directory layout:
    ``T<seed>_<vmn>.csv``, ``FieldData/fieldMeas_<seed>_<name>.csv``,
    ``FieldData/FieldSettings<seed>.txt``,
    ``GPDataSets/GPData_<rate>_fieldMeas_<seed>_<name>.csv``.

    ``est`` short-circuits stage 1 with precomputed estimates (the study
    driver batches the whole sweep's KFs in one vmapped launch,
    generate_estimates_batch).
    """
    name = traj_name or f"T{cfg.seed}_{cfg.vmn:g}"
    if est is None:
        est = generate_estimates(traj, cfg)
    if field is None:
        rng = field_rng or np.random.default_rng(cfg.seed)
        xmax = max(10.0, est.col("x").max())
        ymax = max(20.0, est.col("y").max())
        zmax = max(10.0, est.col("z").max())
        field = random_field(rng, [[0, xmax], [0, ymax]], zmax)
    rng_meas = field_rng or np.random.default_rng(cfg.seed + 1)
    meas = generate_field_measurements(est, field, cfg, rng_meas)
    gp_data = bin_fidelity(est, meas, cfg)

    if out_dir is not None:
        os.makedirs(os.path.join(out_dir, "FieldData"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "GPDataSets"), exist_ok=True)
        write_run_settings(os.path.join(out_dir, name + "Settings.txt"),
                           cfg, origin=getattr(traj, "origin", "<in-memory>"))
        est.save(os.path.join(out_dir, name + ".csv"))
        meas.save(os.path.join(
            out_dir, "FieldData", f"fieldMeas_{cfg.seed}_{name}.csv"))
        write_field_settings(
            os.path.join(out_dir, "FieldData", f"FieldSettings{cfg.seed}.txt"),
            field, meas_noise=cfg.meas_noise)
        gp_data.save(os.path.join(
            out_dir, "GPDataSets",
            f"GPData_{cfg.meas_rate:g}_fieldMeas_{cfg.seed}_{name}.csv"))
    return est, meas, gp_data, field
