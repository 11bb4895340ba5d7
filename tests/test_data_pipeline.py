"""Data pipeline + trainer harness tests (SURVEY C16-C20).

Fixture-based parity: reads the reference's recorded GPDataSets /
FieldSettings / MSE artifacts where available.
"""

import glob
import os

import numpy as np
import pytest

from mfgp_jax.data import (Table, bin_fidelity, collect_results,
                           generate_estimates, generate_field_measurements,
                           load_gp_dataset, mean_metrics, run_pipeline,
                           summary)
from mfgp_jax.data.io import parse_mse, parse_mse_filename, save_mse
from mfgp_jax.data.trainers import evaluate_models, train_models
from mfgp_jax.fields.wrbf import parse_field_settings
from mfgp_jax.utils.configs import SimConfig

REF_GPDATA = ("/root/reference/Data/TrajectoriesAndEstimates/GPDataSets/"
              "GPData_0.2_fieldMeas_0_T0_0.csv")
REF_FIELD = ("/root/reference/Data/TrajectoriesAndEstimates/FieldData/"
             "FieldSettings0.txt")
REF_MSE_DIR = "/root/reference/Data/TrajectoriesAndEstimates/GPResults"


@pytest.fixture
def synth_traj():
    t = np.arange(0, 600, 0.1)
    x = 5 + 4 * np.sin(2 * np.pi * t / 200)
    y = 10 + 8 * np.sin(2 * np.pi * t / 300)
    z = np.clip(5 * np.sin(2 * np.pi * t / 120) ** 2 - 0.4, 0, None)
    return Table(["t", "x", "y", "z"], np.column_stack([t, x, y, z]))


def test_config_fidlevels_match_reference():
    # (min(diff(WS)) * [.05,.15,.25])**2 with WS=[[0,10],[0,20]] -> min span 10
    cfg = SimConfig()
    np.testing.assert_allclose(cfg.fidlevels, [0.25, 2.25, 6.25])


def test_config_test_points_matches_reference_ordering():
    tp = SimConfig().test_points()
    assert tp.shape == (2000, 3)
    # Fortran-ravel of meshgrid: x varies fastest along axis 1 blocks
    assert tp[0].tolist() == [0.0, 0.0, 0.0]
    assert tp[-1].tolist() == [10.0, 20.0, 10.0]


def test_estimates_schema_and_gating(synth_traj):
    cfg = SimConfig(seed=0, vmn=0.1)
    est = generate_estimates(synth_traj, cfg)
    assert est.headers == ("t,x,y,z,xh,yh,zh,sigx,sigy,sigz,xe,ye,ze"
                           .split(","))
    # depth is directly measured -> much tighter than x/y underwater
    assert est.col("sigz").mean() < est.col("sigx").mean()
    # estimates track truth
    assert np.abs(est.col("xe")).mean() < 1.0


def test_full_pipeline_roundtrip(tmp_path, synth_traj):
    cfg = SimConfig(seed=3, vmn=0.2)
    est, meas, gpd, field = run_pipeline(synth_traj, cfg,
                                         out_dir=str(tmp_path))
    assert (tmp_path / "T3_0.2.csv").exists()
    f = tmp_path / "GPDataSets" / "GPData_0.2_fieldMeas_3_T3_0.2.csv"
    assert f.exists()
    ds = load_gp_dataset(str(f))
    assert ds.n == gpd.data.shape[0]
    assert set(np.unique(ds.fid_lev)) <= {1, 2, 3}
    # downsample rate: ~1 sample per 5s (measRate=0.2Hz)
    dt = np.diff(gpd.col("t"))
    assert dt.min() > 1.0 / cfg.meas_rate - 0.2
    # field settings roundtrip
    f2 = parse_field_settings(str(tmp_path / "FieldData" /
                                  "FieldSettings3.txt"))
    np.testing.assert_allclose(np.asarray(f2.p), np.asarray(field.p),
                               rtol=1e-4)


def test_measurements_clamped_nonnegative(synth_traj, rng):
    cfg = SimConfig()
    est = generate_estimates(synth_traj, cfg)
    from mfgp_jax.fields.wrbf import random_field

    field = random_field(rng, [[0, 10], [0, 20]], 10.0)
    meas = generate_field_measurements(est, field, cfg, rng)
    assert (meas.col("fieldVal") >= 0).all()


@pytest.mark.skipif(not os.path.exists(REF_GPDATA),
                    reason="reference artifacts unavailable")
def test_reference_dataset_loads():
    ds = load_gp_dataset(REF_GPDATA)
    assert ds.n == 709  # BASELINE.md scale fact
    Xs, ys = ds.fidelity_lists()
    assert sum(x.shape[0] for x in Xs) == 709
    # emukit order: index 0 = fidLev 3
    assert Xs[0].shape[0] == (ds.fid_lev == 3).sum()


@pytest.mark.skipif(not os.path.exists(REF_GPDATA),
                    reason="reference artifacts unavailable")
def test_trainer_harness_parity_fixed_budget():
    """Train (short budget) on the real dataset; RMSE must land in the
    recorded ballpark (reference MSE_0.2_fieldMeas_0_T0_0.txt ~5.24)."""
    ds = load_gp_dataset(REF_GPDATA)
    field = parse_field_settings(REF_FIELD)
    models = train_models(ds, optimize=False)
    # GPy-default hyps (all ones) are poor; just check the full plumbing
    metrics, grids = evaluate_models(models, SimConfig().test_points(), field)
    for k in ("RMSE mf", "RMSE sf", "RMSE nisf", "RMSE sfTP"):
        assert np.isfinite(metrics[k])
    assert grids["mf"][0].shape == (2000,)


def test_mse_artifact_roundtrip(tmp_path):
    metrics = {"RMSE mf": 1.25, "RMSE sf": 2.5, "WRMSE mf": 0.125}
    p = tmp_path / "MSE_0.2_fieldMeas_0_T1_0.2.txt"
    save_mse(str(p), metrics)
    back = parse_mse(str(p))
    assert back == metrics
    assert parse_mse_filename(str(p)) == {"fieldNum": 0, "T": 1,
                                          "velVariance": 0.2}


@pytest.mark.skipif(not os.path.isdir(REF_MSE_DIR),
                    reason="reference artifacts unavailable")
def test_aggregate_reproduces_reference_means(tmp_path):
    """collect+mean over the reference's own 88 MSE files must reproduce
    the BASELINE.md headline numbers."""
    rows = collect_results(os.path.join(REF_MSE_DIR, "MSE_*.txt"),
                           str(tmp_path / "results.csv"))
    assert len(rows) >= 88
    # the recorded results.csv snapshot has 88 rows (one MSE file was added
    # after it was generated); restrict to that snapshot for exact parity
    # with BASELINE.md's means
    recorded = np.genfromtxt(os.path.join(REF_MSE_DIR, "results.csv"),
                             delimiter=",", names=True, dtype=None,
                             encoding="utf-8")
    names = set(recorded["filename"])
    rows88 = [r for r in rows if r["filename"] in names]
    assert len(rows88) == len(names)
    rep = mean_metrics(rows88)
    assert abs(rep["RMSE mf"] - 8.039) < 0.01
    assert abs(rep["RMSE sf"] - 8.052) < 0.01
    assert abs(rep["WRMSE mf"] - 0.185) < 0.005
    assert abs(rep["WRMSE nisf"] - 0.147) < 0.005
    s = summary(rows)
    assert s["overall"]["n"] == len(rows)
    assert "velVariance=0.1" in s


def test_physical_config_surface():
    """Robot-run grids & pre-set hyps (SURVEY C26,
    reference/PhysicalExperimentCode/exploreExpSettings.py)."""
    from mfgp_jax.utils.configs import ExperimentConfig

    exp = ExperimentConfig()
    assert exp.erg_grid().shape == (21 * 11 * 5, 3)
    assert exp.ig_grid().shape == (10 * 6 * 5, 3)
    tp = exp.robot_test_points()
    assert tp.shape == (31 * 31 * 11, 3)  # BASELINE.md: 10571 robot grid
    assert tp.shape[0] == 10571
    assert exp.physical_init_hyps_sf().shape == (5,)
    hyps = exp.physical_init_hyps_mf()
    assert hyps.shape == (17,)
    # loads straight into the MFGP param layout
    from mfgp_jax.models.mfgp import MFGPParams

    p = MFGPParams.from_vector(hyps, 3, 3)
    np.testing.assert_allclose(np.asarray(p.rhos), [1.0, 1.0])
    # field transform log(x+1)
    np.testing.assert_allclose(ExperimentConfig.field_transform([0.0, 1.0]),
                               [0.0, np.log(2.0)])


def test_run_settings_artifact(tmp_path, synth_traj):
    """T*Settings.txt provenance dump written alongside the estimates
    (reference/trajectoryEstimateGenerator.py:16-43)."""
    cfg = SimConfig(seed=1, vmn=0.1)
    run_pipeline(synth_traj, cfg, out_dir=str(tmp_path))
    p = tmp_path / "T1_0.1Settings.txt"
    assert p.exists()
    txt = p.read_text()
    assert "Random Seed: 1" in txt
    assert "KF Q Matrix" in txt and "KF R Matrix" in txt


def test_batched_estimates_match_serial(synth_traj):
    """vmapped sweep filtering must reproduce the serial path per
    trajectory (same seeds -> identical rows)."""
    from mfgp_jax.data import generate_estimates_batch

    cfg = SimConfig(seed=7, vmn=0.1)
    # two different-length trajectories
    short = Table(synth_traj.headers, synth_traj.data[:3000])
    outs = generate_estimates_batch([synth_traj, short], cfg,
                                    seeds=[7, 8])
    ref0 = generate_estimates(synth_traj, cfg, seed=7)
    ref1 = generate_estimates(short, cfg, seed=8)
    np.testing.assert_allclose(outs[0].data, ref0.data, rtol=1e-10)
    np.testing.assert_allclose(outs[1].data, ref1.data, rtol=1e-10)


def test_study_driver_end_to_end(tmp_path):
    """run_study produces the full reference artifact tree + aggregation
    (tiny configuration for speed; fit quality is covered elsewhere)."""
    from mfgp_jax.data.study import run_study

    rep = run_study(str(tmp_path), traj_seeds=(0,), vmn_levels=(0.1,),
                    field_seeds=(0,), duration=300.0, optimize=False)
    assert rep["overall"]["n"] == 1
    assert np.isfinite(rep["overall"]["RMSE sf"])
    res = tmp_path / "GPResults"
    assert (res / "results.csv").exists()
    assert (res / "MSE_0.2_fieldMeas_0_T0_0.1.txt").exists()
    assert (tmp_path / "GPDataSets" /
            "GPData_0.2_fieldMeas_0_T0_0.1.csv").exists()
    assert (tmp_path / "T0_0.1Settings.txt").exists()


def test_batched_estimates_match_per_file(synth_traj):
    """generate_estimates_batch (one vmapped scan over the sweep) equals
    the per-file filter row for row, including ragged lengths."""
    from mfgp_jax.data.pipeline import (generate_estimates,
                                        generate_estimates_batch)

    cfg = SimConfig(seed=3, vmn=0.1)
    short = Table(synth_traj.headers,
                  synth_traj.data[: synth_traj.data.shape[0] // 2])
    batch = generate_estimates_batch([synth_traj, short], cfg,
                                     seeds=[3, 11])
    singles = [generate_estimates(synth_traj, cfg, seed=3),
               generate_estimates(short, cfg, seed=11)]
    for b, s in zip(batch, singles):
        assert b.data.shape == s.data.shape
        np.testing.assert_allclose(b.data, s.data, rtol=1e-12, atol=1e-12)


def test_batched_study_matches_per_run(tmp_path, synth_traj):
    """data.study_batched: the whole-matrix batched fit+eval launches
    reproduce the per-run device path's metrics (same inits, same
    restart-batched L-BFGS lanes under vmap) and write the same artifact
    files."""
    import glob

    from mfgp_jax.data.study_batched import process_datasets_batched
    from mfgp_jax.data.trainers import process_dataset

    paths, settings = [], []
    for seed, vmn in ((1, 0.1), (2, 0.2)):
        cfg = SimConfig(seed=seed, vmn=vmn)
        run_pipeline(synth_traj, cfg, out_dir=str(tmp_path))
        paths.append(str(tmp_path / "GPDataSets" /
                         f"GPData_0.2_fieldMeas_{seed}_T{seed}_{vmn}.csv"))
        settings.append(str(tmp_path / "FieldData" /
                            f"FieldSettings{seed}.txt"))
    cfg = SimConfig()
    out = tmp_path / "batched"
    # eval_chunk=1 exercises the multi-chunk launch path (B=2 -> 2
    # launches of the one compiled executable); chunking must not change
    # the mathematics
    # ftol=0.0: disable the batched stagnation stop so the lanes run the
    # same pure max|g|<tol criterion as the per-run device fits below —
    # the "same inits => same optimum" contract stays exact
    res_b = process_datasets_batched(paths, settings, out_dir=str(out),
                                     cfg=cfg, dtype=np.float32,
                                     eval_chunk=1, ftol=0.0)
    assert len(res_b) == 2
    # artifact set per dataset: 4 hyp files + GPRes + MSE
    for p in paths:
        base = p.split("/")[-1].replace(".csv", "")
        for suffix in ("_emuGP.txt", "_sfGP.txt", "_sfGPTP.txt",
                       "_nisfGP.txt"):
            assert (out / (base + suffix)).exists()
        assert (out / (base.replace("GPData", "MSE") + ".txt")).exists()
    assert len(glob.glob(str(out / "GPRes_*.csv"))) == 2

    # per-run parity on the first dataset (same inits => same optimum;
    # f32 lockstep-vmap arithmetic tolerance)
    _, m = process_dataset(paths[0], settings[0], out_dir=None, cfg=cfg,
                           fit_mode="device", dtype=np.float32)
    mb = res_b[paths[0].split("/")[-1]]
    for k in ("RMSE mf", "RMSE sf", "RMSE sfTP"):
        np.testing.assert_allclose(mb[k], m[k], rtol=0.05)
    assert np.isfinite(mb["WRMSE nisf"]) and np.isfinite(mb["RMSE nisf"])


def test_batched_study_overlapped_repairs(tmp_path, synth_traj,
                                          monkeypatch):
    """Lanes whose f32 device eval is non-finite are repaired by the
    OVERLAPPED host-f64 worker (futures submitted as each family's eval
    lands — ~1/3 of real study lanes take this path, census in
    tools/study_repair_census.py). Forcing every sf/sfTP lane non-finite
    must still produce finite metrics that agree with the healthy device
    eval (the repair recomputes the same posterior in f64)."""
    import jax.numpy as jnp

    from mfgp_jax.data import study_batched as sb

    paths, settings = [], []
    for seed, vmn in ((1, 0.1),):
        cfg = SimConfig(seed=seed, vmn=vmn)
        run_pipeline(synth_traj, cfg, out_dir=str(tmp_path))
        paths.append(str(tmp_path / "GPDataSets" /
                         f"GPData_0.2_fieldMeas_{seed}_T{seed}_{vmn}.csv"))
        settings.append(str(tmp_path / "FieldData" /
                            f"FieldSettings{seed}.txt"))
    cfg = SimConfig()
    # default ftol: the stagnation stop keeps this fit cheap — both runs
    # share it, so the healthy-vs-repaired comparison stays apples-to-apples
    healthy = sb.process_datasets_batched(paths, settings, out_dir=None,
                                          cfg=cfg, dtype=np.float32)

    real_eval = sb._eval_sf_one

    def poisoned(vec, X, y, tp, f_true, kernel, jitter, normalize):
        rmse, w, mu, var = real_eval(vec, X, y, tp, f_true, kernel,
                                     jitter, normalize)
        nan = jnp.asarray(float("nan"), w.dtype)
        return rmse, nan, mu, var

    monkeypatch.setattr(sb, "_eval_sf_one", poisoned)
    repaired = sb.process_datasets_batched(paths, settings, out_dir=None,
                                           cfg=cfg, dtype=np.float32)
    base = paths[0].split("/")[-1]
    for k in ("RMSE sf", "WRMSE sf", "RMSE sfTP", "WRMSE sfTP"):
        assert np.isfinite(repaired[base][k]), k
        # f64 recomputation of the same fitted vector ~ the f32 value
        np.testing.assert_allclose(repaired[base][k], healthy[base][k],
                                   rtol=0.2)
    # untouched families identical
    for k in ("RMSE mf", "WRMSE mf", "RMSE nisf"):
        np.testing.assert_allclose(repaired[base][k], healthy[base][k],
                                   rtol=1e-6)
