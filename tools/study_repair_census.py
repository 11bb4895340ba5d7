"""Census of the study's host-f64 lane repairs (which family, which metric).

The instrumented r5 study run measured 128 host-f64 lane repairs costing
113.8 s — over a third of the 360 fits, not the "rare" case the fallback
was written for. This tool re-runs the four device eval families on a
finished study tree's saved hyp vectors (no fits) and reports, per
family, how many lanes' f32 (RMSE, WMSE) are non-finite BEFORE repair —
attributing the tail so the fix targets the right family.

  python tools/study_repair_census.py /tmp/study_r5c
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("study_dir")
    ap.add_argument("--chunk", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mfgp_jax.data import study_batched as sb
    from mfgp_jax.fields.wrbf import parse_field_settings
    from mfgp_jax.data.trainers import load_gp_dataset
    from mfgp_jax.utils.configs import SimConfig

    cfg = SimConfig()
    dtype = jnp.float32
    paths = sorted(glob.glob(
        os.path.join(args.study_dir, "GPDataSets", "GPData_*.csv")))
    res_dir = os.path.join(args.study_dir, "GPResults")
    datasets = [load_gp_dataset(p, t_cut=cfg.t_cut) for p in paths]
    tp = np.asarray(cfg.test_points(), np.float32)
    tpj = jnp.asarray(tp)

    # per-dataset true field (FieldData/FieldSettings<fseed>.txt)
    f_true = []
    for p in paths:
        fseed = os.path.basename(p).split("fieldMeas_")[1].split("_")[0]
        f = parse_field_settings(os.path.join(
            args.study_dir, "FieldData", f"FieldSettings{fseed}.txt"))
        f_true.append(np.asarray(f(tpj), np.float32))
    f_true = np.stack(f_true)

    D = datasets[0].X_est.shape[1]
    F = 3
    n = datasets[0].n
    assert all(d.n == n for d in datasets), "single-group study expected"

    X_sf = np.stack([d.X_est for d in datasets]).astype(np.float32)
    X_tp = np.stack([d.X_true for d in datasets]).astype(np.float32)
    y_b = np.stack([d.y for d in datasets]).astype(np.float32)
    import mfgp_jax.models.mfgp as mfm

    Xmf, fmf, ymf = [], [], []
    for d in datasets:
        Xs, ys = d.fidelity_lists(use_estimates=True)
        X, fid, y = mfm.stack_fidelity_lists(Xs, ys)
        Xmf.append(np.asarray(X)); fmf.append(np.asarray(fid))
        ymf.append(np.asarray(y))
    Xmf = np.stack(Xmf).astype(np.float32)
    fmf = np.stack(fmf).astype(np.int32)
    ymf = np.stack(ymf).astype(np.float32)

    def hyp(stem, suffix):
        v = np.loadtxt(os.path.join(
            res_dir, stem + suffix), delimiter=",", ndmin=1)
        return v.reshape(-1)

    mf_vecs, sf_vecs, tp_vecs, ni_lhs = [], [], [], []
    for p in paths:
        stem = os.path.basename(p).replace(".csv", "_")
        mf_vecs.append(hyp(stem, "emuGP.txt"))
        sf_vecs.append(np.log(hyp(stem, "sfGP.txt")))
        tp_vecs.append(np.log(hyp(stem, "sfGPTP.txt")))
        s = hyp(stem, "nisfGP.txt")  # [sigx(D), var, noise, ls(D)]
        lh = np.concatenate([np.log(s[-D:]), np.log(s[D:D + 2]),
                             np.log(s[:D])])
        ni_lhs.append(lh)
    mf_vecs = np.stack(mf_vecs).astype(np.float32)
    sf_vecs = np.stack(sf_vecs).astype(np.float32)
    tp_vecs = np.stack(tp_vecs).astype(np.float32)
    ni_lhs = np.stack(ni_lhs).astype(np.float32)

    jitter, normalize = 1e-6, cfg.normalize_wmse
    kernel = "rbf"
    f_mf = jax.jit(jax.vmap(
        lambda v, X, f, y, ft: sb._eval_mf_one(
            v, X, f, y, tpj, ft, F, kernel, jitter, normalize)))
    f_sf = jax.jit(jax.vmap(
        lambda v, X, y, ft: sb._eval_sf_one(
            v, X, y, tpj, ft, kernel, jitter, normalize)))
    f_ni = jax.jit(jax.vmap(
        lambda v, X, y, ft: sb._eval_nigp_one(v, X, y, tpj, ft,
                                              normalize)))

    fams = {
        "mf": (f_mf, (mf_vecs, Xmf, fmf, ymf, f_true)),
        "sf": (f_sf, (sf_vecs, X_sf, y_b, f_true)),
        "sfTP": (f_sf, (tp_vecs, X_tp, y_b, f_true)),
        "nigp": (f_ni, (ni_lhs, X_sf, y_b, f_true)),
    }
    out = {}
    for name, (fn, arrs) in fams.items():
        ev = sb._chunked_launch(fn, *[jnp.asarray(a) for a in arrs],
                                chunk=args.chunk)
        rmse, w = np.asarray(ev[0]), np.asarray(ev[1])
        out[name] = {
            "rmse_nonfinite": int((~np.isfinite(rmse)).sum()),
            "wmse_nonfinite": int((~np.isfinite(w)).sum()),
            "repairs": int((~(np.isfinite(rmse) & np.isfinite(w))).sum()),
        }
    out["total_repairs"] = sum(v["repairs"] for v in out.values()
                               if isinstance(v, dict))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
