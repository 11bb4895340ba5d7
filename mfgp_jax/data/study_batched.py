"""Whole-matrix batched study: the experiment sweep as FOUR device launches.

The per-run path (data.trainers.process_dataset) pays host<->device
round-trip latency for every fit preamble, predict, and metric fetch —
a cost that dominates small per-run fits. The reference's study design is embarrassingly parallel
and every dataset shares one static shape (same trajectory duration and
measurement rate -> same N), so this module stacks the WHOLE matrix along
a dataset axis and runs

    1 vmapped restart-batched L-BFGS launch per model family (MFGP /
    SFGP / SFGP-TP / NIGP: B datasets x R restarts lanes), then
    1 vmapped evaluation launch per family (condition -> full-covariance
    grid posterior -> RMSE + precision-weighted MSE)

with only O(B) scalars/vectors crossing to the host. Artifacts are written
per dataset in the reference's exact schemas, byte-compatible with the
per-run path (reference/GPTrainers.py:70-170).

Datasets of differing N are grouped by N and each group is batched
(different shapes cannot share an executable); within the reference's
sweep design all 90 runs share one N.
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.data.io import (load_gp_dataset, save_gpres, save_hyp_vector,
                              save_mse)
from mfgp_jax.fields.wrbf import parse_field_settings
from mfgp_jax.models import gp as gpm
from mfgp_jax.models import mfgp as mfm
from mfgp_jax.models import nigp as nim
from mfgp_jax.ops import kernels as _k
from mfgp_jax.ops import linalg as _la
from mfgp_jax.utils.configs import SimConfig

_H = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# batched fits (thin vmaps over the module-level restart sweeps)
# ---------------------------------------------------------------------------
from functools import partial


@partial(jax.jit, static_argnames=("kernel", "jitter", "maxiter", "tol",
                                   "ftol"))
def _fit_sf_batch(inits, Xb, yb, kernel, jitter, maxiter, tol, ftol=0.0):
    xs, fs = jax.vmap(
        lambda X, y: gpm._fit_restarts(inits, X, y, kernel, jitter,
                                       maxiter, tol, ftol))(Xb, yb)
    best = jnp.argmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf), axis=1)
    return jnp.take_along_axis(xs, best[:, None, None], 1)[:, 0, :]


@partial(jax.jit, static_argnames=("kernel", "jitter", "maxiter", "tol",
                                   "ftol"))
def _fit_mf_batch(inits, Xb, fidb, yb, fixed_rhos, lower, upper, kernel,
                  jitter, maxiter, tol, ftol=0.0):
    xs, fs = jax.vmap(
        lambda X, f, y: mfm._mf_fit_restarts(inits, X, f, y, fixed_rhos,
                                             lower, upper, kernel, jitter,
                                             maxiter, tol,
                                             ftol))(Xb, fidb, yb)
    best = jnp.argmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf), axis=1)
    return jnp.take_along_axis(xs, best[:, None, None], 1)[:, 0, :]


@partial(jax.jit, static_argnames=("maxiter", "ftol"))
def _fit_nigp_batch(initsb, Xb, yb, lower, upper, maxiter, ftol=0.0):
    xs, fs = jax.vmap(
        lambda ini, X, y: nim._nigp_fit_restarts(ini, X, y, lower, upper,
                                                 maxiter,
                                                 ftol))(initsb, Xb, yb)
    best = jnp.argmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf), axis=1)
    return jnp.take_along_axis(xs, best[:, None, None], 1)[:, 0, :]


# ---------------------------------------------------------------------------
# batched evaluation (same mathematics as trainers.evaluate_models)
# ---------------------------------------------------------------------------
def _chunked_launch(fn, *arrs, chunk, label=None, async_depth: int = 4):
    """Run ``fn`` over fixed-size chunks of the leading (dataset) axis.

    The tail chunk is padded by repeating the last lane so every launch
    shares ONE compiled executable per family.

    Chunks are PIPELINED: up to ``async_depth`` launches are dispatched
    before the oldest one's outputs are fetched, so a straggler lane in
    chunk k no longer stalls the dispatch of chunk k+1 — the device queue
    stays full and per-chunk host latency overlaps execution (JAX async
    dispatch; outputs per chunk are O(B) scalars/vectors, so queued
    results cost no meaningful device memory). Chunk 0 is a
    synchronization barrier: it carries the executable compile, so later
    chunks (and any concurrently-driven family's first chunk) only
    dispatch once it completes.

    ``label``: print per-chunk wall times — chunk 0 carries the compile;
    pipelined chunks report time-to-fetch (overlapped, not additive)."""
    fetched = []
    pending = []  # (chunk_idx, t0, device outputs, pad)

    def _fetch():
        ci, t0, out, pad = pending.pop(0)
        out = jax.tree.map(np.asarray, out)  # blocks on this chunk only
        if pad:
            out = jax.tree.map(lambda a: a[:-pad], out)
        fetched.append(out)
        if label:
            word = "compile+run" if ci == 0 else "run"
            print(f"  {label} chunk {ci} ({word}): "
                  f"{time.monotonic() - t0:.1f}s", flush=True)

    B = arrs[0].shape[0]
    for ci, c0 in enumerate(range(0, B, chunk)):
        t0 = time.monotonic()
        sl = [a[c0:c0 + chunk] for a in arrs]
        pad = chunk - sl[0].shape[0]
        if pad:
            sl = [jnp.concatenate([a] + [a[-1:]] * pad) for a in sl]
        pending.append((ci, t0, fn(*sl), pad))
        if ci == 0 or len(pending) >= async_depth:
            _fetch()
    while pending:
        _fetch()
    return jax.tree.map(lambda *ps: np.concatenate(ps), *fetched)


def _metrics_from_cov(err, cov, normalize):
    """RMSE + precision-weighted MSE with the non-finite jitter retry of
    trainers.evaluate_models, branch-free for vmap."""
    rmse = jnp.sqrt(jnp.mean(err**2))
    w = _la.weighted_mse(err, cov, normalize=normalize)
    M = cov.shape[0]
    # dtype-aware retry jitter: the Cholesky of a near-singular posterior
    # (NIGP with vanishing noise) needs ~eps * lambda_max to succeed; the
    # f64-sized 1e-10 * trace/M is invisible at f32
    eps = jnp.finfo(cov.dtype).eps
    jit = 10.0 * eps * jnp.trace(cov) + 1e-12
    w2 = _la.weighted_mse(err, cov + jit * jnp.eye(M, dtype=cov.dtype),
                          normalize=normalize)
    return rmse, jnp.where(jnp.isfinite(w), w, w2)


def _eval_sf_one(vec, X, y, tp, f_true, kernel, jitter, normalize):
    D = X.shape[1]
    p = gpm.GPParams(vec[0], vec[1 : 1 + D], vec[1 + D])
    kern = _k.KERNELS[kernel]
    Kn = _la.diag_add(kern(X, X, p.variance, p.lengthscales),
                      jnp.broadcast_to(p.noise + jitter, (X.shape[0],)))
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    Kxs = kern(tp, X, p.variance, p.lengthscales)
    mu = _la.posterior_mean(Kxs, alpha)
    Kss = kern(tp, tp, p.variance, p.lengthscales)
    cov = _la.posterior_cov(Kss, Kxs, L)
    cov = _la.diag_add(cov, jnp.broadcast_to(p.noise, (tp.shape[0],)))
    err = mu - f_true
    rmse, w = _metrics_from_cov(err, cov, normalize)
    return rmse, w, mu, jnp.diagonal(cov)


def _eval_mf_one(vec, X, fid, y, tp, f_true, F, kernel, jitter, normalize):
    D = X.shape[1]
    p = mfm.MFGPParams(jnp.log(vec[: F * (D + 1)].reshape(F, D + 1)[:, 0]),
                       jnp.log(vec[: F * (D + 1)].reshape(F, D + 1)[:, 1:]),
                       vec[F * (D + 1) : F * (D + 1) + F - 1],
                       jnp.log(vec[F * (D + 1) + F - 1 :]))
    fid_s = jnp.full((tp.shape[0],), F - 1, jnp.int32)
    Kn = _la.diag_add(
        _k.ar1_cov(X, fid, X, fid, p.variances, p.lengthscales, p.rhos,
                   kernel),
        _k.mf_noise_diag(fid, p.noises) + jitter)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    Kxs = _k.ar1_cov(tp, fid_s, X, fid, p.variances, p.lengthscales,
                     p.rhos, kernel)
    mu = _la.posterior_mean(Kxs, alpha)
    Kss = _k.ar1_cov(tp, fid_s, tp, fid_s, p.variances, p.lengthscales,
                     p.rhos, kernel)
    cov = _la.posterior_cov(Kss, Kxs, L)
    cov = _la.diag_add(cov, _k.mf_noise_diag(fid_s, p.noises))
    err = mu - f_true
    rmse, w = _metrics_from_cov(err, cov, normalize)
    return rmse, w, mu, jnp.diagonal(cov)


def _np_rbf(X1, X2, var, ls):
    a = np.asarray(X1, np.float64) / ls
    b = np.asarray(X2, np.float64) / ls
    r2 = (np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
          - 2.0 * a @ b.T)
    return var * np.exp(-0.5 * np.maximum(r2, 0.0))


def _host64_wmse(family, vec, X, fid, y, tp, f_true, normalize):
    """Host f64 recomputation of one lane's (RMSE, precision-weighted
    MSE) — the fallback when the f32 on-device eval is numerically bad
    (indefinite covariance, or a NaN posterior mean from a blown-up f32
    fit). Recomputes the WHOLE posterior from the fitted vector in f64,
    so it also repairs lanes whose f32 mean was non-finite. RBF base
    kernels (the fallback is exercised by the study harness, which is
    RBF)."""
    from scipy.linalg import cho_factor, cho_solve

    from mfgp_jax.data.trainers import wmse_host64

    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    tp = np.asarray(tp, np.float64)
    vec = np.asarray(vec, np.float64)
    D = X.shape[1]
    if family == "sf":
        var, ls, noise = (np.exp(vec[0]), np.exp(vec[1 : 1 + D]),
                          np.exp(vec[1 + D]))
        Kn = _np_rbf(X, X, var, ls) + (noise + 1e-6) * np.eye(X.shape[0])
        Kxs = _np_rbf(tp, X, var, ls)
        Kss = _np_rbf(tp, tp, var, ls) + noise * np.eye(tp.shape[0])
    elif family == "mf":
        F = 3
        per = vec[: F * (D + 1)].reshape(F, D + 1)
        vars_, lss = per[:, 0], per[:, 1:]
        rhos = vec[F * (D + 1) : F * (D + 1) + F - 1]
        noises = vec[F * (D + 1) + F - 1 :]
        C = np.concatenate([[1.0], np.cumprod(rhos)])
        W = np.zeros((F, F))
        for m in range(F):
            for f in range(m, F):
                W[m, f] = C[f] / C[m]
        fid = np.asarray(fid)
        fid_s = np.full(tp.shape[0], F - 1)

        def ar1(A, fa, B, fb):
            out = np.zeros((A.shape[0], B.shape[0]))
            for m in range(F):
                out += (vars_[m] * np.outer(W[m][fa], W[m][fb])
                        * _np_rbf(A, B, 1.0, lss[m]))
            return out

        Kn = ar1(X, fid, X, fid) + np.diag(noises[fid] + 1e-6)
        Kxs = ar1(tp, fid_s, X, fid)
        Kss = ar1(tp, fid_s, tp, fid_s) + noises[F - 1] * np.eye(
            tp.shape[0])
    else:  # nigp
        ls = np.exp(vec[:D])
        sf2 = np.exp(vec[D])
        sy = np.exp(vec[D + 1])
        sx = np.exp(vec[D + 2 :])
        K = _np_rbf(X, X, sf2, ls)
        cf0 = cho_factor(K + sy**2 * np.eye(X.shape[0]), lower=True)
        alpha0 = cho_solve(cf0, y)
        grads = (K @ (alpha0[:, None] * X) - X * (K @ alpha0)[:, None])             / ls**2
        v = np.sum(grads**2 * sx[None, :] ** 2, axis=1)
        Kn = K + np.diag(sy**2 + v)
        Kxs = _np_rbf(tp, X, sf2, ls)
        Kss = _np_rbf(tp, tp, sf2, ls) + 1e-12 * np.eye(tp.shape[0])
    cf = cho_factor(Kn, lower=True)
    Vt = cho_solve(cf, Kxs.T)
    cov = Kss - Kxs @ Vt
    mu = Kxs @ cho_solve(cf, y)
    err = mu - np.asarray(f_true, np.float64)
    rmse = float(np.sqrt(np.mean(err**2)))
    return rmse, wmse_host64(err, cov, normalize)


def _eval_nigp_one(lh, X, y, tp, f_true, normalize):
    D = X.shape[1]
    ls = jnp.exp(lh[:D])
    sigma_f = jnp.exp(lh[D])
    sigma_y = jnp.exp(lh[D + 1])
    sigma_x = jnp.exp(lh[D + 2 :])
    _, grads = nim.posterior_mean_grads(X, y, ls, sigma_f, sigma_y)
    v = jnp.sum((grads**2) * (sigma_x[None, :] ** 2), axis=1)
    Kn = _la.diag_add(_k.rbf(X, X, sigma_f, ls),
                      jnp.broadcast_to(sigma_y**2, (X.shape[0],)) + v)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    Kxs = _k.rbf(tp, X, sigma_f, ls)
    mu = _la.posterior_mean(Kxs, alpha)
    cov = _la.posterior_cov(_k.rbf(tp, tp, sigma_f, ls), Kxs, L)
    cov = cov + 1e-12 * jnp.eye(tp.shape[0], dtype=cov.dtype)
    err = mu - f_true
    rmse, w = _metrics_from_cov(err, cov, normalize)
    return rmse, w, mu, jnp.diagonal(cov)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
def process_datasets_batched(gpdata_paths, field_settings, out_dir=None,
                             cfg: SimConfig | None = None,
                             kernel: str = "rbf", jitter: float = 1e-6,
                             dtype=np.float32, n_restarts: int = 8,
                             maxiter: int = 200, tol: float = 1e-3,
                             nigp_restarts: int = 2, seed: int = 0,
                             verbose: bool = False, eval_chunk: int = 8,
                             fit_chunk: int = 8, ftol: float = 1e-6):
    """Fit + evaluate every dataset with four vmapped launches per
    same-shape group. ``field_settings``: one path, or a list aligned with
    ``gpdata_paths``. Returns {basename: metrics dict}; writes the
    per-dataset reference artifacts when ``out_dir`` is given.

    ``fit_chunk``/``eval_chunk``: the dataset axis is processed in
    fixed-size chunks (tail padded by repetition) so each model family
    still compiles exactly ONE fit and ONE eval executable, while each
    launch's lane count — and with it the while-loop tail set by its
    slowest lane and the live (chunk, M, M) eval covariances — stays
    bounded.

    ``ftol``: relative-f stagnation stop for the restart-batched L-BFGS
    lanes (scipy L-BFGS-B's ``factr`` criterion — the optimizer the
    reference's GPy fits actually use, reference/GPTrainers.py:68).
    Under vmap a launch runs until its LAST lane converges; measured on
    study-shaped fits, typical restarts converge in 20-50 iterations
    while the odd wandering lane burns all 200, so cutting lanes that
    decrease f by <ftol*max(1,|f|) per accepted step removes a ~4x
    straggler tail. Set 0.0 for the pure max|g|<tol criterion."""
    cfg = cfg or SimConfig()
    if isinstance(field_settings, (str, os.PathLike)):
        field_settings = [field_settings] * len(gpdata_paths)
    datasets = [load_gp_dataset(p, t_cut=cfg.t_cut) for p in gpdata_paths]
    tp = np.asarray(cfg.test_points(), dtype)
    fields = [parse_field_settings(f) for f in field_settings]
    f_true = np.stack([np.asarray(f(jnp.asarray(tp))) for f in fields])
    f_true = f_true.astype(dtype)
    normalize = cfg.normalize_wmse

    groups: dict[int, list[int]] = {}
    for i, ds in enumerate(datasets):
        groups.setdefault(ds.n, []).append(i)

    results: dict[str, dict] = {}
    for n, idxs in sorted(groups.items()):
        t0 = time.monotonic()
        B = len(idxs)
        dss = [datasets[i] for i in idxs]
        D = dss[0].X_est.shape[1]
        F = 3

        # stacked arrays (MF rows in emukit fidelity order, like
        # stack_fidelity_lists)
        # host copies stay live: the overlapped host-f64 lane repairs
        # slice them per dataset without device round-trips
        X_sf_np = np.stack([d.X_est for d in dss])
        X_tp_np = np.stack([d.X_true for d in dss])
        y_np = np.stack([d.y for d in dss])
        X_sf = jnp.asarray(X_sf_np, dtype)
        X_tp = jnp.asarray(X_tp_np, dtype)
        y_b = jnp.asarray(y_np, dtype)
        Xmf_l, fmf_l, ymf_l = [], [], []
        for d in dss:
            Xs, ys = d.fidelity_lists(use_estimates=True)
            X, fid, y = mfm.stack_fidelity_lists(Xs, ys)
            Xmf_l.append(np.asarray(X))
            fmf_l.append(np.asarray(fid))
            ymf_l.append(np.asarray(y))
        Xmf_np = np.stack(Xmf_l)
        fmf_np = np.stack(fmf_l)
        ymf_np = np.stack(ymf_l)
        Xmf = jnp.asarray(Xmf_np, dtype)
        fmf = jnp.asarray(fmf_np, jnp.int32)
        ymf = jnp.asarray(ymf_np, dtype)

        # shared restart inits (identical to the per-run path: default
        # params + seeded spread, optimize_restarts semantics)
        rng_key = jax.random.key(seed)
        x0_sf = np.zeros(D + 2, dtype)  # log-space GPy defaults (all 1.0)
        inits_sf = np.asarray(
            x0_sf[None]
            + np.asarray(jax.random.normal(rng_key, (n_restarts, D + 2)),
                         dtype))
        inits_sf[0] = x0_sf
        n_mf = F + F * D + F  # log vars + log ls + log noises
        x0_mf = np.zeros(n_mf, dtype)
        inits_mf = np.asarray(
            x0_mf[None]
            + np.asarray(jax.random.normal(rng_key, (n_restarts, n_mf)),
                         dtype))
        inits_mf[0] = x0_mf
        fixed_rhos = jnp.ones((F - 1,), dtype)
        inf = jnp.full((n_mf,), jnp.inf, dtype)

        # NIGP inits are data-dependent (median pairwise distance):
        # replicate fit_native's heuristics per dataset on host
        nig_inits = []
        nrng = np.random.default_rng(seed)
        for d in dss:
            Xn = np.asarray(d.X_est, dtype)
            pair = np.sqrt(np.maximum(0, np.sum(
                (Xn[:, None, :] - Xn[None, :, :]) ** 2, axis=2)))
            pos = pair[pair > 0]
            med = np.median(pos) if pos.size else 1.0
            std_y = np.std(np.asarray(d.y)) or 1.0
            lh0 = np.concatenate([
                np.log(np.ones(D) * (med if med > 0 else 1.0)),
                [np.log(std_y), np.log(0.1 * std_y)],
                np.log(np.maximum(np.ones(D) * 0.01 * np.std(Xn, axis=0),
                                  1e-8))])
            ini = (lh0[None, :] + 0.3 * nrng.standard_normal(
                (max(nigp_restarts, 1), lh0.shape[0])))
            ini[0] = lh0
            nig_inits.append(ini)
        nig_inits = jnp.asarray(np.stack(nig_inits), dtype)
        nig_lo = jnp.full((2 * D + 2,), np.log(1e-6), dtype)
        nig_hi = jnp.full((2 * D + 2,), np.log(1e6), dtype)

        # --- four fit sweeps (chunked launches, one executable each) -----
        i_mf = jnp.asarray(inits_mf)
        i_sf = jnp.asarray(inits_sf)
        lbl = (lambda s: s if verbose else None)
        vec_mf = _chunked_launch(
            lambda X, f, y: _fit_mf_batch(i_mf, X, f, y, fixed_rhos, -inf,
                                          inf, kernel, jitter, maxiter,
                                          tol, ftol),
            Xmf, fmf, ymf, chunk=fit_chunk, label=lbl("fit mf"))
        vec_sf = _chunked_launch(
            lambda X, y: _fit_sf_batch(i_sf, X, y, kernel, jitter,
                                       maxiter, tol, ftol),
            X_sf, y_b, chunk=fit_chunk, label=lbl("fit sf"))
        vec_tp = _chunked_launch(
            lambda X, y: _fit_sf_batch(i_sf, X, y, kernel, jitter,
                                       maxiter, tol, ftol),
            X_tp, y_b, chunk=fit_chunk, label=lbl("fit sfTP"))
        vec_ni = _chunked_launch(
            lambda ini, X, y: _fit_nigp_batch(ini, X, y, nig_lo, nig_hi,
                                              maxiter, ftol),
            nig_inits, X_sf, y_b, chunk=fit_chunk, label=lbl("fit nigp"))
        t_fit = time.monotonic() - t0
        if verbose:
            print(f"group N={n}: {B} datasets, 4 fit sweeps done in "
                  f"{t_fit:.1f}s", flush=True)

        # --- four eval launches (chunked: B lanes of (M, M) posterior
        # covariances at once bound the live device memory) --
        tpj = jnp.asarray(tp)
        ftj = jnp.asarray(f_true[idxs])
        # MF eval consumes the GPy param_array layout (positive space)
        mf_param = jax.vmap(lambda v: mfm.MFGPParams(
            v[:F], v[F : F + F * D].reshape(F, D), fixed_rhos,
            v[F + F * D :]))(vec_mf)
        mf_vec = jax.vmap(lambda p: p.to_vector())(mf_param)
        sf_vec = jax.vmap(lambda v: jnp.concatenate(
            [jnp.exp(v[:1]), jnp.exp(v[1 : 1 + D]), jnp.exp(v[1 + D :])])
        )(vec_sf)
        tp_vec = jax.vmap(lambda v: jnp.concatenate(
            [jnp.exp(v[:1]), jnp.exp(v[1 : 1 + D]), jnp.exp(v[1 + D :])])
        )(vec_tp)
        f_mf = jax.jit(jax.vmap(
            lambda v, X, f, y, ft: _eval_mf_one(v, X, f, y, tpj, ft, F,
                                                kernel, jitter, normalize),
            in_axes=(0, 0, 0, 0, 0)))
        f_sf = jax.jit(jax.vmap(
            lambda v, X, y, ft: _eval_sf_one(v, X, y, tpj, ft, kernel,
                                             jitter, normalize),
            in_axes=(0, 0, 0, 0)))
        f_ni = jax.jit(jax.vmap(
            lambda v, X, y, ft: _eval_nigp_one(v, X, y, tpj, ft,
                                               normalize),
            in_axes=(0, 0, 0, 0)))

        mf_vec_np = np.asarray(mf_vec)
        ni_np = np.asarray(vec_ni)
        vec_sf_np = np.asarray(vec_sf)
        vec_tp_np = np.asarray(vec_tp)
        # ONE transfer for the positive-space vectors (per-lane slicing of
        # a device array re-transfers it per dataset)
        sf_vec_np = np.asarray(sf_vec)
        tp_vec_np = np.asarray(tp_vec)

        # Host-f64 lane repairs OVERLAP the remaining device eval time:
        # the f32 on-device eval is non-finite for every lane whose
        # posterior covariance assembly (Kss - V^T V at tiny fitted
        # noise) loses definiteness to f32 cancellation — measured on
        # the r5 study matrix that is ~1/3 of ALL lanes (census:
        # tools/study_repair_census.py, 128/360 repairs, 113.8 s
        # serial). Submitting each family's repairs to a worker thread
        # the moment ITS eval lands hides them behind the later
        # families' device launches (NumPy/LAPACK releases the GIL);
        # only the last family's repairs remain a tail.
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        repair_futs: dict = {}

        def _submit_repairs(key, fam, ev, vecs, Xb, fidb, yb):
            bad = ~(np.isfinite(np.asarray(ev[0]))
                    & np.isfinite(np.asarray(ev[1])))
            for b in np.nonzero(bad)[0]:
                b = int(b)
                repair_futs[(b, key)] = pool.submit(
                    _host64_wmse, fam, vecs[b], Xb[b],
                    None if fidb is None else fidb[b], yb[b], tp,
                    f_true[idxs[b]], normalize)

        # (chunk, M, M) posterior covariances bound peak memory per launch
        ev_mf = _chunked_launch(f_mf, mf_vec, Xmf, fmf, ymf, ftj,
                                chunk=eval_chunk, label=lbl("eval mf"))
        _submit_repairs("mf", "mf", ev_mf, mf_vec_np, Xmf_np, fmf_np,
                        ymf_np)
        ev_sf = _chunked_launch(f_sf, jnp.asarray(vec_sf), X_sf, y_b, ftj,
                                chunk=eval_chunk, label=lbl("eval sf"))
        _submit_repairs("sf", "sf", ev_sf, vec_sf_np, X_sf_np, None, y_np)
        ev_tp = _chunked_launch(f_sf, jnp.asarray(vec_tp), X_tp, y_b, ftj,
                                chunk=eval_chunk, label=lbl("eval sfTP"))
        _submit_repairs("sfTP", "sf", ev_tp, vec_tp_np, X_tp_np, None,
                        y_np)
        ev_ni = _chunked_launch(f_ni, jnp.asarray(vec_ni), X_sf, y_b, ftj,
                                chunk=eval_chunk, label=lbl("eval nigp"))
        _submit_repairs("nisf", "nigp", ev_ni, ni_np, X_sf_np, None, y_np)
        t_total = time.monotonic() - t0
        if verbose:
            print(f"group N={n}: {B} datasets, fits {t_fit:.1f}s, "
                  f"total {t_total:.1f}s", flush=True)

        n_repairs, t_repairs = 0, 0.0
        for b, i in enumerate(idxs):
            path = gpdata_paths[i]
            base = os.path.basename(path)
            metrics = {
                "RMSE mf": float(ev_mf[0][b]),
                "WRMSE mf": float(ev_mf[1][b]),
                "RMSE sf": float(ev_sf[0][b]),
                "WRMSE sf": float(ev_sf[1][b]),
                "RMSE sfTP": float(ev_tp[0][b]),
                "WRMSE sfTP": float(ev_tp[1][b]),
                "RMSE nisf": float(ev_ni[0][b]),
                "WRMSE nisf": float(ev_ni[1][b]),
            }
            # host-f64 fallback for lanes whose f32 covariance was
            # numerically indefinite (~1/3 of lanes on the study
            # matrix; computed in the overlapped worker above —
            # .result() only waits on repairs the device didn't hide)
            for key in ("mf", "sf", "sfTP", "nisf"):
                if not (np.isfinite(metrics[f"WRMSE {key}"])
                        and np.isfinite(metrics[f"RMSE {key}"])):
                    t_r = time.monotonic()
                    rm, wm = repair_futs[(b, key)].result()
                    n_repairs += 1
                    t_repairs += time.monotonic() - t_r
                    metrics[f"RMSE {key}"] = rm
                    metrics[f"WRMSE {key}"] = wm
            results[base] = metrics
            if out_dir is None:
                continue
            os.makedirs(out_dir, exist_ok=True)
            stem = base.replace(".csv", "_")
            save_hyp_vector(os.path.join(out_dir, stem + "emuGP.txt"),
                            mf_vec_np[b], row=True)
            save_hyp_vector(os.path.join(out_dir, stem + "sfGP.txt"),
                            sf_vec_np[b])
            save_hyp_vector(os.path.join(out_dir, stem + "sfGPTP.txt"),
                            tp_vec_np[b])
            lh = ni_np[b]
            nig_params = np.hstack([np.exp(lh[D + 2 :]),
                                    np.exp(lh[D]), np.exp(lh[D + 1]),
                                    np.exp(lh[:D])])
            save_hyp_vector(os.path.join(out_dir, stem + "nisfGP.txt"),
                            nig_params)
            save_gpres(os.path.join(out_dir,
                                    base.replace("GPData", "GPRes")),
                       tp, f_true[i], ev_sf[2][b], ev_sf[3][b],
                       ev_mf[2][b], ev_mf[3][b])
            save_mse(os.path.join(out_dir, base.replace("GPData", "MSE")
                                  .replace(".csv", ".txt")), metrics)
        pool.shutdown()
        if verbose:
            print(f"group N={n}: artifacts+repairs "
                  f"{time.monotonic() - t0 - t_total:.1f}s "
                  f"({n_repairs} host-f64 lane repairs, "
                  f"{t_repairs:.1f}s blocked — the rest overlapped the "
                  f"device evals)", flush=True)
    return results
