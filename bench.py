"""Headline benchmark: MFGP train-step + posterior grid at N=20k.

Measures the wall-clock of the benchmark unit defined by BASELINE.json's
north star ("train + posterior-grid at N=20k"):

    1 exact NLML + full hyperparameter gradient        (the per-iteration
      cost of the reference's GPy L-BFGS fit, reference/GPTrainers.py:68)
  + 1 conditioning (Cholesky of the N=20k AR1 covariance + weight solve)
  + posterior mean/variance on the 10571-point robot grid
      (reference/PhysicalExperimentCode/exploreExpSettings.py:170-173)

on the flagship 3-fidelity AR1 MFGP with D=3 inputs, synthetic
fidelity-binned WRBF data. Device path: f32 with HIGHEST-precision matmuls,
jitted end to end. Baseline: the same mathematics in NumPy/scipy f64
(vectorised kernel assembly, cho_factor/cho_solve, analytic trace-identity
gradients — GPy-class CPU code) on this host.

Baseline methodology: the committed constant is ONE full measured run of
the exact NumPy unit at N=20000, M=10571 on this (single-core) host —
2764.3 s. `python bench.py --calibrate` additionally measures small-N
scaling points for sanity.

Prints ONE JSON line:
  {"metric": ..., "value": <unit seconds on the device>, "unit": "s",
   "vs_baseline": <baseline_seconds / value>}
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# Measured single-core NumPy f64 wall-clock of the exact unit at N=20000,
# M=10571 on this host (run_numpy_unit, one full run on 2026-08-16:
# 2764.3 s, nlml=6969.5). Re-measure with:
#   python -c "from bench import *; print(run_numpy_unit(N_TRAIN, M_GRID))"
# Overridden by --baseline-seconds.
BASELINE_CPU_SECONDS = 2764.3
# NLML value of that same measured f64 baseline run (the cross-check that
# makes the speedup provably same-answer: the device unit must reproduce it).
BASELINE_CPU_NLML = 6969.5
# Same-unit matern32 baseline: one full N=20000 f64 run on this host
# (run_numpy_unit(N_TRAIN, M_GRID, kernel="matern32"), idle 1-core host,
# 2026-08-18: 5175.5 s, nlml 15576.08 — the extra sqrt/exp over every
# N^2 pass costs ~1.9x the rbf unit in NumPy).
BASELINE_CPU_SECONDS_MATERN32 = 5175.5
BASELINE_CPU_NLML_MATERN32 = 15576.08

N_TRAIN = 20_000
M_GRID = 10_571
D_IN = 3
N_FID = 3


# ---------------------------------------------------------------------------
# Problem construction (synthetic WRBF field, fidelity-binned)
# ---------------------------------------------------------------------------
def build_problem(N=N_TRAIN, M=M_GRID, D=D_IN, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lo = np.zeros(D)
    hi = np.array([60.0, 110.0, 4.5][:D])
    X = (lo + (hi - lo) * rng.random((N, D))).astype(dtype)
    centers = lo + (hi - lo) * rng.random((4, D))
    y = np.zeros(N)
    for c in centers:
        y += 30.0 * np.exp(-0.004 * np.sum((X - c) ** 2, axis=1))
    y = (y + 0.1 * rng.standard_normal(N)).astype(dtype)
    fid = rng.integers(0, N_FID, N).astype(np.int32)
    grid = (lo + (hi - lo) * rng.random((M, D))).astype(dtype)
    grid_fid = np.full((M,), N_FID - 1, np.int32)
    return X, fid, y, grid, grid_fid


def _theta(D=D_IN, dtype=np.float64):
    """Plausible mid-optimization hyperparameters (fixed for the bench)."""
    variances = np.array([25.0, 10.0, 5.0], dtype)
    lengthscales = np.tile(np.array([[12.0, 20.0, 1.5]], dtype), (N_FID, 1))
    rhos = np.ones(N_FID - 1, dtype)
    noises = np.array([0.5, 0.2, 0.1], dtype)
    return variances, lengthscales, rhos, noises


# ---------------------------------------------------------------------------
# Device unit
# ---------------------------------------------------------------------------
def run_device(N, M, repeats=3, fast=False, kernel="rbf"):
    import jax
    import jax.numpy as jnp

    from mfgp_jax.models import mfgp as mf

    X, fid, y, grid, grid_fid = build_problem(N, M)
    v, l, r, nz = _theta()
    params = mf.MFGPParams(
        jnp.log(jnp.asarray(v, jnp.float32)),
        jnp.log(jnp.asarray(l, jnp.float32)),
        jnp.asarray(r, jnp.float32),
        jnp.log(jnp.asarray(nz, jnp.float32)),
    )
    Xj = jnp.asarray(X)
    fj = jnp.asarray(fid)
    yj = jnp.asarray(y)
    gj = jnp.asarray(grid)
    gfj = jnp.asarray(grid_fid)

    # analytic trace-identity gradient + conditioned state from ONE
    # factorization (the NumPy baseline also factorizes once). The state
    # carries the explicit inverse factor L^-1 (computed for the gradient's
    # K^-1 anyway), so the posterior's substitutions become plain
    # matmuls — see models/mfgp.nlml_value_grad_state_inv /
    # predict_blocked_inv.
    mode = "high" if fast else "highest"
    vgs = jax.jit(
        lambda p: mf.nlml_value_grad_state_inv(p, Xj, fj, yj,
                                               kernel=kernel, jitter=1e-6,
                                               inv_mode=mode))
    post = jax.jit(
        lambda p, s: mf.predict_blocked_inv(p, s, gj, gfj, kernel=kernel,
                                            precision=mode))

    def unit():
        val, g, state = vgs(params)
        mu, var = post(params, state)
        jax.block_until_ready((val, g, mu, var))
        return float(val)

    nlml_device = unit()  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        unit()
        times.append(time.perf_counter() - t0)

    # tracked sub-metrics (BASELINE.md): N=20k Cholesky time, posterior
    # grid points/sec (measured on the same warm executables)
    from mfgp_jax.models.mfgp import _assemble_noisy_cov
    from mfgp_jax.ops import linalg as _la

    chol_fn = jax.jit(
        lambda p: _la.chol(_assemble_noisy_cov(p, Xj, fj, 1e-6, kernel)))
    jax.block_until_ready(chol_fn(params))
    t0 = time.perf_counter()
    jax.block_until_ready(chol_fn(params))
    chol_s = time.perf_counter() - t0

    _, _, state = vgs(params)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    jax.block_until_ready(post(params, state))
    post_s = time.perf_counter() - t0

    return {
        "seconds": min(times),
        "nlml_device": nlml_device,
        "chol_seconds": chol_s,
        "grid_points_per_sec": M / post_s,
    }


# ---------------------------------------------------------------------------
# Device planner unit (tracked: one-launch RIG + fleet plan_batch)
# ---------------------------------------------------------------------------
# The reference replans on-robot inside a 45 s wall-clock budget
# (reference/PhysicalExperimentCode/exploreExpSettings.py:214-218) — the
# natural baseline for one replan decision.
PLANNER_BASELINE_SECONDS = 45.0
PLAN_ITERS = 200
PLAN_LANES = 8


def run_planner(repeats=3, iters=PLAN_ITERS, lanes=PLAN_LANES,
                    seed=0):
    """Wall-clock of (a) ONE 200-iteration DeviceRIG launch and (b) an
    ``lanes``-lane ``plan_batch`` fleet launch, at SIM-DEFAULT settings
    (ergodic cost, traj_count=3 — the light edge mix where vmap lane
    overhead is largest; ROADMAP 'Parallelism'). Extraction/transfer is
    included: this is the serving-relevant replan latency."""
    import jax

    from mfgp_jax.metrics.eid import eid_grid
    from mfgp_jax.planning.rig_device import DeviceRIG
    from mfgp_jax.utils.configs import SimConfig

    cfg_s = SimConfig()
    grid = np.asarray(eid_grid([list(b) for b in cfg_s.WS],
                               cfg_s.max_depth))
    rng = np.random.default_rng(seed)
    eid = rng.random(grid.shape[0])
    eid = eid / eid.sum()
    planner = DeviceRIG(
        cfg=cfg_s.agent(), delta=cfg_s.step_size, B=150.0,
        WS=np.asarray(cfg_s.WS, float), R=cfg_s.near_rad, Rd=cfg_s.Rd,
        same_node_distance=cfg_s.same_node_distance, budget_cutoff=0.9,
        max_iter=iters, grid=grid, eid=eid, cost="ergodic")
    x0 = np.array([1.0, 1.0])
    key = jax.random.key(seed)

    # BOTH solo index-op lowerings (rig_device traces one-hot by default,
    # gather on request) so the lane-overhead ratio is vs the BEST solo —
    # the honest accounting (dividing by the slower solo flatters the
    # batch; VERDICT r4 weak #3)
    planner.plan(x0, key)  # compile + warm (one-hot)
    solo_oh = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        planner.plan(x0, key)
        solo_oh.append(time.perf_counter() - t0)
    planner.plan(x0, key, gather=True)  # compile + warm (gather)
    solo_ga = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        planner.plan(x0, key, gather=True)
        solo_ga.append(time.perf_counter() - t0)
    best_solo = min(min(solo_oh), min(solo_ga))

    keys = jax.random.split(key, lanes)
    x0s = np.tile(x0, (lanes, 1))
    Bs = np.full(lanes, 150.0)
    planner.plan_batch(x0s, keys, Bs)  # compile + warm
    batch = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        planner.plan_batch(x0s, keys, Bs)
        batch.append(time.perf_counter() - t0)
    return {"plan_seconds": best_solo,
            "plan_solo_onehot_seconds": min(solo_oh),
            "plan_solo_gather_seconds": min(solo_ga),
            "plan_batch_seconds": min(batch),
            "lanes": lanes,
            "lane_overhead_x": min(batch) / best_solo}


# ---------------------------------------------------------------------------
# NumPy/scipy f64 baseline (the reference's compute stack)
# ---------------------------------------------------------------------------
def _np_ar1_weights(rhos, F):
    C = np.concatenate([[1.0], np.cumprod(rhos)])
    W = np.zeros((F, F))
    for m in range(F):
        for f in range(m, F):
            W[m, f] = C[f] / C[m]
    return W


def _np_base_kernels(X1, X2, lengthscales, kernel="rbf"):
    """Per-fidelity unit-variance base-kernel matrices + derivative bases.

    Returns (Ks, Es): Ks the covariance matrices, Es the lengthscale
    derivative base (dK/dl_d = E * d_d^2 / l_d^3 elementwise) — for rbf
    E IS K; for matern32 E = 3 exp(-sqrt(3) r)."""
    Ks, Es = [], []
    for m in range(lengthscales.shape[0]):
        inv_l = 1.0 / lengthscales[m]
        a = X1 * inv_l
        b = X2 * inv_l
        r2 = (np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
              - 2.0 * a @ b.T)
        np.maximum(r2, 0.0, out=r2)
        if kernel == "rbf":
            K = np.exp(-0.5 * r2)
            E = K
        else:  # matern32, ops.kernels semantics incl. the sqrt guard
            r = np.sqrt(r2 + 1e-36)
            e = np.exp(-np.sqrt(3.0) * r)
            K = (1.0 + np.sqrt(3.0) * r) * e
            E = 3.0 * e
        Ks.append(K)
        Es.append(E)
    return Ks, Es


def numpy_unit(X, fid, y, grid, grid_fid, kernel="rbf"):
    """One NLML+grad + condition + grid posterior, NumPy/scipy f64.

    The plain reference the device unit is checked against. Returns a dict
    with ``nlml``; ``grad``, the NLML gradient w.r.t. the LOG
    hyperparameters in MFGPParams order (log variances (F,), log
    lengthscales (F, D), log noises (F,); rhos are held fixed); and the
    posterior ``mu``/``var`` (noise included) on the grid."""
    from scipy.linalg import cho_factor, cho_solve

    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    grid = np.asarray(grid, np.float64)
    N, D = X.shape
    variances, lengthscales, rhos, noises = _theta(D)
    F = N_FID

    W = _np_ar1_weights(rhos, F)
    Ks, Es = _np_base_kernels(X, X, lengthscales, kernel)
    K = np.zeros((N, N))
    for m in range(F):
        w = W[m][fid]
        K += variances[m] * (w[:, None] * w[None, :]) * Ks[m]
    Kn = K + np.diag(noises[fid] + 1e-6)

    # NLML
    cf = cho_factor(Kn, lower=True)
    alpha = cho_solve(cf, y)
    L = np.tril(cf[0])
    nlml = (0.5 * y @ alpha + np.sum(np.log(np.diag(L)))
            + 0.5 * N * np.log(2 * np.pi))

    # gradient via trace identities: dL/dth = 0.5 tr((Kinv - aa^T) dK/dth)
    Kinv = cho_solve(cf, np.eye(N))
    Wmat = Kinv - np.outer(alpha, alpha)
    g_var = np.zeros(F)
    g_ls = np.zeros((F, D))
    for m in range(F):
        w = W[m][fid]
        ww = w[:, None] * w[None, :]
        g_var[m] = 0.5 * np.sum(Wmat * (ww * Ks[m]))
        base = variances[m] * ww * Es[m]
        for d in range(D):
            diff = (X[:, d][:, None] - X[:, d][None, :]) ** 2
            dK_dl = base * diff / lengthscales[m, d] ** 3
            g_ls[m, d] = 0.5 * np.sum(Wmat * dK_dl)
    g_noise = np.array([0.5 * np.sum(np.diag(Wmat) * (fid == f))
                        for f in range(F)])
    # chain rule to the log parametrization the models optimize
    grad = np.concatenate([g_var * variances,
                           (g_ls * lengthscales).reshape(-1),
                           g_noise * noises])

    # condition + posterior grid (mean + marginal variance)
    mu, var = _np_posterior_from_factor(
        L, alpha, X, fid, grid, grid_fid, variances, lengthscales, rhos,
        noises, kernel)
    return dict(nlml=float(nlml), grad=grad, mu=mu, var=var)


def _np_ar1_cov(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                kernel="rbf"):
    """Dense AR1 covariance between labelled point sets, NumPy f64."""
    F = variances.shape[0]
    W = _np_ar1_weights(rhos, F)
    Ks, _ = _np_base_kernels(X1, X2, lengthscales, kernel)
    K = np.zeros((X1.shape[0], X2.shape[0]))
    for m in range(F):
        K += (variances[m] * (W[m][fid1][:, None] * W[m][fid2][None, :])
              * Ks[m])
    return K


def _np_posterior_from_factor(L, alpha, X, fid, Xs, fid_s, variances,
                              lengthscales, rhos, noises, kernel):
    from scipy.linalg import solve_triangular

    Kxs = _np_ar1_cov(Xs, fid_s, X, fid, variances, lengthscales, rhos,
                      kernel)
    mu = Kxs @ alpha
    V = solve_triangular(L, Kxs.T, lower=True)
    W = _np_ar1_weights(rhos, variances.shape[0])
    kss = np.sum((W[:, fid_s] ** 2) * variances[:, None], axis=0)
    return mu, kss - np.sum(V * V, axis=0) + noises[fid_s]


def numpy_posterior(X, fid, y, Xs, fid_s, variances, lengthscales, rhos,
                    noises, kernel="rbf", jitter=1e-6):
    """AR1 MFGP posterior mean/variance (noise included), NumPy/scipy f64
    — the plain reference for a model conditioned from scratch."""
    from scipy.linalg import cho_factor, cho_solve

    X, Xs = np.asarray(X, np.float64), np.asarray(Xs, np.float64)
    fid, fid_s = np.asarray(fid, int), np.asarray(fid_s, int)
    variances, lengthscales, rhos, noises = (
        np.asarray(a, np.float64)
        for a in (variances, lengthscales, rhos, noises))
    Kn = _np_ar1_cov(X, fid, X, fid, variances, lengthscales, rhos, kernel)
    Kn += np.diag(noises[fid] + jitter)
    cf = cho_factor(Kn, lower=True)
    alpha = cho_solve(cf, np.asarray(y, np.float64))
    return _np_posterior_from_factor(
        np.tril(cf[0]), alpha, X, fid, Xs, fid_s, variances, lengthscales,
        rhos, noises, kernel)


def run_numpy_unit(N, M, seed=0, kernel="rbf"):
    """Timed NumPy/scipy f64 unit on the bench problem: (seconds, nlml,
    sum of posterior means, sum of posterior variances)."""
    X, fid, y, grid, grid_fid = build_problem(N, M, seed=seed)
    t0 = time.perf_counter()
    r = numpy_unit(X, fid, y, grid, grid_fid, kernel=kernel)
    elapsed = time.perf_counter() - t0
    return (elapsed, r["nlml"], float(np.sum(r["mu"])),
            float(np.sum(r["var"])))


def calibrate(ns=(2000, 3000, 4000, 6000), m=M_GRID, kernel="rbf"):
    """Fit t = a N^3 + b N^2 on small-N runs, extrapolate to N_TRAIN."""
    rows = []
    for n in ns:
        t, nl, _, _ = run_numpy_unit(n, m, kernel=kernel)
        rows.append((n, t))
        print(f"  N={n}: {t:.2f}s (nlml={nl:.1f})", flush=True)
    A = np.array([[n**3, n**2] for n, _ in rows], np.float64)
    b = np.array([t for _, t in rows])
    coef, *_ = np.linalg.lstsq(A, b, rcond=None)
    t20k = float(coef[0] * N_TRAIN**3 + coef[1] * N_TRAIN**2)
    print(f"fit a={coef[0]:.3e} b={coef[1]:.3e} -> "
          f"extrapolated t(N={N_TRAIN}) = {t20k:.1f}s")
    return t20k


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the NumPy baseline on this host")
    ap.add_argument("--baseline-seconds", type=float, default=None)
    ap.add_argument("--n", type=int, default=N_TRAIN)
    ap.add_argument("--m", type=int, default=M_GRID)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kernel", default="rbf",
                    choices=("rbf", "matern32"),
                    help="base kernel for the measured unit (both "
                         "kernels have a recorded-NLML cross-check at the "
                         "default N)")
    ap.add_argument("--fast", action="store_true",
                    help="HIGH-precision matmuls on the K^-1/posterior "
                         "phases (~5e-2 max posterior-variance rel err vs "
                         "~1e-3 at the HIGHEST default)")
    ap.add_argument("--planner", action="store_true",
                    help="measure ONLY the device-planner unit (200-iter "
                         "one-launch RIG + 8-lane plan_batch at sim "
                         "defaults) and print it as its own JSON line")
    ap.add_argument("--no-planner", action="store_true",
                    help="skip the planner sub-metrics in the default "
                         "line (saves its compile when iterating on the "
                         "train-step unit)")
    ap.add_argument("--no-matern32", action="store_true",
                    help="skip the matern32-unit sub-metrics in the "
                         "default line (the physical drivers' kernel, "
                         "reference/PhysicalExperimentCode/"
                         "GraceExplorationExperiments_SFGP.py:610-615)")
    args = ap.parse_args()

    from mfgp_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    if args.calibrate:
        calibrate(kernel=args.kernel)
        return

    if args.planner:
        p = run_planner(repeats=args.repeats)
        print(json.dumps({
            "metric": "device_planner_200iter_replan_wallclock",
            "value": round(p["plan_seconds"], 4), "unit": "s",
            "vs_baseline": round(
                PLANNER_BASELINE_SECONDS / p["plan_seconds"], 2),
            "plan_solo_onehot_seconds": round(
                p["plan_solo_onehot_seconds"], 4),
            "plan_solo_gather_seconds": round(
                p["plan_solo_gather_seconds"], 4),
            "plan_batch8_seconds": round(p["plan_batch_seconds"], 4),
            "lane_overhead_x": round(p["lane_overhead_x"], 2),
        }))
        return

    if args.baseline_seconds is not None:
        baseline = args.baseline_seconds
    elif args.kernel == "rbf":
        baseline = BASELINE_CPU_SECONDS
    else:
        # a same-unit baseline only: never report a matern32 speedup
        # against the rbf-measured constant
        baseline = BASELINE_CPU_SECONDS_MATERN32
    stats = run_device(args.n, args.m, args.repeats, fast=args.fast,
                    kernel=args.kernel)
    value = stats["seconds"]
    out = {
        "metric": "mfgp_n20k_train_step_plus_grid_wallclock",
        "value": round(value, 4),
        "unit": "s",
        "precision": "high" if args.fast else "highest",
        "vs_baseline": (round(baseline / value, 2)
                        if baseline is not None else None),
        "chol_seconds": round(stats["chol_seconds"], 4),
        "grid_points_per_sec": round(stats["grid_points_per_sec"], 1),
    }
    if args.kernel != "rbf":
        out["metric"] = out["metric"].replace("mfgp_", f"mfgp_{args.kernel}_")
    recorded_nlml = (BASELINE_CPU_NLML if args.kernel == "rbf"
                     else BASELINE_CPU_NLML_MATERN32)
    if args.n == N_TRAIN and recorded_nlml is not None:
        # same-answer proof: the device f32 unit reproduces the measured f64
        # NumPy baseline's NLML (the recorded value for this kernel)
        out["nlml_device"] = round(stats["nlml_device"], 2)
        out["nlml_numpy_f64"] = recorded_nlml
        out["nlml_rel_err"] = round(
            abs(stats["nlml_device"] - recorded_nlml)
            / abs(recorded_nlml), 6)
    if args.kernel == "rbf" and not args.no_matern32:
        # the SECOND tracked kernel unit (the physical drivers' Matern32)
        # rides the same line — one executable family, same N/M
        try:
            m32 = run_device(args.n, args.m, args.repeats, fast=args.fast,
                          kernel="matern32")
            out["matern32_seconds"] = round(m32["seconds"], 4)
            out["matern32_vs_baseline"] = round(
                BASELINE_CPU_SECONDS_MATERN32 / m32["seconds"], 2)
            if args.n == N_TRAIN:
                out["matern32_nlml_rel_err"] = round(
                    abs(m32["nlml_device"] - BASELINE_CPU_NLML_MATERN32)
                    / abs(BASELINE_CPU_NLML_MATERN32), 6)
        except Exception as e:  # noqa: BLE001 — never lose the headline
            out["matern32_error"] = repr(e)
    if not args.no_planner:
        # planner sub-metrics ride the tracked line (vs the reference's
        # 45 s replan budget)
        try:
            p = run_planner(repeats=args.repeats)
            out["planner_replan_seconds"] = round(p["plan_seconds"], 4)
            out["planner_solo_onehot_seconds"] = round(
                p["plan_solo_onehot_seconds"], 4)
            out["planner_solo_gather_seconds"] = round(
                p["plan_solo_gather_seconds"], 4)
            out["planner_batch8_seconds"] = round(
                p["plan_batch_seconds"], 4)
            # overhead vs the BEST solo mode (honest accounting)
            out["planner_lane_overhead_x"] = round(
                p["lane_overhead_x"], 2)
        except Exception as e:  # noqa: BLE001 — never lose the headline
            out["planner_error"] = repr(e)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
