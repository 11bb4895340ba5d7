"""Fully on-device RIG planner (ergodic-KL, Fourier, or sequential-gain).

The host planner (planning/rig.py) keeps the graph bookkeeping in Python
and batches only the scoring onto the device — the right split at the
reference's scale (~100 nodes, 45 s replan budget). This module is the
scale-up variant: the ENTIRE planning loop — sampling, expansion-ring
nearest, steering, node merging, candidate-edge synthesis
(primitives_device), feasibility filtering, the path-set dynamic program,
scoring, and best-path tracking — runs inside one jitted
``lax.fori_loop`` over padded buffers. One device launch per ``plan()``;
planner throughput is then bounded by arithmetic instead of
host-device round trips.

Score-everything semantics (all cost modes). The host planner scores
every budget-eligible path extension (reference/GraceRIGV3.py:1157-1170
via ``updatePathList``); so does this planner, in every cost mode:

* ``ergodic`` — each edge's unnormalized time-integral of the
  Gaussian-sensor density over the grid is computed once; a path's
  statistics are the running sum (the algebraic identity the host planner
  recomputes from scratch per candidate, reference/GraceRIGV3.py:581-596
  via ergodicKLDivergence.py:46-61). Flooring/normalization match
  metrics.ergodic exactly.
* ``fourier`` — each edge's unnormalized cosine-coefficient sums are
  additive the same way (the reference's own incremental merge,
  reference/PhysicalExperimentCode/ergodicMetric.py:89-96); the score is
  the negative Sobolev distance to the EID's coefficients, matching the
  host ``FourierErgodicCost`` exactly on identical point sets.
* ``sf_gain`` / ``mf_gain`` — the sequential-entropy gain is made
  additive by a per-path bordered-Cholesky carry: each beam slot carries
  ``chol(C_path | train)``, the factor of its points' noisy posterior
  covariance given the (static, padded) training set. Extending a path by
  one S-point edge borders that factor by S rows (one O(P^2 S) triangular
  solve + an S x S Cholesky), and the path's gain increases by exactly
  the new points' sequential terms — identical, in exact arithmetic, to
  the host scorer's full-path closed form (scoring._sf_gain_one /
  _mf_gain_one; reference calcPathInfoSF2 / calculatePathInfoEmu,
  reference/GraceRIGV3.py:443-466, :525-562). Every eligible extension is
  scored; there is no beam preselection and no truncated/corrupted point
  set — ``max_path_points`` is a hard capacity, and extensions that would
  exceed it are simply infeasible (size it >= samples_per_edge *
  ceil(B / min-edge-budget) to make it unreachable).
* ``sf_logdet`` / ``mf_logdet`` — the batch mutual information over a
  fixed evaluation grid (host BatchLogDetCost / MFBatchLogDetCost;
  reference calcPathInfoSFBatch / calculatePathInfoEmuBatch,
  reference/PhysicalExperimentCode/GraceRIGV3.py:571-617 — what the
  physical SFGP/MFGP drivers score with). Each beam slot additionally
  carries the GRID's latent posterior covariance given train+path;
  conditioning on an edge's S points is a rank-S downdate computed
  through the same bordered pipeline (O(G S (P + G)) + one G x G
  Cholesky per candidate), so every eligible extension's exact score is
  evaluated. Use the coarse IG grid (the reference keeps a 10x6x5 grid
  beside the dense EID grid) — the carry is O(max_nodes*max_paths*G^2).

Capacity-bounded analogues of the host's unbounded structures:

* Path sets are a BEAM: each node keeps its top ``max_paths`` extensions
  (ranked by actual score — scored paths first, then unscored by their
  accumulated gain / budget progress) instead of the host's unbounded
  path list. Accepted paths live in an append-only arena so backpointer
  chains stay valid under eviction; gain-mode carries live per
  (node, beam slot), so carry memory is O(max_nodes * max_paths * P^2),
  independent of ``max_iter``.
* The near-phase extends the ``near_neighbors`` closest near nodes per
  iteration (the host extends every node within R).

Reference semantics retained: expansion-ring nearest ((Rd - d)^2 argmin,
reference/GraceRIGV3.py:801), same-node merging, workspace box test,
underwater-time feasibility filter, the -10000 sentinel below the
budget-cutoff fraction (reference/GraceRIGV3.py:1157-1170), and
best-by-info with lower-budget tie-break.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.metrics.ergodic import gaussian_sensor
from mfgp_jax.metrics.fourier import (basis_norms, config_k, fourier_basis,
                                      sobolev_weights)
from mfgp_jax.planning.primitives import AgentConfig
from mfgp_jax.planning.primitives_device import (
    evaluate_trajectory_device, generate_trajectory_device)

SENTINEL = -10000.0
NEG = -1e30
PIN = 1e20  # beam-rank pin for the root trivial path

GAIN_COSTS = ("sf_gain", "mf_gain")  # additive sequential-entropy carries
LOGDET_COSTS = ("sf_logdet", "mf_logdet")  # carried grid-posterior cov
STAT_COSTS = ("ergodic", "fourier")  # additive-statistics modes


# Index-op lowering for the DP-state reads/writes, chosen PER TRACE:
# "onehot" = dense masked contractions, "gather" = jnp.take/.at[].set.
# A solo plan is a latency-bound sequential fori_loop, where the two
# lowerings cost about the same; under vmapped lanes the per-iteration
# work is K-fold and gathers scale better at rich edge mixes. plan()
# traces with one-hot and the vmapped entry points
# (plan_ensemble/plan_batch) trace with gather. Both were chosen on the
# previous accelerator; neither has been measured on the GPU yet.
# MFGP_PLAN_GATHER=0/1 pins BOTH paths for A/B; default "auto".
_PLAN_GATHER_ENV = os.environ.get("MFGP_PLAN_GATHER", "auto")
_INDEX_GATHER = {"on": _PLAN_GATHER_ENV == "1"}


@contextlib.contextmanager
def _index_gather(on: bool):
    """Select the index-op lowering for traces started in this scope."""
    if _PLAN_GATHER_ENV in ("0", "1"):
        on = _PLAN_GATHER_ENV == "1"
    old = _INDEX_GATHER["on"]
    _INDEX_GATHER["on"] = on
    try:
        yield
    finally:
        _INDEX_GATHER["on"] = old


def _fill_zero(dtype):
    return False if dtype == jnp.bool_ else 0


def _row(arr, idx):
    """``arr[idx]`` (scalar idx, leading axis) as a one-hot contraction.

    Under ``vmap`` (plan_ensemble) a batched scalar-index read lowers to a
    gather; the one-hot select lowers to a dense masked reduction, which
    vectorizes across instances. Negligible cost unbatched."""
    if _INDEX_GATHER["on"]:
        return jnp.take(arr, idx, axis=0, mode="fill",
                        fill_value=_fill_zero(arr.dtype))
    oh = jnp.arange(arr.shape[0]) == idx
    ohx = oh.reshape((-1,) + (1,) * (arr.ndim - 1))
    return jnp.sum(jnp.where(ohx, arr, jnp.zeros((), arr.dtype)), axis=0,
                   dtype=arr.dtype)


def _rows(arr, idx):
    """``arr[idx]`` for an index VECTOR: one-hot matmul (floats) or masked
    reduction (ints/bools). Invalid (-1) indices yield zeros."""
    if _INDEX_GATHER["on"]:
        return jnp.take(arr, idx, axis=0, mode="fill",
                        fill_value=_fill_zero(arr.dtype))
    oh = idx[:, None] == jnp.arange(arr.shape[0])[None, :]  # (K, A)
    if arr.dtype == jnp.bool_:
        return jnp.any(oh & arr[None, :], axis=1)
    if arr.ndim == 1:
        return jnp.sum(jnp.where(oh, arr[None, :],
                                 jnp.zeros((), arr.dtype)), axis=1,
                       dtype=arr.dtype)
    if jnp.issubdtype(arr.dtype, jnp.floating):
        # HIGHEST keeps the read exact: at default precision an f32
        # contraction may run in TF32/bf16 and round the gathered values
        return jnp.tensordot(oh.astype(arr.dtype), arr, axes=1,
                             precision=jax.lax.Precision.HIGHEST)
    ohx = oh.reshape(oh.shape + (1,) * (arr.ndim - 1))
    return jnp.sum(jnp.where(ohx, arr[None], jnp.zeros((), arr.dtype)),
                   axis=1, dtype=arr.dtype)


def _set_row(arr, idx, value, active=True):
    """``arr.at[idx].set(value) if active`` as a dense one-hot select
    (scatter-free under vmap)."""
    if _INDEX_GATHER["on"]:
        safe = jnp.where(jnp.asarray(active), idx, arr.shape[0])
        return arr.at[safe].set(value, mode="drop")
    oh = (jnp.arange(arr.shape[0]) == idx) & active
    ohx = oh.reshape((-1,) + (1,) * (arr.ndim - 1))
    return jnp.where(ohx, value, arr)


def _lex_top_idx(tier, key, K):
    """Indices of the top-K entries by (tier, key) DESCENDING,
    lexicographically exact (no additive-bonus precision traps: a float
    bonus large enough to separate tiers would swallow the within-tier
    key at f32)."""
    n = tier.shape[0]
    _, _, idx = jax.lax.sort(
        (-tier.astype(jnp.int32), -key, jnp.arange(n, dtype=jnp.int32)),
        num_keys=2)
    return idx[:K]


@dataclass
class DevicePlanResult:
    info: float
    budget: float
    time: float
    points: np.ndarray  # (P, 4) x, y, z, t waypoints of the best path
    n_nodes: int
    node_states: np.ndarray  # (n_nodes, 2)
    # best-path edge chain: (padded prims (L, 4), src_xy, dst_xy) per edge —
    # enough to rebuild the runtime flight plan (hw.runtime.flight_plan)
    edges: list = None
    # retained for API compatibility: gain scores are never computed on a
    # truncated point set any more (over-cap extensions are infeasible)
    truncated: bool = False
    # feasible candidate edges actually admitted to the graph (counted in
    # the loop state, not launch capacity)
    n_feasible_edges: int = 0
    # chronological admitted-extension trace, (K, 6): iteration, x_src,
    # y_src, x_dst, y_dst, edge_id — enough to replay graph growth
    # frame by frame (viz.plot_plan_animation; the reference draws the
    # graph as it plans, reference/GraceRIGV3.py:1213-1216)
    trace: np.ndarray = None


class DeviceRIG:
    """One-launch RIG planner. See module docstring.

    >>> planner = DeviceRIG(cfg, delta=2.0, B=20.0, WS=ws, R=3.0, Rd=2.0,
    ...                     eid=eid, grid=grid, max_iter=40)
    >>> result = planner.plan(np.array([1.0, 1.0]), jax.random.key(0))
    """

    def __init__(self, cfg: AgentConfig, *, delta: float, B: float, WS,
                 R: float, Rd: float = 0.0, same_node_distance: float = 0.0,
                 budget_cutoff: float = 0.9, max_iter: int = 40,
                 eid=None, grid=None, sigma_diag=None,
                 max_nodes: int = 64, max_paths: int = 8,
                 samples_per_edge: int = 24, near_neighbors: int = 1,
                 cost: str = "ergodic", max_path_points: int = 192,
                 kernel: str = "rbf", dtype=jnp.float32,
                 fourier_bounds=None, n_coefs: int = 5):
        self.cfg = cfg
        self.delta = float(delta)
        self.B = float(B)
        self.WS = np.asarray(WS, float).reshape(2, 2)
        self.R = float(R)
        self.Rd = float(Rd)
        self.snd = float(same_node_distance)
        self.budget_cutoff = float(budget_cutoff)
        self.max_iter = int(max_iter)
        self.max_nodes = int(max_nodes)
        self.max_paths = int(max_paths)
        self.S = int(samples_per_edge)
        self.K = int(near_neighbors)  # near-phase extensions per iteration
        if cost not in STAT_COSTS + GAIN_COSTS + LOGDET_COSTS:
            raise ValueError(cost)
        from mfgp_jax.ops.kernels import KERNELS

        if kernel not in KERNELS:
            raise ValueError(kernel)
        self.kernel = kernel
        self.cost = cost
        self.P = int(max_path_points)  # per-path point capacity (gain mode)
        if self.P < int(samples_per_edge):
            raise ValueError("max_path_points must be >= samples_per_edge")
        self.dtype = dtype
        if grid is None:
            if cost in STAT_COSTS + LOGDET_COSTS:
                raise ValueError(f"{cost} scoring needs a grid"
                                 + (" (+ eid)" if cost in STAT_COSTS
                                    else ""))
            grid = np.zeros((1, 3))
        else:
            grid = np.asarray(grid, float)
        self.grid = jnp.asarray(grid, dtype)
        if sigma_diag is None:
            sigma_diag = 0.25 * np.ones(grid.shape[1])
        self.sigma_diag = jnp.asarray(sigma_diag, dtype)
        self._eid = (None if eid is None
                     else jnp.asarray(np.asarray(eid, float).reshape(-1),
                                      dtype))
        if cost == "fourier":
            # cosine-basis tables (host FourierErgodicCost semantics); the
            # target coefficients are computed from the traced EID inside
            # the jitted plan so one executable serves every replan
            if fourier_bounds is None:
                fourier_bounds = np.concatenate(
                    [self.WS, [[0.0, float(cfg.max_depth)]]], axis=0)
            fb = np.asarray(fourier_bounds, float).reshape(-1, 2)
            d = fb.shape[0]
            self._f_lo = jnp.asarray(fb[:, 0], dtype)
            self._f_ilen = jnp.asarray(1.0 / (fb[:, 1] - fb[:, 0]), dtype)
            k = config_k(*[(int(n_coefs), 1.0)] * d)
            self._f_k = jnp.asarray(k, dtype)
            self._f_hk = jnp.asarray(basis_norms(k), dtype)
            self._f_lam = jnp.asarray(sobolev_weights(k), dtype)
            gu = (self.grid[:, :d] - self._f_lo) * self._f_ilen
            self._f_grid_basis = fourier_basis(gu, self._f_k)  # (M, G)
        # B and the EID are TRACED arguments: one compiled plan() serves
        # every replan (varying budget tranche + refreshed EID)
        self._plan_jit = jax.jit(self._plan_impl)
        self._plan_jit_gather = None  # gather-lowered solo trace (A/B)
        self._ensemble_jit = None
        self._batch_jit = None

    # -- per-edge geometry + additive statistics ----------------------------
    def _edge_stats(self, prims, src_xy, dst_xy):
        """(feasible, budget, time, q (G|M,), pts (S, 4), var (S,))."""
        cfg = self.cfg
        t_e, dist_e, tuw, wpts, budget = evaluate_trajectory_device(
            prims, cfg)
        # bearing from src to dst (host edge_points_to_traj_points)
        dxy = dst_xy - src_xy
        b = jnp.arctan2(dxy[1], dxy[0])
        ts = jnp.linspace(0.0, t_e, self.S)
        d = jnp.interp(ts, wpts[:, 2], wpts[:, 0])
        z = jnp.interp(ts, wpts[:, 2], wpts[:, 1])
        xyz = jnp.stack([src_xy[0] + d * jnp.cos(b),
                         src_xy[1] + d * jnp.sin(b), z], axis=1)
        if self.cost == "ergodic":
            # unnormalized time-integral of the sensor density per cell
            dens = jax.vmap(lambda s: gaussian_sensor(xyz, s,
                                                      self.sigma_diag)
                            )(self.grid)  # (G, S)
            dt = ts[1:] - ts[:-1]
            w = jnp.zeros_like(ts).at[:-1].add(0.5 * dt).at[1:].add(
                0.5 * dt)
            q = dens @ w
        elif self.cost == "fourier":
            # unnormalized cosine-coefficient sums over the edge samples
            # (additive across edges; host coef = sum / count / hk)
            xu = (xyz - self._f_lo) * self._f_ilen
            q = jnp.sum(fourier_basis(xu, self._f_k), axis=1)  # (M,)
        else:  # gain mode scores from the points themselves
            q = jnp.zeros((1,), xyz.dtype)
        feasible = tuw <= cfg.underwater_time_limit
        pts = jnp.concatenate([xyz, ts[:, None]], axis=1)
        var_s = jnp.interp(ts, wpts[:, 2], wpts[:, 3])
        return feasible, budget, t_e, q, pts, var_s

    def _score(self, q, T, r):
        """Host _ergodic_one semantics on additive stats (floor + KL);
        ``r`` is the pre-floored, normalized EID."""
        qn = q / jnp.maximum(T, 1e-30)
        floor = jnp.minimum(jnp.min(jnp.where(qn > 0, qn, jnp.inf)),
                            jnp.asarray(1e-15, self.dtype))
        qn = jnp.where(jnp.any(qn == 0), qn + floor, qn)
        p = qn / jnp.sum(qn)
        return -jnp.sum(jnp.where(p > 0, p * (jnp.log(p) - jnp.log(r)),
                                  0.0))

    def _score_fourier(self, fc_sum, count, target):
        """Host _fourier_erg_one on additive stats: coef = sum/count/hk,
        score = -sum_k lambda_k (coef - target)^2."""
        coef = fc_sum / jnp.maximum(count, 1.0) / self._f_hk
        return -jnp.sum(self._f_lam * (coef - target) ** 2)

    # -- the jitted loop -----------------------------------------------------
    def _plan_impl(self, x0, key, B, eid, gp):
        cfg = self.cfg
        dt = self.dtype
        ld_mode = self.cost in LOGDET_COSTS
        gain_mode = self.cost in GAIN_COSTS or ld_mode
        mf = self.cost in ("mf_gain", "mf_logdet")
        if self.cost == "ergodic":
            floor = jnp.minimum(jnp.min(jnp.where(eid > 0, eid, jnp.inf)),
                                jnp.asarray(1e-15, dt))
            p_eid = jnp.where(jnp.any(eid == 0), eid + floor, eid)
            p_eid = p_eid / jnp.sum(p_eid)
        elif self.cost == "fourier":
            # target coefficients of the EID over the grid — identical to
            # FourierErgodicCost.__post_init__ (mean(F * p * G) / hk =
            # sum(F * p) / hk)
            f_target = (self._f_grid_basis @ eid.astype(dt)) / self._f_hk
        MAXN, MAXP, E = self.max_nodes, self.max_paths, cfg.traj_count
        G = self.grid.shape[0]
        S = self.S
        P = self.P
        PH = 1 + self.K  # phases per iteration: nearest + K near-nodes
        ARENA = 1 + PH * self.max_iter * MAXP  # slot 0 = root trivial path
        MAXE = PH * self.max_iter * E
        lo = jnp.asarray(self.WS[:, 0], dt)
        hi = jnp.asarray(self.WS[:, 1], dt)

        # gain mode: unpack the padded conditioned GP state and build the
        # explicit train-precision once per launch (matmul-friendly posterior
        # projections; N is small — the padded train size)
        if gain_mode:
            from mfgp_jax.ops import kernels as _k
            from mfgp_jax.ops import linalg as _la

            kern = _k.KERNELS[self.kernel]
            if mf:
                (X_pad, fid_pad, L_pad, variances, lengthscales, rhos,
                 noises, fl) = gp
                F = variances.shape[0]
                Wf = _k.ar1_fidelity_weights(rhos, F)
            else:
                X_pad, L_pad, variance, lengthscales, noise = gp
            N = X_pad.shape[0]
            Kinv = _la.chol_solve(L_pad, jnp.eye(N, dtype=L_pad.dtype))

            def flabels(var):
                """Accrued variance -> conditioning fidelity (traced
                fids_from_variance, reference/GraceRIGV3.py:528-533)."""
                lev = jnp.sum(var[:, None] >= fl[None, :], axis=1)
                return (F - 1 - lev).astype(jnp.int32)

            def cov_c(A, fa, Bm, fb):
                if mf:
                    return _k.ar1_cov(A, fa, Bm, fb, variances,
                                      lengthscales, rhos, self.kernel)
                return kern(A, Bm, variance, lengthscales)

            if ld_mode:
                # batch-mutual-information mode (host BatchLogDetCost /
                # MFBatchLogDetCost; reference calcPathInfoSFBatch /
                # calculatePathInfoEmuBatch, reference/
                # PhysicalExperimentCode/GraceRIGV3.py:571-617): each beam
                # slot carries the GRID's latent posterior covariance
                # given train+path; conditioning on an edge's S points is
                # a rank-S downdate through the same bordered pipeline,
                # so EVERY eligible extension is scored exactly.
                grid_j = self.grid
                if mf:
                    fid_g = jnp.full((G,), F - 1, jnp.int32)
                    g_noise = noises[F - 1]
                else:
                    fid_g = None
                    g_noise = noise
                Kxg = cov_c(X_pad, fid_pad if mf else None, grid_j, fid_g)
                Kgg = cov_c(grid_j, fid_g, grid_j, fid_g)
                Ag = Kinv @ Kxg  # (N, G)
                Sig0 = Kgg - Kxg.T @ Ag  # latent grid posterior | train
                eyeG = jnp.eye(G, dtype=dt)
                ld_prior = _la.logdet_from_chol(
                    _la.chol(Sig0 + g_noise * eyeG))

        if self.cost == "ergodic":
            nstats = G
        elif self.cost == "fourier":
            nstats = self._f_k.shape[0]
        else:
            nstats = 0
        state = dict(
            nodes=jnp.zeros((MAXN, 2), dt).at[0].set(jnp.asarray(x0, dt)),
            n_nodes=jnp.asarray(1, jnp.int32),
            n_feas=jnp.asarray(0, jnp.int32),
            # per-node beam: arena indices, -1 = empty
            node_paths=jnp.full((MAXN, MAXP), -1, jnp.int32),
            # arena (append-only): slot 0 is the root's trivial path.
            # An (MAXN, MAXP, nstats) per-beam-slot carry layout
            # (leading-axis slice reads, .at[].set merge) holds 6x less
            # state but was slower than the arena form on the previous
            # accelerator; not re-measured on the GPU
            **({"a_q": jnp.zeros((ARENA, nstats), dt)}
               if not gain_mode else {}),
            **({"a_cnt": jnp.zeros((ARENA,), dt)}
               if self.cost == "fourier" else {}),
            a_budget=jnp.zeros((ARENA,), dt),
            a_time=jnp.zeros((ARENA,), dt),
            a_score=jnp.full((ARENA,), SENTINEL, dt),
            a_prev=jnp.full((ARENA,), -1, jnp.int32),
            a_edge=jnp.full((ARENA,), -1, jnp.int32),
            a_node=jnp.zeros((ARENA,), jnp.int32),
            edge_pts=jnp.zeros((MAXE, S, 4), dt),
            # gain-mode carries, per (node, beam slot): path points
            # (xyz + accrued var), count, accumulated gain, and the
            # bordered factor chol(C_path | train). O(MAXN*MAXP*P^2),
            # independent of max_iter.
            **({"c_pts": jnp.zeros((MAXN, MAXP, P, 4), dt),
                "c_np": jnp.zeros((MAXN, MAXP), jnp.int32),
                "c_gain": jnp.zeros((MAXN, MAXP), dt),
                "c_L": jnp.broadcast_to(jnp.eye(P, dtype=dt),
                                        (MAXN, MAXP, P, P))}
               if gain_mode else {}),
            # logdet mode: carried latent grid posterior cov per slot
            **({"c_sig": jnp.broadcast_to(Sig0, (MAXN, MAXP, G, G))}
               if ld_mode else {}),
            edge_prims=jnp.full((MAXE, 2 * cfg.num_legs + 1, 4),
                                -1.0, dt),
            edge_src=jnp.zeros((MAXE,), jnp.int32),
            edge_dst=jnp.zeros((MAXE,), jnp.int32),
            best_score=jnp.asarray(NEG, dt),
            best_budget=jnp.asarray(jnp.inf, dt),
            best_arena=jnp.asarray(-1, jnp.int32),
            key=key,
        )
        state["node_paths"] = state["node_paths"].at[0, 0].set(0)
        # the root's trivial path must never be evicted from node 0's beam
        # (every path starts by extending it): give it a beam-ranking score
        # above any real one (never read as a best-path candidate, which
        # only considers scored extensions)
        state["a_score"] = state["a_score"].at[0].set(PIN)

        def extend(state, src_idx, dst_xy, phase, it):
            """Synthesize E candidate edges src->dst, run the DP update."""
            key, k_edges = jax.random.split(state["key"])
            state = dict(state, key=key)
            nodes, n_nodes = state["nodes"], state["n_nodes"]
            src_xy = _row(nodes, src_idx)

            # merge into an existing node, else allocate a new slot
            d_all = jnp.linalg.norm(nodes - dst_xy[None, :], axis=1)
            d_all = jnp.where(jnp.arange(MAXN) < n_nodes, d_all, jnp.inf)
            j_min = jnp.argmin(d_all)
            merge = jnp.min(d_all) < self.snd
            have_room = n_nodes < MAXN
            dst_idx = jnp.where(merge, j_min,
                                jnp.where(have_room, n_nodes,
                                          j_min)).astype(jnp.int32)
            dst_xy = jnp.where(merge, _row(nodes, dst_idx), dst_xy)
            in_ws = jnp.all((dst_xy >= lo) & (dst_xy <= hi))
            active = in_ws & (merge | have_room) & (dst_idx != src_idx)

            # candidate edges: vmapped synthesis + stats
            distance = jnp.linalg.norm(dst_xy - src_xy)
            probs = jnp.asarray(list(cfg.leg_probs), dt)
            ek = jax.random.split(k_edges, E + 1)
            choices = jax.random.categorical(ek[0], jnp.log(probs),
                                             shape=(E, cfg.num_legs))

            def one_edge(k, ch):
                prims = generate_trajectory_device(k, ch, distance, cfg,
                                                   num_legs=cfg.num_legs)
                return (*self._edge_stats(prims, src_xy, dst_xy), prims)

            (feas, e_budget, e_time, e_q, e_pts, e_var,
             e_prims) = jax.vmap(one_edge)(ek[1:], choices)
            feas = feas & active
            ebase = (PH * it + phase) * E
            state = dict(
                state,
                n_feas=(state["n_feas"]
                        + jnp.sum(feas).astype(jnp.int32)),
                edge_pts=jax.lax.dynamic_update_slice(
                    state["edge_pts"], e_pts, (ebase, 0, 0)),
                edge_prims=jax.lax.dynamic_update_slice(
                    state["edge_prims"], e_prims, (ebase, 0, 0)),
                edge_src=jax.lax.dynamic_update_slice(
                    state["edge_src"],
                    jnp.full((E,), src_idx, jnp.int32), (ebase,)),
                edge_dst=jax.lax.dynamic_update_slice(
                    state["edge_dst"],
                    jnp.full((E,), dst_idx, jnp.int32), (ebase,)))

            # DP: extend every source path slot by every feasible edge
            src_slots = _row(state["node_paths"], src_idx)  # (MAXP,)
            src_valid = src_slots >= 0
            sb = _rows(state["a_budget"], src_slots)
            st = _rows(state["a_time"], src_slots)
            xb = (sb[:, None] + e_budget[None, :]).reshape(-1)
            xt = (st[:, None] + e_time[None, :]).reshape(-1)
            ok = ((src_valid[:, None] & feas[None, :]).reshape(-1)
                  & (xb < B))
            abase = 1 + (PH * it + phase) * MAXP

            if not gain_mode:
                scored = ok & (xb > self.budget_cutoff * B)
                # scores are cheap (additive stats): score ALL extensions,
                # beam by score. NaN note: infeasible entries can carry
                # NaNs from masked-out synthesis branches — force them
                # below every real key.
                sq = _rows(state["a_q"], src_slots)
                xq = sq[:, :, None] + e_q.T[None, :, :]  # (MAXP, nst, E)
                xq = jnp.transpose(xq, (0, 2, 1)).reshape(MAXP * E, nstats)
                if self.cost == "fourier":
                    scnt = _rows(state["a_cnt"], src_slots)
                    xcnt = (scnt[:, None]
                            + jnp.full((1, E), float(S), dt)).reshape(-1)
                    scores = jax.vmap(
                        lambda q, c: self._score_fourier(q, c, f_target))(
                        xq, xcnt)
                else:
                    scores = jax.vmap(
                        lambda q, T: self._score(q, T, p_eid))(xq, xt)
                scores = jnp.where(scored, scores,
                                   jnp.where(ok, SENTINEL, NEG))
                # scored: by score (lower budget tie-break). Unscored:
                # prefer HIGHER budget — those paths are closest to the
                # budget_cutoff scoring band; preferring cheap ones starves
                # budget accumulation and deep bands never score (the host
                # planner keeps every path, so it has no such pressure)
                key_rank = jnp.where(
                    scored, scores - 1e-6 * xb,
                    jnp.where(ok, SENTINEL + 1e-6 * xb, NEG))
                top = jax.lax.top_k(key_rank, MAXP)[1]
                sel_ok = _rows(ok, top)
                top_scored = _rows(scored, top)
                top_scores = _rows(scores, top)
                blk_real = jnp.where(top_scored & sel_ok, top_scores, NEG)
                a_score_blk = jnp.where(sel_ok, top_scores, NEG)
                state = dict(state, a_q=jax.lax.dynamic_update_slice(
                    state["a_q"], _rows(xq, top), (abase, 0)))
                if self.cost == "fourier":
                    state = dict(state, a_cnt=jax.lax.dynamic_update_slice(
                        state["a_cnt"], _rows(xcnt, top), (abase,)))
            else:
                # gain mode, score-everything: per-path bordered-Cholesky
                # carries make the sequential gain additive per edge, so
                # EVERY eligible extension is scored exactly (host
                # updatePathList semantics, reference/GraceRIGV3.py:
                # 1157-1170). Extensions that would exceed the P-point
                # carry capacity are infeasible (never mis-scored).
                # contiguous-block dynamic slices (NOT one-hot selects:
                # c_L is the big carry buffer — a dense masked read would
                # stream all MAXN rows per extend)
                ppts = state["c_pts"][src_idx]   # (MAXP, P, 4)
                pnp = state["c_np"][src_idx]     # (MAXP,)
                pgain = state["c_gain"][src_idx]
                Lp = state["c_L"][src_idx]       # (MAXP, P, P)
                ok = ok & jnp.repeat(pnp + S <= P, E)
                scored = ok & (xb > self.budget_cutoff * B)
                e_xyz = e_pts[:, :, :3]          # (E, S, 3)
                if mf:
                    e_fid = jax.vmap(flabels)(e_var)        # (E, S)
                    fid0 = jnp.zeros((S,), jnp.int32)
                    p_fid = jax.vmap(flabels)(ppts[:, :, 3])  # (MAXP, P)

                # per-edge posterior projections against the train set
                def eprep(xyz, fid_c):
                    if mf:
                        Kx_c = cov_c(X_pad, fid_pad, xyz, fid_c)  # (N, S)
                        A_c = Kinv @ Kx_c
                        D_cc = (cov_c(xyz, fid_c, xyz, fid_c)
                                + jnp.diag(_k.mf_noise_diag(fid_c, noises))
                                - Kx_c.T @ A_c)
                    else:
                        Kx_c = kern(X_pad, xyz, variance, lengthscales)
                        A_c = Kinv @ Kx_c
                        D_cc = (kern(xyz, xyz, variance, lengthscales)
                                + noise * jnp.eye(S, dtype=dt)
                                - Kx_c.T @ A_c)
                    if ld_mode:
                        # latent grid<->edge posterior cross-cov | train
                        Cgs = (cov_c(grid_j, fid_g, xyz, fid_c)
                               - Ag.T @ Kx_c)  # (G, S)
                        return Kx_c, Kx_c, D_cc, Cgs, jnp.zeros((S,), dt)
                    if mf:
                        Kx_p = cov_c(X_pad, fid_pad, xyz, fid0)
                        A_p = Kinv @ Kx_p
                        Sig_cp = (cov_c(xyz, fid_c, xyz, fid0)
                                  - Kx_c.T @ A_p)
                        kpp = jnp.sum((Wf[:, fid0] ** 2)
                                      * variances[:, None], axis=0)
                        sig_pp = kpp - jnp.sum(Kx_p * A_p, axis=0)
                        return Kx_c, Kx_p, D_cc, Sig_cp, sig_pp
                    return Kx_c, Kx_c, D_cc, D_cc, jnp.zeros((S,), dt)

                (eKx_c, eKx_p, eD_cc, eSig_cp, esig_pp) = jax.vmap(eprep)(
                    e_xyz, e_fid if mf else jnp.zeros((E, S), jnp.int32))

                # per-path prefix projection (masked rows beyond n)
                Lp_all = Lp

                def pprep(pts_i, n_i, fid_i, Lp_i):
                    m = jnp.arange(P) < n_i
                    Kpx = cov_c(pts_i[:, :3], fid_i, X_pad,
                                fid_pad if mf else None)
                    Kpx = jnp.where(m[:, None], Kpx, 0.0)
                    Rp_i = Kpx @ Kinv  # (P, N)
                    if not ld_mode:
                        return Rp_i, jnp.zeros((P, 1), dt)
                    # whitened prefix<->grid posterior cross-cov | train
                    Kpg = cov_c(pts_i[:, :3], fid_i, grid_j, fid_g)
                    Kpg = jnp.where(m[:, None], Kpg, 0.0)
                    Vg_i = _la.tri_solve(Lp_i, Kpg - Rp_i @ Kxg)  # (P, G)
                    return Rp_i, Vg_i

                if mf:
                    Rp, Vg = jax.vmap(pprep)(ppts, pnp, p_fid, Lp_all)
                else:
                    Rp, Vg = jax.vmap(
                        lambda p, n, L_: pprep(p, n, None, L_))(
                        ppts, pnp, Lp_all)

                strict_lower_S = jnp.tril(jnp.ones((S, S), bool), k=-1)
                if ld_mode:
                    csig_src = state["c_sig"][src_idx]  # (MAXP, G, G)

                def pair(ip, ie):
                    """Exact score of extending path ip by edge ie + the
                    bordered factor pieces for the carry."""
                    n_i = pnp[ip]
                    m = jnp.arange(P) < n_i
                    xyzp = ppts[ip][:, :3]
                    xyz_e = e_xyz[ie]
                    fc = e_fid[ie] if mf else None
                    fp = p_fid[ip] if mf else None
                    Kpn_cc = cov_c(xyzp, fp, xyz_e, fc)
                    Kpn_cc = jnp.where(m[:, None], Kpn_cc, 0.0)
                    # latent posterior cross-cov prefix<->new given train
                    Sig_cc = Kpn_cc - Rp[ip] @ eKx_c[ie]
                    U = _la.tri_solve(Lp[ip], Sig_cc)  # (P, S)
                    Schur = eD_cc[ie] - U.T @ U
                    Ls = _la.chol(Schur)
                    if ld_mode:
                        # rank-S grid-cov downdate; score = batch mutual
                        # information over the grid (host _logdet_gain_one
                        # / _mf_logdet_gain_one semantics)
                        Cgs = eSig_cp[ie] - Vg[ip].T @ U  # (G, S)
                        W = _la.tri_solve(Ls, Cgs.T)  # (S, G)
                        Sig_new = csig_src[ip] - W.T @ W
                        sc = 0.5 * (ld_prior - _la.logdet_from_chol(
                            _la.chol(Sig_new + g_noise * eyeG)))
                        if not mf:  # the reference's SF variant clamps
                            sc = jnp.maximum(sc, 0.0)
                        return sc, U, Ls, W
                    if not mf:
                        v = jnp.diagonal(Ls) ** 2
                        terms = jnp.log(1.0 + v / noise)
                        # first-point self-conditioning quirk at path start
                        # (reference/GraceRIGV3.py:454-456)
                        a = eD_cc[ie][0, 0] - noise
                        t0 = jnp.log(
                            1.0 + (a - a * a / (a + noise) + noise) / noise)
                        terms = terms.at[0].set(
                            jnp.where(n_i == 0, t0, terms[0]))
                        return jnp.sum(terms), U, Ls
                    Kpn_cp = cov_c(xyzp, fp, xyz_e, fid0)
                    Kpn_cp = jnp.where(m[:, None], Kpn_cp, 0.0)
                    Sig_cp_pfx = Kpn_cp - Rp[ip] @ eKx_p[ie]
                    B_top = _la.tri_solve(Lp[ip], Sig_cp_pfx)  # (P, S)
                    Mx = eSig_cp[ie] - U.T @ B_top
                    B_bot = _la.tri_solve(Ls, Mx)  # (S, S)
                    w = (jnp.sum(B_top ** 2, axis=0)
                         + jnp.sum(jnp.where(strict_lower_S.T,
                                             B_bot ** 2, 0.0), axis=0))
                    v = esig_pp[ie] - w + noises[0]
                    return (jnp.sum(jnp.log(1.0 + v / noises[0])),
                            U, Ls)

                ips = jnp.repeat(jnp.arange(MAXP), E)
                ies = jnp.tile(jnp.arange(E), MAXP)
                if ld_mode:
                    inc, U_all, Ls_all, W_all = jax.vmap(pair)(ips, ies)
                    gains = inc  # direct scores (not additive increments)
                else:
                    inc, U_all, Ls_all = jax.vmap(pair)(ips, ies)
                    gains = jnp.repeat(pgain, E) + inc  # (MAXP*E,)
                finite = jnp.isfinite(gains)
                gains = jnp.where(finite, gains, NEG)
                ok = ok & finite
                scored = scored & finite
                # beam selection: scored extensions outrank unscored;
                # within a tier, by accumulated gain (cheaper ties first).
                # Lexicographic (tier, key) sort keeps f32 gains exact.
                tier = jnp.where(ok, jnp.where(scored, 1, 0), -1)
                top = _lex_top_idx(tier, gains - 1e-6 * xb, MAXP)
                sel_ok = _rows(ok, top)
                top_scored = _rows(scored, top)
                top_scores = _rows(gains, top)
                blk_real = jnp.where(top_scored & sel_ok, top_scores, NEG)
                a_score_blk = jnp.where(
                    sel_ok, jnp.where(top_scored, top_scores, SENTINEL),
                    NEG)

                # build the selected extensions' carries
                ip_s, ie_s = _rows(ips, top), _rows(ies, top)
                n_s = _rows(pnp, ip_s)
                exyzv = jnp.concatenate(
                    [_rows(e_xyz, ie_s), _rows(e_var, ie_s)[:, :, None]],
                    axis=2)
                new_pts = jax.vmap(
                    lambda p, e, n0: jax.lax.dynamic_update_slice(
                        p, e, (n0, jnp.zeros((), jnp.int32))))(
                    _rows(ppts, ip_s), exyzv, n_s)
                new_np = n_s + S

                def border(Lpi, Ui, Lsi, n0):
                    rowblk = jax.lax.dynamic_update_slice(
                        Ui.T, Lsi, (jnp.zeros((), jnp.int32), n0))
                    return jax.lax.dynamic_update_slice(
                        Lpi, rowblk, (n0, jnp.zeros((), jnp.int32)))

                new_L = jax.vmap(border)(_rows(Lp, ip_s), _rows(U_all, top),
                                         _rows(Ls_all, top), n_s)
                new_gain = top_scores
                eyeP = jnp.eye(P, dtype=dt)
                new_L = jnp.where(sel_ok[:, None, None], new_L, eyeP)
                new_pts = jnp.where(sel_ok[:, None, None], new_pts, 0.0)
                new_np = jnp.where(sel_ok, new_np, 0).astype(jnp.int32)
                new_gain = jnp.where(sel_ok, new_gain, 0.0)
                if ld_mode:
                    W_s = _rows(W_all, top)  # (MAXP, S, G)
                    new_sig = (_rows(csig_src, ip_s)
                               - jnp.einsum("ksg,ksh->kgh", W_s, W_s))
                    new_sig = jnp.where(sel_ok[:, None, None], new_sig,
                                        Sig0)

            prev = _rows(src_slots, top // E)
            edge_ids = ebase + (top % E)
            blk_budget = _rows(xb, top)
            state = dict(
                state,
                a_budget=jax.lax.dynamic_update_slice(
                    state["a_budget"], blk_budget, (abase,)),
                a_time=jax.lax.dynamic_update_slice(
                    state["a_time"], _rows(xt, top), (abase,)),
                a_score=jax.lax.dynamic_update_slice(
                    state["a_score"], a_score_blk, (abase,)),
                a_prev=jax.lax.dynamic_update_slice(
                    state["a_prev"],
                    jnp.where(sel_ok, prev, -1).astype(jnp.int32),
                    (abase,)),
                a_edge=jax.lax.dynamic_update_slice(
                    state["a_edge"],
                    jnp.where(sel_ok, edge_ids, -1).astype(jnp.int32),
                    (abase,)),
                a_node=jax.lax.dynamic_update_slice(
                    state["a_node"],
                    jnp.where(sel_ok, dst_idx, 0).astype(jnp.int32),
                    (abase,)),
            )

            # merge the new block into dst's beam
            new_idx = (abase + jnp.arange(MAXP)).astype(jnp.int32)
            new_idx = jnp.where(sel_ok, new_idx, -1)
            old_idx = _row(state["node_paths"], dst_idx)
            cand = jnp.concatenate([old_idx, new_idx])
            sc_c = _rows(state["a_score"], cand)
            # _rows zeroes invalid (-1) rows; a real arena score can be 0,
            # so force invalid cand entries to the sentinelless NEG
            sc_c = jnp.where(cand >= 0, sc_c, NEG)
            bu_c = _rows(state["a_budget"], cand)
            if gain_mode:
                # rank by accumulated gain (scored entries above unscored,
                # cheaper ties first); the root pin dominates everything
                cand_gain = jnp.concatenate(
                    [_row(state["c_gain"], dst_idx), new_gain])
                ctier = jnp.where(
                    cand >= 0,
                    jnp.where(sc_c >= PIN * 0.5, 2,
                              jnp.where(sc_c != SENTINEL, 1, 0)), -1)
                ckey = cand_gain - 1e-6 * bu_c
                keep = _lex_top_idx(ctier, ckey, MAXP)
                beam = jnp.where(_rows(ctier, keep) >= 0,
                                 _rows(cand, keep), -1).astype(jnp.int32)
            else:
                # beams rank scored paths by score (cheaper ties first) and
                # sentinel (unscored) paths by HIGHER budget
                ck = jnp.where(cand >= 0,
                               jnp.where(sc_c == SENTINEL,
                                         SENTINEL + 1e-6 * bu_c,
                                         sc_c - 1e-6 * bu_c), NEG)
                keep = jax.lax.top_k(ck, MAXP)[1]
                beam = jnp.where(_rows(ck, keep) > NEG,
                                 _rows(cand, keep), -1).astype(jnp.int32)
            admitted = jnp.any(beam >= 0) & active
            state = dict(
                state,
                node_paths=_set_row(state["node_paths"], dst_idx, beam,
                                    active),
                nodes=_set_row(state["nodes"], dst_idx, dst_xy, active),
                n_nodes=jnp.where(admitted & ~merge & have_room,
                                  n_nodes + 1, n_nodes).astype(jnp.int32),
            )
            if gain_mode:
                # gather the surviving entries' carries into dst's slots
                bvalid = beam >= 0
                cL = _rows(jnp.concatenate([state["c_L"][dst_idx], new_L]),
                           keep)
                cP = _rows(jnp.concatenate([state["c_pts"][dst_idx],
                                            new_pts]), keep)
                cN = _rows(jnp.concatenate([state["c_np"][dst_idx],
                                            new_np]), keep)
                cG = _rows(jnp.concatenate([state["c_gain"][dst_idx],
                                            new_gain]), keep)
                cL = jnp.where(bvalid[:, None, None], cL, eyeP)
                cP = jnp.where(bvalid[:, None, None], cP, 0.0)
                cN = jnp.where(bvalid, cN, 0).astype(jnp.int32)
                cG = jnp.where(bvalid, cG, 0.0)
                upd = active
                state = dict(
                    state,
                    c_L=state["c_L"].at[dst_idx].set(
                        jnp.where(upd, cL, state["c_L"][dst_idx])),
                    c_pts=state["c_pts"].at[dst_idx].set(
                        jnp.where(upd, cP, state["c_pts"][dst_idx])),
                    c_np=state["c_np"].at[dst_idx].set(
                        jnp.where(upd, cN, state["c_np"][dst_idx])),
                    c_gain=state["c_gain"].at[dst_idx].set(
                        jnp.where(upd, cG, state["c_gain"][dst_idx])),
                )
                if ld_mode:
                    cS = _rows(jnp.concatenate(
                        [state["c_sig"][dst_idx], new_sig]), keep)
                    cS = jnp.where(bvalid[:, None, None], cS, Sig0)
                    state = dict(state, c_sig=state["c_sig"].at[
                        dst_idx].set(jnp.where(upd, cS,
                                               state["c_sig"][dst_idx])))

            # global best (scored extensions only; lower budget tie-break).
            # the best SCORED extension always ranks inside the arena block
            # (its key carries the scored bonus / sorts above sentinel), so
            # its arena index is abase + its position within the block.
            # mask the key: budgets of infeasible rows can be NaN, and
            # argmax treats NaN as maximal
            blk_key = jnp.where(blk_real > NEG,
                                blk_real - 1e-9 * blk_budget, NEG)
            pos = jnp.argmax(blk_key)
            cand_s, cand_b = blk_real[pos], blk_budget[pos]
            better = ((cand_s > state["best_score"])
                      | ((cand_s == state["best_score"])
                         & (cand_b < state["best_budget"])))
            better = better & (cand_s > NEG)
            state = dict(
                state,
                best_score=jnp.where(better, cand_s, state["best_score"]),
                best_budget=jnp.where(better, cand_b,
                                      state["best_budget"]),
                best_arena=jnp.where(better, abase + pos,
                                     state["best_arena"]).astype(jnp.int32),
            )
            return state

        def body(it, state):
            key, k1 = jax.random.split(state["key"])
            state = dict(state, key=key)
            xsamp = lo + (hi - lo) * jax.random.uniform(k1, (2,), dt)
            nodes, n_nodes = state["nodes"], state["n_nodes"]
            d = jnp.linalg.norm(nodes - xsamp[None, :], axis=1)
            valid = jnp.arange(MAXN) < n_nodes
            ring = jnp.where(valid, (self.Rd - d) ** 2, jnp.inf)
            i_near = jnp.argmin(ring)
            # steer
            v = xsamp - nodes[i_near]
            dist = jnp.linalg.norm(v)
            step = jnp.minimum(dist, self.delta)
            xfeas = nodes[i_near] + jnp.where(dist > 0, step / dist, 0.0) * v
            # near-set BEFORE the phase-0 extend: the host extends
            # PRE-existing nodes within R (reference/GraceRIGV3.py:1284-
            # 1337); computing d2 afterwards would always pick the node
            # phase 0 just created at xfeas — a guaranteed self-merge no-op
            d2 = jnp.linalg.norm(nodes - xfeas[None, :], axis=1)
            d2 = jnp.where((jnp.arange(MAXN) < n_nodes)
                           & (jnp.arange(MAXN) != i_near), d2, jnp.inf)
            state = extend(state, i_near, xfeas, 0, it)
            # near phases: the K closest pre-existing OTHER nodes within R
            # each steer toward xfeas (K caps the host's every-near-node
            # loop for static shapes)
            _, near_js = jax.lax.top_k(-d2, self.K)
            for k in range(self.K):
                j = near_js[k]
                has_near = d2[j] <= self.R
                v2 = xfeas - state["nodes"][j]
                dist2 = jnp.linalg.norm(v2)
                step2 = jnp.minimum(dist2, self.delta)
                x2 = state["nodes"][j] + jnp.where(dist2 > 0,
                                                   step2 / dist2, 0.0) * v2
                x2 = jnp.where(has_near, x2, lo - 1.0)  # out of WS: inactive
                state = extend(state, j, x2, 1 + k, it)
            return state

        state = jax.lax.fori_loop(0, self.max_iter, body, state)
        # carries are working state, not results — don't ship them home
        for k in ("c_L", "c_pts", "c_np", "c_gain", "c_sig", "a_q",
                  "a_cnt"):
            state.pop(k, None)
        return state

    def _args(self, x0, B, eid, gp):
        eid_arr = (self._eid if eid is None
                   else jnp.asarray(np.asarray(eid, float).reshape(-1),
                                    self.dtype))
        if eid_arr is None:
            if self.cost in STAT_COSTS:
                raise ValueError(f"{self.cost} scoring needs an eid "
                                 "(constructor or plan argument)")
            eid_arr = jnp.ones((1,), self.dtype)  # unused in gain mode
        if gp is None and self.cost in GAIN_COSTS + LOGDET_COSTS:
            raise ValueError(
                "gain/logdet scoring needs the conditioned GP state: pass "
                "gp=prepare_sf_gain_state(...)/prepare_mf_gain_state(...)")
        if gp is None:
            z = jnp.zeros((1, 1), self.dtype)
            if self.cost in ("mf_gain", "mf_logdet"):
                gp = (jnp.zeros((1, 3), self.dtype),
                      jnp.zeros((1,), jnp.int32), z,
                      jnp.ones((3,), self.dtype),
                      jnp.ones((3, 3), self.dtype),
                      jnp.ones((2,), self.dtype),
                      jnp.ones((3,), self.dtype),
                      jnp.ones((2,), self.dtype))
            else:
                gp = (jnp.zeros((1, 3), self.dtype), z,
                      jnp.ones((), self.dtype), jnp.ones((3,), self.dtype),
                      jnp.ones((), self.dtype))
        else:
            gp = tuple(a if (hasattr(a, "dtype")
                             and jnp.issubdtype(a.dtype, jnp.integer))
                       else jnp.asarray(a, self.dtype) for a in gp)
        return (jnp.asarray(np.asarray(x0, float).reshape(-1), self.dtype),
                jnp.asarray(B if B is not None else self.B, self.dtype),
                eid_arr, gp)

    def plan(self, x0, key, B=None, eid=None, gp=None,
             gather: bool = False) -> DevicePlanResult:
        """Run the on-device loop, extract the best path on host.

        ``B`` (budget), ``eid`` (ergodic target), and ``gp`` (the
        conditioned GP for gain scoring, prepare_sf_gain_state) override
        the constructor defaults WITHOUT recompiling — they are traced
        arguments, so one compiled executable serves every replan of an
        exploration run.

        ``gather=True`` traces (and caches) a second solo executable with
        gather-lowered index ops — the A/B partner for the default
        one-hot form (bench.py times both)."""
        x0j, Bj, eidj, gpj = self._args(x0, B, eid, gp)
        if gather:
            if self._plan_jit_gather is None:
                self._plan_jit_gather = jax.jit(self._plan_impl)
            with _index_gather(True):
                st = self._plan_jit_gather(x0j, key, Bj, eidj, gpj)
            return self._extract(st)
        with _index_gather(False):  # solo plans: one-hot form
            st = self._plan_jit(x0j, key, Bj, eidj, gpj)
        return self._extract(st)

    def plan_ensemble(self, x0, key, n_plans: int = 8, B=None,
                      eid=None, gp=None, mesh=None) -> DevicePlanResult:
        """K independent planner instances in ONE vmapped launch; the
        best-scoring plan wins (ties break toward lower budget).

        Lanes fill the idle compute of the latency-bound solo loop, so an
        ensemble costs less than the same plans run serially. Under
        ``mesh`` sharding the instances partition over dp with zero
        collectives.
        """
        x0j, Bj, eidj, gpj = self._args(x0, B, eid, gp)
        keys = jax.random.split(key, n_plans)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from mfgp_jax.parallel.mesh import DP_AXIS

            keys = jax.device_put(keys, NamedSharding(mesh, P(DP_AXIS)))
        if self._ensemble_jit is None:
            self._ensemble_jit = jax.jit(jax.vmap(
                self._plan_impl, in_axes=(None, 0, None, None, None)))
        with _index_gather(True):  # vmapped lanes: gather form
            sts = dict(self._ensemble_jit(x0j, keys, Bj, eidj, gpj))
        sts.pop("key")  # PRNG keys don't convert to numpy (and aren't used)
        scores = np.asarray(sts["best_score"])
        budgets = np.asarray(sts["best_budget"])
        i = int(np.lexsort((budgets, -scores))[0])
        return self._extract(jax.tree.map(lambda a: np.asarray(a)[i], sts))

    def plan_batch(self, x0s, keys, Bs, eid=None,
                   gp=None) -> list[DevicePlanResult]:
        """K INDEPENDENT (start, key, budget) planner lanes in ONE vmapped
        launch — the fleet-serving form of :meth:`plan_ensemble`:
        concurrent replan requests against the same model (shared
        ``eid``/``gp``) coalesce into a single executable
        (serve.PlannerService batches /plan this way). Lanes are padded
        to the next power of two by repeating lane 0, so the compile
        cache grows logarithmically in fleet size. Batching x0/B along
        with the keys costs the same as plan_ensemble at matched
        settings, with one device round-trip for the whole fleet."""
        x0s = np.atleast_2d(np.asarray(x0s, float))
        K = x0s.shape[0]
        if keys.shape[0] != K:
            raise ValueError("keys must align with x0s")
        Bs = np.broadcast_to(np.asarray(Bs, float).reshape(-1), (K,))
        # defaults/validation shared across lanes
        _, _, eidj, gpj = self._args(x0s[0], None, eid, gp)
        pad = 1
        while pad < K:
            pad *= 2
        idx = np.concatenate([np.arange(K), np.zeros(pad - K, np.intp)])
        x0j = jnp.asarray(x0s[idx], self.dtype)
        Bj = jnp.asarray(Bs[idx], self.dtype)
        keysj = keys[jnp.asarray(idx)]
        if self._batch_jit is None:
            self._batch_jit = jax.jit(jax.vmap(
                self._plan_impl, in_axes=(0, 0, 0, None, None)))
        with _index_gather(True):  # vmapped lanes: gather form
            sts = dict(self._batch_jit(x0j, keysj, Bj, eidj, gpj))
        sts.pop("key")  # PRNG keys don't convert to numpy (and aren't used)
        sts = jax.tree.map(np.asarray, sts)  # ONE device->host transfer
        return [self._extract(jax.tree.map(lambda a: a[i], sts))
                for i in range(K)]

    def _extract(self, st) -> DevicePlanResult:
        best = int(st["best_arena"])
        n_nodes = int(st["n_nodes"])
        n_feas = int(st["n_feas"])
        nodes = np.asarray(st["nodes"])[:n_nodes]
        a_prev = np.asarray(st["a_prev"])
        a_edge = np.asarray(st["a_edge"])
        edge_pts = np.asarray(st["edge_pts"])
        edge_prims = np.asarray(st["edge_prims"])
        edge_src = np.asarray(st["edge_src"])
        edge_dst = np.asarray(st["edge_dst"])
        all_nodes = np.asarray(st["nodes"])
        # admitted-extension chronology from the arena: entries with a
        # real backing edge, in arena (= insertion) order; the arena block
        # index encodes the planning iteration
        kept = np.nonzero(a_edge >= 0)[0]
        eids = a_edge[kept]
        its = (kept - 1) // ((1 + self.K) * self.max_paths)
        trace = np.column_stack([
            its.astype(float),
            all_nodes[edge_src[eids]], all_nodes[edge_dst[eids]],
            eids.astype(float)]) if kept.size else np.zeros((0, 6))
        if best < 0:
            return DevicePlanResult(-np.inf, 0.0, 0.0, np.zeros((0, 4)),
                                    n_nodes, nodes, [],
                                    n_feasible_edges=n_feas, trace=trace)
        chain = []
        i = best
        while i > 0:
            chain.append(int(a_edge[i]))
            i = int(a_prev[i])
        chain.reverse()
        rows, edges, t_off = [], [], 0.0
        for e in chain:
            pts = edge_pts[e].copy()
            pts[:, 3] += t_off
            t_off = pts[-1, 3]
            rows.append(pts)
            edges.append((edge_prims[e], all_nodes[edge_src[e]],
                          all_nodes[edge_dst[e]]))
        points = np.concatenate(rows, axis=0) if rows else np.zeros((0, 4))
        return DevicePlanResult(
            float(st["best_score"]), float(st["a_budget"][best]),
            float(st["a_time"][best]), points, n_nodes, nodes, edges,
            truncated=False, n_feasible_edges=n_feas, trace=trace)


def prepare_sf_gain_state(model, n_max: int, dtype=jnp.float32):
    """Pad a conditioned single-fidelity GP to a STATIC train size for the
    device planner's gain scoring (one compiled plan() across replans as
    the training set grows).

    Dummy rows sit at a far sentinel coordinate (kernel values underflow
    to 0, so cross-covariances to them vanish) and the factor is extended
    block-diagonally with the identity — the padded posterior equals the
    real one exactly. Returns (X_pad, L_pad, variance, lengthscales,
    noise) for ``DeviceRIG.plan(gp=...)``.
    """
    X = np.asarray(model.state.X)
    L = np.asarray(model.state.L)
    n, D = X.shape
    if n > n_max:
        raise ValueError(f"train size {n} exceeds n_max={n_max}")
    X_pad = np.full((n_max, D), 1e6)
    X_pad[:n] = X
    L_pad = np.eye(n_max)
    L_pad[:n, :n] = L
    p = model.params
    return (jnp.asarray(X_pad, dtype), jnp.asarray(L_pad, dtype),
            jnp.asarray(p.variance, dtype),
            jnp.asarray(p.lengthscales, dtype),
            jnp.asarray(p.noise, dtype))


def prepare_mf_gain_state(model, fid_levels, n_max: int,
                          dtype=jnp.float32):
    """MF counterpart of prepare_sf_gain_state: pad the conditioned AR1
    multi-fidelity GP to a static train size. Returns (X_pad, fid_pad,
    L_pad, variances, lengthscales, rhos, noises, fid_levels) for
    ``DeviceRIG(cost="mf_gain").plan(gp=...)``."""
    X = np.asarray(model.state.X)
    fid = np.asarray(model.state.fid)
    L = np.asarray(model.state.L)
    n, D = X.shape
    if n > n_max:
        raise ValueError(f"train size {n} exceeds n_max={n_max}")
    X_pad = np.full((n_max, D), 1e6)
    X_pad[:n] = X
    fid_pad = np.zeros(n_max, np.int32)
    fid_pad[:n] = fid
    L_pad = np.eye(n_max)
    L_pad[:n, :n] = L
    p = model.params
    F = int(np.asarray(p.variances).shape[0])
    fl = np.asarray(fid_levels, float)
    if fl.shape[0] < F - 1:  # host fids_from_variance raises too
        raise ValueError(
            f"need {F - 1} fidelity thresholds, got {fl.shape[0]}")
    fl = fl[: F - 1]
    return (jnp.asarray(X_pad, dtype), jnp.asarray(fid_pad),
            jnp.asarray(L_pad, dtype), jnp.asarray(p.variances, dtype),
            jnp.asarray(p.lengthscales, dtype), jnp.asarray(p.rhos, dtype),
            jnp.asarray(p.noises, dtype), jnp.asarray(fl, dtype))


class DeviceRIGAdapter:
    """Drop-in shim exposing the host RIGPlanner's sim-facing surface
    (``plan(x0)`` / ``best_path_points`` / ``graph_summary``) over a
    DeviceRIG, so ``sim.ExplorationSim(planner_backend="device")`` swaps
    the whole planning loop onto the device without touching the sim.
    One instance serves every replan: budget tranche, EID, and seed are
    per-plan arguments, not compile-time constants."""

    def __init__(self, seed: int = 0, n_plans: int = 1, mesh=None, **kw):
        self._planner = DeviceRIG(**kw)
        self._seed = seed
        self._n_plans = int(n_plans)
        self._mesh = mesh  # shard the ensemble axis over its dp extent
        self._res: Optional[DevicePlanResult] = None

    def plan(self, x0, seed: int | None = None, B=None, eid=None,
             gp=None):
        key = jax.random.key(self._seed if seed is None else seed)
        x0r = np.asarray(x0, float).reshape(-1)
        if self._n_plans > 1:
            self._res = self._planner.plan_ensemble(
                x0r, key, n_plans=self._n_plans, B=B, eid=eid, gp=gp,
                mesh=self._mesh)
        else:
            self._res = self._planner.plan(x0r, key, B=B, eid=eid, gp=gp)
        r = self._res

        class _Best:
            info = r.info
            budget = r.budget
            segments = r.points if r.points.shape[0] else None

        return _Best()

    def plan_batch(self, x0s, seeds, Bs, eid=None,
                   gp=None) -> list[DevicePlanResult]:
        """Independent per-request plans as ONE vmapped launch (see
        DeviceRIG.plan_batch). Stateless: does NOT update the
        ``best_path_points``/``graph_summary`` cache — each returned
        DevicePlanResult carries its own path/summary fields."""
        if self._n_plans > 1:
            raise ValueError("plan_batch is for single-plan services; "
                             "n_plans>1 ensembles already batch")
        keys = jax.vmap(jax.random.key)(
            jnp.asarray(list(seeds), jnp.uint32))
        return self._planner.plan_batch(x0s, keys, Bs, eid=eid, gp=gp)

    def best_path_points(self, dense: bool = True):
        if self._res is None or self._res.points.shape[0] == 0:
            return None
        return self._res.points  # (P, 4) x, y, z, t — the sim's schema

    def flight_plan(self):
        """(waypoints, legs) of the best plan for the robot runtime —
        the device-planner counterpart of hw.runtime.flight_plan: per-edge
        primitives are rolled out on host and rotated by the edge bearing
        (reference pathPoints/edgeChain, reference/...MFEGP.py:449-461)."""
        from mfgp_jax.hw.runtime import chain_to_flight_plan
        from mfgp_jax.planning.primitives_device import padded_to_prims

        if self._res is None or not self._res.edges:
            return None, None
        triples = [(padded_to_prims(p), src, dst)
                   for p, src, dst in self._res.edges]
        return chain_to_flight_plan(triples, self._planner.cfg)

    def graph_summary(self):
        return {"nodes": self._res.n_nodes if self._res else 0,
                # feasible candidate edges admitted to the graph, counted
                # in the loop (NOT launch capacity)
                "edges": (self._res.n_feasible_edges if self._res else 0),
                "best_info": self._res.info if self._res else -np.inf,
                "best_budget": self._res.budget if self._res else 0.0}
