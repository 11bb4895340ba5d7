"""The WHOLE exploration experiment as ONE jitted XLA program.

The reference's drivers (reference/PhysicalExperimentCode/
GraceExplorationExperiments_{MFEGP,MFGP,SFEGP,SFGP}.py, SURVEY C25) run a
host loop per mission: replan -> fly the plan -> accumulate fidelity-binned
measurements -> retrain the GP -> recompute the EID -> next tranche. Our
``sim.ExplorationSim`` rebuilds that loop with device *pieces* (one-launch
planner, online conditioning) orchestrated from the host; each replan
still pays several host<->device round-trips.

This module closes the loop ON the device: a ``lax.fori_loop`` over budget
tranches where every stage of every replan —

    arena posterior -> EID -> DeviceRIG plan (the full sampling/synthesis/
    beam-DP/scoring loop) -> best-path chain extraction -> KF flight along
    the path -> field measurement + fidelity binning -> masked bordered-
    Cholesky extension of the training arena

— is traced into a single XLA program. ``run()`` is ONE device launch for
the entire mission; nothing crosses the host boundary until the final
artifacts come home.

``flight="dynamic"`` replaces the kinematic KF flight with the device
runtime scan (hw/runtime_device.py): each plan's chain assembles
in-graph into a waypoint/leg program (`_chain_plan`) and is FLOWN
through the full sense->estimate->control loop — glider plant dynamics,
sensor noise, the four KFs, the body-velocity observer, and the four
per-primitive control laws — still inside the same single launch. The
entire reference experiment, vehicle dynamics included, is then one XLA
program; samples carry fidelity labels from the live position-KF
covariance, replans start from the robot's belief (reference
:428-439), and per-replan tracking RMSE / integrated flight energy are
recorded.

Design notes:

* **Static-capacity arena.** The training set grows inside a fixed
  ``(n_max, n_max)`` Cholesky arena, exactly the padding contract of
  ``planning.rig_device.prepare_sf_gain_state``: padding rows sit at a far
  sentinel coordinate (kernel values underflow to exactly 0) with identity
  factor rows, so the padded posterior equals the real one *exactly*.
  Extending by a flight's measurements is a masked rank-S bordered update:
  invalid (padding) rows border as identity and stay inert forever.
* **One compile for everything.** Budget tranche, EID, and the arena are
  traced values; the planner's ``_plan_impl`` inlines into the mission
  program, so the DP arenas, the flight filter, and the GP algebra fuse
  into one executable reused across seeds.
* **Masked replans, not dynamic trips.** The budget-termination rule
  (reference/...MFEGP.py:341: stop when the remaining budget is under half
  a tranche) becomes an ``active`` flag that turns trailing loop
  iterations into no-ops with bit-identical state.

Semantics matched to ``ExplorationSim`` (kinematic flight, frozen
hyperparameters — the host loop's ``fit_mode="extend"`` regime):

* EID: posterior on the dense sim grid -> ``expected_information_density``
  (reference/exploreSimSettings.py:6-37).
* Flight: the planned waypoints ARE the flown path; localization noise
  from the same 6-state constant-velocity KF ``lax.scan``
  (reference/trajectoryEstimateGenerator.py:51-72), fidelity binned by
  0.5 tr(P_xy) (reference/prepGPData.py:58-65).
* Measurement rows, GPData schema, and the per-replan artifact values
  (best info, plan budget, node/edge counts) match the host sim's.

Two deliberate deviations: (1) the host loop REBUILDS the model from the
harvested rows alone once it has >= 4 (dropping the start-pose dummy row);
the mission arena keeps the dummy row (one zero-target observation at the
start pose) for its whole life — it is one row against hundreds and the
refit optimizes the same NLML family. (2) the host ``_fly`` drops
duplicate-timestamp rows
(each edge's first sample repeats the previous edge's last); here every
edge contributes its samples 1..S-1 plus the path's very first point — the
same kept set except that the host also keeps a duplicate first row per
plan when edges are non-contiguous in time (they never are).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.data.io import GPDATA_HEADER, Table
from mfgp_jax.estimation.kalman import filter_trajectory
from mfgp_jax.fields.wrbf import WRBFField, default_sim_field
from mfgp_jax.metrics.eid import eid_grid, expected_information_density
from mfgp_jax.models.gp import GP
from mfgp_jax.models.mfgp import MFGP
from mfgp_jax.ops import kernels as _k
from mfgp_jax.ops import linalg as _la
from mfgp_jax.ops.optimize import batched_lbfgs
from mfgp_jax.planning.rig_device import (DeviceRIG, prepare_mf_gain_state,
                                          prepare_sf_gain_state)
from mfgp_jax.utils.configs import ExperimentConfig

SENTINEL_X = 1e6  # far coordinate: kernel values underflow to exactly 0



@dataclass
class DeviceMissionResult:
    """Host-side unpacking of the single-launch mission."""

    gp_data: Table  # harvested fidelity-binned training rows (GPData schema)
    replans: list  # dicts: plan_num, info, budget, t_flown, nodes, edges
    theta: np.ndarray  # final log-hyperparameters (= initial when frozen)
    budget_used: float
    rmse: float  # final-model RMSE on the sim test grid vs the true field
    n_replans: int
    flown: np.ndarray  # (BD, R, 4) planned/flown points per replan (padded)
    flown_mask: np.ndarray  # (BD, R) row validity
    test_mu: np.ndarray  # final posterior mean on the test grid
    test_var: np.ndarray  # final posterior variance on the test grid
    chain_overflow: bool  # a best path exceeded e_max edges (capacity)
    # dynamic flight only (flight="dynamic"): per-replan closed-loop stats
    tracking_rmse: Optional[np.ndarray] = None  # (BD,) 3D RMS to target
    flown_budget: Optional[np.ndarray] = None  # (BD,) integrated energy
    meas_overflow: bool = False  # a flight produced more samples than slots
    # per-replan artifact logs (reference artifact schemas)
    thetas: Optional[np.ndarray] = None  # (BD, n_theta) hyps after replan r
    eids: Optional[np.ndarray] = None  # (BD, G) the EID each replan planned on


class DeviceMission:
    """Budgeted exploration mission compiled to one XLA program.

    >>> mission = DeviceMission(ExperimentConfig(B=20.0, BD=2,
    ...                                          update_hyps=False), seed=0)
    >>> res = mission.run()          # ONE device launch
    >>> res.rmse, res.budget_used

    Covers the reference's variant matrix through the device planner's
    cost menu: ergodic / fourier (MFEGP, SFEGP), SF/MF sequential gain and
    SF/MF batch log-det (MFGP, SFGP; reference GraceRIGV3 scoring modes).

    ``update_hyps``: with ``exp.update_hyps=True`` (the reference's
    default, exploreExpSettings.py:73) each replan ends with an IN-GRAPH
    L-BFGS refit of the hyperparameters on the masked arena NLML
    (warm-started from the current values, like the host ``_fit``; MF
    rhos stay fixed and lengthscales keep the host's (1e-4, 100) bounds),
    followed by the host loop's blow-up recovery (params > 90 reset to 1,
    reference/...MFEGP.py:398-410) and a refactorization of the arena.
    ``fit_restarts > 1`` makes each refit restart-batched (warm start +
    ``N(0, fit_spread)`` log-space perturbations, the host
    ``optimize_restarts`` sampling, as one vmapped launch; best finite
    NLML kept) — robustness to NLML multimodality at ~restarts x the
    refit cost. With ``update_hyps=False`` hyperparameters stay frozen —
    the host loop's ``fit_mode="extend"`` regime.
    """

    def __init__(self, exp: ExperimentConfig | None = None, seed: int = 0,
                 field_env: Optional[WRBFField] = None, plan_iters: int = 40,
                 e_max: int = 16, n_max: Optional[int] = None,
                 dtype=jnp.float32, fit_maxiter: int = 100,
                 fit_tol: float = 1e-4, fit_restarts: int = 1,
                 fit_spread: float = 1.0, flight: str = "kinematic",
                 runtime_cfg=None, t_cap: int = 8192,
                 glide_stride: int = 1,
                 launch_ceiling_s: Optional[float] = None, **planner_kw):
        self.exp = exp or ExperimentConfig()
        if flight not in ("kinematic", "dynamic"):
            raise ValueError(flight)
        self.flight = flight
        self.update_hyps = bool(self.exp.update_hyps)
        self.fit_maxiter = int(fit_maxiter)
        self.fit_tol = float(fit_tol)
        self.fit_restarts = int(fit_restarts)
        self.fit_spread = float(fit_spread)
        if self.fit_restarts < 1:
            raise ValueError("fit_restarts must be >= 1")
        if self.fit_restarts > 1 and not self.update_hyps:
            raise ValueError("fit_restarts > 1 requires "
                             "exp.update_hyps=True (frozen-hyperparameter "
                             "missions never refit)")
        if int(glide_stride) != 1 and flight != "dynamic":
            raise ValueError("glide_stride != 1 requires "
                             "flight='dynamic' (kinematic missions have "
                             "no runtime scan to coarsen)")
        if self.exp.plan_wallclock:
            raise ValueError("the device mission is fixed-iteration; set "
                             "plan_iters instead of plan_wallclock")
        cfg = self.exp.sim
        self.cfg = cfg
        self.seed = int(seed)
        self.dtype = dtype
        self.field = field_env or default_sim_field(cfg.WS, cfg.max_depth)
        self.agent_cfg = cfg.agent()
        self.kf_model = cfg.kf_model(
            dtype=np.float64 if dtype == jnp.float64 else np.float32)
        self.grid = np.asarray(eid_grid([list(b) for b in cfg.WS],
                                        cfg.max_depth))
        self.ig_grid = np.asarray(eid_grid([list(b) for b in cfg.WS],
                                           cfg.max_depth, nums=(10, 6, 5)))

        if self.exp.ergodic:
            cost = ("fourier" if self.exp.ergodic_metric == "fourier"
                    else "ergodic")
        elif self.exp.info_cost == "batch":
            cost = "mf_logdet" if self.exp.multi_fidelity else "sf_logdet"
        else:
            cost = "mf_gain" if self.exp.multi_fidelity else "sf_gain"
        self.cost = cost
        dev_grid = self.ig_grid if cost.endswith("_logdet") else self.grid
        self.planner = DeviceRIG(
            cfg=self.agent_cfg, delta=cfg.step_size, B=self.exp.B,
            WS=np.asarray(cfg.WS, float), R=cfg.near_rad, Rd=cfg.Rd,
            same_node_distance=cfg.same_node_distance, budget_cutoff=0.9,
            max_iter=plan_iters, grid=dev_grid, kernel=self.exp.kernel,
            cost=cost, dtype=dtype, **planner_kw)

        self.e_max = int(e_max)
        S = self.planner.S
        self.R = 1 + self.e_max * (S - 1)  # flight rows per replan
        s_meas = self.R - 1  # measurement rows per replan

        # dynamic flight: the device runtime scan (hw/runtime_device)
        # flies the chain through the full sense->estimate->control stack
        # INSIDE the mission program (host analogue: ExplorationSim
        # flight="dynamic" -> RobotRuntime.fly, reference :761-1033)
        self.rt = None
        if flight == "dynamic":
            from mfgp_jax.hw.runtime import RuntimeConfig
            from mfgp_jax.hw.runtime_device import DeviceRuntime

            self._lp = 2 * self.agent_cfg.num_legs + 1
            fld = self.field

            def point_field(x, y, z):
                return fld(jnp.stack([x, y, z])[None])[0]

            self.rt = DeviceRuntime(
                self.agent_cfg, runtime_cfg or RuntimeConfig(dt=0.1),
                field=point_field, max_depth=cfg.max_depth, dtype=dtype,
                w_cap=1 + self.e_max * self._lp,
                l_cap=self.e_max * self._lp,
                glide_stride=glide_stride)
            self.t_cap = int(t_cap)
            # sample slots per replan: the runtime samples at meas_rate
            # (plus capped burst sampling); periodic capacity for a full
            # t_cap flight + burst margin. Excess flags meas_overflow.
            s_meas = max(s_meas, int(
                self.t_cap * self.rt.cfg.dt
                * self.agent_cfg.meas_rate) + 32)
        self.s_meas = s_meas
        need = 1 + self.exp.BD * s_meas
        self.n_max = int(n_max) if n_max is not None else -(-need // 128) * 128
        if self.n_max < need:
            raise ValueError(f"n_max={n_max} < required {need} "
                             f"(1 + BD * sample slots per replan)")

        # initial model: single dummy point at the start pose, like the
        # drivers (reference/PhysicalExperimentCode/...MFEGP.py:621-666)
        ws = np.asarray(cfg.WS, float)
        self._x0 = np.array([ws[0, 0] + 0.05 * (ws[0, 1] - ws[0, 0]),
                             ws[1, 0] + 0.05 * (ws[1, 1] - ws[1, 0])])
        dummy_X = np.array([[self._x0[0], self._x0[1], 0.0]])
        self.mf = bool(self.exp.multi_fidelity)
        if self.mf:
            model = MFGP.from_fidelity_lists(
                [dummy_X[:0], dummy_X[:0], dummy_X],
                [np.zeros(0), np.zeros(0), np.zeros(1)],
                kernel=self.exp.kernel, jitter=1e-6)
            (Xp, fp, Lp, variances, ls, rhos, noises, fl) = \
                prepare_mf_gain_state(model, self.agent_cfg.fid_levels,
                                      self.n_max, dtype)
            self._rhos0 = rhos  # fixed across refits (host fix_rhos=True)
            self._fl = fl
            self.F = int(variances.shape[0])
            self.D = int(np.asarray(model.state.X).shape[1])
            self._theta0 = jnp.concatenate(
                [jnp.log(variances), jnp.log(ls).reshape(-1),
                 jnp.log(noises)])
        else:
            model = GP(dummy_X, np.zeros(1), kernel=self.exp.kernel,
                       jitter=1e-6)
            Xp, Lp, variance, ls, noise = prepare_sf_gain_state(
                model, self.n_max, dtype)
            fp = jnp.full((self.n_max,), 0, jnp.int32)
            self.D = int(ls.shape[0])
            self._theta0 = jnp.concatenate(
                [jnp.log(variance)[None], jnp.log(ls),
                 jnp.log(noise)[None]])
        ma0 = jnp.zeros((self.n_max,), bool).at[0].set(True)
        self._arena0 = dict(
            Xa=Xp, fida=fp, La=Lp,
            ya=jnp.zeros((self.n_max,), dtype),
            cnt=jnp.asarray(1, jnp.int32), ma=ma0)
        # L-BFGS bounds: MF lengthscales keep the host _fit's (1e-4, 100)
        # box; everything else unbounded (GPy defaults)
        n_th = self._theta0.shape[0]
        lo = np.full(n_th, -np.inf)
        hi = np.full(n_th, np.inf)
        if self.mf:
            F, D = self.F, self.D
            lo[F:F + F * D] = np.log(1e-4)
            hi[F:F + F * D] = np.log(100.0)
        self._fit_lo = jnp.asarray(lo, dtype)
        self._fit_hi = jnp.asarray(hi, dtype)

        tp = np.asarray(cfg.test_points())
        self._test_points = jnp.asarray(tp, dtype)
        self._f_true = jnp.asarray(np.asarray(self.field(jnp.asarray(tp))),
                                   dtype)
        self._grid_j = jnp.asarray(self.grid, dtype)
        self._run_jit = jax.jit(self._run_impl, static_argnames=("bd",))
        # stepped-execution machinery (tranche spans under an optional
        # per-launch wall-clock ceiling; see run())
        self.launch_ceiling_s = launch_ceiling_s
        self._span_jit = None
        self._finish_jit = None
        self._ens_span_jit = None
        self._ens_finish_jit = None
        self.last_run_launches = 0  # introspection: launches of last run

    # -- in-graph GP algebra over the padded arena ---------------------------
    def _unpack(self, theta):
        """Log-parameter vector -> positive parameter tuple.

        SF: (variance, lengthscales, noise). MF: (variances (F,),
        lengthscales (F, D), rhos, noises, fidelity thresholds) — rhos are
        fixed across refits (host _fit uses fix_rhos=True)."""
        if self.mf:
            F, D = self.F, self.D
            return (jnp.exp(theta[:F]),
                    jnp.exp(theta[F:F + F * D]).reshape(F, D),
                    self._rhos0, jnp.exp(theta[F + F * D:]), self._fl)
        D = self.D
        return (jnp.exp(theta[0]), jnp.exp(theta[1:1 + D]),
                jnp.exp(theta[1 + D]))

    def _prior_sig(self, params):
        """Data-free variance for the EID (host _eid's param_array picks:
        sum of per-fidelity variances + top noise / variance + noise)."""
        if self.mf:
            variances, _, _, noises, _ = params
            return jnp.sum(variances) + noises[-1]
        variance, _, noise = params
        return variance + noise

    def _grid_post(self, params, Xa, fida, La, alpha, Xs):
        """Posterior mean/marginal-variance at Xs (include_noise=True,
        matching models.gp/mfgp.predict defaults used by the host _eid)."""
        kern = _k.KERNELS[self.exp.kernel]
        G = Xs.shape[0]
        if self.mf:
            variances, ls, rhos, noises, _ = params
            F = variances.shape[0]
            fid_s = jnp.full((G,), F - 1, jnp.int32)
            Kxg = _k.ar1_cov(Xa, fida, Xs, fid_s, variances, ls, rhos,
                             self.exp.kernel)  # (n_max, G)
            W = _k.ar1_fidelity_weights(rhos, F)
            kss = jnp.sum(W[:, F - 1] ** 2 * variances)
            noise = noises[F - 1]
        else:
            variance, ls, noise = params
            Kxg = kern(Xa, Xs, variance, ls)
            kss = variance
        mu = Kxg.T @ alpha
        V = _la.tri_solve(La, Kxg)  # (n_max, G); padding rows are inert
        var = kss - jnp.sum(V * V, axis=0) + noise
        return mu, var

    def _cross_cov(self, params, X1, f1, X2, f2):
        if self.mf:
            variances, ls, rhos, _, _ = params
            return _k.ar1_cov(X1, f1, X2, f2, variances, ls, rhos,
                              self.exp.kernel)
        variance, ls, _ = params
        return _k.KERNELS[self.exp.kernel](X1, X2, variance, ls)

    def _noise_diag(self, params, fid):
        if self.mf:
            return _k.mf_noise_diag(fid, params[3])
        return jnp.broadcast_to(params[2], fid.shape)

    def _masked_cov(self, params, Xa, fida, ma):
        """Full masked arena covariance: valid block = K + (noise+jitter) I
        (models.gp/mfgp ``_assemble`` semantics), padding block = identity,
        zero cross terms — so its Cholesky keeps padding rows as identity
        rows (the prepare_*_gain_state contract) and its NLML equals the
        valid-row NLML plus a theta-independent constant."""
        dt = self.dtype
        K = self._cross_cov(params, Xa, fida, Xa, fida)
        K = K * (ma[:, None] & ma[None, :])
        return K + jnp.diag(jnp.where(
            ma, self._noise_diag(params, fida) + 1e-6, jnp.asarray(1.0, dt)))

    def _masked_nlml(self, theta, Xa, fida, ya, ma):
        """NLML of the valid arena rows as a function of the log-parameter
        vector (padding contributes exactly 0 to the quadratic and the
        log-det). The refit objective — same minimiser as the host
        ``_fit``'s full-model NLML."""
        K = self._masked_cov(self._unpack(theta), Xa, fida, ma)
        L = _la.chol(K)
        v = _la.tri_solve(L, ya)
        n = jnp.sum(ma).astype(self.dtype)
        val = 0.5 * (v @ v + n * jnp.log(2 * jnp.pi)) \
            + jnp.sum(jnp.where(ma, jnp.log(jnp.diag(L)), 0.0))
        return jnp.where(jnp.isfinite(val), val,
                         jnp.asarray(1e20, self.dtype))

    def _extend_arena(self, params, ar, newX, newfid, newy, valid):
        """Masked rank-S bordered-Cholesky extension of the train arena.

        Invalid rows are written as padding (sentinel coordinate, identity
        factor row, zero target) — exactly the prepare_*_gain_state
        contract, so the arena posterior stays exact. Writing an
        all-invalid block is a bit-identical no-op.
        """
        dt = self.dtype
        Sf = newX.shape[0]
        vX = jnp.where(valid[:, None], newX,
                       jnp.asarray(SENTINEL_X, dt))
        vf = jnp.where(valid, newfid, 0).astype(jnp.int32)
        B = self._cross_cov(params, vX, vf, ar["Xa"], ar["fida"])
        B = B * valid[:, None]  # (Sf, n_max)
        C = self._cross_cov(params, vX, vf, vX, vf)  # (Sf, Sf)
        C = C * (valid[:, None] & valid[None, :])
        # conditioning diagonal: K + (noise + jitter) I on valid rows
        # (models.gp/mfgp _assemble semantics); identity on padding
        C = C + jnp.diag(jnp.where(valid,
                                   self._noise_diag(params, vf) + 1e-6,
                                   jnp.asarray(1.0, dt)))
        L21T = _la.tri_solve(ar["La"], B.T)  # (n_max, Sf); pad rows -> 0
        Lc = _la.chol(C - L21T.T @ L21T)
        # new factor rows: [L21 | Lc at the block diagonal | 0]; L21's
        # columns >= cnt are already 0 (zero cross-cov to padding)
        zero = jnp.asarray(0, ar["cnt"].dtype)
        rowblock = jax.lax.dynamic_update_slice(L21T.T, Lc,
                                                (zero, ar["cnt"]))
        return dict(
            Xa=jax.lax.dynamic_update_slice(ar["Xa"], vX,
                                            (ar["cnt"], zero)),
            fida=jax.lax.dynamic_update_slice(ar["fida"], vf,
                                              (ar["cnt"],)),
            La=jax.lax.dynamic_update_slice(ar["La"], rowblock,
                                            (ar["cnt"], zero)),
            ya=jax.lax.dynamic_update_slice(
                ar["ya"], jnp.where(valid, newy, 0.0), (ar["cnt"],)),
            ma=jax.lax.dynamic_update_slice(ar["ma"], valid, (ar["cnt"],)),
            cnt=ar["cnt"] + Sf)

    # -- best-path chain extraction (in-graph _extract) ----------------------
    def _chain(self, pst):
        """Walk a_prev/a_edge from the best arena slot; returns the
        forward-ordered edge ids (e_max,), the edge count, and an overflow
        flag (chain longer than e_max)."""
        best = pst["best_arena"]
        a_prev, a_edge = pst["a_prev"], pst["a_edge"]

        def step(i, _):
            e = jnp.where(i > 0, a_edge[jnp.maximum(i, 0)], -1)
            nxt = jnp.where(i > 0, a_prev[jnp.maximum(i, 0)], i)
            return nxt, e

        i_end, rev = jax.lax.scan(step, best, None, length=self.e_max)
        n_e = jnp.sum(rev >= 0)
        overflow = i_end > 0
        idxf = jnp.clip(n_e - 1 - jnp.arange(self.e_max), 0)
        chain = jnp.clip(rev[idxf], 0)
        return chain, n_e.astype(jnp.int32), overflow

    def _assemble_points(self, pst, chain, n_e):
        """Dense flown rows from the edge chain: the path's first sample
        plus samples 1..S-1 of every edge, with per-edge time offsets
        (host _extract: pts[:,3] += t_off; t_off = pts[-1,3])."""
        ep = pst["edge_pts"][chain]  # (e_max, S, 4)
        valid_e = jnp.arange(self.e_max) < n_e
        durs = jnp.where(valid_e, ep[:, -1, 3], 0.0)
        offs = jnp.concatenate([jnp.zeros((1,), durs.dtype),
                                jnp.cumsum(durs)[:-1]])
        ts = ep[:, :, 3] + offs[:, None]
        body = jnp.concatenate([ep[:, 1:, :3].reshape(-1, 3),
                                ts[:, 1:].reshape(-1, 1)], axis=1)
        first = jnp.concatenate([ep[0, 0, :3], ts[0, 0][None]])
        pts = jnp.concatenate([first[None], body], axis=0)  # (R, 4)
        S1 = ep.shape[1] - 1
        mask = jnp.concatenate([(n_e > 0)[None],
                                jnp.repeat(valid_e, S1)])
        return pts, mask

    def _chain_plan(self, pst, chain, n_e):
        """In-graph ``hw.runtime.chain_to_flight_plan``: the best-path
        chain's per-edge primitives and node endpoints assemble into a
        padded DevicePlan (waypoints + leg rows) for the runtime scan.
        Padded legs are NOOP rows; padded waypoints hold the final
        position at strictly increasing times past ``t_end``, so the
        runtime's interpolation and primitive lookup are unaffected."""
        from mfgp_jax.hw.runtime_device import DevicePlan
        from mfgp_jax.planning.primitives_device import (
            NOOP, evaluate_trajectory_device)

        dt = self.dtype
        e_max, lp = self.e_max, self._lp
        prims = pst["edge_prims"][chain]  # (e_max, Lp, 4)
        src = pst["nodes"][pst["edge_src"][chain]]  # (e_max, 2)
        dst = pst["nodes"][pst["edge_dst"][chain]]
        valid_e = jnp.arange(e_max) < n_e
        t_e, _, _, wpnts, _ = jax.vmap(
            lambda p: evaluate_trajectory_device(p, self.agent_cfg))(prims)
        t_e = jnp.where(valid_e, t_e, 0.0)
        bear = jnp.arctan2(dst[:, 1] - src[:, 1], dst[:, 0] - src[:, 0])
        d = wpnts[:, 1:, 0]  # (e_max, Lp) per-leg cumulative distance
        xs = src[:, 0, None] + d * jnp.cos(bear)[:, None]
        ys = src[:, 1, None] + d * jnp.sin(bear)[:, None]
        zs = wpnts[:, 1:, 1]
        offs = jnp.concatenate([jnp.zeros((1,), dt),
                                jnp.cumsum(t_e)[:-1]])
        ts = wpnts[:, 1:, 2] + offs[:, None]
        t_end = jnp.sum(t_e)
        last = jnp.maximum(n_e - 1, 0)
        fin = (dst[last, 0], dst[last, 1], wpnts[last, lp, 1])
        ve = jnp.repeat(valid_e, lp)
        xs = jnp.where(ve, xs.reshape(-1), fin[0])
        ys = jnp.where(ve, ys.reshape(-1), fin[1])
        zs = jnp.where(ve, zs.reshape(-1), fin[2])
        ts = jnp.where(ve, ts.reshape(-1),
                       t_end + 1.0 + jnp.arange(e_max * lp, dtype=dt))
        row0 = jnp.stack([src[0, 0], src[0, 1],
                          jnp.asarray(0.0, dt), jnp.asarray(0.0, dt)])
        wp = jnp.concatenate(
            [row0[None], jnp.stack([xs, ys, zs, ts], axis=1)], axis=0)
        legs = prims.reshape(-1, 4)
        legs = legs.at[:, 0].set(
            jnp.where(ve, legs[:, 0], jnp.asarray(float(NOOP), dt)))
        n_rows = jnp.asarray(1 + e_max * lp, jnp.int32)
        return DevicePlan(wp=wp.astype(dt), n_wp=n_rows,
                          legs=legs.astype(dt),
                          n_legs=n_rows - 1, t_end=t_end)

    # -- the mission program --------------------------------------------------
    def _body_fn(self):
        """The traced per-tranche loop body (replan -> fly -> harvest ->
        extend [-> refit]) — shared by the one-launch program
        (``_run_impl``) and the stepped spans (``_span_impl``), so both
        execution modes run the SAME mathematics on the same carried
        state (parity pinned by test_mission_stepped_equals_one_launch)."""
        dt = self.dtype
        exp = self.exp
        B = jnp.asarray(exp.B, dt)
        R = self.R
        fidlevels = jnp.asarray(self.cfg.fidlevels, dt)

        def gp_tuple(ar, params):
            if self.cost in ("ergodic", "fourier"):
                z = jnp.zeros((1, 1), dt)
                if self.mf:
                    return (jnp.zeros((1, 3), dt),
                            jnp.zeros((1,), jnp.int32), z,
                            jnp.ones((3,), dt), jnp.ones((3, 3), dt),
                            jnp.ones((2,), dt), jnp.ones((3,), dt),
                            jnp.ones((2,), dt))
                return (jnp.zeros((1, 3), dt), z, jnp.ones((), dt),
                        jnp.ones((3,), dt), jnp.ones((), dt))
            if self.mf:
                variances, ls, rhos, noises, fl = params
                return (ar["Xa"], ar["fida"], ar["La"], variances, ls,
                        rhos, noises, fl)
            variance, ls, noise = params
            return (ar["Xa"], ar["La"], variance, ls, noise)

        def body(r, st):
            ar = {k: st[k] for k in ("Xa", "fida", "La", "ya", "cnt", "ma")}
            params = self._unpack(st["theta"])
            remaining = B - st["planned"]
            active = st["active"] & (remaining > 0.5 * B / exp.BD)
            tranche = jnp.minimum(B / exp.BD, remaining)

            # 1. arena posterior -> EID on the dense sim grid
            alpha = _la.chol_solve(ar["La"], ar["ya"])
            mu, sig = self._grid_post(params, ar["Xa"], ar["fida"],
                                      ar["La"], alpha, self._grid_j)
            eid = expected_information_density(
                mu, sig, self._prior_sig(params), auto=exp.alpha_auto)

            # 2. plan (the planner's whole jitted loop, inlined). kf only
            # feeds restart perturbations, but it is split unconditionally
            # so fit_restarts does not perturb the flight/measurement
            # streams (restart vs single-start runs see the same plans).
            key, kp, kkf, km, kf = jax.random.split(st["key"], 5)
            pst = self.planner._plan_impl(st["x0"], kp, tranche,
                                          eid.astype(dt),
                                          gp_tuple(ar, params))
            ok = (pst["best_arena"] >= 0) & active
            chain, n_e, overflow = self._chain(pst)
            ok &= (n_e > 0) & ~overflow

            # 3. flight rows (benign fallback when the replan is a no-op)
            pts, mask = self._assemble_points(pst, chain, n_e)
            mask &= ok
            benign_t = jnp.arange(R, dtype=dt)
            benign_p = jnp.broadcast_to(
                jnp.concatenate([st["x0"], jnp.zeros((1,), dt)]), (R, 3))
            t_raw = jnp.where(ok, pts[:, 3], benign_t)
            pos_raw = jnp.where(ok, pts[:, :3], benign_p)
            idx_last = jnp.maximum(jnp.sum(mask) - 1, 0)
            t_last = t_raw[idx_last]
            pos_last = pos_raw[idx_last]
            bump = jnp.cumsum((~mask).astype(dt))
            t_fix = jnp.where(mask, t_raw, t_last + bump)
            pos_fix = jnp.where(mask[:, None], pos_raw, pos_last[None])

            # 4. flight + measurement + fidelity binning
            rt_st = {}
            if self.flight == "dynamic":
                # fly the chain through the full device runtime scan
                # (host analogue: _fly_dynamic -> RobotRuntime.fly); the
                # next plan starts where the robot BELIEVES it is
                # (reference/...MFEGP.py:428-439)
                rt_prev = {k[3:]: st[k] for k in st
                           if k.startswith("rt_")}
                plan_dev = self._chain_plan(pst, chain, n_e)
                tick_of = ((plan_dev.t_end / self.rt.cfg.dt + 1)
                           > self.t_cap)
                ok &= ~tick_of
                rt_new, rlogs = self.rt._fly_impl(plan_dev, rt_prev, kkf,
                                                  self.t_cap)
                rt_new = jax.tree.map(
                    lambda a, b: jnp.where(ok, a, b), rt_new, rt_prev)
                n_smp = jnp.sum(rlogs["sample"])
                idx = jnp.nonzero(rlogs["sample"], size=self.s_meas,
                                  fill_value=self.t_cap)[0]
                sval = idx < self.t_cap
                ci = jnp.clip(idx, 0, self.t_cap - 1)
                out = dict(t=rlogs["t"][ci].astype(dt),
                           pos=rlogs["truth"][ci].astype(dt),
                           xh=rlogs["sample_xh"][ci].astype(dt))
                noisy = jnp.maximum(
                    0.0, rlogs["blue"][ci].astype(dt)
                    + self.cfg.meas_noise
                    * jax.random.normal(km, (self.s_meas,), dt))
                fid = rlogs["fid"][ci].astype(jnp.int32)
                meas_mask = sval & ok
                t_flown = jnp.where(ok, plan_dev.t_end, 0.0)
                x0_next = jnp.where(ok, rt_new["xhat"][:2].astype(dt),
                                    st["x0"])
                alive = rlogs["alive"]
                track = jnp.sqrt(jnp.sum(rlogs["err2"] * alive)
                                 / jnp.maximum(jnp.sum(alive), 1))
                rt_st = {f"rt_{k}": v for k, v in rt_new.items()}
                rt_st["track"] = st["track"].at[r].set(
                    jnp.where(ok, track, 0.0))
                rt_st["fbudget"] = st["fbudget"].at[r].set(
                    rt_new["budget"] - rt_prev["budget"])
                rt_st["m_overflow"] = st["m_overflow"] | (
                    ok & (n_smp > self.s_meas))
            else:
                out = filter_trajectory(self.kf_model, t_fix, pos_fix,
                                        kkf)
                meas_mask = mask[1:]  # row j needs input rows j and j+1
                vals = self.field(out["pos"]).astype(dt)
                noisy = jnp.maximum(
                    0.0, vals + self.cfg.meas_noise
                    * jax.random.normal(km, (R - 1,), dt))
                cov_comp = 0.5 * (out["sig"][:, 0] + out["sig"][:, 1])
                fid = jnp.where(cov_comp < fidlevels[0], 1,
                                jnp.where(cov_comp < fidlevels[1], 2, 3))
                t_flown = jnp.where(ok, t_last - t_raw[0], 0.0)
                x0_next = jnp.where(ok, pos_last[:2], st["x0"])

            # 5. masked bordered extension (train on ESTIMATED positions,
            #    reference/prepGPData.py rows: X=xh, y=measured field)
            newfid = ((3 - fid) if self.mf
                      else jnp.zeros_like(fid)).astype(jnp.int32)
            ar2 = self._extend_arena(params, ar, out["xh"].astype(dt),
                                     newfid, noisy, meas_mask)
            ar2["cnt"] = jnp.where(ok, ar2["cnt"], ar["cnt"])
            theta = st["theta"]

            # 6. in-graph hyperparameter refit (host loop's update_hyps
            #    regime: warm-started L-BFGS on the full-data NLML after
            #    every flight with >= 4 real rows, elementwise blow-up
            #    recovery, then refactorize the arena at the new params)
            if self.update_hyps:
                do_fit = ok & (jnp.sum(ar2["ma"]) >= 5)  # 4 rows + dummy

                def obj(th):
                    return self._masked_nlml(th, ar2["Xa"], ar2["fida"],
                                             ar2["ya"], ar2["ma"])

                if self.fit_restarts > 1:
                    # restart-batched refit (host optimize_restarts
                    # sampling: warm start + N(0, spread) perturbations in
                    # log space; one vmapped launch runs every trajectory,
                    # keep the best finite NLML). Index 0 IS the warm
                    # start, so the result is never worse than the
                    # single-start refit on the same arena.
                    n_th = theta.shape[0]
                    inits = theta[None] + jnp.asarray(
                        self.fit_spread, dt) * jax.random.normal(
                            kf, (self.fit_restarts, n_th), dt)
                    inits = jnp.clip(inits.at[0].set(theta),
                                     self._fit_lo, self._fit_hi)
                    th_all, f_all, _ = jax.vmap(
                        lambda t0: batched_lbfgs(
                            obj, t0, lower=self._fit_lo,
                            upper=self._fit_hi,
                            maxiter=self.fit_maxiter,
                            tol=self.fit_tol))(inits)
                    best = jnp.argmin(jnp.where(jnp.isfinite(f_all),
                                                f_all, jnp.inf))
                    th_new = th_all[best]
                else:
                    th_new, _, _ = batched_lbfgs(
                        obj, theta, lower=self._fit_lo, upper=self._fit_hi,
                        maxiter=self.fit_maxiter, tol=self.fit_tol)
                # blow-up recovery: any param with |p| > 90 (or non-finite)
                # resets to 1 (reference/...MFEGP.py:398-410; host
                # _recover_hyps) -- elementwise, in positive space
                p = jnp.exp(th_new)
                bad = ~jnp.isfinite(p) | (jnp.abs(p) > 90.0)
                th_new = jnp.where(bad, 0.0, th_new)
                theta = jnp.where(do_fit, th_new, theta)
                La_re = _la.chol(self._masked_cov(
                    self._unpack(theta), ar2["Xa"], ar2["fida"], ar2["ma"]))
                ar2["La"] = jnp.where(do_fit, La_re, ar2["La"])

            # 7. bookkeeping + per-replan records
            budget = jnp.where(ok, pst["a_budget"][pst["best_arena"]], 0.0)
            mask &= ok
            rows9 = jnp.concatenate(
                [out["t"][:, None], out["pos"], out["xh"],
                 noisy[:, None], fid[:, None].astype(dt)], axis=1)
            st = dict(
                st, key=key, x0=x0_next, theta=theta, **rt_st,
                planned=st["planned"] + budget,
                t_now=st["t_now"] + t_flown,
                active=active & ok,
                overflow=st["overflow"] | (overflow & active),
                info=st["info"].at[r].set(
                    jnp.where(ok, pst["best_score"], -jnp.inf)),
                thetas=st["thetas"].at[r].set(theta),
                eids=st["eids"].at[r].set(eid.astype(dt)),
                budget=st["budget"].at[r].set(budget),
                t_flown=st["t_flown"].at[r].set(t_flown),
                nodes=st["nodes"].at[r].set(pst["n_nodes"]),
                edges=st["edges"].at[r].set(pst["n_feas"]),
                did=st["did"].at[r].set(ok),
                flown=st["flown"].at[r].set(
                    jnp.concatenate([pos_fix, t_fix[:, None]], axis=1)),
                flown_mask=st["flown_mask"].at[r].set(mask),
                rows=st["rows"].at[r].set(rows9),
                rows_mask=st["rows_mask"].at[r].set(meas_mask),
                **ar2)
            return st

        return body

    def _init_state(self, key, arena, bd):
        """The mission carry at replan 0 (fresh arena + per-replan logs)."""
        dt = self.dtype
        R = self.R
        st = dict(
            arena,
            key=key,
            theta=self._theta0,
            x0=jnp.asarray(self._x0, dt),
            planned=jnp.asarray(0.0, dt),
            t_now=jnp.asarray(0.0, dt),
            active=jnp.asarray(True),
            overflow=jnp.asarray(False),
            info=jnp.zeros((bd,), dt),
            thetas=jnp.zeros((bd, self._theta0.shape[0]), dt),
            eids=jnp.zeros((bd, self.grid.shape[0]), dt),
            budget=jnp.zeros((bd,), dt),
            t_flown=jnp.zeros((bd,), dt),
            nodes=jnp.zeros((bd,), jnp.int32),
            edges=jnp.zeros((bd,), jnp.int32),
            did=jnp.zeros((bd,), bool),
            flown=jnp.zeros((bd, R, 4), dt),
            flown_mask=jnp.zeros((bd, R), bool),
            rows=jnp.zeros((bd, self.s_meas, 9), dt),
            rows_mask=jnp.zeros((bd, self.s_meas), bool),
        )
        if self.flight == "dynamic":
            rt0 = self.rt.init_carry(float(self._x0[0]),
                                     float(self._x0[1]))
            st.update({f"rt_{k}": v for k, v in rt0.items()})
            st["track"] = jnp.zeros((bd,), dt)
            st["fbudget"] = jnp.zeros((bd,), dt)
            st["m_overflow"] = jnp.asarray(False)
        return st

    def _finish_impl(self, st):
        """Final posterior on the sim test grid + RMSE vs the true field;
        drops the PRNG key (stepped runs carry it between spans)."""
        st = dict(st)
        alpha = _la.chol_solve(st["La"], st["ya"])
        mu, var = self._grid_post(self._unpack(st["theta"]), st["Xa"],
                                  st["fida"], st["La"], alpha,
                                  self._test_points)
        st["test_mu"], st["test_var"] = mu, var
        st["rmse"] = jnp.sqrt(jnp.mean((mu - self._f_true) ** 2))
        st.pop("key")
        return st

    def _run_impl(self, key, arena, bd):
        st = self._init_state(key, arena, bd)
        st = jax.lax.fori_loop(0, bd, self._body_fn(), st)
        return self._finish_impl(st)

    def _span_impl(self, st, r0, r1):
        """Replans [r0, r1) as ONE launch over the carried mission state.

        Traced bounds: a single compiled executable serves EVERY span
        size, so the host can size spans to a per-launch wall-clock
        ceiling (``launch_ceiling_s``) without recompiling. Semantics are
        identical to the one-launch program — same body, same state."""
        return jax.lax.fori_loop(r0, r1, self._body_fn(), st)

    def _launch_ceiling(self) -> float:
        """Per-launch wall-clock budget: ``launch_ceiling_s`` when given
        (``<= 0`` disables), otherwise none on every backend."""
        if self.launch_ceiling_s is None:
            return np.inf
        c = float(self.launch_ceiling_s)
        return np.inf if c <= 0 else c

    def run(self, max_replans: Optional[int] = None,
            mode: str = "auto") -> DeviceMissionResult:
        """Execute the mission.

        ``mode``:

        - ``"one"`` — the whole mission as a single device launch (the
          flagship one-XLA-program form).
        - ``"stepped"`` — budget-tranche SPANS as separate launches of one
          shared traced-bounds executable with carried device state: the
          first span runs one tranche, its warm wall-clock sizes every
          later span to ~70% of the launch ceiling. Reference analogue:
          the drivers' replan-tranche host loop
          (reference/PhysicalExperimentCode/
          GraceExplorationExperiments_MFEGP.py:427), except the state
          never leaves the device between spans.
        - ``"auto"`` (default) — ``"stepped"`` when a finite
          ``launch_ceiling_s`` was given, ``"one"`` otherwise. Both modes
          run the same traced tranche body, so results agree to
          factorization tolerance (pinned by test).
        """
        bd = int(self.exp.BD if max_replans is None else max_replans)
        if mode not in ("auto", "one", "stepped"):
            raise ValueError(f"mode must be auto|one|stepped, got {mode!r}")
        ceiling = self._launch_ceiling()
        if mode == "one" or (mode == "auto" and not np.isfinite(ceiling)):
            self.last_run_launches = 1
            st = self._run_jit(jax.random.key(self.seed), self._arena0,
                               bd=bd)
        else:
            st = self._run_stepped(jax.random.key(self.seed), self._arena0,
                                   bd, ceiling)
        return self._unpack_result(
            {k: np.asarray(v) for k, v in st.items()}, bd)

    def _run_stepped(self, key, arena, bd, ceiling):
        """Stepped execution: adaptive tranche spans under the ceiling."""
        import time
        import warnings

        from mfgp_jax.planning.rig_device import _index_gather

        if self._span_jit is None:
            self._span_jit = jax.jit(self._span_impl)
            self._finish_jit = jax.jit(self._finish_impl)
        st = self._init_state(key, arena, bd)
        r, chunk, launches = 0, 1, 0
        warned = False
        while r < bd:
            r1 = min(r + chunk, bd)
            t0 = time.perf_counter()
            with _index_gather(False):  # solo lanes: one-hot forms win
                st = self._span_jit(st, np.int32(r), np.int32(r1))
                jax.block_until_ready(st)
            wall = time.perf_counter() - t0
            launches += 1
            per = wall / (r1 - r)
            if (launches >= 2 and np.isfinite(ceiling) and per > ceiling
                    and not warned):
                warnings.warn(
                    f"one mission tranche takes {per:.1f}s > the "
                    f"{ceiling:.0f}s launch ceiling; spans cannot "
                    "subdivide a tranche — lower plan_iters/fit_maxiter "
                    "or raise launch_ceiling_s", RuntimeWarning)
                warned = True
            if not np.isfinite(ceiling) or launches == 1:
                # forced-stepped without a ceiling stays one tranche per
                # launch; the first span's wall-clock includes compile, so
                # re-measure warm before growing
                chunk = 1
            else:
                chunk = max(1, min(bd, int(0.7 * ceiling
                                           / max(per, 1e-9))))
            r = r1
        st = self._finish_jit(st)
        jax.block_until_ready(st)
        self.last_run_launches = launches + 1
        return st

    def run_ensemble(self, n: int,
                     max_replans: Optional[int] = None,
                     mesh=None, mode: str = "auto",
                     seed_chunk: Optional[int] = None,
                     ) -> "list[DeviceMissionResult]":
        """N COMPLETE missions (seeds ``seed..seed+n-1``) as vmapped
        launches — a Monte-Carlo of whole experiments (dynamics included
        in ``flight="dynamic"``). Member i equals
        ``DeviceMission(..., seed=seed+i).run()`` to near-machine
        tolerance (same per-mission key; the vmapped executable only
        reorders reductions), so ensembles are reproducible runs.

        By default the whole ensemble is ONE vmapped launch. ``seed_chunk``
        splits the SEED axis into vmapped launches of that many lanes
        (tail chunks pad by repeating lane 0 and drop the extras, so ONE
        executable serves every chunk); ``mode="stepped"`` (or ``"auto"``
        with a finite ``launch_ceiling_s``) runs each chunk as tranche
        spans (``run(mode="stepped")`` semantics, vmapped). Member
        results are unchanged by either knob.

        ``mesh``: shard the member axis over the mesh's dp extent
        (members are independent programs — zero collectives, linear
        scaling; the arena arg is replicated). Host sim analogue: one
        process per variant/seed; reference analogue: sequential driver
        re-runs."""
        bd = int(self.exp.BD if max_replans is None else max_replans)
        n = int(n)
        if mode not in ("auto", "one", "stepped"):
            raise ValueError(f"mode must be auto|one|stepped, got {mode!r}")
        ceiling = self._launch_ceiling()
        stepped = (mode == "stepped"
                   or (mode == "auto" and np.isfinite(ceiling)))
        c = n if seed_chunk is None else int(seed_chunk)
        c = max(1, min(c, n))
        if mesh is not None:
            from mfgp_jax.parallel.mesh import DP_AXIS

            dp = mesh.shape[DP_AXIS]
            if c % dp:
                raise ValueError(
                    f"ensemble launch width {c} must be a multiple of the "
                    f"mesh dp extent {dp} (the member axis shards over dp;"
                    " pick seed_chunk accordingly)")
        results = []
        for s0 in range(0, n, c):
            k = min(c, n - s0)
            # tail chunks pad to c lanes (repeating lane 0's seed) so the
            # shapes — and hence the compiled executable — match; the
            # padded extras are dropped below
            keys = jnp.stack([jax.random.key(
                self.seed + s0 + (i if i < k else 0)) for i in range(c)])
            if stepped:
                st = self._run_ens_stepped(keys, bd, ceiling, mesh)
            else:
                st = self._run_ens_one(keys, bd, mesh)
            st = {kk: np.asarray(v) for kk, v in st.items()}
            results.extend(self._unpack_result(
                {kk: v[i] for kk, v in st.items()}, bd) for i in range(k))
        return results

    def _run_ens_one(self, keys, bd, mesh):
        """One vmapped launch of whole missions (the flagship form)."""
        from mfgp_jax.planning.rig_device import _index_gather

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from mfgp_jax.parallel.mesh import DP_AXIS

            keys = jax.device_put(keys, NamedSharding(mesh, P(DP_AXIS)))
        if not hasattr(self, "_ens_jit"):
            self._ens_jit = {}
        fn = self._ens_jit.get(bd)
        if fn is None:
            fn = jax.jit(jax.vmap(
                lambda k, a: self._run_impl(k, a, bd=bd),
                in_axes=(0, None)))
            self._ens_jit[bd] = fn
        # the inlined planner's index ops: gather lowers better under
        # the member vmap (one-hot streams O(members x ARENA) per read)
        with _index_gather(True):
            st = fn(keys, self._arena0)
        self.last_run_launches = 1
        return dict(st)

    def _run_ens_stepped(self, keys, bd, ceiling, mesh):
        """Vmapped stepped execution: tranche spans under the ceiling,
        every lane advancing in lockstep over the carried batched state."""
        import time
        import warnings

        from mfgp_jax.planning.rig_device import _index_gather

        if self._ens_span_jit is None:
            self._ens_span_jit = jax.jit(
                jax.vmap(self._span_impl, in_axes=(0, None, None)))
            self._ens_finish_jit = jax.jit(jax.vmap(self._finish_impl))
        st = jax.vmap(
            lambda kk: self._init_state(kk, self._arena0, bd))(keys)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from mfgp_jax.parallel.mesh import DP_AXIS

            st = jax.device_put(st, NamedSharding(mesh, P(DP_AXIS)))
        r, chunk, launches = 0, 1, 0
        warned = False
        while r < bd:
            r1 = min(r + chunk, bd)
            t0 = time.perf_counter()
            with _index_gather(True):  # vmapped lanes: gather wins
                st = self._ens_span_jit(st, np.int32(r), np.int32(r1))
                jax.block_until_ready(st)
            wall = time.perf_counter() - t0
            launches += 1
            per = wall / (r1 - r)
            if (launches >= 2 and np.isfinite(ceiling) and per > ceiling
                    and not warned):
                warnings.warn(
                    f"one vmapped mission tranche takes {per:.1f}s > the "
                    f"{ceiling:.0f}s launch ceiling; lower seed_chunk or "
                    "plan_iters/fit_maxiter, or raise launch_ceiling_s",
                    RuntimeWarning)
                warned = True
            if not np.isfinite(ceiling) or launches == 1:
                chunk = 1  # first span's wall-clock includes compile
            else:
                chunk = max(1, min(bd, int(0.7 * ceiling
                                           / max(per, 1e-9))))
            r = r1
        with _index_gather(True):
            st = self._ens_finish_jit(st)
        jax.block_until_ready(st)
        self.last_run_launches = launches + 1
        return dict(st)

    def _unpack_result(self, st: dict, bd: int) -> DeviceMissionResult:
        did = st["did"]
        dyn = self.flight == "dynamic"
        replans = [dict(plan_num=int(r), info=float(st["info"][r]),
                        budget=float(st["budget"][r]),
                        t_flown=float(st["t_flown"][r]),
                        nodes=int(st["nodes"][r]),
                        edges=int(st["edges"][r]),
                        **(dict(tracking_rmse=float(st["track"][r]),
                                flown_budget=float(st["fbudget"][r]))
                           if dyn else {}))
                   for r in range(bd) if did[r]]
        rows = st["rows"][st["rows_mask"]]
        gp_data = Table(GPDATA_HEADER.split(","),
                        rows if rows.size else np.zeros((0, 9)))
        return DeviceMissionResult(
            gp_data=gp_data, replans=replans, theta=st["theta"],
            budget_used=float(st["planned"]), rmse=float(st["rmse"]),
            n_replans=int(did.sum()), flown=st["flown"],
            flown_mask=st["flown_mask"], test_mu=st["test_mu"],
            test_var=st["test_var"],
            chain_overflow=bool(st["overflow"]),
            tracking_rmse=st["track"] if dyn else None,
            flown_budget=st["fbudget"] if dyn else None,
            meas_overflow=bool(st["m_overflow"]) if dyn else False,
            thetas=st["thetas"], eids=st["eids"])

    # -- artifacts ------------------------------------------------------------
    def save_artifacts(self, res: DeviceMissionResult, out_dir: str):
        """Write a mission result as the reference's per-replan artifact
        set (the schemas ``sim.explore`` emits, SURVEY §5: plannedTraj
        ``reference/...MFEGP.py:469-483``, EID grids ``:672``, hyp rows
        per replan ``:412-417``, replans summary) so comparison tooling
        built for host-loop runs reads device-mission runs unchanged:

        - ``GPData.csv`` — the harvested fidelity-binned training table
        - ``plannedTraj{n}.csv`` — (x, y, z, t) rows of replan n's plan
        - ``EID{n}.csv`` — grid coords + the EID replan n planned on
        - ``hyps.csv`` — per-replan POSITIVE hyperparameters (one row per
          replan; constant rows under frozen hyperparameters)
        - ``replans.csv`` — the host loop's summary schema (fitMode
          "device"; fitSeconds 0 — refits are in-graph)
        """
        import os

        os.makedirs(out_dir, exist_ok=True)
        res.gp_data.save(os.path.join(out_dir, "GPData.csv"))
        done = [r["plan_num"] for r in res.replans]
        for n in done:
            mask = res.flown_mask[n]
            np.savetxt(os.path.join(out_dir, f"plannedTraj{n}.csv"),
                       res.flown[n][mask], delimiter=",")
            np.savetxt(os.path.join(out_dir, f"EID{n}.csv"),
                       np.column_stack([self.grid, res.eids[n]]),
                       delimiter=",")
        if res.thetas is not None and done:
            np.savetxt(os.path.join(out_dir, "hyps.csv"),
                       np.exp(res.thetas[done]), delimiter=",")
        tranche = self.exp.B / self.exp.BD
        with open(os.path.join(out_dir, "replans.csv"), "w") as f:
            f.write("planNum,tStart,tranche,bestInfo,nodes,edges,"
                    "fitSeconds,fitMode,trackingRmse,flownBudget,"
                    "planTruncated\n")
            t_start = 0.0
            for r in res.replans:
                f.write(f"{r['plan_num']},{t_start},{tranche},"
                        f"{r['info']},{r['nodes']},{r['edges']},"
                        f"0.0,device,"
                        f"{r.get('tracking_rmse', '')},"
                        f"{r.get('flown_budget', '')},0\n")
                t_start += r["t_flown"]

    # -- introspection --------------------------------------------------------
    def host_params(self, theta):
        """A mission log-parameter vector as host model params (GPParams /
        MFGPParams) — for conditioning a host model at the mission's
        refitted hyperparameters in parity checks."""
        from mfgp_jax.models.gp import GPParams
        from mfgp_jax.models.mfgp import MFGPParams

        theta = jnp.asarray(theta, self.dtype)
        if self.mf:
            F, D = self.F, self.D
            return MFGPParams(theta[:F], theta[F:F + F * D].reshape(F, D),
                              self._rhos0, theta[F + F * D:])
        D = self.D
        return GPParams(theta[0], theta[1:1 + D], theta[1 + D])

    def harvested(self, res: DeviceMissionResult):
        """(X, fid_emukit, y) of the valid harvested training rows — for
        cross-checking the arena posterior against a host-conditioned
        model on the same data."""
        d = res.gp_data.data
        X = d[:, 4:7]
        y = d[:, 7]
        fid = (3 - d[:, 8]).astype(int) if self.mf \
            else np.zeros(d.shape[0], int)
        return X, fid, y


def run_campaign(variants=("MFEGP", "MFGP", "SFEGP", "SFGP"),
                 n_seeds: int = 5, seed: int = 0, exp_kw: dict | None = None,
                 mesh=None, mode: str = "auto",
                 seed_chunk: Optional[int] = None, **mission_kw) -> dict:
    """The reference's whole experiment CAMPAIGN — its four closed-loop
    driver scripts x repeat runs (SURVEY C25: GraceExplorationExperiments_
    {MFEGP,MFGP,SFEGP,SFGP}.py, one multi-hour host loop per run) — as
    ONE vmapped :class:`DeviceMission` launch per variant.

    Four compiled programs total (the variants differ in cost menu and
    model family); each launch runs ``n_seeds`` COMPLETE missions (seeds
    ``seed..seed+n_seeds-1``), sharded over ``mesh``'s dp extent when a
    mesh is given. Member i of a variant equals
    ``DeviceMission(exp_of(variant), seed=seed+i).run()`` (the
    run_ensemble reproducibility contract), so campaign statistics are
    statistics of real runs.

    ``mode``/``seed_chunk`` forward to :meth:`DeviceMission.run_ensemble`
    (seed-axis chunking and stepped tranche spans).

    Returns ``{variant: {"rmse": [...], "replans": [...],
    "budget_used": [...], "seconds": float, "results":
    [DeviceMissionResult, ...]}}``.
    """
    import time

    from mfgp_jax.utils.configs import ExperimentConfig

    out = {}
    for v in variants:
        v = v.upper()
        if v not in ("MFEGP", "MFGP", "SFEGP", "SFGP"):
            raise ValueError(f"unknown variant {v!r} (the reference "
                             "campaign is MFEGP/MFGP/SFEGP/SFGP)")
        kw = dict(exp_kw or {})
        kw.update(multi_fidelity=v.startswith("MF"),
                  ergodic=v in ("MFEGP", "SFEGP"))
        mission = DeviceMission(ExperimentConfig(**kw), seed=seed,
                                **mission_kw)
        t0 = time.perf_counter()
        results = mission.run_ensemble(n_seeds, mesh=mesh, mode=mode,
                                       seed_chunk=seed_chunk)
        out[v] = dict(rmse=[r.rmse for r in results],
                      replans=[r.n_replans for r in results],
                      budget_used=[r.budget_used for r in results],
                      seconds=time.perf_counter() - t0,
                      results=results)
    return out
