"""Recursive multi-fidelity GP (Le Gratiet & Garnier formulation).

An alternative to the joint AR1 model (models/mfgp.py, the reference's
emukit formulation): train one GP per fidelity level on the *residuals*
against the previous level's posterior mean,

    f_0 ~ GP(0, k_0)
    d_m = y_m - rho_m * mu_{m-1}(X_m),    delta_m ~ GP(0, k_m)
    mu_m(x)    = rho_m mu_{m-1}(x)    + mu_{delta_m}(x)
    sig2_m(x)  = rho_m^2 sig2_{m-1}(x) + sig2_{delta_m}(x)

For nested designs (X_m a subset of X_{m-1}) this reproduces the joint
AR1 posterior exactly (Le Gratiet 2013); for non-nested designs it is the
standard recursive approximation (see PAPERS.md: arxiv 2511.20183 compares
the two). Cost: O(sum_m N_m^3) independent Cholesky factorizations instead
of O((sum N_m)^3) on the joint covariance — the levels train concurrently
on device and the per-level solves are much smaller.

Not in the reference (which only has the emukit joint model,
reference/GPTrainers.py:60-68); provided as the faster-training
alternative with the same data conventions (fidelity 0 = lowest; predict
at the highest level).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from mfgp_jax.models.gp import GP


@dataclass
class RecursiveMFGP:
    """Per-level residual GPs with scalar AR1 couplings.

    >>> m = RecursiveMFGP.from_fidelity_lists([Xlo, Xmid, Xhi],
    ...                                       [ylo, ymid, yhi])
    >>> m.optimize()
    >>> mu, var = m.predict(Xs)      # at the highest fidelity
    """

    X_list: List[np.ndarray]  # lowest -> highest fidelity
    y_list: List[np.ndarray]
    kernel: str = "rbf"
    jitter: float = 1e-6
    fix_rhos: bool = True  # the reference fixes the AR1 scales to 1
    rhos: np.ndarray | None = None  # (F-1,)
    residual_mode: str = "posterior_mean"  # or "observed"

    def __post_init__(self):
        self.X_list = [np.atleast_2d(np.asarray(x, float))
                       for x in self.X_list]
        self.y_list = [np.asarray(y, float).reshape(-1)
                       for y in self.y_list]
        self.F = len(self.X_list)
        if self.rhos is None:
            self.rhos = np.ones(self.F - 1)
        self.levels: List[GP] = []
        self._build()

    @classmethod
    def from_fidelity_lists(cls, X_list, y_list, **kw):
        return cls(list(X_list), list(y_list), **kw)

    # -- fitting ------------------------------------------------------------
    def _level_residuals(self, m: int) -> np.ndarray:
        """Targets for level m: y_m minus the coupled lower level.

        ``posterior_mean`` mode subtracts the recursive posterior mean of
        level m-1 (works for any design); ``observed`` mode subtracts the
        *observed* y_{m-1} at shared points (Le Gratiet's construction —
        exact joint-model equivalence for nested, noise-free designs),
        falling back to the posterior mean where a point has no lower-level
        observation."""
        if m == 0:
            return self.y_list[0]
        mu_prev, _ = self._predict_level(m - 1, self.X_list[m])
        base = np.array(mu_prev)
        if self.residual_mode == "observed":
            Xlo = self.X_list[m - 1]
            ylo = self.y_list[m - 1]
            for i, x in enumerate(self.X_list[m]):
                hits = np.where((np.abs(Xlo - x) < 1e-12).all(axis=1))[0]
                if hits.size:
                    base[i] = ylo[hits[0]]
        return self.y_list[m] - self.rhos[m - 1] * base

    def _build(self):
        """(Re)build the per-level GPs at current hyps/rhos."""
        self.levels = []
        for m in range(self.F):
            if self.X_list[m].shape[0] == 0:
                self.levels.append(None)
                continue
            d = self._level_residuals(m)
            gp = GP(self.X_list[m], d, kernel=self.kernel,
                    jitter=self.jitter)
            self.levels.append(gp)

    def optimize(self, n_restarts: int = 4, maxiter: int = 200,
                 seed: int = 0):
        """Fit level by level (each level's residuals depend on the fitted
        level below). Per-level fits are device-batched restart L-BFGS."""
        for m in range(self.F):
            if self.X_list[m].shape[0] == 0:
                continue
            d = self._level_residuals(m)
            gp = GP(self.X_list[m], d, kernel=self.kernel,
                    jitter=self.jitter)
            if self.X_list[m].shape[0] >= 3:
                gp.optimize_restarts(n_restarts=n_restarts, maxiter=maxiter,
                                     seed=seed + m)
            self.levels[m] = gp
            if not self.fix_rhos and m + 1 < self.F and \
                    self.X_list[m + 1].shape[0] >= 2:
                # closed-form LS estimate of rho_{m+1}: regress y_{m+1}
                # on mu_m(X_{m+1})
                mu, _ = self._predict_level(m, self.X_list[m + 1])
                mu = np.asarray(mu)
                denom = float(mu @ mu)
                if denom > 0:
                    self.rhos[m] = float(mu @ self.y_list[m + 1]) / denom
        return self

    # -- prediction ---------------------------------------------------------
    def _predict_level(self, m: int, Xs):
        gp = self.levels[m]
        if gp is None:
            mu = np.zeros(np.atleast_2d(Xs).shape[0])
            var = np.zeros_like(mu)
        else:
            mu_j, var_j = gp.predict(Xs, include_noise=False)
            mu, var = np.asarray(mu_j), np.asarray(var_j)
        if m == 0:
            return mu, var
        mu_lo, var_lo = self._predict_level(m - 1, Xs)
        r = self.rhos[m - 1]
        return r * mu_lo + mu, r * r * var_lo + var

    def predict(self, Xs, level: int | None = None,
                include_noise: bool = True):
        """Posterior at fidelity ``level`` (default: highest)."""
        level = self.F - 1 if level is None else level
        mu, var = self._predict_level(level, Xs)
        if include_noise and self.levels[level] is not None:
            var = var + float(self.levels[level].params.noise)
        return mu, var

    # -- interop ------------------------------------------------------------
    @property
    def param_array(self) -> np.ndarray:
        """[per-level GPy vectors ..., rhos] — not the emukit 17-layout
        (different model family); kept stable for checkpointing."""
        parts = [lvl.param_array if lvl is not None else np.array([])
                 for lvl in self.levels]
        return np.concatenate(parts + [self.rhos])
