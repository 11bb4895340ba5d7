"""Batched device scoring of candidate paths.

SURVEY C13/C14: the planner's path-cost family. Each cost exposes

* ``__call__(points)`` — score one path (points = (T, 5) rows of
  x, y, depth, t, variance from ``primitives.path_to_traj_points``);
* ``batch(list_of_points)`` — score many candidate paths in one jitted
  vmap launch, padding each to a shape bucket (powers of two) so XLA
  compiles a handful of shapes once per planning *session*, not per replan.

This is the planner's hot loop: the reference re-fits a GPy model per
trajectory point per candidate (reference/GraceRIGV3.py:443-503), while
here every candidate costs one posterior-covariance block + one Cholesky,
batched across candidates. All jitted entry points are module-level and
take arrays as arguments, so successive replans (same shape buckets) reuse
the compiled executables.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.metrics.ergodic import kl_divergence, trajectory_distribution
from mfgp_jax.metrics.fourier import (basis_norms, config_k,
                                      fourier_basis, fourier_coefficients,
                                      sobolev_weights)
from mfgp_jax.metrics.info_gain import (sequential_gain_from_cov,
                                        sequential_gain_cross)
from mfgp_jax.models import gp as gpm
from mfgp_jax.models import mfgp as mfm
from mfgp_jax.ops import kernels as _k
from mfgp_jax.ops import linalg as _la


def fids_from_variance(var, fid_levels, n_fidelities: int):
    """Accrued localization variance -> conditioning fidelity label.

    Reference semantics (reference/GraceRIGV3.py:528-533): below the first
    threshold -> highest fidelity (F-1), each further threshold steps one
    level down, floor 0. Generalized to any F (the previous copies
    hardcoded F=3 and crashed or mislabelled otherwise).
    """
    fl = np.asarray(fid_levels, float)
    if fl.shape[0] < n_fidelities - 1:
        raise ValueError(
            f"need {n_fidelities - 1} fidelity thresholds, got {fl.shape[0]}")
    lev = np.searchsorted(fl[: n_fidelities - 1], np.asarray(var),
                          side="right")
    return (n_fidelities - 1 - lev).astype(np.int32)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_paths(paths: Sequence[np.ndarray], width: int):
    """Pad (T_i, width) arrays to a common bucketed T; returns
    (B, T, width) array + (B, T) bool mask. The final row is repeated into
    the padding (keeps interpolants finite); masks remove its weight."""
    T = _bucket(max(p.shape[0] for p in paths))
    B = len(paths)
    out = np.zeros((B, T, width))
    mask = np.zeros((B, T), bool)
    for i, p in enumerate(paths):
        t = p.shape[0]
        out[i, :t] = p[:, :width]
        out[i, t:] = p[-1, :width]
        mask[i, :t] = True
    return jnp.asarray(out), jnp.asarray(mask)


# ---------------------------------------------------------------------------
# jitted kernels (module level: compile once per shape bucket)
# ---------------------------------------------------------------------------
@jax.jit
def _ergodic_one(t, xyz, mask, grid, sigma_diag, p_floored):
    q = trajectory_distribution(t, xyz, grid, sigma_diag, mask=mask)
    floor = jnp.minimum(jnp.min(jnp.where(q > 0, q, jnp.inf)), 1e-15)
    q = jnp.where(jnp.any(q == 0), q + floor, q)
    return -kl_divergence(q, p_floored)


@jax.jit
def _ergodic_batch(pts, mask, grid, sigma_diag, p_floored):
    return jax.vmap(
        lambda p, m: _ergodic_one(p[:, 3], p[:, :3], m, grid, sigma_diag,
                                  p_floored))(pts, mask)


@partial(jax.jit, static_argnames=("kernel",))
def _sf_gain_one(xyz, mask, X, L, variance, lengthscales, sig_n,
                 kernel="rbf"):
    kern = _k.KERNELS[kernel]
    Kxs = kern(xyz, X, variance, lengthscales)
    Kss = kern(xyz, xyz, variance, lengthscales)
    Sigma = _la.posterior_cov(Kss, Kxs, L)
    return sequential_gain_from_cov(Sigma, sig_n, mask=mask)


@partial(jax.jit, static_argnames=("kernel",))
def _sf_gain_batch(pts, mask, X, L, variance, lengthscales, sig_n,
                   kernel="rbf"):
    return jax.vmap(
        lambda p, m: _sf_gain_one(p, m, X, L, variance, lengthscales, sig_n,
                                  kernel))(pts, mask)


@partial(jax.jit, static_argnames=("kernel",))
def _mf_gain_one(xyz, fid_c, mask, X, fidX, L, variances, lengthscales,
                 rhos, noises, kernel="rbf"):
    F = variances.shape[0]
    fid_p = jnp.zeros(xyz.shape[0], jnp.int32)
    Kc_x = _k.ar1_cov(xyz, fid_c, X, fidX, variances, lengthscales, rhos,
                      kernel)
    Kp_x = _k.ar1_cov(xyz, fid_p, X, fidX, variances, lengthscales, rhos,
                      kernel)
    Kcc = _k.ar1_cov(xyz, fid_c, xyz, fid_c, variances, lengthscales, rhos,
                     kernel)
    Kpc = _k.ar1_cov(xyz, fid_p, xyz, fid_c, variances, lengthscales, rhos,
                     kernel)
    W = _k.ar1_fidelity_weights(rhos, F)
    kpp_diag = jnp.sum((W[:, fid_p] ** 2) * variances[:, None], axis=0)

    Vc = _la.tri_solve(L, Kc_x.T)
    Vp = _la.tri_solve(L, Kp_x.T)
    Sig_cc = Kcc - Vc.T @ Vc
    Sig_pc = Kpc - Vp.T @ Vc
    sig_pp = kpp_diag - jnp.sum(Vp * Vp, axis=0)
    C = Sig_cc + jnp.diag(_k.mf_noise_diag(fid_c, noises))
    if mask is not None:
        P = C.shape[0]
        mm = mask[:, None] & mask[None, :]
        C = jnp.where(mm, C, jnp.eye(P, dtype=C.dtype))
        Sig_pc = jnp.where(mm, Sig_pc, 0.0)
    return sequential_gain_cross(sig_pp, Sig_pc, C, noises[0], noises[0],
                                 mask=mask)


@partial(jax.jit, static_argnames=("kernel",))
def _mf_gain_batch(pts, fids, mask, X, fidX, L, variances, lengthscales,
                   rhos, noises, kernel="rbf"):
    return jax.vmap(
        lambda p, f, m: _mf_gain_one(p, f, m, X, fidX, L, variances,
                                     lengthscales, rhos, noises, kernel)
    )(pts, fids, mask)


@partial(jax.jit, static_argnames=("kernel", "clamp"))
def _logdet_gain_one(xyz, mask, X, L, grid, variance, lengthscales, noise,
                     logdet_prior, kernel="rbf", clamp=True):
    kern = _k.KERNELS[kernel]
    P = xyz.shape[0]
    B = kern(X, xyz, variance, lengthscales)  # (N, P)
    C = kern(xyz, xyz, variance, lengthscales) + noise * jnp.eye(
        P, dtype=xyz.dtype)
    Kg_path = kern(grid, xyz, variance, lengthscales)  # (G, P)
    if mask is not None:
        mm = mask[:, None] & mask[None, :]
        B = jnp.where(mask[None, :], B, 0.0)
        C = jnp.where(mm, C, jnp.eye(P, dtype=C.dtype) * noise)
        Kg_path = jnp.where(mask[None, :], Kg_path, 0.0)
    L_ext = _la.chol_append_block(L, B, C)
    Kg_train = kern(grid, X, variance, lengthscales)
    Kxs = jnp.concatenate([Kg_train, Kg_path], axis=1)
    Kss = kern(grid, grid, variance, lengthscales)
    cov = _la.posterior_cov(Kss, Kxs, L_ext) + noise * jnp.eye(
        grid.shape[0], dtype=xyz.dtype)
    I = 0.5 * (logdet_prior - _la.logdet_from_chol(_la.chol(cov)))
    if clamp:
        I = jnp.maximum(I, 0.0)
    return I


@partial(jax.jit, static_argnames=("kernel", "clamp"))
def _logdet_gain_batch(pts, mask, X, L, grid, variance, lengthscales, noise,
                       logdet_prior, kernel="rbf", clamp=True):
    return jax.vmap(
        lambda p, m: _logdet_gain_one(p, m, X, L, grid, variance,
                                      lengthscales, noise, logdet_prior,
                                      kernel, clamp))(pts, mask)


@partial(jax.jit, static_argnames=("kernel",))
def _mf_logdet_gain_one(xyz, fid_c, mask, X, fidX, L, variances,
                        lengthscales, rhos, noises, grid, logdet_prior,
                        kernel="rbf"):
    """MF batch mutual information (reference ``calculatePathInfoEmuBatch``,
    reference/PhysicalExperimentCode/GraceRIGV3.py:599-617): grid posterior
    covariance at the highest fidelity, conditioning extended by the path
    points at their accrued-variance fidelity labels via one bordered
    Cholesky block."""
    F = variances.shape[0]
    P = xyz.shape[0]
    G = grid.shape[0]
    fid_g = jnp.full((G,), F - 1, jnp.int32)
    B = _k.ar1_cov(X, fidX, xyz, fid_c, variances, lengthscales, rhos,
                   kernel)  # (N, P)
    C = _k.ar1_cov(xyz, fid_c, xyz, fid_c, variances, lengthscales, rhos,
                   kernel) + jnp.diag(_k.mf_noise_diag(fid_c, noises))
    Kg_path = _k.ar1_cov(grid, fid_g, xyz, fid_c, variances, lengthscales,
                         rhos, kernel)  # (G, P)
    if mask is not None:
        mm = mask[:, None] & mask[None, :]
        B = jnp.where(mask[None, :], B, 0.0)
        C = jnp.where(mm, C, jnp.eye(P, dtype=C.dtype))
        Kg_path = jnp.where(mask[None, :], Kg_path, 0.0)
    L_ext = _la.chol_append_block(L, B, C)
    Kg_train = _k.ar1_cov(grid, fid_g, X, fidX, variances, lengthscales,
                          rhos, kernel)
    Kxs = jnp.concatenate([Kg_train, Kg_path], axis=1)
    Kss = _k.ar1_cov(grid, fid_g, grid, fid_g, variances, lengthscales,
                     rhos, kernel)
    cov = (_la.posterior_cov(Kss, Kxs, L_ext)
           + noises[F - 1] * jnp.eye(G, dtype=grid.dtype))
    return 0.5 * (logdet_prior - _la.logdet_from_chol(_la.chol(cov)))


@partial(jax.jit, static_argnames=("kernel",))
def _mf_logdet_gain_batch(pts, fids, mask, X, fidX, L, variances,
                          lengthscales, rhos, noises, grid, logdet_prior,
                          kernel="rbf"):
    return jax.vmap(
        lambda p, f, m: _mf_logdet_gain_one(
            p, f, m, X, fidX, L, variances, lengthscales, rhos, noises,
            grid, logdet_prior, kernel))(pts, fids, mask)


# ---------------------------------------------------------------------------
# cost objects
# ---------------------------------------------------------------------------
@dataclass(eq=False)
class ErgodicCost:
    """Negative forward-KL between trajectory statistics and the EID
    (SURVEY C14, reference/GraceRIGV3.py:581-596): cost = -KL(q || EID).

    Zero-probability handling matches the reference: both q and the EID are
    floored by their smallest positive entry (capped at 1e-15) before the
    KL (reference/GraceRIGV3.py:588-592).
    """

    eid: np.ndarray  # (G,)
    grid: np.ndarray  # (G, d)
    sigma_diag: np.ndarray | None = None

    def __post_init__(self):
        self.grid = jnp.asarray(self.grid)
        if self.sigma_diag is None:
            self.sigma_diag = 0.25 * jnp.ones(self.grid.shape[1])
        self.sigma_diag = jnp.asarray(self.sigma_diag)
        p = jnp.asarray(self.eid).reshape(-1)
        floor = jnp.minimum(jnp.min(jnp.where(p > 0, p, jnp.inf)), 1e-15)
        self._p = jnp.where(jnp.any(p == 0), p + floor, p)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(_ergodic_one(jnp.asarray(points[:, 3]),
                                  jnp.asarray(points[:, :3]), None,
                                  self.grid, self.sigma_diag, self._p))

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask = _pad_paths(paths, 4)
        return np.asarray(_ergodic_batch(pts, mask, self.grid,
                                         self.sigma_diag, self._p))


@jax.jit
def _fourier_erg_one(xyz_unit, mask, k, hk, lamk, target_coef):
    w = (mask.astype(xyz_unit.dtype) if mask is not None
         else jnp.ones(xyz_unit.shape[0], xyz_unit.dtype))
    F = fourier_basis(xyz_unit, k)  # (M, T)
    coef = jnp.sum(F * w[None, :], axis=1) / jnp.maximum(jnp.sum(w), 1.0) / hk
    return -jnp.sum(lamk * (coef - target_coef) ** 2)


@jax.jit
def _fourier_erg_batch(pts, mask, k, hk, lamk, target_coef):
    return jax.vmap(lambda p, m: _fourier_erg_one(p, m, k, hk, lamk,
                                                  target_coef))(pts, mask)


@dataclass(eq=False)
class FourierErgodicCost:
    """Spectral (Sobolev-norm) ergodic cost over the cosine basis.

    The reference implements this metric standalone and never wires it into
    the planner (SURVEY C11, reference/PhysicalExperimentCode/
    ergodicMetric.py); here it is a first-class planner cost: score =
    -sum_k lambda_k (c_k(traj) - c_k(target))^2, with the target
    coefficients precomputed from the EID over the grid. Coordinates are
    normalized to the unit box (the cosine basis domain).
    """

    eid: np.ndarray  # (G,) target distribution over grid
    grid: np.ndarray  # (G, d)
    bounds: np.ndarray  # (d, 2) workspace box for unit normalization
    n_coefs: int = 5  # coefficients per dimension

    def __post_init__(self):
        self.bounds = np.asarray(self.bounds, float)
        d = self.bounds.shape[0]
        lengths = self.bounds[:, 1] - self.bounds[:, 0]
        self._k = jnp.asarray(config_k(*[(self.n_coefs, 1.0)] * d))
        self._hk = basis_norms(self._k)
        self._lamk = sobolev_weights(self._k)
        gu = (np.asarray(self.grid)[:, :d] - self.bounds[:, 0]) / lengths
        p = np.asarray(self.eid).reshape(-1)
        self._target = fourier_coefficients(jnp.asarray(gu), jnp.asarray(p)
                                            * p.shape[0], self._k, self._hk)
        self._lo = jnp.asarray(self.bounds[:, 0])
        self._ilen = jnp.asarray(1.0 / lengths)
        self._d = d

    def _unit(self, xyz):
        return (jnp.asarray(xyz[:, : self._d]) - self._lo) * self._ilen

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(_fourier_erg_one(self._unit(points), None, self._k,
                                      self._hk, self._lamk, self._target))

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask = _pad_paths(paths, self._d)
        units = jax.vmap(self._unit)(pts)
        return np.asarray(_fourier_erg_batch(units, mask, self._k, self._hk,
                                             self._lamk, self._target))


@dataclass(eq=False)
class SFInfoGainCost:
    """Sequential entropy gain against a single-fidelity GP
    (reference ``calcPathInfoSF2``, reference/GraceRIGV3.py:443-466),
    closed form, one Cholesky per candidate."""

    model: gpm.GP

    def __post_init__(self):
        m = self.model
        self._args = (m.state.X, m.state.L, m.params.variance,
                      m.params.lengthscales, m.params.noise)
        self._kernel = m.kernel

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(_sf_gain_one(jnp.asarray(points[:, :3]), None,
                                  *self._args, kernel=self._kernel))

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask = _pad_paths(paths, 3)
        return np.asarray(_sf_gain_batch(pts, mask, *self._args,
                                         kernel=self._kernel))


@dataclass(eq=False)
class MFInfoGainCost:
    """Sequential gain against the multi-fidelity model
    (reference ``calculatePathInfoEmu``, reference/GraceRIGV3.py:525-562):
    each path point conditions at the fidelity implied by its accrued
    localization variance; prediction happens at fidelity 0 with the
    fidelity-0 likelihood noise as reference scale."""

    model: mfm.MFGP
    fid_levels: Sequence[float]  # ascending variance thresholds

    def __post_init__(self):
        m = self.model
        p = m.params
        self._args = (m.state.X, m.state.fid, m.state.L, p.variances,
                      p.lengthscales, p.rhos, p.noises)
        self._kernel = m.kernel
        self._F = int(p.variances.shape[0])

    def _fids_from_var(self, var):
        return fids_from_variance(var, self.fid_levels, self._F)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        fids = self._fids_from_var(points[:, 4])
        return float(_mf_gain_one(jnp.asarray(points[:, :3]),
                                  jnp.asarray(fids), None, *self._args,
                                  kernel=self._kernel))

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask = _pad_paths(paths, 5)
        fids = jnp.asarray(self._fids_from_var(np.asarray(pts[..., 4])))
        return np.asarray(_mf_gain_batch(pts[..., :3], fids, mask,
                                         *self._args, kernel=self._kernel))


@dataclass(eq=False)
class MFBatchLogDetCost:
    """Multi-fidelity batch mutual-information score over the eval grid
    (reference ``calculatePathInfoEmuBatch``, reference/
    PhysicalExperimentCode/GraceRIGV3.py:599-617). Path points condition at
    the fidelity implied by their accrued localization variance
    (labels l1*2+l2*1+l3*0, :602-606); the prior grid log-det is cached per
    instance like the reference's per-plan ``logDetPrior``."""

    model: mfm.MFGP
    grid: np.ndarray
    fid_levels: Sequence[float]

    def __post_init__(self):
        m = self.model
        self.grid = jnp.asarray(self.grid, m.X.dtype)
        cov_prior = m.predict_covariance(self.grid)
        self._logdet_prior = _la.logdet_from_chol(_la.chol(cov_prior))
        p = m.params
        self._args = (m.state.X, m.state.fid, m.state.L, p.variances,
                      p.lengthscales, p.rhos, p.noises, self.grid,
                      self._logdet_prior)
        self._kernel = m.kernel
        self._F = int(p.variances.shape[0])

    def _fids_from_var(self, var):
        return fids_from_variance(var, self.fid_levels, self._F)

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        fids = self._fids_from_var(points[:, 4])
        return float(_mf_logdet_gain_one(
            jnp.asarray(points[:, :3]), jnp.asarray(fids), None,
            *self._args, kernel=self._kernel))

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask = _pad_paths(paths, 5)
        fids = jnp.asarray(self._fids_from_var(np.asarray(pts[..., 4])))
        return np.asarray(_mf_logdet_gain_batch(
            pts[..., :3], fids, mask, *self._args, kernel=self._kernel))


@dataclass(eq=False)
class BatchLogDetCost:
    """Batch mutual-information score over a fixed evaluation grid
    (reference ``calcPathInfoSFBatch``, reference/PhysicalExperimentCode/
    GraceRIGV3.py:571-598): 0.5 (log|Sigma_prior(grid)| -
    log|Sigma_post(grid | train + path)|); the prior log-determinant is
    cached per session like the reference's ``logDetPrior``. Conditioning
    on the path extends the training Cholesky by one block (O(N^2 P))
    instead of refitting.
    """

    model: gpm.GP
    grid: np.ndarray
    clamp_nonnegative: bool = True  # the reference's SF variant clamps >= 0

    def __post_init__(self):
        m = self.model
        self.grid = jnp.asarray(self.grid)
        _, cov_prior = m.predict(self.grid, full_cov=True, include_noise=True)
        self._logdet_prior = _la.logdet_from_chol(_la.chol(cov_prior))
        self._args = (m.state.X, m.state.L, self.grid, m.params.variance,
                      m.params.lengthscales, m.params.noise,
                      self._logdet_prior)
        self._kernel = m.kernel

    def __call__(self, points: np.ndarray) -> float:
        if points.shape[0] == 0:
            return -np.inf
        return float(_logdet_gain_one(jnp.asarray(points[:, :3]), None,
                                      *self._args, kernel=self._kernel,
                                      clamp=self.clamp_nonnegative))

    def batch(self, paths: Sequence[np.ndarray]) -> np.ndarray:
        pts, mask = _pad_paths(paths, 3)
        return np.asarray(_logdet_gain_batch(pts, mask, *self._args,
                                             kernel=self._kernel,
                                             clamp=self.clamp_nonnegative))
