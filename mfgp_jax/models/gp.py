"""Single-fidelity exact GP regression in JAX.

Capability parity with ``GPy.models.GPRegression`` as used by the reference
(reference/GPTrainers.py:80-98: RBF-ARD kernel, ``optimize()``, ``predict``
with optional ``full_cov``; Matern32 variant used by the physical drivers,
reference/PhysicalExperimentCode/GraceExplorationExperiments_SFGP.py:610-615).

Architecture: one pure functional core —

    nlml(params)             exact negative log marginal likelihood,
                             differentiable end to end with jax.grad
    condition(params, X, y)  -> GPState (Cholesky factor + alpha), cached
    predict(state, Xs)       posterior mean / var / full covariance

The stateful :class:`GP` wrapper only stores arrays + params; every compute
path is jitted and dtype-generic (f64 on CPU for parity tests, f32 with
HIGHEST-precision matmuls on the GPU).

Parameter vector layout matches the GPy ``param_array`` the reference saves
to ``*_sfGP.txt`` hyp files: ``[variance, lengthscale_1..D, noise]``
(reference/GPTrainers.py:85-88), so recorded reference hyperparameters load
directly for fixed-hyperparameter parity checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.ops import kernels as _k
from mfgp_jax.ops import linalg as _la
from mfgp_jax.ops.optimize import batched_lbfgs, scipy_lbfgsb

_LOG2PI = float(np.log(2.0 * np.pi))
# the NLML data-fit term is a true f32 dot: at default precision a GPU
# may run an f32 contraction in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


class GPParams(NamedTuple):
    """Log-space hyperparameters (positivity by construction)."""

    log_variance: jax.Array  # ()
    log_lengthscales: jax.Array  # (D,)
    log_noise: jax.Array  # ()

    @property
    def variance(self):
        return jnp.exp(self.log_variance)

    @property
    def lengthscales(self):
        return jnp.exp(self.log_lengthscales)

    @property
    def noise(self):
        return jnp.exp(self.log_noise)

    def to_vector(self) -> jax.Array:
        """GPy ``param_array`` layout: [variance, lengthscales..., noise]."""
        return jnp.concatenate([
            self.variance[None], self.lengthscales, self.noise[None]
        ])

    @staticmethod
    def from_vector(v, D: int) -> "GPParams":
        v = jnp.asarray(v)
        return GPParams(jnp.log(v[0]), jnp.log(v[1 : 1 + D]), jnp.log(v[1 + D]))

    @staticmethod
    def default(D: int, dtype=jnp.float64) -> "GPParams":
        """GPy defaults: variance=1, lengthscale=1, noise=1."""
        z = jnp.zeros((), dtype)
        return GPParams(z, jnp.zeros((D,), dtype), z)


class GPState(NamedTuple):
    """Cached conditioning state: data + Cholesky factor + weights."""

    X: jax.Array  # (N, D)
    y: jax.Array  # (N,)
    L: jax.Array  # (N, N) lower chol of K + noise*I (+ extra diag)
    alpha: jax.Array  # (N,)


def _cov(params: GPParams, X1, X2, kernel: str):
    return _k.KERNELS[kernel](X1, X2, params.variance, params.lengthscales)


@partial(jax.checkpoint, static_argnums=(4,))
def _assemble_noisy_cov(params: GPParams, X, extra_noise_diag, jitter,
                        kernel: str):
    """K + noise diag, rematerialised so the NLML backward pass doesn't keep
    the kernel matrix + clamp masks alive (see mfgp._assemble_noisy_cov)."""
    N = X.shape[0]
    K = _cov(params, X, X, kernel)
    obs = params.noise + extra_noise_diag + jitter
    return _la.diag_add(K, jnp.broadcast_to(obs, (N,)))


@partial(jax.jit, static_argnames=("kernel",))
def nlml(params: GPParams, X, y, extra_noise_diag=0.0, kernel: str = "rbf",
         jitter: float = 0.0):
    """Exact negative log marginal likelihood.

    ``0.5 y^T K_n^-1 y + 0.5 log|K_n| + 0.5 N log 2pi`` with
    ``K_n = K + (noise + extra_noise_diag) I`` — the quantity GPy's
    ``optimize()`` minimises and the reference's NIGP builds by hand
    (reference/NIGP.py:130-165). ``extra_noise_diag`` carries the NIGP
    per-point input-noise inflation.
    """
    N = X.shape[0]
    Kn = _assemble_noisy_cov(params, X, extra_noise_diag, jitter, kernel)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    return (0.5 * jnp.dot(y, alpha, precision=_HIGHEST)
            + 0.5 * _la.logdet_from_chol(L)
            + 0.5 * N * _LOG2PI)


def _gp_vg_core(params: GPParams, X, y, extra_noise_diag=0.0,
                kernel: str = "rbf", jitter: float = 0.0,
                inv_mode: str | None = None):
    """NLML + analytic gradient (RBF/Matern32): the F=1 case of the
    trace-identity shortcut in models/mfgp.nlml_value_and_grad — ~2.5x
    faster than the Cholesky-VJP backward at large N.
    Returns (value, GPParams-grad, L, alpha, Linv); ``inv_mode`` selects
    the explicit-inverse K^-1 (see mfgp._nlml_vg_core)."""
    if kernel not in ("rbf", "matern32"):
        raise NotImplementedError(f"analytic gradient: {kernel}")
    N, D = X.shape
    K = _cov(params, X, X, kernel)
    obs = params.noise + extra_noise_diag + jitter
    Kn = _la.diag_add(K, jnp.broadcast_to(obs, (N,)))
    L = _la.chol(Kn)
    if inv_mode is None:
        alpha = _la.solve_posterior(L, y)
        Linv = None
    else:
        # alpha via the explicit factor (two streaming triangular
        # matvecs) — see mfgp._nlml_vg_core for the rationale
        Linv = _la.tri_inv_recursive(L)
        z = _la.tri_lower_matmul(Linv, y[:, None])
        alpha = _la.tri_lower_matmul_right(
            z.reshape(1, -1), Linv).reshape(-1)
    val = (0.5 * jnp.dot(y, alpha, precision=_HIGHEST)
           + 0.5 * _la.logdet_from_chol(L)
           + 0.5 * N * _LOG2PI)

    if inv_mode is None:
        Kinv = _la.chol_solve_blocked(L, jnp.eye(N, dtype=X.dtype))
    else:
        from mfgp_jax.models.mfgp import _PRECISIONS

        Kinv = _la.syrk_tri_lower(Linv, precision=_PRECISIONS[inv_mode])
    W = Kinv - alpha[:, None] * alpha[None, :]
    A = W * K  # == W o (dK/dlog variance)
    ones_x = jnp.concatenate([jnp.ones((N, 1), X.dtype), X], axis=1)
    sv = jnp.dot(A, ones_x, precision=jax.lax.Precision.HIGHEST)
    g_logvar = 0.5 * jnp.sum(sv[:, 0])
    if kernel == "matern32":
        # dK/dlog l_d = 3 v e^{-sqrt3 r} r_d^2 (see mfgp version)
        r = jnp.sqrt(_k.sqdist(X, X, 1.0 / params.lengthscales) + 1e-36)
        Als = W * (params.variance * 3.0 * jnp.exp(-1.7320508075688772 * r))
        sv = jnp.dot(Als, ones_x, precision=jax.lax.Precision.HIGHEST)
    s, Ax = sv[:, 0], sv[:, 1:]
    g_logls = (jnp.sum((X**2) * s[:, None], axis=0)
               - jnp.sum(X * Ax, axis=0)) / (params.lengthscales**2)
    g_lognoise = 0.5 * params.noise * jnp.sum(jnp.diagonal(W))
    return val, GPParams(g_logvar, g_logls, g_lognoise), L, alpha, Linv


@partial(jax.jit, static_argnames=("kernel",))
def nlml_value_and_grad(params: GPParams, X, y, extra_noise_diag=0.0,
                        kernel: str = "rbf", jitter: float = 0.0):  # noqa: F811
    """Public (value, grad) wrapper over the shared core."""
    val, grad, _, _, _ = _gp_vg_core(params, X, y, extra_noise_diag, kernel,
                                  jitter)
    return val, grad


@partial(jax.jit, static_argnames=("kernel",))
def nlml_value_grad_state(params: GPParams, X, y, extra_noise_diag=0.0,
                          kernel: str = "rbf", jitter: float = 0.0):
    """(value, grad, conditioned GPState) sharing one factorization — the
    single-fidelity counterpart of mfgp.nlml_value_grad_state."""
    val, grad, L, alpha, _ = _gp_vg_core(params, X, y, extra_noise_diag,
                                         kernel, jitter)
    return val, grad, GPState(X, y, L, alpha)


class GPStateInv(NamedTuple):
    """Conditioned single-fidelity state carrying L^-1 (see
    mfgp.MFGPStateInv for the rationale and measurements)."""

    X: jax.Array
    y: jax.Array
    Linv: jax.Array
    alpha: jax.Array


@partial(jax.jit, static_argnames=("kernel", "inv_mode"))
def nlml_value_grad_state_inv(params: GPParams, X, y, extra_noise_diag=0.0,
                              kernel: str = "rbf", jitter: float = 0.0,
                              inv_mode: str = "highest"):
    """Fast-path (value, grad, GPStateInv): the single-fidelity
    counterpart of mfgp.nlml_value_grad_state_inv."""
    val, grad, _, alpha, Linv = _gp_vg_core(params, X, y, extra_noise_diag,
                                            kernel, jitter,
                                            inv_mode=inv_mode)
    return val, grad, GPStateInv(X, y, Linv, alpha)


@partial(jax.jit, static_argnames=("kernel", "include_noise", "block_size",
                                   "precision"))
def predict_blocked_inv(params: GPParams, state: GPStateInv, Xs,
                        kernel: str = "rbf", include_noise: bool = True,
                        block_size: int = 1024, precision: str = "highest"):
    """Blocked posterior from a GPStateInv: variance substitutions as
    triangular matmuls (see mfgp.predict_blocked_inv)."""
    from mfgp_jax.models.mfgp import _PRECISIONS
    from mfgp_jax.ops import covariance as _cc

    prec = _PRECISIONS[precision]
    M = Xs.shape[0]
    nb = -(-M // block_size)
    pad = nb * block_size - M
    Xs_pad = jnp.pad(Xs, ((0, pad), (0, 0))).reshape(
        nb, block_size, Xs.shape[1])
    noise = params.noise if include_noise else 0.0

    def one(xb):
        Kxs = _cc.sf_cross_cov(params.variance, params.lengthscales, xb,
                               state.X, kernel)
        mean = _la.posterior_mean(Kxs, state.alpha)
        V = _la.tri_lower_matmul(state.Linv, Kxs.T, precision=prec)
        kss = jnp.broadcast_to(params.variance, (xb.shape[0],))
        var = kss - jnp.sum(V * V, axis=0) + noise
        return mean, var

    means, variances = jax.lax.map(one, Xs_pad)
    return means.reshape(-1)[:M], variances.reshape(-1)[:M]


@partial(jax.jit, static_argnames=("kernel",))
def condition(params: GPParams, X, y, extra_noise_diag=0.0,
              kernel: str = "rbf", jitter: float = 0.0) -> GPState:
    from mfgp_jax.ops import covariance as _cc

    Kn = _cc.sf_train_cov(params.variance, params.lengthscales,
                          params.noise + extra_noise_diag + jitter, X,
                          kernel)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    return GPState(X, y, L, alpha)


@partial(jax.jit, static_argnames=("kernel", "full_cov", "include_noise"))
def predict(params: GPParams, state: GPState, Xs, kernel: str = "rbf",
            full_cov: bool = False, include_noise: bool = True):
    """Posterior mean and (co)variance at test points.

    ``include_noise=True`` matches GPy ``predict``'s default
    ``include_likelihood=True`` — the reference relies on that default in
    its info-gain scorers and WMSE metric (reference/GraceRIGV3.py:455,
    reference/GPTrainers.py:116-117).
    """
    from mfgp_jax.ops import covariance as _cc

    Kxs = _cc.sf_cross_cov(params.variance, params.lengthscales, Xs,
                           state.X, kernel)
    mean = _la.posterior_mean(Kxs, state.alpha)
    noise = params.noise if include_noise else 0.0
    if full_cov:
        Kss = _cc.sf_cross_cov(params.variance, params.lengthscales, Xs,
                               Xs, kernel)
        cov = _la.posterior_cov(Kss, Kxs, state.L)
        cov = cov + noise * jnp.eye(Xs.shape[0], dtype=cov.dtype)
        return mean, cov
    kss = jnp.broadcast_to(params.variance, (Xs.shape[0],))
    var = _la.posterior_var(kss, Kxs, state.L) + noise
    return mean, var


@partial(jax.jit, static_argnames=("kernel", "include_noise", "block_size"))
def predict_blocked(params: GPParams, state: GPState, Xs, kernel: str = "rbf",
                    include_noise: bool = True, block_size: int = 1024):
    """Posterior mean/variance streamed over grid-row blocks.

    One (M_big, N) triangular solve makes XLA keep an O(M N) chain of
    update-slice temporaries live (tens of GB for N=20k, M=10571).
    ``lax.map`` over fixed-size row
    blocks runs the same math as a sequential loop with one reused
    (block, N) buffer: peak extra memory is block_size * N * 4 bytes
    (~160 MB at the defaults) at identical FLOPs.
    """
    M = Xs.shape[0]
    nb = -(-M // block_size)
    pad = nb * block_size - M
    Xs_pad = jnp.pad(Xs, ((0, pad), (0, 0))).reshape(
        nb, block_size, Xs.shape[1])
    noise = params.noise if include_noise else 0.0

    from mfgp_jax.ops import covariance as _cc

    def one(xb):
        Kxs = _cc.sf_cross_cov(params.variance, params.lengthscales, xb,
                               state.X, kernel)
        mean = _la.posterior_mean(Kxs, state.alpha)
        kss = jnp.broadcast_to(params.variance, (xb.shape[0],))
        var = _la.posterior_var(kss, Kxs, state.L) + noise
        return mean, var

    means, variances = jax.lax.map(one, Xs_pad)
    return means.reshape(-1)[:M], variances.reshape(-1)[:M]


@partial(jax.jit, static_argnames=("kernel", "jitter", "maxiter", "tol",
                                   "ftol"))
def _fit_restarts(inits, X, y, kernel, jitter, maxiter, tol=1e-6,
                  ftol=0.0):
    """Restart-batched projected L-BFGS sweep (module-level so the
    compiled executable is cached across GP instances of the same shape
    — one compile serves a whole study sweep)."""
    D = X.shape[1]

    def obj(vec):
        p = GPParams(vec[0], vec[1 : 1 + D], vec[1 + D])
        v = nlml(p, X, y, kernel=kernel, jitter=jitter)
        return jnp.where(jnp.isfinite(v), v, 1e20)

    vg = None
    if kernel in ("rbf", "matern32"):
        def vg(vec):
            p = GPParams(vec[0], vec[1 : 1 + D], vec[1 + D])
            v, g = nlml_value_and_grad(p, X, y, kernel=kernel,
                                       jitter=jitter)
            gv = jnp.concatenate([g.log_variance[None],
                                  g.log_lengthscales,
                                  g.log_noise[None]])
            bad = ~jnp.isfinite(v)
            return (jnp.where(bad, 1e20, v),
                    jnp.where(bad | ~jnp.isfinite(gv), 0.0, gv))

    return jax.vmap(
        lambda v: batched_lbfgs(obj, v, maxiter=maxiter, tol=tol,
                                ftol=ftol, value_and_grad=vg)[:2])(inits)


@dataclass
class GP:
    """Stateful convenience wrapper (mirrors the GPy call sites).

    >>> gp = GP(X, y, kernel="rbf")
    >>> gp.optimize()
    >>> mu, var = gp.predict(Xs)
    """

    X: jax.Array
    y: jax.Array
    kernel: str = "rbf"
    params: GPParams | None = None
    jitter: float = 0.0

    def __post_init__(self):
        self.X = jnp.atleast_2d(jnp.asarray(self.X))
        self.y = jnp.asarray(self.y).reshape(-1)
        if self.params is None:
            self.params = GPParams.default(self.X.shape[1], self.X.dtype)
        self._state = None

    # -- data ---------------------------------------------------------------
    def set_XY(self, X, y):
        """Replace the training set (reference ``gp.set_XY``, GPTrainers.py:83)."""
        self.X = jnp.atleast_2d(jnp.asarray(X))
        self.y = jnp.asarray(y).reshape(-1)
        self._state = None

    @property
    def state(self) -> GPState:
        if self._state is None:
            self._state = condition(self.params, self.X, self.y,
                                    kernel=self.kernel, jitter=self.jitter)
        return self._state

    # -- training -----------------------------------------------------------
    def log_likelihood(self) -> float:
        return -float(nlml(self.params, self.X, self.y, kernel=self.kernel,
                           jitter=self.jitter))

    def optimize(self, maxiter: int = 1000, bounds=None):
        """Single L-BFGS run from current params (GPy ``optimize()``)."""
        D = self.X.shape[1]
        x0 = np.concatenate([
            np.atleast_1d(np.asarray(self.params.log_variance)),
            np.asarray(self.params.log_lengthscales),
            np.atleast_1d(np.asarray(self.params.log_noise)),
        ])

        def obj(vec):
            p = GPParams(vec[0], vec[1 : 1 + D], vec[1 + D])
            return nlml(p, self.X, self.y, kernel=self.kernel, jitter=self.jitter)

        xopt, fopt, _ = scipy_lbfgsb(obj, x0, bounds=bounds, maxiter=maxiter)
        xopt = jnp.asarray(xopt, self.X.dtype)
        self.params = GPParams(xopt[0], xopt[1 : 1 + D], xopt[1 + D])
        self._state = None
        return fopt

    def optimize_restarts(self, n_restarts: int = 8, maxiter: int = 200,
                          spread: float = 1.0, seed: int = 0,
                          tol: float = 1e-6):
        """Device-side restart-batched fit: one launch runs ``n_restarts``
        projected L-BFGS trajectories via vmap and keeps the best.

        The scipy driver in :meth:`optimize` makes one host<->device round
        trip per NLML evaluation. This path keeps the whole optimization on device; the jitted
        sweep lives at module level (_fit_restarts) so SEQUENCES of fits
        over same-shaped datasets (the 90-run study matrix) reuse one
        compiled executable instead of recompiling per model instance.
        """
        D = self.X.shape[1]
        dtype = self.X.dtype
        x0 = jnp.concatenate([
            jnp.atleast_1d(self.params.log_variance),
            self.params.log_lengthscales,
            jnp.atleast_1d(self.params.log_noise),
        ]).astype(dtype)
        key = jax.random.key(seed)
        inits = x0[None, :] + spread * jax.random.normal(
            key, (n_restarts, x0.shape[0]), dtype)
        inits = inits.at[0].set(x0)  # first restart = current params

        xs, fs = _fit_restarts(inits, self.X, self.y, self.kernel,
                               self.jitter, maxiter, tol)
        best = jnp.argmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf))
        xopt = xs[best]
        self.params = GPParams(xopt[0], xopt[1 : 1 + D], xopt[1 + D])
        self._state = None
        return float(fs[best])

    # -- online updates -----------------------------------------------------
    def extend_data(self, X_new, y_new):
        """Online conditioning: append observations WITHOUT refactorizing.

        The Cholesky factor grows by a bordered block (O(N^2 P) instead of
        O((N+P)^3), ops.linalg.chol_append_block) — the "online GP update"
        of BASELINE config 4; the reference instead calls ``gp.set_XY`` and
        refits from scratch on every replan
        (reference/PhysicalExperimentCode/GraceRIGV3.py:590)."""
        X_new = jnp.atleast_2d(jnp.asarray(X_new, self.X.dtype))
        y_new = jnp.asarray(y_new, self.y.dtype).reshape(-1)
        state = self.state  # force factorization of the current data
        B = _cov(self.params, state.X, X_new, self.kernel)
        C = _cov(self.params, X_new, X_new, self.kernel)
        obs = self.params.noise + self.jitter
        C = _la.diag_add(C, jnp.broadcast_to(obs, (X_new.shape[0],)))
        L = _la.chol_append_block(state.L, B, C)
        X = jnp.concatenate([state.X, X_new])
        y = jnp.concatenate([state.y, y_new])
        alpha = _la.solve_posterior(L, y)
        self.X, self.y = X, y
        self._state = GPState(X, y, L, alpha)
        return self

    # -- prediction ---------------------------------------------------------
    def predict(self, Xs, full_cov: bool = False, include_noise: bool = True,
                block_size: int | None = None):
        """Posterior at Xs. Marginal-variance predictions over large grids
        stream in row blocks (see predict_blocked) — pass ``block_size`` to
        override the auto choice."""
        Xs = jnp.atleast_2d(jnp.asarray(Xs, self.X.dtype))
        if not full_cov:
            auto_block = (Xs.shape[0] * self.X.shape[0] > 1 << 25)
            if block_size is not None or auto_block:
                return predict_blocked(
                    self.params, self.state, Xs, kernel=self.kernel,
                    include_noise=include_noise,
                    block_size=block_size or 1024)
        return predict(self.params, self.state, Xs, kernel=self.kernel,
                       full_cov=full_cov, include_noise=include_noise)

    # -- reference interop ----------------------------------------------------
    @property
    def param_array(self) -> np.ndarray:
        """GPy-layout hyp vector, as saved in ``*_sfGP.txt`` files."""
        return np.asarray(self.params.to_vector())

    def set_param_array(self, v):
        self.params = GPParams.from_vector(jnp.asarray(v, self.X.dtype),
                                           self.X.shape[1])
        self._state = None
