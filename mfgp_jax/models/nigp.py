"""NIGP — Gaussian process regression with input noise (McHutchon &
Rasmussen 2011), in JAX.

Capability parity with the reference's from-scratch implementation
(reference/NIGP.py). Semantics preserved exactly:

* RBF-ARD kernel with amplitude ``sigma_f`` used directly as the GPy
  ``variance`` (reference/NIGP.py:18 — the reference names it "signal std"
  but passes it as the variance; we keep the value semantics).
* Observation noise variance ``sigma_y^2 + v_i`` with the per-point
  input-noise inflation ``v_i = sum_d grad_i_d^2 * sigma_x_d^2``
  (reference/NIGP.py:144).
* Alternating fit: (A) analytic posterior-mean gradients at the training
  inputs with the *input-noise-free* covariance (``noise_diag=None`` at
  reference/NIGP.py:222), then (B) L-BFGS-B on the NLML with those gradients
  held fixed, log-space parameters bounded in [1e-6, 1e6], restarts jittered
  by 0.1*N(0,1) (reference/NIGP.py:215-240).

Differences from the reference (documented, value-preserving):

* Posterior-mean gradients are computed with two matmuls instead of the
  reference's Python loop over N points (reference/NIGP.py:55-64):
  ``grads = (K @ (alpha*X) - X * (K@alpha)) / l^2``.
* The NLML + gradient used by L-BFGS is one jitted ``jax.value_and_grad``
  (the reference differentiates numerically inside scipy).
* Restarts can run as one vmapped batched-L-BFGS device launch.

Hyperparameter vector for ``get_params`` matches the reference's saved
``*_nisfGP.txt`` layout: ``[sigma_x (D), sigma_f, sigma_y, lengthscales (D)]``
(reference/NIGP.py:188-189).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.ops import kernels as _k
from mfgp_jax.ops import linalg as _la
from mfgp_jax.ops.optimize import scipy_lbfgsb

_LOG2PI = float(np.log(2.0 * np.pi))
_HIGHEST = jax.lax.Precision.HIGHEST


class NIGPParams(NamedTuple):
    """Log-space hyps: [log l (D), log sigma_f, log sigma_y, log sigma_x (D)].

    Identical vector layout to the reference's ``log_hyp``
    (reference/NIGP.py:127,212).
    """

    log_hyp: jax.Array  # (2D + 2,)

    @property
    def D(self):
        return (self.log_hyp.shape[0] - 2) // 2

    @property
    def lengthscales(self):
        return jnp.exp(self.log_hyp[: self.D])

    @property
    def sigma_f(self):
        return jnp.exp(self.log_hyp[self.D])

    @property
    def sigma_y(self):
        return jnp.exp(self.log_hyp[self.D + 1])

    @property
    def sigma_x(self):
        return jnp.exp(self.log_hyp[self.D + 2 :])


@partial(jax.jit)
def posterior_mean_grads(X, y, lengthscales, sigma_f, sigma_y,
                         noise_diag=None):
    """Posterior mean and its input-gradients at the training points.

    Matches ``compute_post_mean_and_gradients`` (reference/NIGP.py:29-65)
    but contracts the derivative sum with matmuls instead of a per-point
    Python loop:

        grads[i, d] = (1/l_d^2) * [ (K @ (alpha*X))[i,d] - X[i,d]*(K@alpha)[i] ]
    """
    N = X.shape[0]
    K = _k.rbf(X, X, sigma_f, lengthscales)
    obs = sigma_y**2 + (noise_diag if noise_diag is not None else 0.0)
    Kn = _la.diag_add(K, jnp.broadcast_to(obs, (N,)))
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    Ka = jnp.dot(K, alpha, precision=_HIGHEST)  # == posterior mean at train
    KaX = jnp.dot(K, alpha[:, None] * X, precision=_HIGHEST)
    grads = (KaX - X * Ka[:, None]) / (lengthscales**2)
    return Ka, grads


@partial(jax.jit)
def nlml(log_hyp, X, y, grad_fixed, extra_noise_diag=None,
         jitter: float = 1e-8):
    """NLML with fixed posterior-mean gradients (reference/NIGP.py:130-165).

    Per-point input-noise variance ``v = sum_d grad^2 sigma_x^2`` enters the
    observation-noise diagonal; the 1e-8 jitter matches the reference.
    """
    N, D = X.shape
    ls = jnp.exp(log_hyp[:D])
    sigma_f = jnp.exp(log_hyp[D])
    sigma_y = jnp.exp(log_hyp[D + 1])
    sigma_x = jnp.exp(log_hyp[D + 2 :])
    v = jnp.sum((grad_fixed**2) * (sigma_x[None, :] ** 2), axis=1)
    if extra_noise_diag is not None:
        v = v + extra_noise_diag
    K = _k.rbf(X, X, sigma_f, ls)
    Kn = _la.diag_add(K, sigma_y**2 + v + jitter)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    return (0.5 * jnp.dot(y, alpha, precision=_HIGHEST)
            + 0.5 * _la.logdet_from_chol(L)
            + 0.5 * N * _LOG2PI)


@partial(jax.jit)
def nlml_native(log_hyp, X, y, jitter: float = 1e-8):
    """Fully-coupled NIGP NLML: the posterior-mean gradients are recomputed
    from the *current* hyperparameters inside the objective and
    differentiated through (SURVEY §7 step 2's "native mode").

    The reference freezes the gradients per outer iteration and alternates
    (reference/NIGP.py:215-240) because differentiating through its
    gradient computation is impractical in numpy/scipy; under ``jax.grad``
    the exact joint objective is one fused kernel, removing the outer loop
    entirely.
    """
    N, D = X.shape
    ls = jnp.exp(log_hyp[:D])
    sigma_f = jnp.exp(log_hyp[D])
    sigma_y = jnp.exp(log_hyp[D + 1])
    sigma_x = jnp.exp(log_hyp[D + 2 :])
    _, grads = posterior_mean_grads(X, y, ls, sigma_f, sigma_y)
    v = jnp.sum((grads**2) * (sigma_x[None, :] ** 2), axis=1)
    K = _k.rbf(X, X, sigma_f, ls)
    Kn = _la.diag_add(K, sigma_y**2 + v + jitter)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    return (0.5 * jnp.dot(y, alpha, precision=_HIGHEST)
            + 0.5 * _la.logdet_from_chol(L)
            + 0.5 * N * _LOG2PI)


@partial(jax.jit, static_argnames=("maxiter", "ftol"))
def _nigp_fit_restarts(inits, X, y, lower, upper, maxiter, ftol=0.0):
    """Restart-batched L-BFGS on the fully-coupled NLML (module-level so
    the executable is cached across NIGP instances of one shape — study
    sweeps compile it once)."""
    from mfgp_jax.ops.optimize import batched_lbfgs

    def obj(lh):
        v = nlml_native(lh, X, y)
        return jnp.where(jnp.isfinite(v), v, 1e20)

    return jax.vmap(
        lambda v: batched_lbfgs(obj, v, lower=lower, upper=upper,
                                maxiter=maxiter, ftol=ftol)[:2])(inits)


@dataclass
class NIGP:
    """Input-noise GP with the reference's alternating fit schedule.

    >>> m = NIGP(n_restarts=2, iters=10)
    >>> m.fit(X, y)
    >>> mu, var = m.predict(Xs, Xs_input_noise=np.ones_like(Xs) * m.sigma_x_)
    """

    n_restarts: int = 3
    iters: int = 3
    verbose: bool = False
    seed: int = 0

    lengthscales_: np.ndarray | None = field(default=None, repr=False)
    sigma_f_: float | None = field(default=None, repr=False)
    sigma_y_: float | None = field(default=None, repr=False)
    sigma_x_: np.ndarray | None = field(default=None, repr=False)
    X_train_: jax.Array | None = field(default=None, repr=False)
    y_train_: jax.Array | None = field(default=None, repr=False)
    noise_diag_train_: jax.Array | None = field(default=None, repr=False)

    def get_params(self) -> np.ndarray:
        """Saved-artifact layout: [sigma_x, sigma_f, sigma_y, lengthscales]
        (reference/NIGP.py:188-189)."""
        return np.hstack((self.sigma_x_, self.sigma_f_, self.sigma_y_,
                          self.lengthscales_))

    def fit(self, X, y, maxiter_opt: int = 200):
        X = jnp.atleast_2d(jnp.asarray(X, jnp.result_type(float)))
        y = jnp.asarray(y).reshape(-1).astype(X.dtype)
        N, D = X.shape
        self.X_train_, self.y_train_ = X, y
        rng = np.random.default_rng(self.seed)

        # init: median pairwise distance lengthscales (reference/NIGP.py:200-205)
        Xn = np.asarray(X)
        pair = np.sqrt(np.maximum(0, np.sum(
            (Xn[:, None, :] - Xn[None, :, :]) ** 2, axis=2)))
        pos = pair[pair > 0]
        med = np.median(pos) if pos.size else 1.0
        init_ls = np.ones(D) * (med if med > 0 else 1.0)
        std_y = np.std(np.asarray(y))
        init_sigma_f = std_y if std_y > 0 else 1.0
        init_sigma_y = 0.1 * init_sigma_f
        init_sigma_x = np.maximum(np.ones(D) * 0.01 * np.std(Xn, axis=0), 1e-8)
        log_hyp = np.concatenate([
            np.log(init_ls), [np.log(init_sigma_f), np.log(init_sigma_y)],
            np.log(init_sigma_x),
        ])

        grad_fixed = jnp.zeros((N, D), X.dtype)
        bounds = [(np.log(1e-6), np.log(1e6))] * (2 * D + 2)

        # one jitted value+grad shared across all iters x restarts — a
        # fresh lambda per restart would recompile the NLML gradient graph
        # iters*n_restarts times (grad_fixed flows in as an argument)
        vg = jax.jit(jax.value_and_grad(
            lambda lh, gf: nlml(lh, X, y, gf)))

        for it in range(self.iters):
            if self.verbose:
                print(f"NIGP iteration {it + 1}/{self.iters} ...")
            ls = jnp.exp(jnp.asarray(log_hyp[:D], X.dtype))
            sf = jnp.exp(jnp.asarray(log_hyp[D], X.dtype))
            sy = jnp.exp(jnp.asarray(log_hyp[D + 1], X.dtype))
            _, grads = posterior_mean_grads(X, y, ls, sf, sy)
            grad_fixed = grads

            best_x, best_val = None, np.inf
            for _ in range(self.n_restarts):
                init = log_hyp + 0.1 * rng.standard_normal(log_hyp.shape)
                xo, fo, _ = scipy_lbfgsb(
                    None, init, bounds=bounds, maxiter=maxiter_opt,
                    args=(grad_fixed,), value_and_grad=vg)
                if fo < best_val:
                    best_val, best_x = fo, xo
            log_hyp = best_x if best_x is not None else log_hyp
            if self.verbose:
                print(f"  optimized nlml: {best_val:.6g}")

        self.lengthscales_ = np.exp(log_hyp[:D])
        self.sigma_f_ = float(np.exp(log_hyp[D]))
        self.sigma_y_ = float(np.exp(log_hyp[D + 1]))
        self.sigma_x_ = np.exp(log_hyp[D + 2 :])
        v = jnp.sum((grad_fixed**2)
                    * (jnp.asarray(self.sigma_x_, X.dtype)[None, :] ** 2), axis=1)
        self.noise_diag_train_ = v
        self._cond_cache = None
        self._cond_inv_cache = None
        return self

    def fit_native(self, X, y, n_restarts: int | None = None,
                   maxiter: int = 200, spread: float = 0.3):
        """Native-mode fit: one vmapped batched-L-BFGS launch on the
        fully-coupled NLML (``nlml_native``) — no alternating outer loop.
        Same init heuristics and [1e-6, 1e6] bounds as :meth:`fit`."""
        from mfgp_jax.ops.optimize import batched_lbfgs

        X = jnp.atleast_2d(jnp.asarray(X, jnp.result_type(float)))
        y = jnp.asarray(y).reshape(-1).astype(X.dtype)
        N, D = X.shape
        self.X_train_, self.y_train_ = X, y
        rng = np.random.default_rng(self.seed)
        n_restarts = n_restarts or max(self.n_restarts, 1)

        Xn = np.asarray(X)
        pair = np.sqrt(np.maximum(0, np.sum(
            (Xn[:, None, :] - Xn[None, :, :]) ** 2, axis=2)))
        pos = pair[pair > 0]
        med = np.median(pos) if pos.size else 1.0
        std_y = np.std(np.asarray(y)) or 1.0
        log_hyp0 = np.concatenate([
            np.log(np.ones(D) * (med if med > 0 else 1.0)),
            [np.log(std_y), np.log(0.1 * std_y)],
            np.log(np.maximum(np.ones(D) * 0.01 * np.std(Xn, axis=0), 1e-8)),
        ])
        inits = (log_hyp0[None, :]
                 + spread * rng.standard_normal((n_restarts,
                                                 log_hyp0.shape[0])))
        inits[0] = log_hyp0
        lower = jnp.full((2 * D + 2,), np.log(1e-6), X.dtype)
        upper = jnp.full((2 * D + 2,), np.log(1e6), X.dtype)

        xs, fs = _nigp_fit_restarts(jnp.asarray(inits, X.dtype), X, y,
                                    lower, upper, maxiter)
        best = int(jnp.argmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf)))
        log_hyp = np.asarray(xs[best])

        self.lengthscales_ = np.exp(log_hyp[:D])
        self.sigma_f_ = float(np.exp(log_hyp[D]))
        self.sigma_y_ = float(np.exp(log_hyp[D + 1]))
        self.sigma_x_ = np.exp(log_hyp[D + 2 :])
        _, grads = posterior_mean_grads(
            X, y, jnp.asarray(self.lengthscales_, X.dtype),
            self.sigma_f_, self.sigma_y_)
        self.noise_diag_train_ = jnp.sum(
            (grads**2) * (jnp.asarray(self.sigma_x_, X.dtype)[None, :] ** 2),
            axis=1)
        self._cond_cache = None
        self._cond_inv_cache = None
        return self

    def _condition(self):
        """Cached conditioned state (L, alpha) of the fitted model.

        The reference re-factorizes the N x N train covariance on EVERY
        predict (reference/NIGP.py:285-289); serving/planner callers hit
        predict repeatedly with fixed hyperparameters, so the factor is
        computed once per fit and invalidated whenever the fit updates the
        noise diagonal.
        """
        cache = getattr(self, "_cond_cache", None)
        if cache is not None:
            return cache
        from mfgp_jax.ops import covariance as _cc

        X, y = self.X_train_, self.y_train_
        ls = jnp.asarray(self.lengthscales_, X.dtype)
        obs = self.sigma_y_**2 + (
            self.noise_diag_train_
            if self.noise_diag_train_ is not None else 0.0)
        noise = jnp.broadcast_to(obs, (X.shape[0],)).astype(X.dtype)
        Kn = _cc.sf_train_cov(self.sigma_f_, ls, noise, X, "rbf")
        L = _la.chol(Kn)
        alpha = _la.solve_posterior(L, y)
        self._cond_cache = (L, alpha)
        return self._cond_cache

    def _condition_inv(self):
        """Explicit-inverse conditioned state (L^-1, alpha), cached.

        The GP/MFGP fast-path rationale (models.mfgp.MFGPStateInv) applied
        to NIGP: with L^-1 in hand, every posterior-variance substitution
        becomes a triangular matmul instead of a sequential tri_solve —
        repeated large-grid predicts (serving, planner scoring) amortize
        the one-time O(N^3/3) ``tri_inv_recursive``.
        """
        cache = getattr(self, "_cond_inv_cache", None)
        if cache is None:
            L, alpha = self._condition()
            cache = (_la.tri_inv_recursive(L), alpha)
            self._cond_inv_cache = cache
        return cache

    def predict_blocked(self, Xs, block_size: int = 1024,
                        include_noise: bool = False):
        """Blocked heteroscedastic posterior mean/marginal variance via the
        explicit-inverse state. Matches :meth:`predict`'s marginal-variance
        path (reference/NIGP.py:269-333 semantics: no output noise by
        default, 1e-12 floor) block by block over large grids.

        Delegates to :func:`models.gp.predict_blocked_inv` — the
        heteroscedastic training noise is already folded into the cached
        factor, so at predict time NIGP *is* a GP with variance sigma_f
        and output noise sigma_y^2.
        """
        from mfgp_jax.models.gp import (GPParams, GPStateInv,
                                        predict_blocked_inv)

        X = self.X_train_
        Xs = jnp.atleast_2d(jnp.asarray(Xs, X.dtype))
        Linv, alpha = self._condition_inv()
        params = GPParams(
            jnp.log(jnp.asarray(self.sigma_f_, X.dtype)),
            jnp.log(jnp.asarray(self.lengthscales_, X.dtype)),
            jnp.log(jnp.asarray(self.sigma_y_**2, X.dtype)))
        state = GPStateInv(X, self.y_train_, Linv, alpha)
        mean, var = predict_blocked_inv(params, state, Xs, kernel="rbf",
                                        include_noise=include_noise,
                                        block_size=block_size)
        return (np.asarray(mean),
                np.asarray(np.maximum(np.asarray(var), 1e-12)))

    def predict(self, Xs, Xs_input_noise=None, return_var: bool = True,
                return_cov: bool = False, as_numpy: bool = True):
        """Heteroscedastic posterior (reference/NIGP.py:269-333).

        No output noise on the predictive covariance; optional test-point
        input-noise diagonal via analytic mean-gradients at Xs; 1e-12
        diagonal floor. ``as_numpy=False`` returns device arrays (skips
        the host transfer — the study harness consumes the full
        covariance on device).
        """
        from mfgp_jax.ops import covariance as _cc

        X, y = self.X_train_, self.y_train_
        Xs = jnp.atleast_2d(jnp.asarray(Xs, X.dtype))
        ls = jnp.asarray(self.lengthscales_, X.dtype)
        L, alpha = self._condition()
        Kxs = _cc.sf_cross_cov(self.sigma_f_, ls, Xs, X, "rbf")
        mean = _la.posterior_mean(Kxs, alpha)
        if not (return_var or return_cov):
            return np.asarray(mean)

        if not return_cov and Xs_input_noise is None:
            # marginal variances without materialising the (M, M) cov
            kss = jnp.broadcast_to(jnp.asarray(self.sigma_f_, X.dtype),
                                   (Xs.shape[0],))
            var = _la.posterior_var(kss, Kxs, L)
            var = jnp.maximum(var, 1e-12)
            return np.asarray(mean), np.asarray(var)

        Kss = _cc.sf_cross_cov(self.sigma_f_, ls, Xs, Xs, "rbf")
        cov = _la.posterior_cov(Kss, Kxs, L)

        if Xs_input_noise is not None:
            # gradients of the posterior mean at the test points
            KaX = jnp.dot(Kxs, alpha[:, None] * X, precision=_HIGHEST)
            Ka = jnp.dot(Kxs, alpha, precision=_HIGHEST)
            grads_star = (KaX - Xs * Ka[:, None]) / (ls**2)
            Sx = jnp.asarray(Xs_input_noise, X.dtype)
            if Sx.ndim == 1 and Sx.shape[0] == X.shape[1]:
                Sx = Sx[None, :]
            elif Sx.shape != grads_star.shape:
                raise ValueError(
                    "Xs_input_noise must have shape (D,) or (M, D)")
            v_star = jnp.sum((grads_star**2) * (Sx**2), axis=1)
            cov = cov + jnp.diag(v_star)

        cov = cov + 1e-12 * jnp.eye(cov.shape[0], dtype=cov.dtype)
        if return_cov:
            if not as_numpy:
                return mean, cov
            return np.asarray(mean), np.asarray(cov)
        var = jnp.maximum(jnp.diag(cov), 1e-12)
        return np.asarray(mean), np.asarray(var)
