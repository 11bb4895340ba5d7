"""Linear multi-fidelity GP (Kennedy-O'Hagan / AR1) in JAX.

Capability parity with emukit's ``GPyLinearMultiFidelityModel`` +
``GPyMultiOutputWrapper`` as used by the reference
(reference/GPTrainers.py:60-74; model setup in the robot driver at
reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:643-666).

Model: ``f_0 = g_0``, ``f_i = rho_i f_{i-1} + g_i`` with independent GPs
``g_i ~ GP(0, k_i)`` so

    cov(f_i(x), f_j(x')) = sum_{m<=min(i,j)} W[m,i] W[m,j] k_m(x, x'),
    W[m,f] = prod_{l=m+1..f} rho_l

Instead of emukit's augmented-input kernel object, the covariance is one
masked dense sum over base kernels (``ops.kernels.ar1_cov``): every entry is
computed in the same matmuls regardless of fidelity, with per-point AR1
weights — no ragged fidelity blocks, fully jittable.

Data convention (kept for artifact compatibility): inputs carry a trailing
fidelity-index column, 0 = lowest fidelity; the reference maps its fidLev 3
(worst localization) to fidelity 0 and predicts at the highest fidelity by
appending ``2`` (reference/GPTrainers.py:119).

Parameter vector layout matches the 17-element GPy ``param_array`` the
reference logs (header at
reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:659):
``[var_1, l1x, l1y, l1z, var_2, l2x, l2y, l2z, var_3, l3x, l3y, l3z,
rho_1, rho_2, noise_1, noise_2, noise_3]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Sequence

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


class MFGPParams(NamedTuple):
    log_variances: jax.Array  # (F,)
    log_lengthscales: jax.Array  # (F, D)
    rhos: jax.Array  # (F-1,) — unconstrained (emukit's ``scale``)
    log_noises: jax.Array  # (F,)

    @property
    def variances(self):
        return jnp.exp(self.log_variances)

    @property
    def lengthscales(self):
        return jnp.exp(self.log_lengthscales)

    @property
    def noises(self):
        return jnp.exp(self.log_noises)

    def to_vector(self) -> jax.Array:
        """17-element GPy param_array layout (F=3, D=3)."""
        per_kern = jnp.concatenate(
            [jnp.concatenate([v[None], l])
             for v, l in zip(self.variances, self.lengthscales)]
        )
        return jnp.concatenate([per_kern, self.rhos, self.noises])

    @staticmethod
    def from_vector(v, n_fidelities: int, D: int) -> "MFGPParams":
        v = jnp.asarray(v)
        F = n_fidelities
        per = v[: F * (D + 1)].reshape(F, D + 1)
        rhos = v[F * (D + 1) : F * (D + 1) + F - 1]
        noises = v[F * (D + 1) + F - 1 :]
        return MFGPParams(jnp.log(per[:, 0]), jnp.log(per[:, 1:]),
                          rhos, jnp.log(noises))

    @staticmethod
    def default(n_fidelities: int, D: int, dtype=jnp.float64) -> "MFGPParams":
        """GPy/emukit defaults: variances=1, lengthscales=1, rho=1, noise=1."""
        return MFGPParams(
            jnp.zeros((n_fidelities,), dtype),
            jnp.zeros((n_fidelities, D), dtype),
            jnp.ones((n_fidelities - 1,), dtype),
            jnp.zeros((n_fidelities,), dtype),
        )


class MFGPState(NamedTuple):
    X: jax.Array  # (N, D)
    fid: jax.Array  # (N,) int32
    y: jax.Array  # (N,)
    L: jax.Array
    alpha: jax.Array


class MFGPStateInv(NamedTuple):
    """Conditioned state carrying the explicit inverse factor L^-1.

    The fast posterior path: with ``Linv`` resident, the predictive
    variance's triangular substitution becomes one matmul
    (``V = Linv K*^T``). Produced by ``nlml_value_grad_state_inv`` where
    ``Linv`` is computed anyway for the gradient's K^-1.
    """

    X: jax.Array  # (N, D)
    fid: jax.Array  # (N,) int32
    y: jax.Array  # (N,)
    Linv: jax.Array  # (N, N) inverse lower Cholesky factor
    alpha: jax.Array


def split_augmented(X_aug: jax.Array):
    """Split ``[X | fid]`` augmented inputs (emukit convention)."""
    return X_aug[:, :-1], X_aug[:, -1].astype(jnp.int32)


def augment(X: jax.Array, fid) -> jax.Array:
    f = jnp.broadcast_to(jnp.asarray(fid, X.dtype), (X.shape[0],))
    return jnp.concatenate([X, f[:, None]], axis=1)


@partial(jax.checkpoint, static_argnums=(4,))
def _assemble_noisy_cov(params: MFGPParams, X, fid, jitter, kernel: str):
    """Training covariance + noise diag, rematerialised under autodiff.

    Without remat the NLML backward pass keeps every F=3 base-kernel matrix
    and its clamp/select masks alive simultaneously — ~10 x N^2 f32
    temporaries at N=20k. Rematerialisation recomputes the assembly in the
    backward sweep (extra O(N^2 D) work, far cheaper than the O(N^3)
    Cholesky either way) so the live set is just K, L, and the incoming
    cotangent.
    """
    K = _k.ar1_cov(X, fid, X, fid, params.variances, params.lengthscales,
                   params.rhos, kernel)
    return _la.diag_add(K, _k.mf_noise_diag(fid, params.noises) + jitter)


@partial(jax.jit, static_argnames=("kernel",))
def nlml(params: MFGPParams, X, fid, y, kernel: str = "rbf",
         jitter: float = 0.0):
    """Exact NLML of the multi-fidelity model with per-fidelity noise."""
    N = X.shape[0]
    Kn = _assemble_noisy_cov(params, X, fid, jitter, kernel)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    return (0.5 * jnp.dot(y, alpha, precision=_HIGHEST)
            + 0.5 * _la.logdet_from_chol(L)
            + 0.5 * N * _LOG2PI)


@partial(jax.jit, static_argnames=("kernel",))
def nlml_value_and_grad(params: MFGPParams, X, fid, y, kernel: str = "rbf",
                        jitter: float = 0.0):
    """NLML + analytic gradient via trace identities (rhos held fixed).

    Autodiff's backward pass re-materialises the covariance (remat) and
    runs the Cholesky VJP — ~8x the forward cost at N=20k. The classical
    identities need one explicit ``K_n^-1`` (two blocked triangular solves)
    plus per-fidelity elementwise products and a single (N, 1+D) matmul
    each:

        dNLML/dtheta = 0.5 tr(W dK/dtheta),   W = K_n^-1 - alpha alpha^T
        d/dlog var_m      = 0.5 sum(W o T_m),  T_m = var_m (w_m w_m^T) o K_m
        d/dlog l_{m,d}    = sum_i x_d,i^2 s_i - x_d^T A x_d) / l_{m,d}^2,
                            A = W o T_m, s = A 1      (RBF; symmetric A)
        d/dlog noise_f    = 0.5 noise_f sum_{fid_i=f} W_ii

    Returns ``(value, MFGPParams-grad)`` with ``rhos`` gradient zero
    (the reference always fixes them, reference/GPTrainers.py:67).

    Matern32: ``dK/dlog l_d = 3 v e^{-sqrt(3) r} * r_d^2`` with
    ``r_d^2 = (x_d - x'_d)^2 / l_d^2`` — the same row-sum/X-weighted-sum
    matvec contraction applies with ``A' = W o (3 v w w^T e^{-sqrt(3) r})``
    and the variance term keeps ``A = W o T``.
    """
    val, grad, _, _, _ = _nlml_vg_core(params, X, fid, y, kernel, jitter)
    return val, grad


_PRECISIONS = {"high": jax.lax.Precision.HIGH,
               "highest": jax.lax.Precision.HIGHEST}


def _nlml_vg_core(params: MFGPParams, X, fid, y, kernel: str,
                  jitter: float, inv_mode: str | None = None):
    """Shared implementation: returns (val, grad, L, alpha, Linv).

    ``inv_mode=None`` computes the gradient's K^-1 with two blocked
    triangular solves (2 N^3 substitution FLOPs, backward-stable;
    Linv=None). ``inv_mode="high"|"highest"`` computes the explicit
    inverse factor ``Linv = L^-1`` (tri_inv_recursive, HIGHEST) and
    ``K^-1 = Linv^T Linv`` as one matmul at the given precision —
    N^3/3 + N^3 FLOPs on plain matmul shapes. ``"high"`` trades accuracy
    on K^-1 (gradient-quality only; the NLML value path is untouched)
    for matmul speed."""
    if kernel not in ("rbf", "matern32"):
        raise NotImplementedError(f"analytic gradient: {kernel}")
    N, D = X.shape
    F = params.variances.shape[0]
    Wfid = _k.ar1_fidelity_weights(params.rhos, F)  # (F, F)
    w = Wfid[:, fid]  # (F, N)
    inv_ls = 1.0 / params.lengthscales  # (F, D)
    kfn = _k.KERNELS[kernel]

    # base kernels are NOT kept for the gradient loop — holding F of them
    # alive adds F x N^2 live temporaries at N=20k; recomputing each K_m
    # below is O(N^2 D) noise next to the solves
    K = jnp.zeros((N, N), X.dtype)
    for m in range(F):
        Km = kfn(X, X, 1.0, params.lengthscales[m])
        K = K + params.variances[m] * (w[m][:, None] * w[m][None, :]) * Km
    noise_vec = _k.mf_noise_diag(fid, params.noises)
    Kn = _la.diag_add(K, noise_vec + jitter)
    L = _la.chol(Kn)
    if inv_mode is None:
        alpha = _la.solve_posterior(L, y)
    else:
        # the explicit inverse factor is computed for the gradient's K^-1
        # anyway; alpha = Linv^T (Linv y) turns the two SINGLE-RHS
        # triangular substitutions (a serial dependency chain) into two
        # streaming triangular matvecs over the factor already in memory
        Linv = _la.tri_inv_recursive(L)
        z = _la.tri_lower_matmul(Linv, y[:, None])
        alpha = _la.tri_lower_matmul_right(
            z.reshape(1, -1), Linv).reshape(-1)
    val = (0.5 * jnp.dot(y, alpha, precision=_HIGHEST)
           + 0.5 * _la.logdet_from_chol(L)
           + 0.5 * N * _LOG2PI)

    if inv_mode is None:
        eye = jnp.eye(N, dtype=X.dtype)
        Kinv = _la.chol_solve_blocked(L, eye)
        Linv = None
    else:
        Kinv = _la.syrk_tri_lower(Linv,
                                  precision=_PRECISIONS[inv_mode])
    Wm = Kinv - alpha[:, None] * alpha[None, :]

    g_logvar = []
    g_logls = []
    ones_x = jnp.concatenate([jnp.ones((N, 1), X.dtype), X], axis=1)
    _SQRT3 = 1.7320508075688772
    for m in range(F):
        ww = w[m][:, None] * w[m][None, :]
        T = params.variances[m] * ww * kfn(X, X, 1.0, params.lengthscales[m])
        A = Wm * T
        if kernel == "rbf":
            # dK/dlog l_d = K * r_d^2 -> same A drives both contractions
            Avar, Als = A, A
        else:
            # variance term uses K; lengthscale term uses 3 v e^{-sqrt3 r}
            r = jnp.sqrt(_k.sqdist(X, X, inv_ls[m]) + 1e-36)
            E = params.variances[m] * ww * (3.0 * jnp.exp(-_SQRT3 * r))
            Avar, Als = A, Wm * E
        sv = jnp.dot(Avar, ones_x, precision=jax.lax.Precision.HIGHEST)
        g_logvar.append(0.5 * jnp.sum(sv[:, 0]))
        if Als is not Avar:
            sv = jnp.dot(Als, ones_x, precision=jax.lax.Precision.HIGHEST)
        s, Ax = sv[:, 0], sv[:, 1:]
        # 0.5 * sum_ij A'_ij (x_d - x'_d)^2 / l_d^2, via the symmetric
        # matvec identity sum A (x-x')^2 = 2 (x^2 . s - x . (A x))
        g_ls = (jnp.sum((X**2) * s[:, None], axis=0)
                - jnp.sum(X * Ax, axis=0)) * (inv_ls[m] ** 2)
        g_logls.append(g_ls)
    diagW = jnp.diagonal(Wm)
    g_lognoise = jnp.stack([
        0.5 * params.noises[f] * jnp.sum(jnp.where(fid == f, diagW, 0.0))
        for f in range(F)])
    grad = MFGPParams(
        jnp.stack(g_logvar), jnp.stack(g_logls),
        jnp.zeros_like(params.rhos), g_lognoise)
    return val, grad, L, alpha, Linv


@partial(jax.jit, static_argnames=("kernel",))
def nlml_value_grad_state(params: MFGPParams, X, fid, y,
                          kernel: str = "rbf", jitter: float = 0.0):
    """(value, grad, conditioned state) sharing ONE factorization.

    A training loop's final step needs the NLML+gradient AND the
    conditioned posterior state; calling nlml_value_and_grad + condition
    factorizes the N x N covariance twice. This fuses them around a single
    Cholesky (the NumPy reference-equivalent unit in bench.py also
    factorizes once, so this keeps the benchmark apples-to-apples).
    """
    val, grad, L, alpha, _ = _nlml_vg_core(params, X, fid, y, kernel, jitter)
    return val, grad, MFGPState(X, jnp.asarray(fid, jnp.int32), y, L, alpha)


@partial(jax.jit, static_argnames=("kernel", "inv_mode"))
def nlml_value_grad_state_inv(params: MFGPParams, X, fid, y,
                              kernel: str = "rbf", jitter: float = 0.0,
                              inv_mode: str = "highest"):
    """Fast-path variant of nlml_value_grad_state returning MFGPStateInv.

    The gradient's K^-1 comes from the explicit inverse factor (see
    _nlml_vg_core inv_mode), and that factor is returned in the state so
    the posterior runs as pure matmuls (predict_blocked_inv). Same
    mathematics; at f32 the syrk precision is selectable ("high" trades
    ~5e-4 max K^-1 entry error — gradient-only — for ~1.8x on the syrk).
    NLML value, alpha, and logdet are computed exactly as in
    nlml_value_grad_state.
    """
    val, grad, _, alpha, Linv = _nlml_vg_core(params, X, fid, y, kernel,
                                              jitter, inv_mode=inv_mode)
    return val, grad, MFGPStateInv(X, jnp.asarray(fid, jnp.int32), y,
                                   Linv, alpha)


@partial(jax.jit, static_argnames=("kernel",))
def condition(params: MFGPParams, X, fid, y, kernel: str = "rbf",
              jitter: float = 0.0) -> MFGPState:
    from mfgp_jax.ops import covariance as _cov

    Kn = _cov.mf_train_cov(params.variances, params.lengthscales,
                           params.rhos, params.noises, X, fid, jitter,
                           kernel)
    L = _la.chol(Kn)
    alpha = _la.solve_posterior(L, y)
    return MFGPState(X, fid, y, L, alpha)


@partial(jax.jit, static_argnames=("kernel", "full_cov", "include_noise"))
def predict(params: MFGPParams, state: MFGPState, Xs, fid_s,
            kernel: str = "rbf", full_cov: bool = False,
            include_noise: bool = True):
    """Posterior at test points with fidelity labels ``fid_s``.

    ``include_noise=True`` adds the per-fidelity likelihood noise, matching
    emukit's wrapper ``predict``/``predict_covariance``
    (reference/GPTrainers.py:119-120).
    """
    from mfgp_jax.ops import covariance as _cov

    Kxs = _cov.mf_cross_cov(params.variances, params.lengthscales,
                            params.rhos, Xs, fid_s, state.X, state.fid,
                            kernel)
    mean = _la.posterior_mean(Kxs, state.alpha)
    noise = _k.mf_noise_diag(fid_s, params.noises) if include_noise else 0.0
    if full_cov:
        Kss = _cov.mf_cross_cov(params.variances, params.lengthscales,
                                params.rhos, Xs, fid_s, Xs, fid_s, kernel)
        cov = _la.posterior_cov(Kss, Kxs, state.L)
        cov = cov + jnp.diag(jnp.broadcast_to(noise, (Xs.shape[0],)).astype(cov.dtype))
        return mean, cov
    W = _k.ar1_fidelity_weights(params.rhos, params.variances.shape[0])
    kss = jnp.sum((W[:, fid_s] ** 2) * params.variances[:, None], axis=0)
    var = _la.posterior_var(kss, Kxs, state.L) + noise
    return mean, var


@partial(jax.jit, static_argnames=("kernel", "include_noise", "block_size"))
def predict_blocked(params: MFGPParams, state: MFGPState, Xs, fid_s,
                    kernel: str = "rbf", include_noise: bool = True,
                    block_size: int = 1024):
    """MFGP posterior mean/variance streamed over grid-row blocks.

    Same rationale as gp.predict_blocked: ``lax.map`` over fixed row
    blocks bounds peak memory at block_size x N instead of the M x N
    cross-covariance of a full-grid solve, while keeping every matmul
    large.
    """
    M = Xs.shape[0]
    nb = -(-M // block_size)
    pad = nb * block_size - M
    Xs_pad = jnp.pad(Xs, ((0, pad), (0, 0))).reshape(
        nb, block_size, Xs.shape[1])
    fid_pad = jnp.pad(fid_s, (0, pad)).reshape(nb, block_size)
    W = _k.ar1_fidelity_weights(params.rhos, params.variances.shape[0])

    from mfgp_jax.ops import covariance as _cov

    def one(args):
        xb, fb = args
        Kxs = _cov.mf_cross_cov(params.variances, params.lengthscales,
                                params.rhos, xb, fb, state.X, state.fid,
                                kernel)
        mean = _la.posterior_mean(Kxs, state.alpha)
        kss = jnp.sum((W[:, fb] ** 2) * params.variances[:, None], axis=0)
        var = _la.posterior_var(kss, Kxs, state.L)
        if include_noise:
            var = var + _k.mf_noise_diag(fb, params.noises)
        return mean, var

    means, variances = jax.lax.map(one, (Xs_pad, fid_pad))
    return means.reshape(-1)[:M], variances.reshape(-1)[:M]


@partial(jax.jit, static_argnames=("kernel", "include_noise", "block_size",
                                   "precision"))
def predict_blocked_inv(params: MFGPParams, state: MFGPStateInv, Xs, fid_s,
                        kernel: str = "rbf", include_noise: bool = True,
                        block_size: int = 1024,
                        precision: str = "highest"):
    """Blocked posterior mean/variance from an MFGPStateInv.

    Identical contract to predict_blocked, but the variance's triangular
    substitution is replaced by ``V = Linv K*^T`` — one matmul per
    block."""
    from mfgp_jax.ops import covariance as _cov

    prec = _PRECISIONS[precision]
    M = Xs.shape[0]
    nb = -(-M // block_size)
    pad = nb * block_size - M
    Xs_pad = jnp.pad(Xs, ((0, pad), (0, 0))).reshape(
        nb, block_size, Xs.shape[1])
    fid_pad = jnp.pad(fid_s, (0, pad)).reshape(nb, block_size)
    W = _k.ar1_fidelity_weights(params.rhos, params.variances.shape[0])

    def one(args):
        xb, fb = args
        Kxs = _cov.mf_cross_cov(params.variances, params.lengthscales,
                                params.rhos, xb, fb, state.X, state.fid,
                                kernel)
        mean = _la.posterior_mean(Kxs, state.alpha)
        V = _la.tri_lower_matmul(state.Linv, Kxs.T, precision=prec)
        kss = jnp.sum((W[:, fb] ** 2) * params.variances[:, None], axis=0)
        var = kss - jnp.sum(V * V, axis=0)
        if include_noise:
            var = var + _k.mf_noise_diag(fb, params.noises)
        return mean, var

    means, variances = jax.lax.map(one, (Xs_pad, fid_pad))
    return means.reshape(-1)[:M], variances.reshape(-1)[:M]


def stack_fidelity_lists(X_list: Sequence, y_list: Sequence | None = None):
    """emukit ``convert_xy_lists_to_arrays`` equivalent.

    X_list ordered lowest->highest fidelity (the reference passes
    ``[Xf3, Xf2, Xf1]``, reference/GPTrainers.py:60-61). Returns
    (X, fid, y) dense arrays.
    """
    X = jnp.concatenate([jnp.asarray(x) for x in X_list], axis=0)
    fid = jnp.concatenate([
        jnp.full((np.shape(x)[0],), i, jnp.int32) for i, x in enumerate(X_list)
    ])
    if y_list is None:
        return X, fid
    y = jnp.concatenate([jnp.asarray(yy).reshape(-1) for yy in y_list])
    return X, fid, y


@partial(jax.jit, static_argnames=("kernel", "jitter", "maxiter", "tol",
                                   "ftol"))
def _mf_fit_restarts(inits, X, fid, y, fixed_rhos, lower, upper, kernel,
                     jitter, maxiter, tol=1e-6, ftol=0.0):
    """Restart-batched projected L-BFGS sweep for the AR1 MFGP
    (module-level: one compiled executable serves every same-shaped fit
    in a sweep — the 90-run study matrix recompiled per model instance
    when this lived inside optimize_restarts)."""
    F = fixed_rhos.shape[0] + 1
    D = X.shape[1]

    def unpack(vec):
        return MFGPParams(vec[:F], vec[F : F + F * D].reshape(F, D),
                          fixed_rhos, vec[F + F * D :])

    def obj(vec):
        v = nlml(unpack(vec), X, fid, y, kernel=kernel, jitter=jitter)
        return jnp.where(jnp.isfinite(v), v, 1e20)

    vg = None
    if kernel in ("rbf", "matern32"):
        # analytic trace-identity gradient: ~2.5x faster than autodiff
        def vg(vec):
            v, g = nlml_value_and_grad(unpack(vec), X, fid, y,
                                       kernel=kernel, jitter=jitter)
            gv = jnp.concatenate([g.log_variances,
                                  g.log_lengthscales.reshape(-1),
                                  g.log_noises])
            bad = ~jnp.isfinite(v)
            return (jnp.where(bad, 1e20, v),
                    jnp.where(bad | ~jnp.isfinite(gv), 0.0, gv))

    return jax.vmap(
        lambda v: batched_lbfgs(obj, v, lower=lower, upper=upper,
                                maxiter=maxiter, tol=tol, ftol=ftol,
                                value_and_grad=vg)[:2])(inits)


@dataclass
class MFGP:
    """Stateful wrapper mirroring the emukit call sites.

    >>> m = MFGP.from_fidelity_lists([Xlo, Xmid, Xhi], [ylo, ymid, yhi])
    >>> m.optimize(fix_rhos=True)          # reference fixes scale to [1,1]
    >>> mu, var = m.predict(Xs)            # at highest fidelity
    """

    X: jax.Array
    fid: jax.Array
    y: jax.Array
    n_fidelities: int = 3
    kernel: str = "rbf"
    params: MFGPParams | None = None
    jitter: float = 0.0

    def __post_init__(self):
        self.X = jnp.atleast_2d(jnp.asarray(self.X))
        self.fid = jnp.asarray(self.fid, jnp.int32).reshape(-1)
        self.y = jnp.asarray(self.y).reshape(-1)
        if self.params is None:
            self.params = MFGPParams.default(self.n_fidelities,
                                             self.X.shape[1], self.X.dtype)
        self._state = None

    @classmethod
    def from_fidelity_lists(cls, X_list, y_list, **kw):
        X, fid, y = stack_fidelity_lists(X_list, y_list)
        return cls(X, fid, y, n_fidelities=len(X_list), **kw)

    def set_data(self, X, fid, y):
        """Replace data (emukit ``set_data``, reference/GPTrainers.py:66)."""
        self.X = jnp.atleast_2d(jnp.asarray(X))
        self.fid = jnp.asarray(fid, jnp.int32).reshape(-1)
        self.y = jnp.asarray(y).reshape(-1)
        self._state = None

    @property
    def state(self) -> MFGPState:
        if self._state is None:
            self._state = condition(self.params, self.X, self.fid, self.y,
                                    kernel=self.kernel, jitter=self.jitter)
        return self._state

    def log_likelihood(self) -> float:
        return -float(nlml(self.params, self.X, self.fid, self.y,
                           kernel=self.kernel, jitter=self.jitter))

    def optimize(self, maxiter: int = 1000, fix_rhos: bool = True,
                 lengthscale_bounds=None):
        """L-BFGS on the exact NLML.

        ``fix_rhos=True`` replicates ``kern.scale.fix([1,1])``
        (reference/GPTrainers.py:67). ``lengthscale_bounds`` optionally
        replicates ``constrain_bounded(0.0001, 100)``
        (reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:652-657).
        """
        F, D = self.n_fidelities, self.X.shape[1]
        p = self.params
        x0 = np.concatenate([
            np.asarray(p.log_variances),
            np.asarray(p.log_lengthscales).reshape(-1),
            [] if fix_rhos else np.asarray(p.rhos),
            np.asarray(p.log_noises),
        ])
        bounds = None
        if lengthscale_bounds is not None:
            lo, hi = np.log(lengthscale_bounds[0]), np.log(lengthscale_bounds[1])
            bounds = ([(None, None)] * F
                      + [(lo, hi)] * (F * D)
                      + ([] if fix_rhos else [(None, None)] * (F - 1))
                      + [(None, None)] * F)
        fixed_rhos = p.rhos

        def unpack(vec):
            i = 0
            lv = vec[i : i + F]; i += F
            ll = vec[i : i + F * D].reshape(F, D); i += F * D
            if fix_rhos:
                rh = fixed_rhos
            else:
                rh = vec[i : i + F - 1]; i += F - 1
            ln = vec[i : i + F]
            return MFGPParams(lv, ll, rh, ln)

        def obj(vec):
            return nlml(unpack(vec), self.X, self.fid, self.y,
                        kernel=self.kernel, jitter=self.jitter)

        xopt, fopt, _ = scipy_lbfgsb(obj, x0, bounds=bounds, maxiter=maxiter)
        self.params = unpack(jnp.asarray(xopt, self.X.dtype))
        self._state = None
        return fopt

    def optimize_restarts(self, n_restarts: int = 8, maxiter: int = 200,
                          spread: float = 1.0, seed: int = 0,
                          fix_rhos: bool = True, lengthscale_bounds=None,
                          tol: float = 1e-6):
        """Device-side restart-batched fit (see gp.GP.optimize_restarts):
        all restarts advance in one vmapped projected-L-BFGS launch, best
        NLML wins. Replicates the reference's hyperparameter constraints
        (``scale.fix``, ``constrain_bounded``) via fixed rhos + log-space
        box projection."""
        F, D = self.n_fidelities, self.X.shape[1]
        dtype = self.X.dtype
        p = self.params
        x0 = jnp.concatenate([
            p.log_variances, p.log_lengthscales.reshape(-1), p.log_noises,
        ]).astype(dtype)
        n = x0.shape[0]
        lower = jnp.full((n,), -jnp.inf, dtype)
        upper = jnp.full((n,), jnp.inf, dtype)
        if lengthscale_bounds is not None:
            lo, hi = (float(np.log(lengthscale_bounds[0])),
                      float(np.log(lengthscale_bounds[1])))
            idx = jnp.arange(F, F + F * D)
            lower = lower.at[idx].set(lo)
            upper = upper.at[idx].set(hi)
        fixed_rhos = p.rhos
        X, fid, y = self.X, self.fid, self.y
        kernel, jitter = self.kernel, self.jitter
        if not fix_rhos:
            raise NotImplementedError(
                "free rhos use optimize(); the reference always fixes them "
                "(kern.scale.fix, reference/GPTrainers.py:67)")

        key = jax.random.key(seed)
        inits = x0[None, :] + spread * jax.random.normal(
            key, (n_restarts, n), dtype)
        inits = inits.at[0].set(x0)
        xs, fs = _mf_fit_restarts(inits, X, fid, y, fixed_rhos, lower,
                                  upper, kernel, jitter, maxiter, tol)
        best = jnp.argmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf))
        xopt = xs[best]
        self.params = MFGPParams(xopt[:F],
                                 xopt[F : F + F * D].reshape(F, D),
                                 fixed_rhos, xopt[F + F * D :])
        self._state = None
        return float(fs[best])

    def extend_data(self, X_new, fid_new, y_new):
        """Online conditioning: append fidelity-labelled observations via a
        bordered Cholesky block — O(N^2 P) vs the reference's full
        ``set_data`` + refit per replan (see gp.GP.extend_data)."""
        X_new = jnp.atleast_2d(jnp.asarray(X_new, self.X.dtype))
        fid_new = jnp.asarray(fid_new, jnp.int32).reshape(-1)
        y_new = jnp.asarray(y_new, self.y.dtype).reshape(-1)
        state = self.state
        p = self.params
        B = _k.ar1_cov(state.X, state.fid, X_new, fid_new, p.variances,
                       p.lengthscales, p.rhos, self.kernel)
        C = _k.ar1_cov(X_new, fid_new, X_new, fid_new, p.variances,
                       p.lengthscales, p.rhos, self.kernel)
        C = _la.diag_add(C, _k.mf_noise_diag(fid_new, p.noises)
                         + self.jitter)
        L = _la.chol_append_block(state.L, B, C)
        X = jnp.concatenate([state.X, X_new])
        fid = jnp.concatenate([state.fid, fid_new])
        y = jnp.concatenate([state.y, y_new])
        alpha = _la.solve_posterior(L, y)
        self.X, self.fid, self.y = X, fid, y
        self._state = MFGPState(X, fid, y, L, alpha)
        return self

    def predict(self, Xs, fid=None, full_cov: bool = False,
                include_noise: bool = True, block_size: int | None = None):
        """Predict at fidelity ``fid`` (default: highest).

        Accepts plain (M, D) inputs, or emukit-style augmented (M, D+1)
        inputs with a trailing fidelity column when ``fid`` is None.
        Marginal-variance predictions over large grids stream in row blocks
        (see predict_blocked).
        """
        Xs = jnp.atleast_2d(jnp.asarray(Xs, self.X.dtype))
        if fid is None:
            if Xs.shape[1] == self.X.shape[1] + 1:
                Xs, fid_s = split_augmented(Xs)
            else:
                fid_s = jnp.full((Xs.shape[0],), self.n_fidelities - 1, jnp.int32)
        else:
            fid_s = jnp.broadcast_to(jnp.asarray(fid, jnp.int32), (Xs.shape[0],))
        if not full_cov:
            auto_block = (Xs.shape[0] * self.X.shape[0] > 1 << 25)
            if block_size is not None or auto_block:
                return predict_blocked(
                    self.params, self.state, Xs, fid_s, kernel=self.kernel,
                    include_noise=include_noise,
                    block_size=block_size or 1024)
        return predict(self.params, self.state, Xs, fid_s, kernel=self.kernel,
                       full_cov=full_cov, include_noise=include_noise)

    def predict_covariance(self, Xs, fid=None):
        """emukit ``predict_covariance`` (reference/GPTrainers.py:120)."""
        _, cov = self.predict(Xs, fid=fid, full_cov=True, include_noise=True)
        return cov

    @property
    def param_array(self) -> np.ndarray:
        return np.asarray(self.params.to_vector())

    def set_param_array(self, v):
        self.params = MFGPParams.from_vector(jnp.asarray(v, self.X.dtype),
                                             self.n_fidelities, self.X.shape[1])
        self._state = None
