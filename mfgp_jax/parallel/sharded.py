"""ICI-sharded GP computations (shard_map over the device mesh).

The hot dense-grid computations of the reference — posterior evaluation over
2000–10571-point grids (reference/GPTrainers.py:115-120,
reference/PhysicalExperimentCode/exploreExpSettings.py:170-173) and the
precision-weighted MSE's dense M×M inverse (reference/GPTrainers.py:121-137)
— are embarrassingly parallel over grid rows / solve columns. Here they are
expressed with explicit ``shard_map`` layouts:

* training data, Cholesky factor, and weights are **replicated** (N ≲ 20k
  fits on every chip),
* the grid/test axis is **sharded over the "mp" mesh axis**; each chip
  computes its rows of ``K(X*, X)`` and its posterior slice locally,
* scalar reductions (Frobenius norms) are ``psum`` over ICI.

Pad helpers keep shapes static and divisible by the shard count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mfgp_jax.models import gp as _gp
from mfgp_jax.models import mfgp as _mf
from mfgp_jax.ops import kernels as _k
from mfgp_jax.ops import linalg as _la
from mfgp_jax.parallel.mesh import MP_AXIS, pad_to_multiple

_HIGHEST = jax.lax.Precision.HIGHEST


def _pad_rows(a: jax.Array, m: int):
    """Pad axis 0 to a multiple of m. Returns (padded, original_len)."""
    n = a.shape[0]
    np_ = pad_to_multiple(n, m)
    if np_ == n:
        return a, n
    pad = [(0, np_ - n)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad), n


def make_sharded_gp_predict(mesh: Mesh, kernel: str = "rbf"):
    """Posterior mean/var over a grid, rows sharded over the mp axis.

    Returns ``f(params, state, grid) -> (mean, var)`` where grid rows are
    distributed; train-side state is replicated on every chip. The per-shard
    body is exactly the single-chip posterior math — the layout *is* the
    distribution strategy.
    """
    n_mp = mesh.shape[MP_AXIS]

    def shard_body(params, X, y, L, alpha, grid):
        state = _gp.GPState(X, y, L, alpha)
        return _gp.predict(params, state, grid, kernel=kernel)

    smapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(MP_AXIS)),
        out_specs=(P(MP_AXIS), P(MP_AXIS)),
    )

    @jax.jit
    def f(params: _gp.GPParams, state: _gp.GPState, grid: jax.Array):
        gpad, n = _pad_rows(grid, n_mp)
        mu, var = smapped(params, state.X, state.y, state.L, state.alpha, gpad)
        return mu[:n], var[:n]

    return f


def make_sharded_mfgp_predict(mesh: Mesh, kernel: str = "rbf"):
    """MFGP posterior over a fidelity-labelled grid, mp-sharded rows."""
    n_mp = mesh.shape[MP_AXIS]

    def shard_body(params, X, fid, y, L, alpha, grid, grid_fid):
        state = _mf.MFGPState(X, fid, y, L, alpha)
        return _mf.predict(params, state, grid, grid_fid, kernel=kernel)

    smapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(MP_AXIS), P(MP_AXIS)),
        out_specs=(P(MP_AXIS), P(MP_AXIS)),
    )

    @jax.jit
    def f(params: _mf.MFGPParams, state: _mf.MFGPState, grid, grid_fid):
        gpad, n = _pad_rows(grid, n_mp)
        fpad, _ = _pad_rows(grid_fid, n_mp)
        mu, var = smapped(params, state.X, state.fid, state.y, state.L,
                          state.alpha, gpad, fpad)
        return mu[:n], var[:n]

    return f


def make_sharded_weighted_mse(mesh: Mesh, normalize: bool = True):
    """Precision-weighted MSE with the identity-solve sharded over columns.

    ``WMSE = e^T (Sigma^-1 / |Sigma^-1|_F) e / n`` (reference metric,
    reference/GPTrainers.py:127-137). The O(M^3) part — the solve of Sigma
    against the identity for the Frobenius normalisation — distributes over
    identity *columns* on the mp axis; each chip holds the replicated
    Cholesky factor, solves its column block, and contributes its partial
    sum of squares to a ``psum`` over ICI.
    """
    n_mp = mesh.shape[MP_AXIS]

    def shard_body(L, err, eye_cols):
        # eye_cols: (M, M/n_mp) — this chip's columns of the identity
        Sinv_cols = _la.chol_solve(L, eye_cols)
        partial_sq = jnp.sum(Sinv_cols * Sinv_cols)
        total_sq = jax.lax.psum(partial_sq, MP_AXIS)
        w = _la.chol_solve(L, err)
        quad = jnp.dot(err, w, precision=_HIGHEST)
        return quad, total_sq

    smapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(None, MP_AXIS)),
        out_specs=(P(), P()),
    )

    @jax.jit
    def f(err: jax.Array, Sigma: jax.Array):
        n = err.shape[0]
        L = _la.chol(Sigma)
        if normalize:
            npad = pad_to_multiple(n, n_mp)
            eye = jnp.eye(n, npad, dtype=Sigma.dtype)
            quad, total_sq = smapped(L, err, eye)
            return quad / jnp.sqrt(total_sq) / n
        w = _la.chol_solve(L, err)
        return jnp.dot(err, w, precision=_HIGHEST) / n

    return f


def make_sharded_nlml_value_and_grad(mesh: Mesh, jitter: float = 0.0):
    """ICI-distributed analytic MFGP NLML gradient (RBF).

    The gradient's dominant cost and memory is the explicit ``K_n^-1``
    (models/mfgp.nlml_value_and_grad). Here each chip owns a *column shard*
    of the inverse: it solves the replicated Cholesky factor against its
    identity columns, forms its columns of ``W o T_m``, and contributes
    partial reductions (total sums, row sums, X-weighted sums, diagonal
    picks) via ``psum`` over the mp axis. Per-chip memory drops from
    O(N^2) to O(N^2 / n_mp) for the inverse — the single-chip N ceiling
    scales with the mesh.

    Returns ``f(params, X, fid, y) -> (value, MFGPParams grad)`` with the
    same semantics as the local function (rhos fixed).
    """
    n_mp = mesh.shape[MP_AXIS]

    def shard_body(params, X, fid, y, L, alpha, logdet):
        import jax.numpy as jnp

        N, D = X.shape
        F = params.variances.shape[0]
        Nc = N // n_mp  # padded by caller
        idx = jax.lax.axis_index(MP_AXIS)
        col0 = idx * Nc
        cols = col0 + jnp.arange(Nc)

        # this chip's identity columns -> K_n^-1 columns
        eye_cols = (jnp.arange(N)[:, None] == cols[None, :]).astype(X.dtype)
        Kinv_cols = _la.chol_solve_blocked(L, eye_cols)  # (N, Nc)
        Wm_cols = Kinv_cols - alpha[:, None] * alpha[cols][None, :]

        Xc = X[cols]
        fc = fid[cols]
        Wfid = _k.ar1_fidelity_weights(params.rhos, F)
        w_full = Wfid[:, fid]  # (F, N)
        w_cols = Wfid[:, fc]

        val = (0.5 * jnp.dot(y, alpha) + 0.5 * logdet
               + 0.5 * N * jnp.log(2 * jnp.pi).astype(X.dtype))

        g_var = []
        g_ls = []
        ones_xc = jnp.concatenate([jnp.ones((Nc, 1), X.dtype), Xc], axis=1)
        for m in range(F):
            Km_cols = _k.KERNELS["rbf"](X, Xc, 1.0, params.lengthscales[m])
            T = (params.variances[m]
                 * (w_full[m][:, None] * w_cols[m][None, :]) * Km_cols)
            A = Wm_cols * T  # (N, Nc)
            # row sums s_i and X-weighted sums over the column axis
            sv = jnp.dot(A, ones_xc, precision=_HIGHEST)  # (N, 1+D)
            sv = jax.lax.psum(sv, MP_AXIS)  # -> global row sums, replicated
            s, Ax = sv[:, 0], sv[:, 1:]
            g_var.append(0.5 * jnp.sum(s))
            gl = (jnp.sum((X**2) * s[:, None], axis=0)
                  - jnp.sum(X * Ax, axis=0)) / (params.lengthscales[m] ** 2)
            g_ls.append(gl)
        diag_cols = Wm_cols[cols, jnp.arange(Nc)]  # this shard's diagonal
        g_noise = jnp.stack([
            0.5 * params.noises[f] * jax.lax.psum(
                jnp.sum(jnp.where(fc == f, diag_cols, 0.0)), MP_AXIS)
            for f in range(F)])
        from mfgp_jax.models.mfgp import MFGPParams

        grad = MFGPParams(jnp.stack(g_var), jnp.stack(g_ls),
                          jnp.zeros_like(params.rhos), g_noise)
        return val, grad

    smapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
    )

    @jax.jit
    def f(params, X, fid, y):
        import jax.numpy as jnp

        from mfgp_jax.models.mfgp import _assemble_noisy_cov

        N = X.shape[0]
        Np = pad_to_multiple(N, n_mp)
        if Np != N:
            # pad with unit-diagonal pseudo-points that cannot affect the
            # value/grad: zero targets, unit noise rows decoupled from data
            raise ValueError(
                f"N={N} must be divisible by the mp axis ({n_mp}); pad the "
                "training set (padding with decoupled pseudo-points changes "
                "the logdet, so it is not done implicitly)")
        Kn = _assemble_noisy_cov(params, X, fid, jitter, "rbf")
        L = _la.chol(Kn)
        alpha = _la.solve_posterior(L, y)
        logdet = _la.logdet_from_chol(L)
        return smapped(params, X, fid, y, L, alpha, logdet)

    return f


def make_sharded_ar1_cross_cov(mesh: Mesh, kernel: str = "rbf"):
    """Cross-covariance ``K(grid, X)`` with grid rows mp-sharded.

    The building block for sharding any dense posterior/scoring op; each
    chip's block is an matmul over its grid rows against the replicated
    training set.
    """
    n_mp = mesh.shape[MP_AXIS]

    def shard_body(grid, grid_fid, X, fid, variances, lengthscales, rhos):
        return _k.ar1_cov(grid, grid_fid, X, fid, variances, lengthscales,
                          rhos, kernel)

    smapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(MP_AXIS), P(MP_AXIS), P(), P(), P(), P(), P()),
        out_specs=P(MP_AXIS),
    )

    @jax.jit
    def f(grid, grid_fid, X, fid, params: _mf.MFGPParams):
        gpad, n = _pad_rows(grid, n_mp)
        fpad, _ = _pad_rows(grid_fid, n_mp)
        K = smapped(gpad, fpad, X, fid, params.variances,
                    params.lengthscales, params.rhos)
        return K[:n]

    return f
