"""Covariance kernels.

Replaces the reference's GPy kernel objects (reference/NIGP.py:11-20 wraps
``GPy.kern.RBF(..., ARD=True, inv_l=True)``; reference/GPTrainers.py:62,80
uses RBF-ARD; the physical drivers use Matern32-ARD,
reference/PhysicalExperimentCode/GraceExplorationExperiments_SFGP.py:610-615)
and emukit's ``LinearMultiFidelityKernel``
(reference/GPTrainers.py:62-64).

Formulation notes
-----------------
* Squared distances are computed via the matmul expansion
  ``r2 = |x|^2 + |x'|^2 - 2 x.x'`` so the O(N*M*D) work runs as a
  single (N,D)x(D,M) contraction instead of materialising an (N,M,D)
  broadcast difference (4.8 GB in f32 at N=M=20k, D=3, per base kernel).
* All matmuls run at ``Precision.HIGHEST`` — GP parity at ~1e-6 relative
  requires true f32 products, not bf16 or TF32 passes.
* Everything is shape-polymorphic in N/M but static under jit; fidelity
  labels are dense per-point integer arrays so the multi-fidelity covariance
  is one masked dense matrix (no ragged per-fidelity blocks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def sqdist(X1: jax.Array, X2: jax.Array, inv_lengthscales: jax.Array) -> jax.Array:
    """ARD squared distance matrix ``r2[i,j] = sum_d (x1[i,d]-x2[j,d])^2 / l_d^2``.

    X1: (N, D), X2: (M, D), inv_lengthscales: (D,) == 1/l.
    Returns (N, M), clamped to >= 0 (the matmul expansion can go slightly
    negative in floating point).
    """
    X1s = X1 * inv_lengthscales
    X2s = X2 * inv_lengthscales
    n1 = jnp.sum(X1s * X1s, axis=-1)
    n2 = jnp.sum(X2s * X2s, axis=-1)
    cross = jnp.dot(X1s, X2s.T, precision=_HIGHEST)
    r2 = n1[:, None] + n2[None, :] - 2.0 * cross
    return jnp.maximum(r2, 0.0)


def rbf(X1, X2, variance, lengthscales) -> jax.Array:
    """Squared-exponential / RBF ARD kernel, GPy convention.

    ``K = variance * exp(-0.5 * r2)`` with ``r2`` the ARD squared distance.
    Matches ``GPy.kern.RBF(ARD=True)`` (the reference's ``inv_l=True``
    parametrization at reference/NIGP.py:18 changes the stored parameter,
    not the kernel value).
    """
    lengthscales = jnp.broadcast_to(jnp.asarray(lengthscales), (X1.shape[-1],))
    r2 = sqdist(X1, X2, 1.0 / lengthscales)
    return variance * jnp.exp(-0.5 * r2)


_SQRT3 = 1.7320508075688772


def matern32(X1, X2, variance, lengthscales) -> jax.Array:
    """Matern-3/2 ARD kernel, GPy convention.

    ``K = variance * (1 + sqrt(3) r) * exp(-sqrt(3) r)``, r = ARD distance.
    Used by the physical experiment drivers
    (reference/PhysicalExperimentCode/GraceExplorationExperiments_SFGP.py:610).
    """
    lengthscales = jnp.broadcast_to(jnp.asarray(lengthscales), (X1.shape[-1],))
    r = jnp.sqrt(sqdist(X1, X2, 1.0 / lengthscales) + 1e-36)
    return variance * (1.0 + _SQRT3 * r) * jnp.exp(-_SQRT3 * r)


KERNELS = {"rbf": rbf, "matern32": matern32}


def rbf_dx1(X1, X2, variance, lengthscales) -> jax.Array:
    """Gradient of the RBF kernel w.r.t. the first input.

    Returns (N, M, D) with ``out[i,j,d] = d k(x1_i, x2_j) / d x1_i[d]
    = -K[i,j] * (x1_i[d]-x2_j[d]) / l_d^2``.

    This is the analytic derivative the NIGP uses for posterior-mean
    gradients (reference/NIGP.py:49-64). Kept lazy (K and diffs fused by
    XLA); callers that only need ``grads = sum_j alpha_j dK`` should use
    :func:`posterior_mean_grads` in models.nigp which contracts without
    materialising the (N,M,D) tensor.
    """
    lengthscales = jnp.broadcast_to(jnp.asarray(lengthscales), (X1.shape[-1],))
    K = rbf(X1, X2, variance, lengthscales)
    diffs = X1[:, None, :] - X2[None, :, :]
    return -K[:, :, None] * diffs / (lengthscales**2)


# ---------------------------------------------------------------------------
# Linear multi-fidelity (Kennedy-O'Hagan / AR1) covariance
# ---------------------------------------------------------------------------
def ar1_fidelity_weights(rhos: jax.Array, n_fidelities: int) -> jax.Array:
    """Weights ``W[m, f] = prod_{l=m+1..f} rho_l`` (0 for f < m).

    In the AR1 model ``f_i = rho_i f_{i-1} + g_i`` (g_m ~ GP(0, k_m)),
    ``cov(f_i(x), f_j(x')) = sum_m W[m,i] W[m,j] k_m(x, x')``.

    rhos: (n_fidelities-1,) scale couplings; the reference fixes them to 1
    via ``kern.scale.fix([1,1])`` (reference/GPTrainers.py:67).
    Returns (n_fidelities, n_fidelities): row m = weight of base kernel m at
    each fidelity level f (fidelity 0 = lowest, matching emukit's
    ``convert_xy_lists_to_arrays`` convention where the reference passes
    [Xf3, Xf2, Xf1] so fidLev 3 (worst localization) maps to fidelity 0,
    reference/GPTrainers.py:55-61).
    """
    # Built row-by-row (F is small and static) instead of a cumprod ratio
    # C[f]/C[m], which is 0/0 = NaN whenever any rho is exactly 0 (e.g. an
    # optimizer with free rhos stepping through 0, or rho=0 to decouple
    # fidelities).
    rows = []
    for m in range(n_fidelities):
        entries = []
        for f in range(n_fidelities):
            if f < m:
                entries.append(jnp.zeros((), rhos.dtype))
            elif f == m:
                entries.append(jnp.ones((), rhos.dtype))
            else:
                entries.append(entries[-1] * rhos[f - 1])
        rows.append(jnp.stack(entries))
    return jnp.stack(rows)


def ar1_cov(
    X1,
    fid1,
    X2,
    fid2,
    variances,
    lengthscales,
    rhos,
    kernel: str = "rbf",
) -> jax.Array:
    """Dense AR1 multi-fidelity covariance between labelled point sets.

    X1: (N, D); fid1: (N,) int fidelity labels in [0, F); likewise X2/fid2.
    variances: (F,), lengthscales: (F, D), rhos: (F-1,).

    Equivalent to emukit's ``LinearMultiFidelityKernel([k_0..k_{F-1}])``
    evaluated on the augmented inputs ``[X | fid]``
    (reference/GPTrainers.py:62-64), but computed as a masked dense sum —
    F base kernels weighted by per-point AR1 weights — so XLA sees F
    matmuls + fused elementwise math, with no ragged fidelity blocks.
    """
    F = variances.shape[0]
    kfn = KERNELS[kernel]
    W = ar1_fidelity_weights(rhos, F)  # (F, F)
    out = None
    for m in range(F):
        Km = kfn(X1, X2, variances[m], lengthscales[m])
        w1 = W[m][fid1]  # (N,)
        w2 = W[m][fid2]  # (M,)
        term = (w1[:, None] * w2[None, :]) * Km
        out = term if out is None else out + term
    return out


def mf_noise_diag(fid: jax.Array, noise_variances: jax.Array) -> jax.Array:
    """Per-point observation noise for fidelity-labelled data.

    Mirrors emukit's mixed-noise likelihood (one Gaussian noise per fidelity,
    the last 3 entries of the reference's 17-parameter vector,
    reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:659).
    """
    return noise_variances[fid]
