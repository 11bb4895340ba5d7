"""Covariance assembly used by the model layers.

Thin wrappers over the XLA composition in ``ops.kernels``: the AR1
multi-fidelity sum of base kernels plus the noise diagonal
(``linalg.diag_add``). Reference equivalent: emukit's kernel evaluations
inside every ``optimize``/``predict`` call
(reference/GPTrainers.py:62-68,115-120). All forms are differentiable, so
the autodiff NLML paths use them as they are.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mfgp_jax.ops import kernels as _k
from mfgp_jax.ops import linalg as _la


def mf_train_cov(variances, lengthscales, rhos, noises, X, fid,
                 jitter: float, kernel: str) -> jax.Array:
    """AR1 training covariance + per-fidelity noise diagonal."""
    K = _k.ar1_cov(X, fid, X, fid, variances, lengthscales, rhos, kernel)
    return _la.diag_add(K, _k.mf_noise_diag(fid, noises) + jitter)


def mf_cross_cov(variances, lengthscales, rhos, X1, fid1, X2, fid2,
                 kernel: str) -> jax.Array:
    """AR1 cross-covariance between labelled point sets."""
    return _k.ar1_cov(X1, fid1, X2, fid2, variances, lengthscales, rhos,
                      kernel)


def sf_train_cov(variance, lengthscales, noise_diag, X,
                 kernel: str) -> jax.Array:
    """Single-fidelity training covariance + noise diagonal."""
    K = _k.KERNELS[kernel](X, X, variance, lengthscales)
    return _la.diag_add(K, jnp.broadcast_to(noise_diag, (X.shape[0],)))


def sf_cross_cov(variance, lengthscales, X1, X2, kernel: str) -> jax.Array:
    """Single-fidelity cross-covariance."""
    return _k.KERNELS[kernel](X1, X2, variance, lengthscales)
