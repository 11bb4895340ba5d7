"""Linear-algebra unit tests vs scipy/numpy (SURVEY.md §4 test pyramid #1)."""

import numpy as np
import jax.numpy as jnp
import scipy.linalg

from mfgp_jax.ops import linalg as la


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def test_chol_solve_matches_scipy(rng):
    K = _spd(rng, 40)
    b = rng.standard_normal(40)
    L = np.asarray(la.chol(jnp.asarray(K)))
    x = np.asarray(la.chol_solve(jnp.asarray(L), jnp.asarray(b)))
    cho = scipy.linalg.cho_factor(K, lower=True)
    np.testing.assert_allclose(x, scipy.linalg.cho_solve(cho, b), rtol=1e-9)


def test_logdet_from_chol(rng):
    K = _spd(rng, 30)
    L = la.chol(jnp.asarray(K))
    np.testing.assert_allclose(float(la.logdet_from_chol(L)),
                               np.linalg.slogdet(K)[1], rtol=1e-10)


def test_posterior_cov_matches_direct(rng):
    n, m = 50, 20
    K = _spd(rng, n)
    Kxs = rng.standard_normal((m, n))
    Kss = _spd(rng, m)
    L = la.chol(jnp.asarray(K))
    cov = np.asarray(la.posterior_cov(jnp.asarray(Kss), jnp.asarray(Kxs), L))
    direct = Kss - Kxs @ np.linalg.solve(K, Kxs.T)
    np.testing.assert_allclose(cov, direct, rtol=1e-8, atol=1e-10)
    var = np.asarray(la.posterior_var(jnp.asarray(np.diag(Kss)),
                                      jnp.asarray(Kxs), L))
    np.testing.assert_allclose(var, np.diag(direct), rtol=1e-8, atol=1e-10)


def test_chol_append_block(rng):
    n, p = 30, 6
    M = _spd(rng, n + p)
    A, B, C = M[:n, :n], M[:n, n:], M[n:, n:]
    L = la.chol(jnp.asarray(A))
    Lfull = np.asarray(la.chol_append_block(L, jnp.asarray(B), jnp.asarray(C)))
    np.testing.assert_allclose(Lfull, np.linalg.cholesky(M), rtol=1e-8,
                               atol=1e-10)


def test_chol_rank1_update(rng):
    n = 20
    A = _spd(rng, n)
    x = rng.standard_normal(n)
    L = np.linalg.cholesky(A)
    Lup = np.asarray(la.chol_rank1_update(jnp.asarray(L), jnp.asarray(x)))
    np.testing.assert_allclose(Lup, np.linalg.cholesky(A + np.outer(x, x)),
                               rtol=1e-8, atol=1e-10)
    Ldn = np.asarray(la.chol_rank1_update(
        jnp.asarray(Lup), jnp.asarray(x), downdate=True))
    np.testing.assert_allclose(Ldn, L, rtol=1e-6, atol=1e-8)


def test_weighted_mse_matches_reference_formula(rng):
    """WMSE = e^T (Sigma^-1/|Sigma^-1|_F) e / n (reference/GPTrainers.py:127)."""
    n = 25
    Sigma = _spd(rng, n)
    e = rng.standard_normal(n)
    got = float(la.weighted_mse(jnp.asarray(e), jnp.asarray(Sigma)))
    Sinv = np.linalg.inv(Sigma)
    want = e @ (Sinv / np.linalg.norm(Sinv)) @ e / n
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_rmse():
    e = np.array([1.0, -1.0, 1.0, -1.0])
    assert float(la.rmse(jnp.asarray(e))) == 1.0


def test_chol_solve_blocked_matches_dense(rng):
    import jax.numpy as jnp

    from mfgp_jax.ops.linalg import chol, chol_solve, chol_solve_blocked

    n = 300
    A = rng.normal(size=(n, n))
    S = A @ A.T + n * np.eye(n)
    L = chol(jnp.asarray(S))
    B = rng.normal(size=(n, 17))
    x1 = np.asarray(chol_solve(L, jnp.asarray(B)))
    x2 = np.asarray(chol_solve_blocked(L, jnp.asarray(B), block=64))
    np.testing.assert_allclose(x2, x1, rtol=1e-10, atol=1e-12)
    b = rng.normal(size=n)
    y1 = np.asarray(chol_solve(L, jnp.asarray(b)))
    y2 = np.asarray(chol_solve_blocked(L, jnp.asarray(b), block=64))
    np.testing.assert_allclose(y2, y1, rtol=1e-10, atol=1e-12)


def test_structure_aware_triangular_kernels(rng):
    """tri_inv_recursive / tri_lower_matmul(+right) / syrk_tri_lower /
    chol_inverse: the structure-aware matmul kernels behind the bench's
    explicit-inverse fast path, vs dense references."""
    import jax.numpy as jnp

    from mfgp_jax.ops.linalg import (chol, chol_inverse, syrk_tri_lower,
                                     tri_inv_recursive, tri_lower_matmul,
                                     tri_lower_matmul_right)

    for n in (96, 250):  # even and ragged vs the block sizes below
        A = rng.normal(size=(n, n))
        S = A @ A.T + n * np.eye(n)
        L = np.asarray(chol(jnp.asarray(S)))
        Linv = np.asarray(tri_inv_recursive(jnp.asarray(L), base=32))
        np.testing.assert_allclose(Linv, np.linalg.inv(L), rtol=1e-8,
                                   atol=1e-10)
        B = rng.normal(size=(n, 13))
        np.testing.assert_allclose(
            np.asarray(tri_lower_matmul(jnp.asarray(L), jnp.asarray(B),
                                        block=32)), L @ B, rtol=1e-10)
        C = rng.normal(size=(7, n))
        np.testing.assert_allclose(
            np.asarray(tri_lower_matmul_right(jnp.asarray(C),
                                              jnp.asarray(L), block=32)),
            C @ L, rtol=1e-10)
        K1 = np.asarray(syrk_tri_lower(jnp.asarray(Linv), block=32))
        np.testing.assert_allclose(K1, Linv.T @ Linv, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(
            np.asarray(chol_inverse(jnp.asarray(L), block=32)),
            np.linalg.inv(S), rtol=1e-7, atol=1e-9)
