"""batched_lbfgs unit tests (the restart-batched optimizer behind every
device fit; reference optimizer = GPy/scipy L-BFGS-B,
reference/GPTrainers.py:68, reference/NIGP.py:235-236)."""

import jax
import jax.numpy as jnp
import numpy as np

from mfgp_jax.ops.optimize import batched_lbfgs


def _quad(x):
    return jnp.sum((x - 1.5) ** 2)


def test_quadratic_converges():
    x, f, k = batched_lbfgs(_quad, jnp.zeros(4), maxiter=100, tol=1e-8)
    np.testing.assert_allclose(np.asarray(x), 1.5, atol=1e-6)
    assert float(f) < 1e-10
    assert int(k) < 30


def test_bounds_projected():
    x, f, _ = batched_lbfgs(_quad, jnp.zeros(4),
                            upper=jnp.full(4, 1.0), maxiter=100)
    np.testing.assert_allclose(np.asarray(x), 1.0, atol=1e-6)


def test_ftol_cuts_stragglers_without_changing_optimum():
    """The scipy-factr-style stagnation stop: on an ill-conditioned
    valley (slow f decrease for many iterations) ftol stops far earlier
    at a nearly identical objective value; ftol=0 preserves the old
    pure-gradient criterion bit-for-bit on well-behaved problems."""

    def rosen(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    x0 = jnp.asarray(np.full(8, -1.2))
    x_ref, f_ref, k_ref = batched_lbfgs(rosen, x0, maxiter=500, tol=1e-10)
    x_ft, f_ft, k_ft = batched_lbfgs(rosen, x0, maxiter=500, tol=1e-10,
                                     ftol=1e-9)
    assert int(k_ft) < int(k_ref)
    # stagnation stop loses at most the stagnation threshold's worth of f
    assert float(f_ft) <= float(f_ref) + 1e-6 * max(1.0, float(f_ref))

    # ftol=0.0 (the default) is the exact old criterion
    x_a, f_a, k_a = batched_lbfgs(_quad, jnp.zeros(4), maxiter=100,
                                  tol=1e-8)
    x_b, f_b, k_b = batched_lbfgs(_quad, jnp.zeros(4), maxiter=100,
                                  tol=1e-8, ftol=0.0)
    assert int(k_a) == int(k_b)
    np.testing.assert_array_equal(np.asarray(x_a), np.asarray(x_b))


def test_ftol_under_vmap_frees_straggler_launch():
    """Under vmap the while_loop runs to the LAST lane's convergence; a
    stagnating lane must not drag the launch to maxiter when ftol is on."""

    def mixed(x):
        # lane-dependent conditioning via the data vector itself
        return (100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
                + jnp.sum(x[2:] ** 2))

    x0s = jnp.asarray(np.stack([np.full(4, -1.2), np.zeros(4)]))
    _, fs, ks = jax.vmap(
        lambda v: batched_lbfgs(mixed, v, maxiter=400, tol=1e-12,
                                ftol=1e-9))(x0s)
    # with tol=1e-12 unreachable in f64 rounding for the rosenbrock lane,
    # only the stagnation stop ends the loop before maxiter
    assert int(jnp.max(ks)) < 400
    assert np.all(np.isfinite(np.asarray(fs)))
