"""Fault-injection fixtures (SURVEY §5 failure-detection).

The reference's defensive patterns — hyperparameter blow-up recovery,
NaN guards, negative-variance guards, Cholesky jitter + penalty — kept as
first-class behaviors and exercised here with injected faults.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mfgp_jax.metrics.eid import expected_information_density
from mfgp_jax.models.gp import GP, GPParams, nlml
from mfgp_jax.models.mfgp import MFGP
from mfgp_jax.sim.explore import ExplorationSim
from mfgp_jax.utils.configs import ExperimentConfig


def test_nlml_nonfinite_maps_to_penalty(rng):
    """Degenerate hyps (huge variance, zero noise on duplicated inputs)
    must not crash the optimizer loop — the scipy driver maps NaN/inf to a
    1e20 penalty (reference safe_obj, reference/NIGP.py:119-123)."""
    X = np.zeros((10, 2))  # duplicated points: singular covariance
    y = rng.normal(size=10)
    gp = GP(X, y)
    # optimize survives the singular start and returns a finite value
    f = gp.optimize(maxiter=5)
    assert np.isfinite(f) or f == pytest.approx(1e20, rel=1)


def test_optimize_restarts_survives_nan_objective(rng):
    X = rng.normal(size=(12, 2))
    y = np.full(12, np.nan)  # poisoned targets
    gp = GP(X, y, jitter=1e-6)
    f = gp.optimize_restarts(n_restarts=2, maxiter=20)
    # every restart hits the 1e20 penalty; params remain finite
    assert np.isfinite(gp.param_array).all()


def test_hyp_blowup_recovery_in_sim(rng):
    """The sim's recovery clamps |param| > 90 to 1 (reference
    reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
    398-410)."""
    exp = ExperimentConfig(multi_fidelity=False, ergodic=False, B=10, BD=1)
    sim = ExplorationSim(exp, seed=0, plan_iters=4)
    X = rng.normal(size=(8, 3))
    y = rng.normal(size=8)
    model = sim._make_model(X, np.ones(8, int), y)
    blown = np.array(model.param_array)
    blown[0] = 1e30
    blown[1] = np.nan
    model.set_param_array(blown)
    sim._recover_hyps(model)
    v = np.asarray(model.param_array)
    assert np.isfinite(v).all() and (np.abs(v) <= 90).all()
    assert v[0] == 1.0 and v[1] == 1.0


def test_eid_negative_variance_guards():
    mu = jnp.asarray([1.0, 2.0, 3.0])
    sig = jnp.asarray([0.5, -0.1, 0.4])  # injected negative variance
    # sim guard: collapse to uniform (reference/exploreSimSettings.py:30-35)
    eid_u = expected_information_density(mu, sig, prior_sig=2.0,
                                         neg_var_guard="uniform")
    np.testing.assert_allclose(np.asarray(eid_u), np.full(3, 1 / 3))
    # physical guard: clamp to prior variance
    # (reference/PhysicalExperimentCode/exploreExpSettings.py:24)
    eid_c = expected_information_density(mu, sig, prior_sig=2.0,
                                         neg_var_guard="clamp")
    assert not np.allclose(np.asarray(eid_c), 1 / 3)
    np.testing.assert_allclose(np.asarray(eid_c).sum(), 1.0, rtol=1e-6)


def test_jitter_rescues_singular_covariance(rng):
    X = np.repeat(rng.normal(size=(5, 3)), 2, axis=0)  # exact duplicates
    y = rng.normal(size=10)
    p = GPParams.default(3, jnp.float64)
    v_nojit = float(nlml(p, jnp.asarray(X), jnp.asarray(y),
                         jitter=0.0))
    v_jit = float(nlml(p, jnp.asarray(X), jnp.asarray(y), jitter=1e-6))
    assert np.isfinite(v_jit)  # jitter path always finite
    del v_nojit  # may or may not be finite depending on backend


def test_empty_and_tiny_fidelity_groups(rng):
    """Live exploration starts with near-empty fidelity groups
    (verify-skill probe)."""
    X = rng.normal(size=(6, 3))
    y = rng.normal(size=6)
    m = MFGP.from_fidelity_lists([X[:0], X[:1], X[1:]],
                                 [y[:0], y[:1], y[1:]], jitter=1e-6)
    mu, var = m.predict(X[:3])
    assert np.isfinite(np.asarray(mu)).all()
    assert (np.asarray(var) > 0).all()


def test_sim_survives_constant_field(rng):
    """A zero-information field (constant measurements) must not break the
    replan loop (softmax of a constant EID is uniform)."""
    from mfgp_jax.fields.wrbf import WRBFField

    flat = WRBFField(p=jnp.zeros((1, 3)), L=jnp.asarray(0.0),
                     s=jnp.asarray(1.0), w=jnp.ones(3))
    exp = ExperimentConfig(multi_fidelity=False, ergodic=True, B=8, BD=1)
    sim = ExplorationSim(exp, seed=1, plan_iters=4, field_env=flat)
    res = sim.run()
    assert res.budget_used <= 8.0


def test_wmse_singular_covariance_recovers(rng):
    """A near-singular posterior covariance must yield a finite WMSE via
    the jitter retry (NIGP with vanishing noise hits this; observed on
    GPData_0.2_fieldMeas_0_T1_0)."""
    import jax.numpy as jnp

    from mfgp_jax.ops.linalg import weighted_mse

    n = 40
    u = rng.normal(size=(n, 2))
    cov = u @ u.T  # rank-2: singular
    err = rng.normal(size=n)
    w = float(weighted_mse(jnp.asarray(err), jnp.asarray(cov)))
    assert not np.isfinite(w)  # raw path fails as expected
    # the trainers-path retry
    jit = 1e-10 * np.trace(cov) / n + 1e-12
    w2 = float(weighted_mse(jnp.asarray(err),
                            jnp.asarray(cov + jit * np.eye(n))))
    assert np.isfinite(w2)
