"""Expected Information Density (EID).

SURVEY C12: GP posterior on a grid -> faux-UCB blend of mean and posterior
std -> softmax distribution (reference/exploreSimSettings.py:6-37 sim
variant; reference/PhysicalExperimentCode/exploreExpSettings.py:8-30
physical variant). The two variants differ only in their negative-variance
guard: the sim one collapses the whole EID to uniform, the physical one
clamps negative variances to the prior variance first — both are provided
via ``neg_var_guard``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mfgp_jax.metrics.ergodic import softmax


def expected_information_density(mu, sig, prior_sig, alpha=1.0 / 11,
                                 auto: bool = False,
                                 neg_var_guard: str = "uniform"):
    """EID = softmax(alpha * mu + (1 - alpha) * sqrt(|sig|)).

    mu, sig: posterior mean / marginal variance on the grid, (G,).
    prior_sig: data-free variance (kernel variance + noise; for the MF
    model the sum of the per-fidelity variances + top noise, the
    ``param_array[[0,4,8,-1]]`` selection at
    reference/exploreSimSettings.py:16).
    auto: adaptive exploitation weight ``alpha = 1 - mean(sig)/prior_sig``
    (reference/exploreSimSettings.py:20-21).
    neg_var_guard: "uniform" (sim: any sig<0 -> uniform EID,
    reference/exploreSimSettings.py:30-35) or "clamp" (physical:
    sig[sig<0] = prior_sig, reference/PhysicalExperimentCode/
    exploreExpSettings.py:24).

    Returns (G,) normalized distribution.
    """
    mu = jnp.asarray(mu).reshape(-1)
    sig = jnp.asarray(sig).reshape(-1)
    had_neg = jnp.any(sig < 0)
    if neg_var_guard == "clamp":
        sig = jnp.where(sig < 0, prior_sig, sig)
        had_neg = jnp.asarray(False)
    if auto:
        alpha = 1.0 - jnp.mean(sig) / prior_sig
    faux_ucb = alpha * mu + (1.0 - alpha) * jnp.sqrt(jnp.abs(sig))
    eid = softmax(faux_ucb)
    uniform = jnp.full_like(eid, 1.0 / eid.shape[0])
    return jnp.where(had_neg, uniform, eid)


def eid_grid(WS, max_depth, nums=(10, 20, 10)):
    """The sim EID evaluation grid: meshgrid over workspace x depth with the
    reference's axis ordering and ravel layout
    (reference/exploreSimSettings.py:8-11)."""
    specs = [(WS[0][0], WS[0][1], nums[0]),
             (WS[1][0], WS[1][1], nums[1]),
             (0.0, max_depth, nums[2])]
    grids = np.meshgrid(*[np.linspace(s[0], s[1], s[2]) for s in specs])
    return np.array([g.ravel() for g in grids]).T
