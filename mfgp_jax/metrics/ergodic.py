"""Ergodic coverage metric: trajectory time-averaged statistics + KL.

SURVEY C10 (reference/ergodicKLDivergence.py). The reference computes the
trajectory distribution with a Python loop over grid cells, each doing a
trapezoid rule over trajectory points (reference/ergodicKLDivergence.py:53-61);
here the whole thing is one (G, T) broadcast + trapezoid reduction — a single
fused elementwise kernel, vmappable over candidate paths for the planner.

Masking: planner batches pad trajectories to a fixed T; pass ``mask`` to
exclude padding (padded steps get zero quadrature weight).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def softmax(a):
    """Vector -> probability distribution (reference/ergodicKLDivergence.py:6-9).

    Max-shifted for overflow safety (value-identical: softmax is shift
    invariant; the reference's raw ``exp`` overflows for large scores).
    """
    a = jnp.asarray(a)
    e = jnp.exp(a - jnp.max(a))
    return e / jnp.sum(e)


def config_grid(*specs):
    """Search-space grid (reference/ergodicKLDivergence.py:12-31).

    Each spec is (low, high, num). Returns (ss, grids..., lengths...) with
    ``ss`` the (prod(num), dim) stacked grid, matching the reference's
    meshgrid + ravel layout.
    """
    dim = len(specs)
    grids = np.meshgrid(*[np.linspace(s[0], s[1], s[2]) for s in specs])
    lengths = [s[1] - s[0] for s in specs]
    ss = np.array([g.ravel() for g in grids]).T
    return (ss, *grids, *lengths)


def gaussian_sensor(x, s, sigma_diag):
    """Gaussian sensor footprint density N(s; x_t, diag(sigma)) per
    trajectory point (reference/ergodicKLDivergence.py:34-44).

    x: (T, d) trajectory; s: (d,) one domain point; sigma_diag: (d,) shared
    variances or (T, d) per-point variances. Returns (T,).
    """
    x = jnp.asarray(x)
    d = x.shape[1]
    sigma_diag = jnp.asarray(sigma_diag)
    norm = 1.0 / jnp.sqrt((2 * jnp.pi) ** d * jnp.prod(sigma_diag, axis=-1))
    quad = jnp.sum((x - s) ** 2 / sigma_diag, axis=-1)
    return norm * jnp.exp(-0.5 * quad)


@partial(jax.jit, static_argnames=("parity_drop_last",))
def trajectory_distribution(t, x, grid, sigma_diag, mask=None,
                            parity_drop_last: bool = False):
    """Time-averaged trajectory statistics q over a discrete domain.

    q[g] = (1/T_total) * trapz_t N(s_g; x(t), diag(sigma)), the quantity the
    reference calls ``computeTrajectoryIntegrand``
    (reference/ergodicKLDivergence.py:46-61), computed for all G grid cells
    at once as a (G, T) broadcast.

    t: (T,) timestamps; x: (T, d); grid: (G, d); sigma_diag: (d,) or (T, d).
    mask: optional (T,) boolean — False entries contribute zero quadrature
    weight (for padded planner batches).
    parity_drop_last: reproduce the reference's loop bound quirk that leaves
    the final grid cell at exactly 0 (its loop runs ``range(G-1)``).
    """
    t = jnp.asarray(t).reshape(-1)
    x = jnp.asarray(x)
    grid = jnp.asarray(grid)
    sigma_diag = jnp.asarray(sigma_diag)
    d = x.shape[1]
    norm = 1.0 / jnp.sqrt((2 * jnp.pi) ** d * jnp.prod(sigma_diag, axis=-1))
    # (G, T) squared Mahalanobis distances
    quad = jnp.sum(
        (x[None, :, :] - grid[:, None, :]) ** 2 / sigma_diag, axis=-1)
    dens = norm * jnp.exp(-0.5 * quad)  # (G, T)
    # trapezoid weights over t
    dt = t[1:] - t[:-1]
    w = jnp.zeros_like(t)
    w = w.at[:-1].add(0.5 * dt).at[1:].add(0.5 * dt)
    if mask is not None:
        # zero the weight of any interval touching a masked step
        mask = jnp.asarray(mask)
        seg = mask[1:] & mask[:-1]
        w = jnp.zeros_like(t)
        w = w.at[:-1].add(0.5 * dt * seg).at[1:].add(0.5 * dt * seg)
        span = jnp.sum(dt * seg)
    else:
        span = t[-1] - t[0]
    q = dens @ w / span
    if parity_drop_last:
        q = q.at[-1].set(0.0)
    return q


def kl_divergence(p, q):
    """KL(p || q) for discrete distributions, normalizing both inputs —
    the semantics of ``scipy.stats.entropy(p, q)`` the reference relies on
    (reference/ergodicKLDivergence.py:63-68)."""
    p = jnp.asarray(p).reshape(-1)
    q = jnp.asarray(q).reshape(-1)
    p = p / jnp.sum(p)
    q = q / jnp.sum(q)
    return jnp.sum(jnp.where(p > 0, p * (jnp.log(p) - jnp.log(q)), 0.0))


def combined_trajectory_distribution(dur1, dur2, q1, q2):
    """Duration-weighted merge of two trajectory distributions
    (reference/ergodicKLDivergence.py:70-71)."""
    tot = dur1 + dur2
    return dur1 / tot * q1 + dur2 / tot * q2
