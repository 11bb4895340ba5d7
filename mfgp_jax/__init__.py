"""mfgp_jax — multi-fidelity GP adaptive-exploration framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``colem404/Adaptive-Exploration-Under-Localization-Uncertainty-Using-
Multi-fidelity-Gaussian-Processes`` (mounted read-only at /root/reference,
cited throughout as ``reference/<file>:<line>``).

Design stance (not a port):
  * One functional GP core: covariance assembly -> Cholesky -> posterior,
    with the exact negative log marginal likelihood differentiable end-to-end
    via ``jax.grad`` (the reference instead leans on GPy/emukit internals).
  * Static shapes everywhere: fidelity groups, planner path sets and
    candidate-trajectory batches are padded + masked so everything jits.
  * Sequential-conditioning information gain is computed in closed form from
    one Cholesky factor instead of the reference's O(P) GP-refit loop
    (reference/GraceRIGV3.py:468-503).
  * Multi-chip scaling via ``jax.sharding.Mesh`` + ``shard_map`` over
    posterior-grid rows and covariance tiles (the reference is single-process
    NumPy throughout).

Subpackages
-----------
ops         covariance kernels, Cholesky/solves, L-BFGS
models      SFGP, AR1 multi-fidelity GP, NIGP (input-noise GP)
estimation  Kalman filters and observers (lax.scan trajectory smoothers)
fields      synthetic WRBF scalar fields
metrics     ergodic KL, Fourier/Sobolev, EID, info-gain, RMSE/WMSE
planning    motion primitives + RIG information-gathering graph planner
data        CSV schemas byte-compatible with the reference Data/ pipeline
parallel    device meshes, sharded posterior evaluation
sim         closed-loop exploration simulator (the reference's missing driver)
utils       configs, checkpointing, profiling
"""

__version__ = "0.1.0"

from mfgp_jax.ops import kernels, linalg  # noqa: F401
