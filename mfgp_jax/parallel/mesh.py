"""Device mesh construction for the exploration stack.

The reference is a single-process numpy codebase with no distributed layer
(SURVEY §2.2; reference/controllerHelper.py:348-355 is Unix-socket hardware
IPC, not compute comms). This framework scales instead over a 2D
``jax.sharding.Mesh``:

* ``"dp"`` — data/restart parallelism: independent hyperparameter-restart
  fits, seeds, candidate-trajectory batches (the reference runs these
  serially, reference/NIGP.py:231-239).
* ``"mp"`` — model/grid parallelism: rows of the posterior evaluation grid
  and columns of dense-covariance solves are sharded across chips; XLA
  inserts the ICI collectives (all-gather of results, psum of Frobenius
  reductions).

Collectives ride ICI within a pod slice; multi-host sweeps over fields /
trajectories are embarrassingly parallel over DCN.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"
MP_AXIS = "mp"


def make_mesh(n_devices: int | None = None, mp: int | None = None,
              devices=None) -> Mesh:
    """Create a 2D (dp, mp) mesh over ``n_devices``.

    ``mp`` defaults to the largest power of two <= sqrt(n): a square-ish
    mesh keeps both the restart batch and the grid shard counts useful.
    A single device yields a (1, 1) mesh so the same jitted functions run
    unmodified on one chip.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"requested n_devices={n_devices} but only {len(devices)} "
            f"devices are available ({devices!r}); provision virtual CPU "
            "devices with XLA_FLAGS=--xla_force_host_platform_device_count "
            "before JAX backend initialization, or use "
            "__graft_entry__.dryrun_multichip which self-bootstraps")
    devices = devices[:n_devices]
    if mp is None:
        # largest power of two <= sqrt(n) that divides n
        mp = 1
        while mp * 2 <= math.isqrt(n_devices) and n_devices % (mp * 2) == 0:
            mp *= 2
    if n_devices % mp:
        raise ValueError(f"mp={mp} does not divide n_devices={n_devices}")
    dp = n_devices // mp
    arr = np.asarray(devices).reshape(dp, mp)
    return Mesh(arr, (DP_AXIS, MP_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def dp_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over the restart/data axis."""
    return NamedSharding(mesh, P(DP_AXIS))


def mp_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over the model/grid axis."""
    return NamedSharding(mesh, P(MP_AXIS))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
