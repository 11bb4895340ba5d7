"""Closed-loop exploration simulation (the reference's missing sim driver)."""

from mfgp_jax.sim.dynamics import (glider_simple, rk4_step,  # noqa: F401
                                    single_integrator_3d, unicycle_3d)
from mfgp_jax.sim.explore import (ExplorationResult, ExplorationSim,
                                  ReplanRecord)
