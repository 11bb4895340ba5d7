"""Declarative configuration (SURVEY C26).

The reference's configuration is *executable* import-time module state
(reference/exploreSimSettings.py seeds the global RNG at import :90, builds
the agent :174-196, writes CSV headers; reference/PhysicalExperimentCode/
exploreExpSettings.py:216-298 likewise). Here the same parameter surface is
plain frozen dataclasses with the reference's parameter names kept, zero
side effects, and explicit constructors for derived objects (KF models,
agent configs, eval grids).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

from mfgp_jax.planning.primitives import AgentConfig


@dataclass(frozen=True)
class KFConfig:
    """6-state constant-velocity filter constants
    (reference/exploreSimSettings.py:143-153)."""

    p0: float = 0.001
    q_diag: Tuple[float, ...] = (0.005, 0.005, 0.005, 0.05, 0.05, 0.05)
    r_diag: Tuple[float, ...] = (0.1, 0.1, 0.05, 0.25, 0.25, 0.25)
    meas_noise: Tuple[float, ...] = (0.05, 0.05, 0.02, 0.2, 0.2, 0.2)
    at_surface: float = 0.2

    def model(self, dtype=np.float64):
        import jax.numpy as jnp

        from mfgp_jax.estimation.kalman import KFModel

        return KFModel(
            P0=self.p0 * jnp.eye(6, dtype=dtype),
            Q=jnp.diag(jnp.asarray(self.q_diag, dtype)),
            R=jnp.diag(jnp.asarray(self.r_diag, dtype)),
            meas_noise_std=jnp.asarray(self.meas_noise, dtype),
            at_surface=self.at_surface,
        )


@dataclass(frozen=True)
class SimConfig:
    """Simulation-pipeline settings (reference/exploreSimSettings.py:88-206).

    Parameter names follow the reference so recorded artifacts and settings
    files line up 1:1.
    """

    seed: int = 0
    WS: Tuple[Tuple[float, float], ...] = ((0.0, 10.0), (0.0, 20.0))
    max_depth: float = 10.0
    vmn: float = 0.2  # velocity measurement noise (m/s)^2
    dt: float = 0.1
    at_surface: float = 0.2
    meas_noise: float = 0.125  # field measurement noise
    meas_rate: float = 0.2  # Hz, GP-data downsample (reference/prepGPData.py:17)
    t_cut: float = 3600.0  # dataset time cutoff (reference/GPTrainers.py:37)
    field_offset: float = 0.0
    # planner (reference/exploreSimSettings.py:198-205)
    B: float = 150.0
    BD: int = 10
    same_node_distance: float = 1.0
    max_iter: int = 100
    Rd: float = 5.0
    near_rad: float = 1.25
    step_size: float = 10.0
    goal_var: float = 4.0  # 2**2
    normalize_wmse: bool = True
    kf: KFConfig = field(default_factory=KFConfig)

    @property
    def fidlevels(self) -> Tuple[float, float, float]:
        """``(min(diff(WS)) * [.05,.15,.25])**2``
        (reference/exploreSimSettings.py:108)."""
        spans = [hi - lo for lo, hi in self.WS]
        m = min(spans)
        return tuple((m * f) ** 2 for f in (0.05, 0.15, 0.25))

    @property
    def kf_meas_noise(self) -> Tuple[float, ...]:
        """Measurement-noise std vector with the velocity-noise level
        spliced in (reference/exploreSimSettings.py:154)."""
        return (0.05, 0.05, 0.02, self.vmn, self.vmn, self.vmn)

    def kf_model(self, dtype=np.float64):
        return replace(self.kf, meas_noise=self.kf_meas_noise,
                       at_surface=self.at_surface).model(dtype)

    def test_points(self, nums=(10, 20, 10)) -> np.ndarray:
        """The 2000-point eval grid, Fortran raveled to match the
        reference's ``testPoints`` ordering
        (reference/exploreSimSettings.py:116-119)."""
        return _grid([(self.WS[0][0], self.WS[0][1], nums[0]),
                      (self.WS[1][0], self.WS[1][1], nums[1]),
                      (0.0, self.max_depth, nums[2])])

    def agent(self) -> AgentConfig:
        cfg = AgentConfig.sim_defaults()
        return replace(
            cfg,
            fid_levels=self.fidlevels,
            max_depth=self.max_depth,
        )


def _grid(specs) -> np.ndarray:
    """Fortran-raveled meshgrid, the reference's grid convention."""
    g = np.meshgrid(*[np.linspace(a, b, n) for a, b, n in specs])
    return np.array([x.ravel("F") for x in g]).T


@dataclass(frozen=True)
class ExperimentConfig:
    """Physical-experiment-shaped settings (reference/PhysicalExperimentCode/
    exploreExpSettings.py) for the closed-loop simulator: the robot grid,
    budget, replan cadence, and model-variant switchboard."""

    sim: SimConfig = field(default_factory=SimConfig)
    B: float = 80.0  # robot energy budget (exploreExpSettings.py:253)
    BD: int = 10
    # wall-clock stopwatch per replan; None = iteration-bounded planning.
    # Set 45.0 to reproduce the reference's stopwatch
    # (exploreExpSettings.py:214-215); now wired into RIGPlanner.
    plan_wallclock: float | None = None
    multi_fidelity: bool = True
    ergodic: bool = True  # False -> information-gain scoring
    alpha_auto: bool = False  # EID auto-alpha (exploreExpSettings.py:71)
    update_hyps: bool = True  # retrain at replan (exploreExpSettings.py:73)
    kernel: str = "rbf"  # physical drivers use "matern32"
    ergodic_metric: str = "kl"  # "kl" (reference) or "fourier" (Sobolev)
    # info-gain variants: "sequential" (calcPathInfoSF2/calculatePathInfoEmu)
    # or "batch" (grid log-det, calcPathInfoSFBatch/calculatePathInfoEmuBatch
    # — what the reference's PHYSICAL SFGP/MFGP drivers score with)
    info_cost: str = "sequential"

    @property
    def variant(self) -> str:
        """The reference's 5-script experiment matrix as a name
        (SURVEY C25): MFEGP / MFGP / SFEGP / SFGP (+Manual separately)."""
        return (("MF" if self.multi_fidelity else "SF")
                + ("E" if self.ergodic else "") + "GP")

    # -- physical-run grids & initial hyps (exploreExpSettings.py) ----------
    def erg_grid(self) -> np.ndarray:
        """Batch-ergodic grid 21x11x5 (exploreExpSettings.py:158-161)."""
        WS, mD = self.sim.WS, self.sim.max_depth
        return _grid([(WS[0][0], WS[0][1], 21), (WS[1][0], WS[1][1], 11),
                      (0.0, mD, 5)])

    def ig_grid(self) -> np.ndarray:
        """Batch info-gain grid 10x6x5 (exploreExpSettings.py:163-166)."""
        WS, mD = self.sim.WS, self.sim.max_depth
        return _grid([(WS[0][0], WS[0][1], 10), (WS[1][0], WS[1][1], 6),
                      (0.0, mD, 5)])

    def robot_test_points(self) -> np.ndarray:
        """31x31x11 robot evaluation grid (exploreExpSettings.py:170-173,
        a 15ft x 10ft x 1m tank)."""
        ft = 0.3048
        return _grid([(0.0, 15 * ft, 31), (0.0, 10 * ft, 31),
                      (0.0, 1.0, 11)])

    @staticmethod
    def physical_init_hyps_sf() -> np.ndarray:
        """Pre-set SFGP hyps [sig_var, l(3), noise]
        (exploreExpSettings.py:75-78)."""
        return np.array([3.378, 0.1678, 0.1792, 0.3618, 1e-8])

    @staticmethod
    def physical_init_hyps_mf() -> np.ndarray:
        """Pre-set MFGP hyps in the 17-element emukit param_array layout.

        The reference's ``initHypsMF`` (exploreExpSettings.py:79-81) is 15
        values — per-fidelity [var, lx, ly, lz] x3, scale [1,1], and ONE
        shared measurement noise; emukit's param_array carries three
        per-fidelity noises, so the shared value is replicated here."""
        fid1 = [6.6895, .3872, .3808, .4076]
        fid2 = [1.9063, .1938, .1868, .2204]
        fid3 = [3.72e-8, 4.78, 3.65, 1.8]
        return np.array(fid1 + fid2 + fid3 + [1.0, 1.0]
                        + [0.1156, 0.1156, 0.1156])

    @staticmethod
    def field_transform(x):
        """Output transform ``log(x + 1)`` applied to the RGB field data
        (exploreExpSettings.py:156 ``ftf``)."""
        return np.log(np.asarray(x) + 1.0)


DEFAULT_SIM = SimConfig()
