"""Dynamic glider plant: the simulated hardware the runtime loop flies.

The reference's drivers close their control loops against the physical
GRACE glider through socket daemons; its ``nocontrol`` flag stubbed
actuation but left no dynamics to track (SURVEY §4 "fake backend"). This
plant supplies those dynamics so the full sense->estimate->control runtime
(hw/runtime.py) can be exercised without hardware:

* actuators (moving mass %, pump %, tail servo) move toward commanded
  positions under rate limits — the runtime's input-rate KF estimates
  their speeds exactly as the reference integrates energy from them
  (reference/PhysicalExperimentCode/GraceExplorationExperiments_MFEGP.py:
  800-806);
* pitch follows the moving-mass offset with a first-order response, so
  ``massSpdControl`` (reference/exploreExpSettings.py:56-66) stabilizes it;
* vertical speed follows pump buoyancy, so ``pumpSpdControl2``
  (reference/exploreExpSettings.py:43-54) tracks depth targets;
* heading rate follows tail bias (sign convention of the Swim/Glide laws,
  reference/...MFEGP.py:902-934,958-981); forward speed combines tail-wave
  propulsion with the buoyancy-glide polar (horizontal speed =
  vertical speed / tan(pitch), the same kinematics the planner's
  primitives assume, reference/GraceRIGV3.py:235-294).

Constants are derived from the :class:`~mfgp_jax.planning.primitives.
AgentConfig` speeds so the same plant works at tank scale (0.65 m) and at
the simulation study's 10 m scale. The plant exposes the full RobotIO
surface (including ``read_inputs``/``read_gyro``) plus a ``TailWave``
object mirroring the reference's 50 Hz ``Swimming`` thread
(reference/controllerHelper.py:297-344).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from mfgp_jax.hw.controllers import saturate, tail_wave
from mfgp_jax.planning.primitives import AgentConfig


@dataclass
class TailWave:
    """Host-side stand-in for the reference's tail-gait thread: the control
    laws write (bias, amp, freq); the plant samples the instantaneous servo
    angle each tick."""

    bias: float = 0.0  # deg
    amp: float = 0.0  # deg
    freq: float = 1.0  # Hz
    wave: str = "square"

    def angle(self, t: float) -> float:
        if self.amp == 0.0:
            return self.bias
        return float(tail_wave(t, self.bias, self.amp, self.freq, self.wave))


@dataclass
class PlantParams:
    """Dynamic constants; :meth:`from_agent` scales them to a planner
    config so flown legs are trackable at the primitives' assumed speeds."""

    mass_neutral: float = 46.0  # % (reference massStart)
    pump_neutral: float = 55.0  # % (reference pumpStart)
    mass_rate: float = 20.0  # %/s actuator slew
    pump_rate: float = 20.0  # %/s
    pitch_per_pct: float = math.radians(1.5)  # steady-state rad per mass %
    pitch_response: float = 0.4  # 1/s
    buoy_per_pct: float = 0.001  # m/s vertical per pump % below neutral
    yaw_per_bias: float = 1.0  # (rad/s) per rad of tail bias, negative sense
    swim_speed: float = 0.05  # m/s at (ref_amp, ref_freq)
    ref_amp_deg: float = 25.0
    ref_freq: float = 1.0
    min_glide_pitch: float = math.radians(8.0)  # below this, no glide polar
    max_glide_ratio: float = 6.0  # cap on horizontal/vertical glide speed

    @classmethod
    def from_agent(cls, cfg: AgentConfig) -> "PlantParams":
        vmax = max(cfg.flat_dive_speed, cfg.vert_glide_speed,
                   cfg.spiral_speed)
        return cls(
            # rise authority (pump at its 75% saturation vs 55% neutral)
            # must exceed the fastest primitive's vertical speed
            buoy_per_pct=1.5 * vmax / (75.0 - 55.0),
            swim_speed=cfg.swim_speed,
            ref_amp_deg=math.degrees(cfg.tail_amp),
            ref_freq=cfg.tail_freq,
        )


@dataclass
class GliderPlant:
    """Integrable glider with the RobotIO sensor/actuator surface."""

    params: PlantParams = field(default_factory=PlantParams)
    x: float = 0.0
    y: float = 0.0
    depth: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0
    t: float = 0.0

    def __post_init__(self):
        p = self.params
        self.mass_pos = p.mass_neutral  # %
        self.pump_pos = p.pump_neutral  # %
        self.mass_cmd = self.mass_pos
        self.pump_cmd = self.pump_pos
        self.tail = TailWave()
        self._field = None
        self._pitch_rate = 0.0
        self._yaw_rate = 0.0
        self._rng = np.random.default_rng(0)

    # -- simulation ----------------------------------------------------------
    def step(self, dt: float) -> None:
        p = self.params
        # actuator slew toward commands
        self.mass_pos += saturate(self.mass_cmd - self.mass_pos,
                                  -p.mass_rate * dt, p.mass_rate * dt)
        self.pump_pos += saturate(self.pump_cmd - self.pump_pos,
                                  -p.pump_rate * dt, p.pump_rate * dt)
        # pitch chases the mass-offset steady state
        pitch_ss = p.pitch_per_pct * (self.mass_pos - p.mass_neutral)
        dpitch = p.pitch_response * (pitch_ss - self.pitch)
        self._pitch_rate = dpitch
        self.pitch += dpitch * dt
        # buoyancy-driven vertical speed (positive = sinking)
        w = p.buoy_per_pct * (p.pump_neutral - self.pump_pos)
        # heading from tail bias (positive bias reduces yaw — the sign the
        # Swim law's heading_err -> bias mapping assumes)
        delta = self.tail.angle(self.t)
        dyaw = -p.yaw_per_bias * math.radians(self.tail.bias)
        self._yaw_rate = dyaw
        self.yaw += dyaw * dt
        # forward speed: tail-wave propulsion + glide polar
        v_swim = (p.swim_speed * (abs(self.tail.amp) / p.ref_amp_deg)
                  * (self.tail.freq / p.ref_freq)) if self.tail.amp else 0.0
        v_glide = 0.0
        if abs(self.pitch) > p.min_glide_pitch and abs(w) > 1e-9:
            ratio = min(1.0 / math.tan(abs(self.pitch)), p.max_glide_ratio)
            v_glide = abs(w) * ratio
        v_h = v_swim + v_glide
        self._vx = v_h * math.cos(self.yaw)
        self._vy = v_h * math.sin(self.yaw)
        self._vz = w if (self.depth > 0.0 or w > 0.0) else 0.0
        self.x += self._vx * dt
        self.y += self._vy * dt
        self.depth = max(0.0, self.depth + w * dt)
        self.t += dt
        self._delta = delta
        self._w = w
        self._v_h = v_h

    # -- RobotIO sensor surface ----------------------------------------------
    def attach_field(self, fn):
        self._field = fn

    def read_depth(self, mode: int = 0) -> float:
        return self.depth

    def read_euler(self, units: str = "rad"):
        if units == "rad":
            return (self.roll, self.pitch, self.yaw)
        return tuple(np.rad2deg([self.roll, self.pitch, self.yaw]))

    def read_gyro(self):
        return (0.0, self._pitch_rate, self._yaw_rate)

    def read_imu(self):
        return (self.roll, self.pitch, self.yaw, 0.0, 0.0, 0.0,
                0.0, self._pitch_rate, self._yaw_rate)

    def read_inputs(self):
        """(mass %, pump %, tail deg) — reference/controllerHelper.py:176-179."""
        return (self.mass_pos, self.pump_pos, self.tail.angle(self.t))

    def read_rgb(self):
        if self._field is None:
            return (0.0, 0.0, 0.0)
        v = float(self._field(self.x, self.y, self.depth))
        return (v, v, v)

    def read_batt_volt(self) -> float:
        return 12.6

    # -- RobotIO actuator surface ---------------------------------------------
    def set_mass_pos(self, per: float) -> None:
        self.mass_cmd = saturate(per, 0.0, 100.0)

    def set_pump_pos(self, per: float) -> None:
        self.pump_cmd = saturate(per, 0.0, 100.0)

    def set_actuators(self, angle: float = -360, mass_pos: float = -1,
                      pump_pos: float = -1):
        if mass_pos != -1:
            self.set_mass_pos(mass_pos)
        if pump_pos != -1:
            self.set_pump_pos(pump_pos)
        if angle != -360:
            self.tail.bias = angle

    def set_servo(self, angle: float) -> None:
        self.tail.bias = angle

    @property
    def position(self) -> np.ndarray:
        return np.array([self.x, self.y, self.depth])

    @property
    def velocity(self) -> np.ndarray:
        """World-frame true velocity (x, y, depth-rate)."""
        return np.array([getattr(self, "_vx", 0.0),
                         getattr(self, "_vy", 0.0),
                         getattr(self, "_vz", 0.0)])
