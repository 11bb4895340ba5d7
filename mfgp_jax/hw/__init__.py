"""Robot runtime layer: controllers, I/O backends, AprilTag localization.

Host-side by design — this is the reference's Raspberry-Pi-facing surface
(SURVEY C23-C25); the accelerator compute path lives in
ops/models/planning.
"""

from mfgp_jax.hw.controllers import (KPID, PID, angle_wrap, saturate,
                                     simple_lpf, tail_wave, yaw_correction)
from mfgp_jax.hw.io import (RobotIO, SimulatedRobotIO, SocketRobotIO,
                            m0_to_act_pos, rp1_to_act_pos)
from mfgp_jax.hw.apriltag import (AprilFusion, AprilFusionConfig,
                                  TagDetection, load_tag_map, rp_to_tf,
                                  tf_to_vec, vec_to_tf, zyx_rotm)
from mfgp_jax.hw.geo import convert_gps_format, gps_bearing_distance
from mfgp_jax.hw.plant import GliderPlant, PlantParams, TailWave
from mfgp_jax.hw.runtime import (FlightLog, RobotRuntime, RuntimeConfig,
                                 flight_plan, mass_spd_control,
                                 pump_spd_control2, traj_point)
from mfgp_jax.hw.trajectories import (TRAJECTORIES, reference_trajectory,
                                      scale_to_workspace)
from mfgp_jax.hw import xbee  # noqa: F401
