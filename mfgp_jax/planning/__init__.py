from mfgp_jax.planning.primitives import (  # noqa: F401
    AgentConfig, Leg, generate_trajectory, evaluate_trajectory,
    edge_points_to_traj_points, path_to_traj_points, swim_energy,
)
from mfgp_jax.planning.scoring import (  # noqa: F401
    ErgodicCost, FourierErgodicCost, SFInfoGainCost, MFInfoGainCost,
    BatchLogDetCost,
    MFBatchLogDetCost,
)
from mfgp_jax.planning.rig import RIGPlanner, Node, PathSegment  # noqa: F401
from mfgp_jax.planning.rig_device import DeviceRIG  # noqa: F401
