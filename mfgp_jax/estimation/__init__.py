from mfgp_jax.estimation.kalman import (  # noqa: F401
    kf_predict, kf_update, kf_step, filter_trajectory, KFModel,
)
from mfgp_jax.estimation import observers  # noqa: F401
