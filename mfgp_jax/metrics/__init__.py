from mfgp_jax.metrics.ergodic import (  # noqa: F401
    softmax, config_grid, gaussian_sensor, trajectory_distribution,
    kl_divergence, combined_trajectory_distribution,
)
from mfgp_jax.metrics.fourier import (  # noqa: F401
    config_k, basis_norms, sobolev_weights, fourier_basis,
    fourier_coefficients, merge_coefficients, sobolev_norm,
)
from mfgp_jax.metrics.eid import expected_information_density, eid_grid  # noqa: F401
from mfgp_jax.metrics.info_gain import (  # noqa: F401
    sequential_gain_from_cov, sequential_gain_cross, batch_logdet_gain,
)
from mfgp_jax.ops.linalg import rmse, weighted_mse  # noqa: F401
