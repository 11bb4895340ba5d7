"""Device-mesh parallelism: ICI-sharded posteriors and restart-batched fits."""

from mfgp_jax.parallel.mesh import (DP_AXIS, MP_AXIS, dp_sharding, make_mesh,
                                    mp_sharding, replicated)
from mfgp_jax.parallel.sharded import (make_sharded_ar1_cross_cov,
                                       make_sharded_nlml_value_and_grad,
                                       make_sharded_gp_predict,
                                       make_sharded_mfgp_predict,
                                       make_sharded_weighted_mse)
from mfgp_jax.parallel.train import (TrainState, fit_sharded, init_restarts,
                                     make_mfgp_train_step)
from mfgp_jax.parallel.sweep import (env_shard, process_shard, run_sweep,
                                     trainer_sweep)
from mfgp_jax.parallel.chol import make_sharded_cholesky
from mfgp_jax.parallel.chol import (make_fully_sharded_nlml_value_and_grad,
                                    make_sharded_tri_solves)
from mfgp_jax.parallel.chol import fit_memory_scaled
