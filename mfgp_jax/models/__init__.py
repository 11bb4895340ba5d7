from mfgp_jax.models.gp import GP, GPParams  # noqa: F401
from mfgp_jax.models.mfgp import MFGP, MFGPParams  # noqa: F401
from mfgp_jax.models.nigp import NIGP, NIGPParams  # noqa: F401
from mfgp_jax.models.mfgp_recursive import RecursiveMFGP  # noqa: F401
