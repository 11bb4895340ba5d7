from mfgp_jax.ops import kernels, linalg  # noqa: F401
