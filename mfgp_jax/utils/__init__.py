"""Configs, checkpointing, and profiling utilities."""

from mfgp_jax.utils.configs import (DEFAULT_SIM, ExperimentConfig, KFConfig,
                                    SimConfig)
