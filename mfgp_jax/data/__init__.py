"""Data pipeline: reference-schema CSV I/O, KF estimate generation,
field measurement synthesis, fidelity binning, GP training harness, and
result aggregation."""

from mfgp_jax.data.io import (GPDataset, Table, load_gp_dataset, load_table,
                              parse_mse, parse_mse_filename)
from mfgp_jax.data.pipeline import (bin_fidelity, generate_estimates,
                                    generate_estimates_batch,
                                    generate_field_measurements, run_pipeline)
from mfgp_jax.data.trainers import (TrainedModels, evaluate_models,
                                    process_dataset, process_directory,
                                    train_models)
from mfgp_jax.data.aggregate import collect_results, mean_metrics, summary
