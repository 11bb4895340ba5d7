"""Test configuration.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4: multi-device tests
via the host-platform device-count override) with x64 enabled so numpy
oracles can be matched to tight tolerances. The accelerator paths
(bench.py, chip_smoke.py) run in separate processes and are unaffected.
"""

import os

# Force CPU even on a host with an accelerator: tests must be hermetic and
# runnable without hardware.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_ROOT = "/root/reference"

# Heavy modules (closed-loop sims, whole-planner jit compiles, 2-process
# DCN spawn): everything here is auto-marked ``slow``; every other test is
# ``quick``. ``pytest -m quick`` is the <3 min tier; per-test overrides via
# an explicit @pytest.mark.slow still apply anywhere.
SLOW_FILES = {
    "test_rig_device.py", "test_sim_cli.py", "test_runtime.py",
    "test_dcn_sweep.py", "test_viz_studies.py", "test_serve.py",
    "test_fault_injection.py", "test_parallel.py", "test_planner.py",
    "test_mfgp.py", "test_mfgp_recursive.py", "test_data_pipeline.py",
    "test_driver_artifacts.py", "test_mission_device.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.fspath.basename in SLOW_FILES
                or item.get_closest_marker("slow") is not None):
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def reference_root():
    if not os.path.isdir(REFERENCE_ROOT):
        pytest.skip("reference artifacts not available")
    return REFERENCE_ROOT


@pytest.fixture
def rng():
    return np.random.default_rng(0)
