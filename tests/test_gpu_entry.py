"""Entry-point and launch defaults for running on a GPU.

All of these hold without a card: they pin what the entry points ask JAX
for, not what JAX finds."""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from mfgp_jax import cli
from mfgp_jax.parallel import sweep
from mfgp_jax.sim.mission_device import DeviceMission


@pytest.mark.parametrize("argv, platform", [
    (["--gpu", "mission"], "cuda"),
    (["mission"], "cpu"),
    (["--gpu", "campaign"], "cuda"),
])
def test_gpu_flag_selects_cuda(argv, platform):
    """--gpu asks for the CUDA platform by name, so a missing card is an
    error rather than a quiet CPU run; the default stays the CPU."""
    args = cli.build_parser().parse_args(argv)
    assert cli.platform_for(args) == platform


@pytest.mark.parametrize("ceiling, expect", [
    (None, np.inf),
    (0.0, np.inf),
    (-1.0, np.inf),
    (30.0, 30.0),
])
def test_launch_ceiling_on_gpu_backend(monkeypatch, ceiling, expect):
    """No per-launch ceiling on any backend unless the caller sets one, so
    mode="auto" is the single-launch mission on the GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    m = types.SimpleNamespace(launch_ceiling_s=ceiling)
    assert DeviceMission._launch_ceiling(m) == expect


def test_spawn_local_workers_run_on_cpu(tmp_path):
    """Sweep workers serve CPU-bound stages: each is pinned to the CPU so
    N processes never each reserve the accelerator's memory."""
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys\n"
        "ok = (os.environ['JAX_PLATFORMS'] == 'cpu'\n"
        "      and os.environ['MFGP_SWEEP_COUNT'] == '2')\n"
        "sys.exit(0 if ok else 1)\n")
    assert sweep.spawn_local_workers([str(script)], 2) == 0


def test_cli_help_names_no_launch_ceiling_backend():
    """The mission help no longer promises a backend-chosen stepped mode."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "mfgp_jax.cli", "mission",
                          "--help"], capture_output=True, text=True,
                         timeout=120, check=True, cwd=root).stdout
    text = " ".join(out.split())
    assert "--mode" in text and "auto = one" in text
    assert "ceiling" not in text and "tunnel" not in text
