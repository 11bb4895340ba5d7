"""chip_smoke.py's phases at tiny sizes on the CPU.

On the card the script runs each phase at full width; here the same
functions run small enough for the quick tier, so a wrong path, argument
or comparison shows before any chip time is spent."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

def test_last_line_is_the_contract_json():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = cs.last_line([dev])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100", "count": 1}}')
    assert json.loads(cs.last_line([dev] * 4))["device"]["count"] == 4


def test_main_refuses_without_gpu(capsys):
    """No accelerator: a non-zero exit and no result line."""
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_run_phases_reports_every_failure():
    def bad():
        cs.check(False, "deliberate", log=lambda s: None)

    seen = []
    failed = cs.run_phases([("a", bad), ("b", lambda: seen.append(1)),
                            ("c", bad)], log=lambda s: None)
    assert failed == ["a", "c"] and seen == [1]


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_phase_model_tiny(kernel):
    errs = cs.phase_model(kernel, n_full=48, n_check=64, m=37,
                          log=lambda s: None)
    assert set(errs) == {"nlml", "grad", "mu", "var"}
    assert max(errs.values()) < 1e-3


def test_phase_planner_tiny():
    out = cs.phase_planner(iters=40, lanes=2, n_train=24, n_max=32,
                           log=lambda s: None)
    assert set(out) == {"ergodic", "mf_gain"}
    assert all(np.isfinite(v["info"]) for v in out.values())


@pytest.fixture
def gpu_card():
    """Skip unless nvidia-smi lists a card (decided here, never at
    import, so every test worker collects the same tests)."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        pytest.skip("no GPU card: nvidia-smi is not available")
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no GPU card: nvidia-smi lists none")


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole smoke check on the card, in its own process (this
    process is pinned to the CPU by conftest)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1500)
    assert res.returncode == 0, res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
