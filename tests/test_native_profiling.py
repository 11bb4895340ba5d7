"""Native CSV loader + profiling utility tests."""

import os
import time

import numpy as np
import pytest

from mfgp_jax import native
from mfgp_jax.utils.profiling import PhaseTimer, device_trace, timed


@pytest.fixture(scope="module")
def built():
    if not native.build():
        pytest.skip("toolchain unavailable")
    return True


def test_native_load_matches_numpy(built, tmp_path, rng):
    d = rng.normal(size=(500, 7))
    p = tmp_path / "d.csv"
    np.savetxt(p, d, delimiter=",", header="a,b,c,d,e,f,g", comments="")
    a = np.loadtxt(p, delimiter=",", skiprows=1, ndmin=2)
    b = native.load_csv(str(p))
    np.testing.assert_array_equal(a, b)


def test_native_write_roundtrip(built, tmp_path, rng):
    d = rng.normal(size=(50, 4))
    p = tmp_path / "w.csv"
    native.write_csv(str(p), d, header="a,b,c,d")
    assert open(p).readline().strip() == "a,b,c,d"
    back = native.load_csv(str(p))
    np.testing.assert_array_equal(back, d)  # %.17g is exact for f64


def test_native_reference_dataset_parity(built):
    path = ("/root/reference/Data/TrajectoriesAndEstimates/GPDataSets/"
            "GPData_0.2_fieldMeas_0_T0_0.csv")
    if not os.path.exists(path):
        pytest.skip("reference unavailable")
    a = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    b = native.load_csv(path)
    np.testing.assert_array_equal(a, b)


def test_io_layer_uses_native_transparently(built, tmp_path, rng):
    from mfgp_jax.data.io import Table, load_table

    t = Table(["t", "x"], rng.normal(size=(20, 2)))
    t.save(str(tmp_path / "t.csv"))
    back = load_table(str(tmp_path / "t.csv"))
    np.testing.assert_allclose(back.data, t.data)
    assert back.headers == t.headers


def test_phase_timer():
    t = PhaseTimer()
    with t("a"):
        time.sleep(0.01)
    with t("a"):
        pass
    s = t.summary()
    assert s["a"]["calls"] == 2
    assert s["a"]["total_s"] >= 0.01
    assert "a" in t.report()


def test_timed_decorator(tmp_path):
    t = PhaseTimer()

    @timed(t, "work")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert t.summary()["work"]["calls"] == 1
    t.dump_json(str(tmp_path / "t.json"))
    t.dump_csv(str(tmp_path / "t.csv"))
    assert os.path.getsize(tmp_path / "t.json") > 10


def test_device_trace_noop(tmp_path):
    # must never raise, whatever the platform supports
    with device_trace(str(tmp_path / "trace")):
        pass
