"""Driver-artifact smoke tests: bench.py and __graft_entry__.py.

The round driver compile-checks entry(), runs dryrun_multichip on a
virtual mesh, and executes bench.py on hardware; these tests catch
regressions in those paths before the driver does.
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    mu, var = jax.jit(fn)(*args)
    assert mu.shape == (16,) and var.shape == (16,)
    assert np.isfinite(np.asarray(mu)).all()
    assert (np.asarray(var) > 0).all()


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    assert len(jax.devices()) == 8
    g.dryrun_multichip(8)  # asserts internally


def test_dryrun_multichip_self_bootstraps_when_backend_initialized():
    """The driver invokes dryrun_multichip directly in a process whose JAX
    backend may already be initialized with a single device (one real
    card). Simulate that: a child with ONE CPU device,
    backend initialized, must still complete the 8-device dry run (via the
    subprocess re-exec fallback)."""
    import subprocess

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "assert len(jax.devices()) == 1; "
        "import __graft_entry__ as g; g.dryrun_multichip(8)")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]


def test_make_mesh_heuristic():
    """mp = largest power of two <= sqrt(n) that divides n (VERDICT weak#2);
    non-power-of-two counts must produce valid meshes."""
    from mfgp_jax.parallel.mesh import make_mesh

    devs = jax.devices()
    assert make_mesh(8).shape == {"dp": 4, "mp": 2}
    assert make_mesh(4).shape == {"dp": 2, "mp": 2}
    assert make_mesh(2).shape == {"dp": 2, "mp": 1}
    assert make_mesh(1).shape == {"dp": 1, "mp": 1}
    assert make_mesh(6).shape == {"dp": 3, "mp": 2}
    assert make_mesh(3).shape == {"dp": 3, "mp": 1}
    assert make_mesh(5).shape == {"dp": 5, "mp": 1}
    assert make_mesh(7).shape == {"dp": 7, "mp": 1}
    with pytest.raises(ValueError, match="only"):
        make_mesh(16, devices=devs)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(8, mp=3)


def test_bench_numpy_unit_smoke():
    from bench import run_numpy_unit

    t, nlml, mu_sum, var_sum = run_numpy_unit(150, 80)
    assert t > 0 and np.isfinite(nlml)
    assert np.isfinite(mu_sum) and np.isfinite(var_sum)


def test_bench_device_unit_smoke_on_cpu():
    """The device unit is platform-generic jitted JAX; exercise it tiny."""
    from bench import run_device

    stats = run_device(120, 64, repeats=1)
    assert stats["seconds"] > 0 and stats["chol_seconds"] > 0
    assert np.isfinite(stats["nlml_device"])
    assert stats["grid_points_per_sec"] > 0


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_bench_units_agree(kernel):
    """The JAX unit and the NumPy baseline compute the same quantities
    (both base kernels — the matern32 baseline must be the same unit
    before its vs_baseline speedup means anything)."""
    import jax.numpy as jnp

    from bench import _theta, build_problem
    from mfgp_jax.models import mfgp as mf

    N, M = 150, 80
    X, fid, y, grid, grid_fid = build_problem(N, M)
    _, nlml_np, mu_np, var_np = __import__("bench").run_numpy_unit(
        N, M, kernel=kernel)
    v, l, r, nz = _theta()
    params = mf.MFGPParams(
        jnp.log(jnp.asarray(v)), jnp.log(jnp.asarray(l)),
        jnp.asarray(r), jnp.log(jnp.asarray(nz)))
    Xj = jnp.asarray(X, jnp.float64)
    val = float(mf.nlml(params, Xj, jnp.asarray(fid),
                        jnp.asarray(y, jnp.float64), jitter=1e-6,
                        kernel=kernel))
    np.testing.assert_allclose(val, nlml_np, rtol=1e-6)
    state = mf.condition(params, Xj, jnp.asarray(fid),
                         jnp.asarray(y, jnp.float64), jitter=1e-6,
                         kernel=kernel)
    mu, var = mf.predict(params, state, jnp.asarray(grid, jnp.float64),
                         jnp.asarray(grid_fid), kernel=kernel)
    np.testing.assert_allclose(float(np.sum(np.asarray(mu))), mu_np,
                               rtol=1e-6)
    np.testing.assert_allclose(float(np.sum(np.asarray(var))), var_np,
                               rtol=1e-5)
    # the baseline's analytic gradient base: same trace-identity gradient
    # as the model's nlml_value_and_grad
    gv = mf.nlml_value_and_grad(params, Xj, jnp.asarray(fid),
                                jnp.asarray(y, jnp.float64), jitter=1e-6,
                                kernel=kernel)
    assert np.isfinite(float(gv[0]))


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_bench_cli_json_schema(kernel):
    """`python bench.py` prints ONE JSON line with the driver's schema;
    --kernel matern32 renames the metric and uses the matern-measured
    baseline (never the rbf constant)."""
    import json
    import subprocess
    import sys

    # run hermetically on CPU
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "bench.py", "--n", "120", "--m", "64",
         "--repeats", "1", "--kernel", kernel, "--no-planner"],
        capture_output=True, text=True, timeout=600, check=True,
        cwd=repo_root, env=env)
    line = out.stdout.strip().splitlines()[-1]
    obj = json.loads(line)
    assert obj["unit"] == "s" and obj["value"] > 0
    import bench as b

    # obj["value"] is rounded in the JSON, so compare as a ratio — still
    # sharp enough to catch the wrong baseline (they differ by 1.9x)
    if kernel == "rbf":
        assert obj["metric"].startswith("mfgp_n20k")
        expect = b.BASELINE_CPU_SECONDS / obj["value"]
    else:
        assert obj["metric"].startswith("mfgp_matern32_")
        expect = b.BASELINE_CPU_SECONDS_MATERN32 / obj["value"]
    # both value (4 dp) and vs_baseline (2 dp) are rounded in the JSON;
    # widen the tolerance by their worst-case rounding error so a very
    # fast tiny-N run can't trip it (still far below the 1.9x gap
    # between the two baselines this test exists to distinguish)
    tol = 0.02 + 5e-5 / obj["value"] + 0.005 / expect
    assert abs(obj["vs_baseline"] - expect) / expect < tol


def test_bench_planner_unit_smoke():
    """run_planner: the tracked planner sub-metric (one-launch RIG +
    fleet plan_batch) returns the schema keys with sane values at a tiny
    iteration count (CPU)."""
    from bench import run_planner

    p = run_planner(repeats=1, iters=4, lanes=2)
    assert p["plan_seconds"] > 0 and p["plan_batch_seconds"] > 0
    assert p["lanes"] == 2
    assert p["lane_overhead_x"] == (p["plan_batch_seconds"]
                                    / p["plan_seconds"])
