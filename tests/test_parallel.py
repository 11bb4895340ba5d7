"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY §4 item 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfgp_jax.models.gp import GP
from mfgp_jax.models.mfgp import MFGP, stack_fidelity_lists
from mfgp_jax.models import mfgp as mf
from mfgp_jax.ops.linalg import weighted_mse
from mfgp_jax.parallel import (fit_sharded, make_mesh,
                               make_sharded_ar1_cross_cov,
                               make_sharded_gp_predict,
                               make_sharded_mfgp_predict,
                               make_sharded_weighted_mse)
from mfgp_jax.parallel.train import make_mfgp_train_step


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return make_mesh(8)


@pytest.fixture
def problem(rng):
    N, D, M = 40, 3, 37  # deliberately not divisible by the shard count
    X = rng.normal(size=(N, D))
    y = np.sin(X.sum(axis=1))
    fid = rng.integers(0, 3, N)
    grid = rng.normal(size=(M, D))
    return X, fid, y, grid


def test_mesh_shape(mesh):
    assert mesh.shape["dp"] * mesh.shape["mp"] == 8
    assert make_mesh(1).shape == {"dp": 1, "mp": 1}


def test_sharded_gp_predict_matches_local(mesh, problem):
    X, _, y, grid = problem
    gp = GP(X, y, jitter=1e-10)
    mu_l, var_l = gp.predict(grid)
    mu_s, var_s = make_sharded_gp_predict(mesh)(gp.params, gp.state,
                                                jnp.asarray(grid))
    np.testing.assert_allclose(mu_s, mu_l, rtol=1e-12)
    np.testing.assert_allclose(var_s, var_l, rtol=1e-10, atol=1e-12)


def test_sharded_mfgp_predict_matches_local(mesh, problem):
    X, fid, y, grid = problem
    m = MFGP(X, fid, y, jitter=1e-10)
    grid_fid = np.full(grid.shape[0], 2, np.int32)
    mu_l, var_l = m.predict(grid)
    mu_s, var_s = make_sharded_mfgp_predict(mesh)(
        m.params, m.state, jnp.asarray(grid), jnp.asarray(grid_fid))
    np.testing.assert_allclose(mu_s, mu_l, rtol=1e-12)
    np.testing.assert_allclose(var_s, var_l, rtol=1e-10, atol=1e-12)


def test_sharded_wmse_matches_local(mesh, rng):
    M = 37
    A = rng.normal(size=(M, M))
    Sigma = A @ A.T + M * np.eye(M)
    err = rng.normal(size=M)
    w_local = float(weighted_mse(jnp.asarray(err), jnp.asarray(Sigma)))
    w_shard = float(make_sharded_weighted_mse(mesh)(jnp.asarray(err),
                                                    jnp.asarray(Sigma)))
    assert abs(w_local - w_shard) < 1e-12 * max(1.0, abs(w_local))


def test_sharded_cross_cov_matches_local(mesh, problem, rng):
    X, fid, y, grid = problem
    m = MFGP(X, fid, y)
    grid_fid = rng.integers(0, 3, grid.shape[0]).astype(np.int32)
    from mfgp_jax.ops import kernels as k

    K_local = k.ar1_cov(jnp.asarray(grid), jnp.asarray(grid_fid),
                        jnp.asarray(X), jnp.asarray(fid, jnp.int32),
                        m.params.variances, m.params.lengthscales,
                        m.params.rhos)
    K_shard = make_sharded_ar1_cross_cov(mesh)(
        jnp.asarray(grid), jnp.asarray(grid_fid), jnp.asarray(X),
        jnp.asarray(fid, jnp.int32), m.params)
    np.testing.assert_allclose(K_shard, K_local, rtol=1e-13)


def test_train_step_improves_and_selects_best(mesh, problem):
    X, fid, y, grid = problem
    fns = make_mfgp_train_step(mesh, learning_rate=0.05)
    init_fn, step_fn, prepare_grid = fns.init_fn, fns.step_fn, fns.prepare_grid
    gpad, gfpad, M = prepare_grid(grid)
    state = init_fn(jax.random.key(0), 8, 3, X.shape[1], jnp.float64)
    Xj = jnp.asarray(X)
    fj = jnp.asarray(fid, jnp.int32)
    yj = jnp.asarray(y)
    first = None
    for i in range(25):
        state, losses, mu, var = step_fn(state, Xj, fj, yj, gpad, gfpad)
        if first is None:
            first = float(jnp.min(losses))
    assert np.isfinite(np.asarray(losses)).all()
    assert float(jnp.min(losses)) < first  # batched Adam made progress
    assert np.isfinite(np.asarray(mu[:M])).all()
    assert (np.asarray(var[:M]) > 0).all()
    # rhos stayed fixed (reference kern.scale.fix([1,1]))
    np.testing.assert_array_equal(np.asarray(state.params.rhos),
                                  np.ones((8, 2)))


def test_fit_sharded_driver(mesh, problem):
    X, fid, y, grid = problem
    best, losses, mu, var = fit_sharded(mesh, X, fid, y, grid, steps=10,
                                        dtype=jnp.float64)
    assert mu.shape == (grid.shape[0],)
    assert np.isfinite(np.asarray(losses)).all()
    # best params reproduce a finite NLML locally
    val = mf.nlml(best, jnp.asarray(X), jnp.asarray(fid, jnp.int32),
                  jnp.asarray(y), jitter=1e-6)
    assert np.isfinite(float(val))


def test_process_shard_partition():
    from mfgp_jax.parallel.sweep import process_shard

    tasks = list(range(10))
    shards = [process_shard(tasks, i, 3) for i in range(3)]
    # disjoint and complete
    assert sorted(sum(shards, [])) == tasks
    assert shards[0] == [0, 3, 6, 9]


def test_run_sweep_isolates_failures():
    from mfgp_jax.parallel.sweep import run_sweep

    def worker(t):
        if t == 2:
            raise ValueError("boom")
        return t * 10

    res = run_sweep([1, 2, 3], worker, process_index=0, process_count=1)
    assert res[1] == 10 and res[3] == 30
    assert isinstance(res[2], ValueError)


def test_trainer_sweep_end_to_end(tmp_path, rng):
    """Host-sharded GPTrainers sweep on two small synthetic datasets."""
    import jax.numpy as jnp

    from mfgp_jax.data.io import GPDATA_HEADER, Table
    from mfgp_jax.fields.wrbf import default_sim_field, write_field_settings
    from mfgp_jax.parallel.sweep import trainer_sweep

    data_dir = tmp_path / "GPDataSets"
    field_dir = tmp_path / "FieldData"
    out_dir = tmp_path / "GPResults"
    data_dir.mkdir(); field_dir.mkdir()
    field = default_sim_field([[0, 10], [0, 20]], 10.0)
    write_field_settings(str(field_dir / "FieldSettings0.txt"), field)
    for t in range(2):
        n = 40
        X = rng.uniform(0, 10, (n, 3)) * [1, 2, 1]
        y = np.asarray(field(jnp.asarray(X)))
        rows = np.column_stack([
            np.arange(n, dtype=float), X, X + 0.05 * rng.standard_normal(
                (n, 3)), y, rng.integers(1, 4, n).astype(float)])
        Table(GPDATA_HEADER.split(","), rows).save(
            str(data_dir / f"GPData_0.2_fieldMeas_0_T{t}_0.csv"))
    # two "hosts" splitting the two files
    r0 = trainer_sweep(str(data_dir), str(field_dir), str(out_dir),
                       process_index=0, process_count=2)
    r1 = trainer_sweep(str(data_dir), str(field_dir), str(out_dir),
                       process_index=1, process_count=2)
    assert len(r0) == 1 and len(r1) == 1
    import os

    assert len([f for f in os.listdir(out_dir)
                if f.startswith("MSE")]) == 2
    # resume: a re-run skips everything
    r0b = trainer_sweep(str(data_dir), str(field_dir), str(out_dir),
                        process_index=0, process_count=2)
    assert list(r0b.values()) == ["skipped"]


def test_sharded_nlml_grad_matches_local(mesh, rng):
    """ICI-distributed analytic gradient (column-sharded K^-1, psum'd
    contractions) == the local trace-identity gradient."""
    from mfgp_jax.parallel.sharded import make_sharded_nlml_value_and_grad

    N, D, F = 48, 3, 3
    X = jnp.asarray(rng.uniform(0, 10, (N, D)))
    fid = jnp.asarray(rng.integers(0, F, N), jnp.int32)
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)))
    params = mf.MFGPParams(
        jnp.log(jnp.asarray([2.0, 1.0, 0.5])),
        jnp.log(jnp.asarray(rng.uniform(0.5, 3, (F, D)))),
        jnp.asarray([1.2, 0.8]),
        jnp.log(jnp.asarray([0.3, 0.1, 0.05])))
    v_l, g_l = mf.nlml_value_and_grad(params, X, fid, y, jitter=1e-6)
    v_s, g_s = make_sharded_nlml_value_and_grad(mesh, jitter=1e-6)(
        params, X, fid, y)
    np.testing.assert_allclose(float(v_s), float(v_l), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g_l), jax.tree.leaves(g_s)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-10)
    # indivisible N is an explicit error, not silent wrong math
    with pytest.raises(ValueError):
        make_sharded_nlml_value_and_grad(mesh)(params, X[:47], fid[:47],
                                               y[:47])


def test_prepare_grid_defaults_to_highest_fidelity(mesh, problem):
    """grid_fid=None must evaluate at the HIGHEST fidelity like every other
    predict path (code-review finding: it silently used fidelity 0)."""
    X, fid, y, grid = problem
    fns = make_mfgp_train_step(mesh)
    _, gfpad, M = fns.prepare_grid(grid, None, jnp.float64, n_fidelities=3)
    assert (np.asarray(gfpad) == 2).all()
    # fit_sharded now matches MFGP.predict's default-fidelity posterior
    best, losses, mu, var = fit_sharded(mesh, X, fid, y, grid, steps=5,
                                        dtype=jnp.float64)
    m = MFGP(X, fid, y, jitter=1e-6)
    m.params = best
    mu_ref, var_ref = m.predict(grid)  # defaults to highest fidelity
    np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_ref),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(var), np.asarray(var_ref),
                               rtol=1e-8)


def test_sharded_cholesky_matches_dense(mesh, rng):
    """Distributed block-column Cholesky == dense factorization to machine
    precision, across panel widths and both mp extents."""
    from mfgp_jax.parallel.chol import make_sharded_cholesky

    for n, b in [(64, 8), (128, 32)]:
        A = rng.normal(size=(n, n))
        K = A @ A.T + n * np.eye(n)
        L = np.asarray(make_sharded_cholesky(mesh, n, block=b)(
            jnp.asarray(K)))
        np.testing.assert_allclose(L, np.linalg.cholesky(K), atol=1e-12)
    mesh4 = make_mesh(8, mp=4)
    A = rng.normal(size=(128, 128))
    K = A @ A.T + 128 * np.eye(128)
    L = np.asarray(make_sharded_cholesky(mesh4, 128, block=16)(
        jnp.asarray(K)))
    np.testing.assert_allclose(L, np.linalg.cholesky(K), atol=1e-12)
    # layout violations raise, not silently mis-factorize
    with pytest.raises(ValueError):
        make_sharded_cholesky(mesh, 63)
    with pytest.raises(ValueError):
        make_sharded_cholesky(mesh, 64, block=24)


def test_sharded_cholesky_cyclic_layout(mesh, rng):
    """Block-cyclic column layout (VERDICT r1 item 8): same factor, and a
    measured trailing-update balance win over the 1D block layout."""
    from mfgp_jax.parallel.chol import (cyclic_permutation,
                                        make_sharded_cholesky,
                                        panel_utilization)

    for n, b in [(64, 8), (128, 16)]:
        A = rng.normal(size=(n, n))
        K = A @ A.T + n * np.eye(n)
        L = np.asarray(make_sharded_cholesky(mesh, n, block=b,
                                             layout="cyclic")(
            jnp.asarray(K)))
        np.testing.assert_allclose(L, np.linalg.cholesky(K), atol=1e-12)

    # the permutation is a bijection gathering panel p on chip p % mp
    perm = cyclic_permutation(64, 2, 8)
    assert sorted(perm.tolist()) == list(range(64))
    # measured panel utilization: cyclic stays balanced (to +-1 panel on
    # the final sweep steps), block decays chip by chip
    u_block = panel_utilization(2048, 8, 64, "block")  # 0.506
    u_cyc = panel_utilization(2048, 8, 64, "cyclic")  # 0.765
    assert u_cyc > u_block + 0.2
    # with more panels per chip the cyclic tail amortises away
    assert panel_utilization(8192, 8, 64, "cyclic") > 0.9

    with pytest.raises(ValueError):
        make_sharded_cholesky(mesh, 64, layout="diag")


def test_sharded_tri_solves_match_scipy(mesh, rng):
    import scipy.linalg as sla

    from mfgp_jax.parallel.chol import (make_sharded_cholesky,
                                        make_sharded_tri_solves)

    n = 128
    A = rng.normal(size=(n, n))
    K = A @ A.T + n * np.eye(n)
    L = np.asarray(make_sharded_cholesky(mesh, n, block=32)(jnp.asarray(K)))
    lower, upper = make_sharded_tri_solves(mesh, n, n, block=32)
    B = rng.normal(size=(n, n))
    X1 = np.asarray(lower(jnp.asarray(L), jnp.asarray(B)))
    np.testing.assert_allclose(X1, sla.solve_triangular(L, B, lower=True),
                               atol=1e-12)
    X2 = np.asarray(upper(jnp.asarray(L), jnp.asarray(X1)))
    np.testing.assert_allclose(
        X2, sla.solve_triangular(L.T, X1, lower=False), atol=1e-12)


def test_fully_sharded_nlml_grad_matches_local(mesh, rng):
    """Every N^2 object column-sharded (assembly -> distributed Cholesky ->
    distributed solves -> psum'd contractions) == the local analytic
    gradient to machine precision."""
    from mfgp_jax.parallel.chol import make_fully_sharded_nlml_value_and_grad

    N, D, F = 64, 3, 3
    X = jnp.asarray(rng.uniform(0, 10, (N, D)))
    fid = jnp.asarray(rng.integers(0, F, N), jnp.int32)
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)))
    params = mf.MFGPParams(
        jnp.log(jnp.asarray([2.0, 1.0, 0.5])),
        jnp.log(jnp.asarray(rng.uniform(0.5, 3, (F, D)))),
        jnp.asarray([1.2, 0.8]),
        jnp.log(jnp.asarray([0.3, 0.1, 0.05])))
    v_l, g_l = mf.nlml_value_and_grad(params, X, fid, y, jitter=1e-8)
    f = make_fully_sharded_nlml_value_and_grad(mesh, N, block=16,
                                               jitter=1e-8)
    v_s, g_s = f(params, X, fid, y)
    np.testing.assert_allclose(float(v_s), float(v_l), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g_l), jax.tree.leaves(g_s)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-10)


def test_fit_memory_scaled_converges(mesh, rng):
    """Adam over the fully ICI-sharded gradient decreases the NLML."""
    from mfgp_jax.parallel.chol import fit_memory_scaled

    N = 64
    X = rng.uniform(0, 10, (N, 3))
    y = np.sin(X.sum(1)) + 0.05 * rng.standard_normal(N)
    fid = rng.integers(0, 3, N)
    params, hist = fit_memory_scaled(mesh, X, fid, y, steps=30, block=16)
    assert hist[-1] < hist[0]
    assert np.isfinite(hist).all()
    # the sharded objective agrees with the local NLML at the returned
    # params (hist entries are pre-update, so compare fresh evaluations)
    from mfgp_jax.parallel.chol import make_fully_sharded_nlml_value_and_grad

    Xj = jnp.asarray(X, jnp.float32)
    fj = jnp.asarray(fid, jnp.int32)
    yj = jnp.asarray(y, jnp.float32)
    val_local = float(mf.nlml(params, Xj, fj, yj, jitter=1e-6))
    val_shard, _ = make_fully_sharded_nlml_value_and_grad(
        mesh, N, block=16, jitter=1e-6)(params, Xj, fj, yj)
    np.testing.assert_allclose(float(val_shard), val_local, rtol=1e-4)


def test_fully_sharded_nlml_grad_cyclic_layout(mesh, rng):
    """layout='cyclic': panels assigned block-cyclically (chips assemble
    their cyclic columns directly, no permutation pass) — value/grad
    identical to the block layout AND the local analytic gradient, with
    measurably better panel utilization."""
    from mfgp_jax.parallel.chol import (
        make_fully_sharded_nlml_value_and_grad, panel_utilization)

    N, D, F = 64, 3, 3
    X = jnp.asarray(rng.uniform(0, 10, (N, D)))
    fid = jnp.asarray(rng.integers(0, F, N), jnp.int32)
    y = jnp.asarray(np.sin(np.asarray(X).sum(1)))
    params = mf.MFGPParams(
        jnp.log(jnp.asarray([2.0, 1.0, 0.5])),
        jnp.log(jnp.asarray(rng.uniform(0.5, 3, (F, D)))),
        jnp.asarray([1.2, 0.8]),
        jnp.log(jnp.asarray([0.3, 0.1, 0.05])))
    v_l, g_l = mf.nlml_value_and_grad(params, X, fid, y, jitter=1e-8)
    n_mp = mesh.shape["mp"]
    f = make_fully_sharded_nlml_value_and_grad(mesh, N, block=8,
                                               jitter=1e-8,
                                               layout="cyclic")
    v_s, g_s = f(params, X, fid, y)
    np.testing.assert_allclose(float(v_s), float(v_l), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g_l), jax.tree.leaves(g_s)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-10)
    # the balance win the layout exists for
    assert (panel_utilization(N, n_mp, 8, "cyclic")
            > panel_utilization(N, n_mp, 8, "block"))
