"""Model-serving endpoint tests."""

import http.client
import json
import threading

import numpy as np
import pytest

from mfgp_jax.models.gp import GP
from mfgp_jax.serve import ModelServer, make_http_server


@pytest.fixture(scope="module")
def server_addr(rng_module):
    X = rng_module.uniform(0, 10, (30, 3))
    y = np.sin(X[:, 0]) + 0.1 * rng_module.standard_normal(30)
    gp = GP(X, y, jitter=1e-8)
    srv = make_http_server(ModelServer(gp), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address
    srv.shutdown()


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(0)


def _req(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr)
    conn.request(method, path, body=json.dumps(body) if body else None)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_health(server_addr):
    code, out = _req(server_addr, "GET", "/health")
    assert code == 200 and out["status"] == "ok" and out["n"] == 30


def test_predict_roundtrip(server_addr, rng_module):
    pts = rng_module.uniform(0, 10, (7, 3)).tolist()
    code, out = _req(server_addr, "POST", "/predict", {"points": pts})
    assert code == 200
    assert len(out["mean"]) == 7 and len(out["var"]) == 7
    assert all(v > 0 for v in out["var"])


def test_eid_normalized(server_addr, rng_module):
    pts = rng_module.uniform(0, 10, (12, 3)).tolist()
    code, out = _req(server_addr, "POST", "/eid", {"points": pts})
    assert code == 200
    assert abs(sum(out["eid"]) - 1.0) < 1e-6


def test_bad_requests(server_addr):
    code, out = _req(server_addr, "POST", "/predict", {"points": []})
    assert code == 400
    code, out = _req(server_addr, "POST", "/nope", {"points": [[0, 0, 0]]})
    assert code == 404


def test_concurrent_requests_batch_into_one_launch(rng_module):
    """>=4 concurrent predict calls coalesce into ONE device launch
    (the batching queue, VERDICT r1 item 9)."""
    X = rng_module.uniform(0, 10, (25, 3))
    y = np.sin(X[:, 0])
    srv = ModelServer(GP(X, y, jitter=1e-8), batch_wait=0.25)
    try:
        launches0 = srv.batcher.launches
        n_clients = 6
        barrier = threading.Barrier(n_clients)
        results = [None] * n_clients
        pts = [rng_module.uniform(0, 10, (2 + i, 3))
               for i in range(n_clients)]

        def client(i):
            barrier.wait()
            results[i] = srv._predict(pts[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert srv.batcher.max_requests_per_launch >= 4
        assert srv.batcher.launches - launches0 <= 2
        # every caller got ITS slice, identical to a solo launch
        for i in range(n_clients):
            mu, var = results[i]
            assert mu.shape == (2 + i,)
            mu_solo, var_solo = srv._predict_device(pts[i])
            np.testing.assert_allclose(mu, mu_solo, rtol=1e-9)
            np.testing.assert_allclose(var, var_solo, rtol=1e-9)
    finally:
        srv.close()


def test_multi_model_routing(rng_module):
    """ModelRouter: named-model routes + default + listing."""
    from mfgp_jax.serve import ModelRouter

    X = rng_module.uniform(0, 10, (20, 3))
    srv_a = ModelServer(GP(X, np.sin(X[:, 0]), jitter=1e-8))
    srv_b = ModelServer(GP(X, np.cos(X[:, 1]), jitter=1e-8))
    router = ModelRouter({"sin": srv_a, "cos": srv_b})
    http_srv = make_http_server(router, port=0)
    t = threading.Thread(target=http_srv.serve_forever, daemon=True)
    t.start()
    addr = http_srv.server_address
    try:
        code, out = _req(addr, "GET", "/models")
        assert code == 200 and out["models"] == ["cos", "sin"]
        assert out["default"] == "sin"
        p = X[:3].tolist()
        code, oa = _req(addr, "POST", "/models/sin/predict", {"points": p})
        assert code == 200
        code, ob = _req(addr, "POST", "/models/cos/predict", {"points": p})
        assert code == 200
        assert not np.allclose(oa["mean"], ob["mean"])
        # bare /predict hits the default model
        code, od = _req(addr, "POST", "/predict", {"points": p})
        assert code == 200 and np.allclose(od["mean"], oa["mean"])
        code, _ = _req(addr, "POST", "/models/nope/predict", {"points": p})
        assert code == 404
    finally:
        http_srv.shutdown()
        router.close()


def test_server_from_checkpoint(tmp_path, rng_module):
    from mfgp_jax.serve import ModelServer
    from mfgp_jax.utils import checkpoint as ckpt

    X = rng_module.uniform(0, 5, (20, 3))
    y = np.cos(X[:, 1])
    gp = GP(X, y, jitter=1e-8)
    ck = ckpt.ExplorationCheckpoint(
        plan_num=0, t_now=0.0, planned_budget=0.0,
        x0=np.zeros((2, 1)), model=ckpt.capture_model(gp),
        data_rows=np.zeros((0, 9)),
        rng_state=np.random.default_rng(0).bit_generator.state,
        jax_key_data=np.zeros(2, np.uint32))
    ckpt.save_checkpoint(str(tmp_path / "m"), ck)
    srv = ModelServer.from_checkpoint(str(tmp_path / "m"))
    out = srv.handle("/predict", {"points": X[:3].tolist()})
    np.testing.assert_allclose(out["mean"],
                               np.asarray(gp.predict(X[:3])[0]), rtol=1e-6)


def test_predict_full_cov(server_addr, rng_module):
    pts = rng_module.uniform(0, 10, (5, 3)).tolist()
    code, out = _req(server_addr, "POST", "/predict",
                     {"points": pts, "full_cov": True})
    assert code == 200
    cov = np.asarray(out["cov"])
    assert cov.shape == (5, 5)
    # SPD-ish: symmetric with positive diagonal
    np.testing.assert_allclose(cov, cov.T, rtol=1e-8, atol=1e-10)
    assert np.all(np.diag(cov) > 0)
    # marginals equal the var route
    code, out2 = _req(server_addr, "POST", "/predict", {"points": pts})
    np.testing.assert_allclose(np.diag(cov), out2["var"], rtol=1e-6)


def test_nigp_checkpoint_serves(rng_module):
    """NIGP checkpoints serve too (its predict lacks include_noise /
    full_cov kwargs — spelled return_cov there)."""
    from mfgp_jax.models.nigp import NIGP
    from mfgp_jax.utils import checkpoint as ckpt

    X = rng_module.uniform(0, 5, (25, 2))
    y = np.sin(X[:, 0])
    m = NIGP(iters=1, n_restarts=1)
    m.fit(X, y)
    srv = ModelServer(m)
    try:
        out = srv.handle("/predict", {"points": X[:4].tolist()})
        assert len(out["mean"]) == 4
        out = srv.handle("/predict", {"points": X[:3].tolist(),
                                      "full_cov": True})
        cov = np.asarray(out["cov"])
        assert cov.shape == (3, 3)
    finally:
        srv.close()


def test_plan_endpoint_ergodic(rng_module):
    """Replan-as-a-service: POST /plan runs the one-launch device planner
    against the served model's EID and returns a flyable path."""
    from mfgp_jax.serve import PlannerService

    X = np.column_stack([rng_module.uniform(0, 10, 25),
                         rng_module.uniform(0, 20, 25),
                         rng_module.uniform(0, 10, 25)])
    y = np.sin(X[:, 0]) + 0.1 * rng_module.standard_normal(25)
    svc = PlannerService(ModelServer(GP(X, y, jitter=1e-8)),
                         cost="ergodic", plan_iters=12)
    srv = make_http_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        code, out = _req(srv.server_address, "POST", "/plan",
                         {"start": [1.0, 1.0], "budget": 20.0, "seed": 0})
        assert code == 200
        path = np.asarray(out["path"])
        assert path.ndim == 2 and path.shape[1] == 4  # x, y, z, t
        assert 0.0 < out["budget"] <= 20.0
        assert np.isfinite(out["info"]) and out["n_nodes"] > 0
        assert out["plan_seconds"] > 0
        # deterministic per seed
        code, out2 = _req(srv.server_address, "POST", "/plan",
                          {"start": [1.0, 1.0], "budget": 20.0, "seed": 0})
        assert out2["path"] == out["path"]
        # non-plan routes pass through to the model server
        code, h = _req(srv.server_address, "GET", "/health")
        assert code == 200 and h["status"] == "ok"
        code, _ = _req(srv.server_address, "POST", "/plan", {"start": []})
        assert code == 400
    finally:
        srv.shutdown()
        svc.close()


def test_plan_endpoint_gain(rng_module):
    """sf_gain /plan conditions the sequential info gain on the served
    model's training set (prepare_sf_gain_state path)."""
    from mfgp_jax.serve import PlannerService

    X = np.column_stack([rng_module.uniform(0, 10, 20),
                         rng_module.uniform(0, 20, 20),
                         rng_module.uniform(0, 10, 20)])
    y = np.sin(X[:, 0])
    svc = PlannerService(ModelServer(GP(X, y, jitter=1e-8)),
                         cost="sf_gain", plan_iters=10, warm=True)
    try:
        out = svc.handle("/plan", {"start": [2.0, 3.0], "budget": 15.0})
        assert np.asarray(out["path"]).shape[0] > 0
        assert np.isfinite(out["info"])
    finally:
        svc.close()


def test_concurrent_plans_coalesce_into_one_launch(rng_module):
    """A fleet replanning at once: >=4 concurrent /plan requests become
    lanes of ONE vmapped planner launch (PlanBatchingQueue ->
    DeviceRIG.plan_batch), and each caller's result matches a solo
    request with the same (start, budget, seed)."""
    from mfgp_jax.serve import PlannerService

    X = np.column_stack([rng_module.uniform(0, 10, 25),
                         rng_module.uniform(0, 20, 25),
                         rng_module.uniform(0, 10, 25)])
    y = np.sin(X[:, 0]) + 0.1 * rng_module.standard_normal(25)
    svc = PlannerService(ModelServer(GP(X, y, jitter=1e-8)),
                         cost="ergodic", plan_iters=12)
    assert svc.plan_queue is not None
    svc.plan_queue.max_wait = 0.25  # widen the window: threads must land
    try:
        n_clients = 5
        barrier = threading.Barrier(n_clients)
        results = [None] * n_clients

        def client(i):
            barrier.wait()
            results[i] = svc.handle(
                "/plan", {"start": [1.0 + i, 2.0], "budget": 20.0,
                          "seed": i})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        q = svc.plan_queue
        assert q.max_requests_per_launch >= 4
        assert q.launches <= 2
        assert q.batched_requests == n_clients
        n_finite = 0
        for i in range(n_clients):
            assert results[i] is not None
            # lane parity: a solo request (1-lane launch) agrees — even
            # for lanes that found no feasible path (info -inf == -inf)
            solo = svc.handle("/plan", {"start": [1.0 + i, 2.0],
                                        "budget": 20.0, "seed": i})
            np.testing.assert_allclose(results[i]["info"], solo["info"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(np.asarray(results[i]["path"]),
                                       np.asarray(solo["path"]),
                                       rtol=1e-4, atol=1e-4)
            n_finite += np.isfinite(results[i]["info"])
        assert n_finite >= 3  # most lanes found a plan at these settings
    finally:
        svc.close()


def test_plan_cost_model_mismatch(rng_module):
    """mf_gain needs an MFGP; NIGP lacks the conditioned state entirely."""
    from mfgp_jax.models.nigp import NIGP
    from mfgp_jax.serve import PlannerService

    X = rng_module.uniform(0, 5, (15, 3))
    y = np.sin(X[:, 0])
    srv = ModelServer(GP(X, y, jitter=1e-8))
    with pytest.raises(ValueError, match="does not match"):
        PlannerService(srv, cost="mf_gain")
    srv.close()
    m = NIGP(iters=1, n_restarts=1)
    m.fit(X, y)
    srv2 = ModelServer(m)
    with pytest.raises(ValueError, match="conditioned"):
        PlannerService(srv2, cost="sf_gain")
    srv2.close()


def test_extend_route_online_conditioning(rng_module):
    """/extend appends observations via bordered-Cholesky online
    conditioning: the served posterior matches a fresh fit-free GP on the
    concatenated data, and the variance at the pushed point collapses."""
    X = rng_module.uniform(0, 10, (25, 3))
    y = np.sin(X[:, 0])
    srv = ModelServer(GP(X, y, jitter=1e-8))
    try:
        q = [[5.0, 5.0, 5.0]]
        var0 = srv.handle("/predict", {"points": q})["var"][0]
        out = srv.handle("/extend", {"points": q, "y": [0.3]})
        assert out["n"] == 26
        assert srv.handle("/health", {})["n"] == 26
        var1 = srv.handle("/predict", {"points": q})["var"][0]
        # one exact-noise observation at q halves the latent variance
        # there (default hyps: noise ~ signal), so the noisy posterior
        # variance drops by ~25%
        assert var1 < 0.8 * var0
        fresh = GP(np.vstack([X, q]), np.append(y, 0.3), jitter=1e-8)
        pts = rng_module.uniform(0, 10, (6, 3))
        mu_s, var_s = srv._predict_device(pts)
        mu_f, var_f = fresh.predict(pts)
        np.testing.assert_allclose(mu_s, np.asarray(mu_f).reshape(-1),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(var_s, np.asarray(var_f).reshape(-1),
                                   rtol=1e-6)
    finally:
        srv.close()


def test_extend_route_mfgp_fid(rng_module):
    """Multi-fidelity /extend requires per-point fid labels and grows the
    AR1 state; /eid stays a distribution on the grown model."""
    from mfgp_jax.models.mfgp import MFGP

    Xl = [rng_module.uniform(0, 5, (12, 3)),
          rng_module.uniform(0, 5, (8, 3)),
          rng_module.uniform(0, 5, (6, 3))]
    yl = [np.sin(x[:, 0]) for x in Xl]
    srv = ModelServer(MFGP.from_fidelity_lists(Xl, yl))
    try:
        q = [[2.0, 2.0, 2.0]]
        with pytest.raises(ValueError, match="fid"):
            srv.handle("/extend", {"points": q, "y": [0.1]})
        out = srv.handle("/extend", {"points": q, "y": [0.1], "fid": [2]})
        assert out["n"] == 27
        pts = rng_module.uniform(0, 5, (9, 3)).tolist()
        eid = srv.handle("/eid", {"points": pts})["eid"]
        assert abs(sum(eid) - 1.0) < 1e-6
    finally:
        srv.close()


def test_refit_route(rng_module):
    """/refit runs the device-batched restart fit on the served data and
    refreshes the inferred prior variance; models without the batched fit
    (NIGP) reject both mutation routes with a client error."""
    from mfgp_jax.models.nigp import NIGP

    X = rng_module.uniform(0, 10, (20, 3))
    y = np.sin(X[:, 0]) + 0.05 * rng_module.standard_normal(20)
    srv = ModelServer(GP(X, y, jitter=1e-8))
    try:
        out = srv.handle("/refit", {"restarts": 2, "maxiter": 30})
        assert np.isfinite(out["nlml"]) and out["n"] == 20
        assert out["prior_sig"] == srv.prior_sig
    finally:
        srv.close()
    m = NIGP(iters=1, n_restarts=1)
    m.fit(X, y)
    srv2 = ModelServer(m)
    try:
        with pytest.raises(ValueError, match="refit"):
            srv2.handle("/refit", {})
        with pytest.raises(ValueError, match="conditioning"):
            srv2.handle("/extend", {"points": X[:1].tolist(), "y": [0.0]})
    finally:
        srv2.close()


def test_plan_cache_invalidation_on_extend(rng_module):
    """/extend invalidates the PlannerService's cached EID, so the next
    /plan scores against the updated posterior (the compiled planner
    executable is reused — the EID is a traced argument)."""
    from mfgp_jax.serve import PlannerService

    X = np.column_stack([rng_module.uniform(0, 10, 18),
                         rng_module.uniform(0, 20, 18),
                         rng_module.uniform(0, 10, 18)])
    y = np.sin(X[:, 0])
    svc = PlannerService(ModelServer(GP(X, y, jitter=1e-8)),
                         cost="ergodic", plan_iters=8)
    try:
        out1 = svc.handle("/plan", {"start": [1.0, 1.0], "budget": 15.0,
                                    "seed": 0})
        assert np.isfinite(out1["info"]) and svc._eid_cache
        eid1 = next(iter(svc._eid_cache.values())).copy()
        svc.handle("/extend", {"points": [[5.0, 10.0, 5.0]], "y": [2.0]})
        assert not svc._eid_cache and svc._gain_cache is None
        out2 = svc.handle("/plan", {"start": [1.0, 1.0], "budget": 15.0,
                                    "seed": 0})
        eid2 = next(iter(svc._eid_cache.values()))
        assert not np.allclose(eid1, eid2)
        assert np.isfinite(out2["info"])
    finally:
        svc.close()


def test_mission_service_warm_executable_reuse():
    """MissionService: the long-lived-server compile mitigation. The
    second submission of the SAME config (new seed) must be marked warm
    (executable transplant — no recompile) and produce finite outcomes;
    jobs serialize on one worker; unknown routes/variants error."""
    import time

    from mfgp_jax.serve import MissionService

    svc = MissionService()
    try:
        spec = {"variant": "SFEGP", "budget": 12.0, "bd": 1,
                "plan_iters": 6, "e_max": 6, "max_nodes": 16,
                "samples_per_edge": 6, "seed": 0}
        j0 = svc.handle("/mission", spec)
        assert j0["state"] == "queued" and j0["warm"] is False
        j1 = svc.handle("/mission", dict(spec, seed=1))

        def wait(i, timeout=300.0):
            t0 = time.monotonic()
            while time.monotonic() - t0 < timeout:
                st = svc.handle(f"/mission/{i}", {})
                if st["state"] in ("done", "error"):
                    return st
                time.sleep(0.2)
            raise TimeoutError(i)

        r0 = wait(j0["job"])
        r1 = wait(j1["job"])
        assert r0["state"] == "done", r0
        assert r1["state"] == "done", r1
        assert r0["warm"] is False and r1["warm"] is True
        for r in (r0, r1):
            assert np.isfinite(r["result"]["rmse"])
            assert r["result"]["replans"] >= 1
            assert r["result"]["budget_used"] <= 12.0 + 1e-6
        # different seeds explore differently but share the executable:
        # the warm run must not pay a second compile
        assert r1["seconds"] < r0["seconds"]
        lst = svc.handle("/missions", {})
        assert len(lst["jobs"]) == 2
        with pytest.raises(ValueError, match="variant"):
            svc.handle("/mission", {"variant": "NOPE"})
        with pytest.raises(KeyError):
            svc.handle("/mission/99", {})
    finally:
        svc.close()
