"""True multi-process DCN sweep execution (SURVEY §2.2 "DCN for multi-host").

Round 1 unit-tested ``parallel.sweep`` sharding in-process only; this spawns
TWO real JAX processes (``jax.distributed.initialize`` over a local
coordinator — the same wire path a multi-host cluster uses),
runs the sweep sharded by the live ``jax.process_index/count`` topology,
exercises a cross-process collective, and checks the merged results are
identical to a single-process run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, sys
sys.path.append(sys.argv[4])  # repo root
import jax

jax.config.update("jax_platforms", "cpu")
pid, coord, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == pid

# cross-process DCN collective: allgather of a per-process scalar
from jax.experimental import multihost_utils
import numpy as np
gathered = np.asarray(
    multihost_utils.process_allgather(np.array([float(pid + 1)])))
assert sorted(gathered.reshape(-1).tolist()) == [1.0, 2.0], gathered

# the sweep, sharded by the LIVE process topology (no explicit index)
from mfgp_jax.parallel.sweep import process_shard, run_sweep

tasks = list(range(7))
mine = process_shard(tasks)
assert all(t % 2 == pid for t in mine), (pid, mine)


def worker(t):
    import jax.numpy as jnp
    return float(jnp.sum(jnp.arange(t + 1, dtype=jnp.float64) ** 2))


res = run_sweep(tasks, worker)
with open(out_path, "w") as f:
    json.dump({str(k): v for k, v in res.items()}, f)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn_sweep(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one local device per process
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), coord,
             str(tmp_path / f"res{i}.json"), REPO],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    merged = {}
    for i in range(2):
        part = json.loads((tmp_path / f"res{i}.json").read_text())
        assert not set(part) & set(merged)  # disjoint shards
        merged.update(part)

    tasks = list(range(7))
    expected = {str(t): float(np.sum(np.arange(t + 1) ** 2.0))
                for t in tasks}
    assert merged == expected
