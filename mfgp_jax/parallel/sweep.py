"""Multi-host sweep driver (SURVEY §7 step 7: DCN-parallel batch sweeps).

The reference's 88-run study is a serial loop over dataset files
(reference/GPTrainers.py:26). The runs are independent — the natural
multi-host axis is the *task list*, not the model: each host (JAX process)
takes a deterministic shard of the tasks and runs them on its local
devices; no cross-host communication is needed beyond the final artifact
collection (the shared filesystem). Resumability comes from the harness's
output-existence skip, so preempted hosts just rejoin.

Single-process fallback degrades to the serial loop (optionally split
across local worker subprocesses for CPU-bound stages).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Callable, Sequence


def process_shard(tasks: Sequence, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """Deterministic round-robin shard of ``tasks`` for this JAX process.

    Uses ``jax.process_index/count`` when a distributed runtime is
    initialized (multi-host over DCN); identity otherwise.
    """
    if process_index is None or process_count is None:
        try:
            import jax

            process_index = jax.process_index()
            process_count = jax.process_count()
        except Exception:
            process_index, process_count = 0, 1
    return [t for i, t in enumerate(tasks)
            if i % process_count == process_index]


def run_sweep(tasks: Sequence, worker: Callable, *,
              process_index: int | None = None,
              process_count: int | None = None,
              on_error: str = "continue") -> dict:
    """Run this host's shard of ``tasks`` through ``worker(task)``.

    Returns {task: result} for completed tasks; failures are recorded as
    the exception (on_error="continue") or re-raised (on_error="raise").
    """
    results = {}
    for t in process_shard(tasks, process_index, process_count):
        try:
            results[t] = worker(t)
        except Exception as e:  # noqa: BLE001 — sweep isolation by design
            if on_error == "raise":
                raise
            results[t] = e
    return results


def trainer_sweep(gpdata_dir: str, field_dir: str, out_dir: str,
                  cfg=None, kernel: str = "rbf", resume: bool = True,
                  optimize: bool = True,
                  process_index: int | None = None,
                  process_count: int | None = None) -> dict:
    """The GPTrainers sweep, host-sharded (reference/GPTrainers.py:26-170).

    Every host processes its shard of ``GPData_*.csv``; output-existence
    resume makes re-runs and host joins idempotent. Task resolution is
    shared with the serial sweep (data.trainers.dataset_task).
    """
    from mfgp_jax.data.trainers import dataset_task, process_dataset

    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(gpdata_dir) if f.endswith(".csv"))

    def worker(fname):
        done, gpdata_path, settings = dataset_task(
            fname, gpdata_dir, field_dir, out_dir, resume)
        if done:
            return "skipped"
        _, metrics = process_dataset(gpdata_path, settings, out_dir, cfg,
                                     kernel=kernel, optimize=optimize)
        return metrics

    return run_sweep(files, worker, process_index=process_index,
                     process_count=process_count)


def spawn_local_workers(script_args: Sequence[str], n_workers: int) -> int:
    """Poor-host's DCN: split a sweep across local subprocesses by passing
    synthetic process_index/count through the environment
    (MFGP_SWEEP_INDEX / MFGP_SWEEP_COUNT). Returns the number of failures.

    The workers serve CPU-bound stages, so each runs with
    ``JAX_PLATFORMS=cpu``: a JAX process reserves most of an accelerator's
    memory when it first touches it, and N workers sharing one card would
    fail for want of memory. Accelerator work stays in one process per
    card."""
    procs = []
    for i in range(n_workers):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   MFGP_SWEEP_INDEX=str(i), MFGP_SWEEP_COUNT=str(n_workers))
        procs.append(subprocess.Popen([sys.executable, *script_args],
                                      env=env))
    return sum(p.wait() != 0 for p in procs)


def env_shard() -> tuple:
    """(index, count) from the spawn_local_workers environment, or the JAX
    process topology, or (0, 1)."""
    if "MFGP_SWEEP_INDEX" in os.environ:
        return (int(os.environ["MFGP_SWEEP_INDEX"]),
                int(os.environ["MFGP_SWEEP_COUNT"]))
    try:
        import jax

        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1
