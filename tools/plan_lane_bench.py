"""Measure DeviceRIG plan_batch lane scaling on the accelerator.

Solo / K=2/4/8 lanes at (a) the sim-default edge mix (traj_count=3 — the
light mix where one-hot/vmap overhead dominates) and (b) the richer mix
(traj_count=8).

  python tools/plan_lane_bench.py            # both mixes
  python tools/plan_lane_bench.py --iters 200 --lanes 1 2 4 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# import the package from the tree this script lives in (lets the same
# script benchmark an old-commit worktree for A/B attribution)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def measure(traj_count: int, iters: int, lanes_list, repeats: int = 3,
            seed: int = 0):
    import jax
    import numpy as np

    from mfgp_jax.metrics.eid import eid_grid
    from mfgp_jax.planning.rig_device import DeviceRIG
    from mfgp_jax.utils.configs import SimConfig

    cfg_s = SimConfig()
    acfg = cfg_s.agent()
    acfg.traj_count = traj_count
    grid = np.asarray(eid_grid([list(b) for b in cfg_s.WS],
                               cfg_s.max_depth))
    rng = np.random.default_rng(seed)
    eid = rng.random(grid.shape[0])
    eid = eid / eid.sum()
    planner = DeviceRIG(
        cfg=acfg, delta=cfg_s.step_size, B=150.0,
        WS=np.asarray(cfg_s.WS, float), R=cfg_s.near_rad, Rd=cfg_s.Rd,
        same_node_distance=cfg_s.same_node_distance, budget_cutoff=0.9,
        max_iter=iters, grid=grid, eid=eid, cost="ergodic")
    x0 = np.array([1.0, 1.0])
    key = jax.random.key(seed)

    out = {}
    planner.plan(x0, key)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        planner.plan(x0, key)
        ts.append(time.perf_counter() - t0)
    solo = min(ts)
    out[1] = solo
    for K in lanes_list:
        if K == 1:
            continue
        keys = jax.random.split(key, K)
        x0s = np.tile(x0, (K, 1))
        Bs = np.full(K, 150.0)
        planner.plan_batch(x0s, keys, Bs)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            planner.plan_batch(x0s, keys, Bs)
            ts.append(time.perf_counter() - t0)
        out[K] = min(ts)
    print(f"traj_count={traj_count} iters={iters}:")
    for K, t in sorted(out.items()):
        print(f"  K={K}: {t * 1000:8.1f} ms  ({t / solo:5.2f}x solo)",
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lanes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--mixes", type=int, nargs="+", default=[3, 8])
    args = ap.parse_args()
    results = {}
    for tc in args.mixes:
        results[tc] = measure(tc, args.iters, args.lanes, args.repeats)
    print(json.dumps({str(tc): {str(k): round(v, 4)
                                for k, v in r.items()}
                      for tc, r in results.items()}))


if __name__ == "__main__":
    main()
