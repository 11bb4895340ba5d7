"""Attribute DeviceRIG lane overhead at sim defaults (VERDICT r4 #4).

At the sim-default edge mix (traj_count=3, 200 iters) an 8-lane
``plan_batch`` has cost several times one plan, and relatively less at
the richer traj_count=8 mix. This sweep varies ONE
knob at a time around the sim-default config and measures solo vs
8-lane wall-clock, so the residual lane cost can be attributed:

- if overhead shrinks as per-edge compute grows (S, grid size G,
  traj_count), the residual is per-iteration bookkeeping/scheduling
  that vmap multiplies by K — the lever would be batching iterations,
  not lanes;
- if overhead is flat in G/S, the bookkeeping one-hot/gather arena ops
  (O(max_nodes), O(max_paths)) dominate — the lever is arena sizing.

Run (GPU):  python tools/plan_lane_attrib.py
Outcome recorded in ROADMAP.md either way.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def measure_config(iters=200, lanes=8, repeats=3, seed=0, traj_count=3,
                   samples_per_edge=24, max_nodes=64, max_paths=8,
                   grid_stride=1):
    import jax
    import numpy as np

    from mfgp_jax.metrics.eid import eid_grid
    from mfgp_jax.planning.rig_device import DeviceRIG
    from mfgp_jax.utils.configs import SimConfig

    cfg_s = SimConfig()
    acfg = cfg_s.agent()
    acfg.traj_count = traj_count
    grid = np.asarray(eid_grid([list(b) for b in cfg_s.WS],
                               cfg_s.max_depth))[::grid_stride]
    rng = np.random.default_rng(seed)
    eid = rng.random(grid.shape[0])
    eid = eid / eid.sum()
    planner = DeviceRIG(
        cfg=acfg, delta=cfg_s.step_size, B=150.0,
        WS=np.asarray(cfg_s.WS, float), R=cfg_s.near_rad, Rd=cfg_s.Rd,
        same_node_distance=cfg_s.same_node_distance, budget_cutoff=0.9,
        max_iter=iters, grid=grid, eid=eid, cost="ergodic",
        max_nodes=max_nodes, max_paths=max_paths,
        samples_per_edge=samples_per_edge)
    x0 = np.array([1.0, 1.0])
    key = jax.random.key(seed)

    def timeit(fn):
        fn()
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    solo_oh = timeit(lambda: planner.plan(x0, key))
    solo_ga = timeit(lambda: planner.plan(x0, key, gather=True))
    keys = jax.random.split(key, lanes)
    x0s = np.tile(x0, (lanes, 1))
    Bs = np.full(lanes, 150.0)
    batch = timeit(lambda: planner.plan_batch(x0s, keys, Bs))
    best = min(solo_oh, solo_ga)
    return {"grid_pts": int(grid.shape[0]), "solo_onehot": round(solo_oh, 4),
            "solo_gather": round(solo_ga, 4), "batch": round(batch, 4),
            "overhead_x": round(batch / best, 2)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    sweeps = [
        ("sim_default", {}),
        ("grid_quarter", {"grid_stride": 4}),
        ("samples_x2", {"samples_per_edge": 48}),
        ("traj8", {"traj_count": 8}),
        ("nodes32_paths4", {"max_nodes": 32, "max_paths": 4}),
        ("iters100", {"iters": 100}),
    ]
    for name, kw in sweeps:
        kw.setdefault("iters", args.iters)
        r = measure_config(lanes=args.lanes, repeats=args.repeats, **kw)
        r["config"] = name
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
