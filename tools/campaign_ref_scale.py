"""Campaign at the reference's sim scale: one variant, B=150, >=10 seeds.

VERDICT r3 #7: run one variant at the reference's sim planner budget
(B=150, reference/exploreSimSettings.py:199) with realistic iteration
counts x >=10 seeds on the chip; record wall-clock + outcome stats for
the PARITY.md table against the recorded 88-run means (BASELINE.md).

  python tools/plan... tools/campaign_ref_scale.py --variant MFEGP \
      --seeds 10 --bd 5 --plan-iters 40

By default each variant's seeds run as one vmapped launch;
--chunk / --mode forward seed chunking and stepped tranche spans to
run_ensemble.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="MFEGP")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", type=float, default=150.0)
    ap.add_argument("--bd", type=int, default=5)
    ap.add_argument("--plan-iters", type=int, default=40)
    ap.add_argument("--e-max", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=0,
                    help=">0: seed_chunk for run_ensemble (default: all "
                         "seeds in one launch)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "one", "stepped"],
                    help="run_ensemble execution mode (auto = one "
                         "launch)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mfgp_jax.sim.mission_device import DeviceMission
    from mfgp_jax.utils.configs import ExperimentConfig

    v = args.variant.upper()
    exp = ExperimentConfig(multi_fidelity=v.startswith("MF"),
                           ergodic=v in ("MFEGP", "SFEGP"),
                           B=args.budget, BD=args.bd, update_hyps=False)
    mission = DeviceMission(exp, seed=args.seed,
                            plan_iters=args.plan_iters, e_max=args.e_max)
    print(f"devices: {jax.devices()}; n_max={mission.n_max}", flush=True)

    t0 = time.perf_counter()
    results = mission.run_ensemble(
        args.seeds, mode=args.mode,
        seed_chunk=args.chunk if args.chunk > 0 else None)
    wall = time.perf_counter() - t0
    print(f"launches (last chunk): {mission.last_run_launches}", flush=True)

    rmse = np.array([r.rmse for r in results])
    wmse = np.array([getattr(r, "wmse", np.nan) for r in results])
    out = {
        "variant": v, "budget": args.budget, "bd": args.bd,
        "plan_iters": args.plan_iters, "seeds": args.seeds,
        "wall_seconds": round(wall, 1),
        "seconds_per_run": round(wall / args.seeds, 1),
        "rmse_mean": round(float(np.nanmean(rmse)), 4),
        "rmse_std": round(float(np.nanstd(rmse)), 4),
        "rmse": [round(float(r), 4) for r in rmse],
        "replans": [r.n_replans for r in results],
        "budget_used": [round(float(r.budget_used), 2) for r in results],
    }
    if np.isfinite(wmse).any():
        out["wmse_mean"] = round(float(np.nanmean(wmse)), 4)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
