"""Device-time breakdown of the bench unit on the GPU.

    python tools/unit_profile.py [--n 20000] [--kernel rbf] [--out DIR]

Runs the bench unit (N=20k AR1 MFGP NLML + gradient + conditioning on
the explicit-inverse path, then the 10,571-point grid posterior), warm,
and reports:

* the unit's host wall-clock (median of repeats, ends in a host read);
* the wall-clock of the covariance assembly alone, as the unit runs it:
  the training Gram matrix twice (once for the factor, once inside the
  gradient contraction) plus the grid cross-covariance;
* a ``jax.profiler`` trace of two unit runs reduced to device time per
  kernel name, busy time (union of kernel intervals) and idle share.

The full reduction goes to ``DIR/unit_profile_<kernel>.json``; a summary
goes to stdout. Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_seconds(fn, repeats):
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def reduce_trace(trace_dir: str, device_prefix: str = "/device:GPU") -> dict:
    """Device kernels of an xplane trace: time per kernel name, busy time
    (union of intervals) and the window from first start to last end."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    per_name: dict = {}
    intervals = []
    stats_of: dict = {}
    for plane in data.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                per_name[ev.name] = per_name.get(ev.name, 0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.end_ns))
                if ev.name not in stats_of:
                    stats_of[ev.name] = {str(k): str(v)[:200]
                                         for k, v in ev.stats}
    if not intervals:
        raise ValueError(f"no events on planes {device_prefix}*")
    intervals.sort()
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    total = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    return {
        "window_ms": window / 1e6, "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "kernel_ms_total": total / 1e6,
        "kernels": [{"name": k, "ms": v / 1e6, "share": v / total,
                     "stats": stats_of[k]} for k, v in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--kernel", default="rbf", choices=("rbf", "matern32"))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("no GPU: refusing to measure", file=sys.stderr)
        return 2
    import bench
    from mfgp_jax.models import mfgp as mf
    from mfgp_jax.ops import covariance as cov
    from mfgp_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    N = args.n or bench.N_TRAIN
    X, fid, y, grid, gfid = (jnp.asarray(a)
                             for a in bench.build_problem(N, bench.M_GRID))
    v, l, r, nz = bench._theta()
    p = mf.MFGPParams(jnp.log(jnp.asarray(v, jnp.float32)),
                      jnp.log(jnp.asarray(l, jnp.float32)),
                      jnp.asarray(r, jnp.float32),
                      jnp.log(jnp.asarray(nz, jnp.float32)))
    k = args.kernel
    vgs = jax.jit(lambda p: mf.nlml_value_grad_state_inv(
        p, X, fid, y, kernel=k, jitter=1e-6, inv_mode="highest"))
    post = jax.jit(lambda p, s: mf.predict_blocked_inv(p, s, grid, gfid,
                                                       kernel=k))

    def unit():
        val, g, s = vgs(p)
        mu, var = post(p, s)
        return float(val + jnp.sum(mu) + jnp.sum(var))  # host read

    train_cov = jax.jit(lambda p: jnp.sum(cov.mf_train_cov(
        p.variances, p.lengthscales, p.rhos, p.noises, X, fid, 1e-6, k)))
    cross_cov = jax.jit(lambda p: jnp.sum(cov.mf_cross_cov(
        p.variances, p.lengthscales, p.rhos, grid, gfid, X, fid, k)))

    t0 = time.perf_counter()
    unit()
    compile_s = time.perf_counter() - t0
    float(train_cov(p)), float(cross_cov(p))
    unit_s, unit_all = _median_seconds(unit, args.repeats)
    tc_s, _ = _median_seconds(lambda: float(train_cov(p)), args.repeats)
    xc_s, _ = _median_seconds(lambda: float(cross_cov(p)), args.repeats)
    cov_share = (2 * tc_s + xc_s) / unit_s

    trace_dir = os.path.join(args.out, f"trace_{k}")
    with jax.profiler.trace(trace_dir):
        unit()
        unit()
    red = reduce_trace(trace_dir)
    out = {
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "kernel": k, "N": N, "M": bench.M_GRID,
        "compile_and_first_run_s": compile_s,
        "unit_median_s": unit_s, "unit_runs_s": unit_all,
        "train_cov_median_s": tc_s, "cross_cov_median_s": xc_s,
        "cov_share_of_unit_wallclock": cov_share,
        "trace": red,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"unit_profile_{k}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({kk: vv for kk, vv in out.items() if kk != "trace"}))
    print(f"trace: window {red['window_ms']:.2f} ms, busy "
          f"{red['busy_ms']:.2f} ms, idle share {red['idle_share']:.4f}")
    for e in red["kernels"][:25]:
        print(f"  {e['ms']:10.3f} ms {e['share']:7.4f}  {e['name'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
